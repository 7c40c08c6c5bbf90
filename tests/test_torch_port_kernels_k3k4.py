"""The port's fused BN+GLU op (K3's twin) and 3x3 conv weight-gradient op
(K4's twin) against the JAX package, on the CPU.

On CPU tensors the port runs its plain versions (``bn_glu_reference``,
``dw3x3_reference``); the JAX side runs its Pallas kernels in interpret
mode, as its own tests do. Inputs are seeded numpy, NHWC for JAX and NCHW
for the port.

Tolerances, float32 on both sides:
  * fused BN+GLU forward: rtol/atol 1e-6 (the same folded affine and
    logistic, elementwise); its gradients (all five inputs): 1e-5, since
    the mean, var, scale and bias gradients are sums over every row;
  * dW: |d| <= 1e-5 max|ref|, for the summation order of contractions over
    B*H*W terms (the Pallas kernels contract per slab, the port per tap);
  * the fused generator against JAX's: 1e-5 on images and BN buffers, at
    batch 4 (at batch 2 train-mode BatchNorm statistics are ill-conditioned,
    ROADMAP F9).

The BatchNorm dtype bfloat16 (TPU_BN_DTYPE's default): the affine runs in
bfloat16 on both sides (y, k and b rounded, the product and the sum each
rounded once), the same bits; the forward takes the float32 bar, or one
bfloat16 ulp where y and the output are bfloat16. The backward
differentiates the composition in bfloat16 (GLU included) on both sides:
y's gradient within 1 ulp(max|ref|) (the logistic's bfloat16 steps,
rounded by XLA:CPU three times and by torch once), the four per-channel
gradients, sums over every row of bfloat16 terms that the two frameworks
accumulate differently, within 8 ulp(max|ref|).
"""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_generator import _perturbed
from text2img_ekl_tpu.config import cfg_from_file
from text2img_ekl_tpu.models import generator as jgen
from text2img_ekl_tpu.nn import blocks as jblocks
from text2img_ekl_tpu.ops import bn_glu as jbn_glu
from text2img_ekl_tpu.ops import conv_dw as jconv_dw
from text2img_ekl_tpu_torch.io_utils.weights import \
    jax_generator_to_state_dict
from text2img_ekl_tpu_torch.models import generator as tgen
from text2img_ekl_tpu_torch.nn import blocks as tblocks
from text2img_ekl_tpu_torch.ops import bn_glu, conv_dw
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca_eval.realcls.yml')
B = 4
GEN_TOL = dict(rtol=1e-5, atol=1e-5)
# the JAX package's block policies, which build_generator sets from a config
JAX_GLOBALS = ('BN_DTYPE', 'SPLIT_JOINT_CONV', 'FUSED_BN_GLU', 'SUBPIXEL_UP',
               'PALLAS_DW')


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    """Building a JAX generator sets module globals of its blocks; workers
    share one process across test files."""
    saved = {k: getattr(jblocks, k) for k in JAX_GLOBALS}
    yield
    for k, v in saved.items():
        setattr(jblocks, k, v)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    a = np.asarray(a)
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


def _bn_inputs(rng, shape):
    """y NHWC [..., 2C] and the four per-channel vectors."""
    c2 = shape[-1]
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.normal(0.0, 0.3, c2).astype(np.float32),
            rng.uniform(0.5, 1.5, c2).astype(np.float32),
            (1.0 + rng.normal(0.0, 0.1, c2)).astype(np.float32),
            rng.normal(0.0, 0.1, c2).astype(np.float32))


# (3, 5, 7): 105 rows, not a multiple of 8; [13, 2C]: a 2-D input
@pytest.mark.parametrize('shape', [(3, 5, 7, 32), (2, 4, 4, 16), (13, 24)])
def test_fused_bn_glu_matches_jax(shape):
    y, mean, var, scale, bias = _bn_inputs(np.random.default_rng(0), shape)
    ref = jbn_glu.fused_bn_glu(jnp.asarray(y), mean, var, scale, bias,
                               jnp.float32, True)
    out = bn_glu.fused_bn_glu(_t(_nchw(y)), _t(mean), _t(var), _t(scale),
                              _t(bias))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=1e-6, atol=1e-6)


def test_fused_bn_glu_gradients_match_jax():
    rng = np.random.default_rng(1)
    inputs = _bn_inputs(rng, (3, 5, 7, 32))
    dz = rng.standard_normal((3, 5, 7, 16), dtype=np.float32)
    _, vjp = jax.vjp(lambda *a: jbn_glu.fused_bn_glu(*a, jnp.float32, True),
                     *[jnp.asarray(a) for a in inputs])
    want = vjp(jnp.asarray(dz))
    t_in = [_t(_nchw(a)).requires_grad_(True) for a in inputs]
    got = torch.autograd.grad(bn_glu.fused_bn_glu(*t_in), t_in,
                              _t(_nchw(dz)))
    for name, g, w in zip(('y', 'mean', 'var', 'scale', 'bias'), got, want):
        np.testing.assert_allclose(g.numpy(), _nchw(w), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def _bf16_ulp(v):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


@pytest.mark.parametrize('y_dtype', ['float32', 'bfloat16'])
def test_fused_bn_glu_in_bfloat16_matches_jax(y_dtype):
    y, mean, var, scale, bias = _bn_inputs(np.random.default_rng(2),
                                           (3, 5, 7, 32))
    yj = jnp.asarray(y).astype(y_dtype)
    ref = jbn_glu.fused_bn_glu(yj, mean, var, scale, bias, jnp.bfloat16,
                               True)
    ref = _nchw(np.asarray(ref.astype(jnp.float32)))
    yt = _t(_nchw(np.asarray(yj.astype(jnp.float32)))).to(
        getattr(torch, y_dtype))
    out = bn_glu.fused_bn_glu(yt, _t(mean), _t(var), _t(scale), _t(bias),
                              torch.bfloat16)
    assert out.dtype == yt.dtype
    out = out.float().numpy()
    if y_dtype == 'float32':
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(out - ref) <= _bf16_ulp(ref)).all()


def test_fused_bn_glu_gradients_in_bfloat16_match_jax():
    rng = np.random.default_rng(3)
    inputs = _bn_inputs(rng, (3, 5, 7, 32))
    dz = rng.standard_normal((3, 5, 7, 16), dtype=np.float32)
    _, vjp = jax.vjp(lambda *a: jbn_glu.fused_bn_glu(*a, jnp.bfloat16, True),
                     *[jnp.asarray(a) for a in inputs])
    want = vjp(jnp.asarray(dz))
    t_in = [_t(_nchw(a)).requires_grad_(True) for a in inputs]
    got = torch.autograd.grad(bn_glu.fused_bn_glu(*t_in, torch.bfloat16),
                              t_in, _t(_nchw(dz)))
    for name, g, w in zip(('y', 'mean', 'var', 'scale', 'bias'), got, want):
        w = _nchw(w)
        ulps = 1 if name == 'y' else 8
        d = np.abs(g.numpy() - w)
        assert d.max() <= ulps * _bf16_ulp(np.abs(w).max()), (name, d.max())


def test_dw_supported_matches_jax():
    for h in (8, 16, 32, 48, 64, 128, 256, 512):
        for w in (h, 2 * h, h + 8):
            for c in (3, 8, 32, 64, 65, 128):
                for f in (3, 8, 12, 64, 128):
                    assert conv_dw.dw_supported(h, w, c, f) == \
                        jconv_dw.dw_supported(h, w, c, f), (h, w, c, f)


# (B, H, C, F): 32 and 64 px maps, C in {8, 64}
DW_GEOMS = [(2, 32, 8, 16), (1, 32, 64, 24), (2, 64, 8, 8), (1, 64, 64, 16)]


def _dw_inputs(geom, seed):
    b, h, c, f = geom
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, h, c), dtype=np.float32),
            rng.standard_normal((b, h, h, f), dtype=np.float32))


def _assert_dw_close(got, want):
    want = np.asarray(want)
    bound = 1e-5 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound, (np.abs(got - want).max(),
                                               bound)


@pytest.mark.parametrize('geom', DW_GEOMS)
@pytest.mark.parametrize('variant', ['dw3x3', 'dw3x3_v2'])
def test_dw3x3_matches_jax(variant, geom):
    x, dy = _dw_inputs(geom, 2)
    want = getattr(jconv_dw, variant)(jnp.asarray(x), jnp.asarray(dy),
                                      interpret=True)
    got = conv_dw.dw3x3(_t(_nchw(x)), _t(_nchw(dy)))
    assert got.shape == (geom[3], geom[2], 3, 3) and \
        got.dtype == torch.float32
    # JAX's [ky, kx, c, f] -> the port's [f, c, ky, kx]
    _assert_dw_close(got.numpy(), np.asarray(want).transpose(3, 2, 0, 1))


@pytest.mark.parametrize('geom', DW_GEOMS)
def test_conv3x3_dw_matches_jax_vjp(geom):
    x, dy = _dw_inputs(geom, 3)
    w = np.random.default_rng(4).standard_normal(
        (3, 3, geom[2], geom[3])).astype(np.float32) * 0.1
    y, vjp = jax.vjp(jconv_dw.conv3x3_dw, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    tx = _t(_nchw(x)).requires_grad_(True)
    tw = _t(w.transpose(3, 2, 0, 1)).requires_grad_(True)
    ty = conv_dw.conv3x3_dw(tx, tw)
    np.testing.assert_allclose(ty.detach().numpy(), _nchw(y), rtol=1e-5,
                               atol=1e-5)
    dx, dw = torch.autograd.grad(ty, (tx, tw), _t(_nchw(dy)))
    assert dw.dtype == torch.float32
    _assert_dw_close(dw.numpy(), np.asarray(want_dw).transpose(3, 2, 0, 1))
    _assert_dw_close(dx.numpy(), _nchw(want_dx))


def test_conv3x3_routes_as_jax():
    """kernel_dw routes by the call's shapes; outside the envelope the
    weight gradient is plain autograd's."""
    calls = []
    real = conv_dw.dw3x3

    def spy(x, dy):
        calls.append(tuple(x.shape))
        return real(x, dy)

    conv_dw.dw3x3 = spy
    try:
        for c, f, h, want in ((8, 16, 32, True), (8, 3, 32, False),
                              (96, 16, 32, False), (8, 16, 16, False)):
            conv = tblocks.Conv3x3(c, f, kernel_dw=True)
            x = torch.randn(1, c, h, h, requires_grad=True)
            conv(x).sum().backward()
            assert bool(calls) == want == jconv_dw.dw_supported(h, h, c, f)
            calls.clear()
    finally:
        conv_dw.dw3x3 = real


# ---------------------------------------------------------------- generator

def _small_cfg():
    cfg = cfg_from_file(CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    cfg.TPU_FUSED_BN_GLU = True
    return cfg


@pytest.fixture(scope='module')
def fused_pair():
    cfg = _small_cfg()
    saved = {k: getattr(jblocks, k) for k in JAX_GLOBALS}
    try:
        jG = jgen.build_generator(cfg, train_flag=True)
        assert jblocks.FUSED_BN_GLU
        rng = np.random.default_rng(0)
        noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
        sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
        cls = np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[3, 7, 9, 11]]
        keys = dict(zip(('params', 'reparam', 'cls_prior'),
                        jax.random.split(jax.random.PRNGKey(0), 3)))
        init = jax.jit(functools.partial(jG.init, train=True,
                                         method='init_all'))
        variables = _perturbed(init(keys, noise, sen, cls), 1)
    finally:
        for k, v in saved.items():
            setattr(jblocks, k, v)
    tG = tgen.build_generator(cfg, train_flag=True)
    tG.load_state_dict(jax_generator_to_state_dict(variables), strict=True)
    return cfg, jG, variables, tG


def test_fused_generator_has_fused_tails(fused_pair):
    _, _, _, tG = fused_pair
    fused = [n for n, m in tG.named_modules()
             if isinstance(m, tblocks.FusedBatchNormGLU)]
    # 4 up blocks, the joint conv, 2 residual blocks, the stage-2 upsample
    assert len(fused) == 8, fused


@pytest.mark.parametrize('train', [True, False])
def test_fused_generator_matches_jax(fused_pair, train):
    """Train mode (batch statistics, running-statistics update) and eval
    mode (running statistics, a supplied class prior) of a GF_DIM 8
    generator whose eight BN+GLU tails are fused on both sides."""
    cfg, jG, variables, tG = fused_pair
    jgen._apply_bn_dtype_policy(cfg)  # the policies jG was built under
    rng = np.random.default_rng(21)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
    if train:
        cls, extra = np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[1, 4, 6, 8]], {}
    else:
        cls, extra = None, {'cls_prior': rng.standard_normal(
            (B, cfg.GAN.MANIFD_DIM), dtype=np.float32)}
    (h_codes, *_), state = jG.apply(
        variables, noise, sen, cls, train=train,
        rngs={'reparam': jax.random.PRNGKey(4),
              'cls_prior': jax.random.PRNGKey(5)},
        capture_intermediates=True, mutable=['intermediates', 'batch_stats'],
        **extra)
    imgs = jG.apply(variables, h_codes, method='image')

    def eps(net):
        c, mu, _, std = state['intermediates'][net]['__call__'][0]
        return _t((np.asarray(c) - np.asarray(mu)) / np.asarray(std))

    G = copy.deepcopy(tG).train(train)
    kw = {k: _t(v) for k, v in extra.items()}
    kw['eps'] = eps('ca_net1')
    if train:
        kw['eps_cls'] = eps('vc_net2')
    with torch.no_grad():
        tcodes = G(_t(noise), _t(sen), None if cls is None else _t(cls),
                   **kw)[0]
        timgs = G.image(tcodes)
    assert len(tcodes) == len(h_codes) == 2
    for got, want in zip(list(tcodes) + timgs, list(h_codes) + list(imgs)):
        np.testing.assert_allclose(got.numpy(), _nchw(want), **GEN_TOL)
    want_sd = jax_generator_to_state_dict(
        {'params': variables['params'],
         'batch_stats': state['batch_stats'] if train
         else variables['batch_stats']})
    got_sd = G.state_dict()
    stats = [k for k in want_sd if '.running_' in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(),
                                   err_msg=k, **GEN_TOL)
