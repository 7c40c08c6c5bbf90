"""The PyTorch port's generator against the JAX package, on the CPU.

One small flagship-family generator (``cfg/birds_2stg_splitz_cap_ca_eval.
realcls.yml`` cut to GF_DIM 8, float32) is initialised in JAX, given
non-trivial parameters and BatchNorm running statistics (fresh 0/1
statistics would hide a wrong eval-mode BatchNorm), and moved into the
port with ``jax_generator_to_state_dict``. The same numpy inputs and the
same random draws (read back from the JAX run) then go through both.

Tolerance: 1e-4 absolute and relative on float outputs. Both sides are
float32 on the CPU, but the convolutions run through different libraries
(XLA:CPU and oneDNN) that sum in different orders, and those differences
pass through up to ten conv+BN layers. Quantised images may differ by one
level where a pixel sits on a rounding edge (the JAX package's own bar
for its batched sampler, tests/test_train_step.py).
"""

import copy
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.config import cfg_from_file
from text2img_ekl_tpu.io_utils.torch_export import (flax_generator_to_torch,
                                                    save_torch_generator)
from text2img_ekl_tpu.models import generator as jgen
from text2img_ekl_tpu.train.step import make_caption_sample_fn
from text2img_ekl_tpu_torch.io_utils.weights import (
    jax_generator_to_state_dict, load_pth_generator)
from text2img_ekl_tpu_torch.models import generator as tgen
from text2img_ekl_tpu_torch.train.sample import caption_sample
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca_eval.realcls.yml')
TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def small_cfg(use_cap=True):
    cfg = cfg_from_file(CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    cfg.TPU_CAPSULE_PALLAS = False
    cfg.TEST.G_CAPSULE = use_cap
    return cfg


def _perturbed(variables, seed):
    """Random BN statistics, BN affines and biases on top of the init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == 'mean':
            return rng.normal(0.0, 0.3, x.shape).astype(np.float32)
        if name == 'var':
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ('scale', 'bias'):
            return x + rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _jax_generator(cfg, seed=0):
    G = jgen.build_generator(cfg, train_flag=False)
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
    cls = np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[3, 7]]
    keys = dict(zip(('params', 'reparam', 'cls_prior'),
                    jax.random.split(jax.random.PRNGKey(seed), 3)))
    # train=True builds every variable, vc_net2 included, as the trainer's
    # state does (eval with a class prior never reaches vc_net2)
    init = jax.jit(functools.partial(G.init, train=True, method='init_all'))
    variables = init(keys, noise, sen, cls)
    return G, _perturbed(variables, seed + 1)


def _port_generator(cfg, variables):
    tcfg = copy.deepcopy(cfg)
    tcfg.TPU_CAPSULE_PALLAS = True  # the kernel wrapper: plain on the CPU
    G = tgen.build_generator(tcfg, train_flag=False)
    G.load_state_dict(jax_generator_to_state_dict(variables), strict=True)
    return G.eval()


@pytest.fixture(scope='module')
def pair():
    cfg = small_cfg()
    jG, variables = _jax_generator(cfg)
    return cfg, jG, variables, _port_generator(cfg, variables)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize('use_cap', [True, False])
def test_state_dict_equals_reference_export(use_cap, pair):
    if use_cap:
        cfg, _, variables, tG = pair
    else:
        cfg = small_cfg(use_cap=False)
        _, variables = _jax_generator(cfg, seed=5)
        tG = _port_generator(cfg, variables)
    ours = jax_generator_to_state_dict(variables)
    ref = {k: v for k, v in flax_generator_to_torch(
        variables, module_prefix=False).items()
        if not k.endswith('num_batches_tracked')}
    assert set(ours) == set(ref) == set(tG.state_dict())
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


# (JAX call on the bound flax G, port call on the torch G, input shapes
# NHWC / [B, D]); each block runs in eval mode on the moved weights.
BLOCKS = {
    'up_block': (lambda m, x: m.h_net1.up.upsample1(x, False),
                 lambda g, x: g.h_net1.upsample1(x), [(B, 4, 4, 128)]),
    'block3x3_relu': (lambda m, x: m.h_net2.jointConv(x, False),
                      lambda g, x: g.h_net2.jointConv(x), [(B, 8, 8, 264)]),
    'res_block': (lambda m, x: m.h_net2.residual[0](x, False),
                  lambda g, x: g.h_net2.residual[0](x), [(B, 8, 8, 8)]),
    'next_stage': (lambda m, h, c: m.h_net2(h, c, False),
                   lambda g, h, c: g.h_net2(h, c), [(B, 8, 8, 8), (B, 256)]),
    'to_rgb': (lambda m, x: m.img_net2(x),
               lambda g, x: g.img_net2(x), [(B, 8, 8, 4)]),
    'capsule_init_stage': (lambda m, c, z: m.h_net1(c, z, False),
                           lambda g, c, z: g.h_net1(c, z),
                           [(B, 256), (B, 128)]),
}


@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_block_matches_jax(name, pair):
    _, jG, variables, tG = pair
    jfn, tfn, shapes = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    args = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    ref = np.asarray(jG.apply(variables, *args, method=jfn))
    targs = [_t(_nchw(a)) if a.ndim == 4 else _t(a) for a in args]
    with torch.no_grad():
        out = tfn(tG, *targs).numpy()
    np.testing.assert_allclose(out, _nchw(ref) if ref.ndim == 4 else ref,
                               **TOL)


@pytest.mark.parametrize('net', ['ca_net1', 'vc_net2'])
def test_conditioning_matches_jax_with_its_draws(net, pair):
    cfg, jG, variables, tG = pair
    rng = np.random.default_rng(11)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
    cls = np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[1, 2]]
    if net == 'ca_net1':
        jargs, targs = (sen,), (_t(sen),)
    else:
        jargs, targs = (noise, cls), (_t(noise), _t(cls))
    c, mu, logvar, std = jG.apply(
        variables, *jargs, method=lambda m, *a: getattr(m, net)(*a, False),
        rngs={'reparam': jax.random.PRNGKey(3)})
    eps = (np.asarray(c) - np.asarray(mu)) / np.asarray(std)
    with torch.no_grad():
        out = getattr(tG, net)(*targs, eps=_t(eps))
    for got, want in zip(out, (c, mu, logvar, std)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ca_eps(inter):
    c1, mu1, _, std1 = inter['intermediates']['ca_net1']['__call__'][0]
    return (np.asarray(c1) - np.asarray(mu1)) / np.asarray(std1)


def test_generator_eval_forward_matches_jax(pair):
    """Both stages and both images of CondGNetCatZCA in eval mode with a
    supplied class prior; the CA eps is read back from ca_net1's output."""
    cfg, jG, variables, tG = pair
    rng = np.random.default_rng(21)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
    prior = rng.standard_normal((B, cfg.GAN.MANIFD_DIM), dtype=np.float32)
    out, inter = jG.apply(variables, noise, sen, None, cls_prior=prior,
                          train=False, rngs={'reparam': jax.random.PRNGKey(4)},
                          capture_intermediates=True,
                          mutable=['intermediates'])
    imgs = jG.apply(variables, out[0], method='image')
    with torch.no_grad():
        tout = tG(_t(noise), _t(sen), None, cls_prior=_t(prior),
                  eps=_t(_ca_eps(inter)))
        timgs = tG.image(tout[0])
    assert len(tout[0]) == len(out[0]) == 2
    for got, want in zip(tout[0] + timgs, list(out[0]) + list(imgs)):
        np.testing.assert_allclose(got.numpy(), _nchw(want), **TOL)
    for got, want in zip(tout[1:], out[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_generator_tracks_jax_bf16():
    """At the configs' default compute dtype (bfloat16 convs and linears,
    float32 BatchNorm, the port's BN policy) the port stays as close to
    JAX as bfloat16 stays to float32. Bound: mean |d| <= 1e-2 and max |d|
    <= 0.1 on tanh images. bfloat16 keeps 8 mantissa bits and the two
    frameworks round at different points (JAX's tile-free joint conv sums
    kernel taps in bfloat16), a gap measured at ~3e-3 mean; a cast in the
    wrong place moves the images far more."""
    cfg = small_cfg()
    cfg.TPU_COMPUTE_DTYPE = 'bfloat16'
    jG, variables = _jax_generator(cfg, seed=7)
    tG = _port_generator(cfg, variables)
    assert tG.h_net2.jointConv[0].dtype == torch.bfloat16
    rng = np.random.default_rng(51)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    sen = rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32)
    prior = rng.standard_normal((B, cfg.GAN.MANIFD_DIM), dtype=np.float32)

    @jax.jit
    def forward(variables, noise, sen, prior):
        out, inter = jG.apply(variables, noise, sen, None, cls_prior=prior,
                              train=False,
                              rngs={'reparam': jax.random.PRNGKey(8)},
                              capture_intermediates=True,
                              mutable=['intermediates'])
        return jG.apply(variables, out[0], method='image'), inter

    imgs, inter = forward(variables, noise, sen, prior)
    with torch.no_grad():
        timgs = tG.image(tG(_t(noise), _t(sen), None, cls_prior=_t(prior),
                            eps=_t(_ca_eps(inter)))[0])
    for got, want in zip(timgs, imgs):
        d = np.abs(got.numpy() - _nchw(want))
        assert d.mean() <= 1e-2 and d.max() <= 0.1, (d.mean(), d.max())


def _jax_draws(jG, variables, key, noise, emb, cls):
    """The CA eps and class code one JAX caption call draws: read back
    through the inputs of h_net1 (c_code = [c1, c2]) and ca_net1's
    output."""
    seen = {}

    def spy(next_fun, args, kwargs, context):
        if (context.module.name == 'h_net1'
                and context.method_name == '__call__'):
            seen['c_code'] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    k_rep, k_prior = jax.random.split(jnp.asarray(key))
    with fnn.intercept_methods(spy):
        _, inter = jG.apply(variables, noise, emb, cls, train=False,
                            rngs={'reparam': k_rep, 'cls_prior': k_prior},
                            capture_intermediates=True,
                            mutable=['intermediates'])
    ef = _ca_eps(inter).shape[1]
    return _ca_eps(inter), seen['c_code'][:, ef:]


@pytest.mark.parametrize('pattern', ['cls', 'cls_share'])
def test_caption_sampler_matches_jax_per_caption(pattern, pair):
    """The port folds C captions into one eval-mode batch; JAX vmaps them.
    uint8 images agree to one level."""
    cfg, jG, variables, tG = pair
    C = 2
    rng = np.random.default_rng(31)
    noise = rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32)
    noise_all = np.broadcast_to(noise, (C, B, cfg.GAN.Z_DIM))
    emb = rng.standard_normal((C, B, cfg.TEXT.DIMENSION), dtype=np.float32)
    cls = np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[5, 9]]
    prior = rng.standard_normal((B, cfg.GAN.MANIFD_DIM), dtype=np.float32)
    keys = np.stack([np.array([100, i], np.uint32) for i in range(C)])
    sampler = make_caption_sample_fn(cfg, jG, pattern=pattern)
    if pattern == 'cls':
        ref = sampler(variables, keys, noise_all, emb, cls)
        draws = [_jax_draws(jG, variables, keys[i], noise, emb[i], cls)
                 for i in range(C)]
        kw = dict(cls=_t(cls), cls_prior=_t(np.stack([d[1] for d in draws])))
    else:
        ref = sampler(variables, keys, noise_all, emb, None, prior)
        draws = [_jax_draws(jG, variables, keys[i], noise, emb[i], None)
                 for i in range(C)]
        kw = dict(cls_prior=_t(prior))
    out = caption_sample(tG, _t(noise_all), _t(emb),
                         eps=_t(np.stack([d[0] for d in draws])), **kw)
    ref = np.asarray(ref)
    assert out.dtype == torch.uint8 and ref.dtype == np.uint8
    assert tuple(out.shape) == ref.shape == (C, B, cfg.imsize, cfg.imsize, 3)
    diff = np.abs(out.numpy().astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1


def test_pth_round_trip(pair, tmp_path):
    """The port's own torch.save file and a reference-format netG .pth
    (DataParallel 'module.' prefixes, num_batches_tracked counters) both
    load with load_state_dict(strict=True)."""
    cfg, _, variables, tG = pair
    own = tmp_path / 'netG_epoch_7.pth'
    torch.save(tG.state_dict(), own)
    reference = tmp_path / 'netG_ref.pth'
    save_torch_generator(variables, str(reference), module_prefix=True)
    rng = np.random.default_rng(41)
    noise = _t(rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32))
    sen = _t(rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32))
    draws = dict(cls_prior=_t(rng.standard_normal(
        (B, cfg.GAN.MANIFD_DIM), dtype=np.float32)),
        eps=_t(rng.standard_normal((B, cfg.GAN.EMBEDDING_DIM),
                                   dtype=np.float32)))
    with torch.no_grad():
        want = tG.image(tG(noise, sen, **draws)[0])
    for path in (own, reference):
        G = tgen.build_generator(cfg, train_flag=False)
        G.load_state_dict(load_pth_generator(str(path)), strict=True)
        G.eval()
        with torch.no_grad():
            got = G.image(G(noise, sen, **draws)[0])
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_quantisation_matches_jax():
    """Device and host [-1, 1] -> uint8 twins against the JAX package's:
    truncation, clamping, exact on the same float32 values."""
    from text2img_ekl_tpu.train.step import _pm1_to_uint8_dev
    from text2img_ekl_tpu_torch.io_utils.images import pm1_to_uint8
    from text2img_ekl_tpu_torch.train.sample import pm1_to_uint8_dev
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001, dtype=np.float32),
                        np.float32([-1, 1, 0, 127.5 / 127.5 - 1])])
    ref = np.asarray(_pm1_to_uint8_dev(jnp.asarray(x)))
    np.testing.assert_array_equal(pm1_to_uint8_dev(_t(x)).numpy(), ref)
    np.testing.assert_array_equal(pm1_to_uint8(x), ref)


def test_orbax_generator_path_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match='orbax'):
        load_pth_generator(str(tmp_path))
