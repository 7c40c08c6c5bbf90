"""The BatchNorm dtype policy (``TPU_BN_DTYPE``) of the PyTorch port against
the JAX package, on the CPU.

The JAX package computes BatchNorm statistics in float32 and casts the
normalised output to ``TPU_BN_DTYPE`` (``_apply_bn_dtype_policy`` sets it
for G and D; flax's ``_normalize`` casts last); GLU, LeakyReLU and the
residual sums then run in that type, and the block casts to the compute
dtype. The flagship configs take the default, bfloat16. The port follows it
(``nn.blocks.BatchNorm(bn_dtype=)``); before it did, it normalised in
float32 whatever the config said (``_float32_batchnorm`` below restores
that, to show that the tests tell the two apart).

Tolerances, in bfloat16 ulps (an ulp of v is 2^(floor(log2|v|) - 7)):
  * one BatchNorm tail (BN -> GLU, BN -> LeakyReLU, BN + skip) on the same
    input: every output is a bfloat16 value on both sides, and |d| <= 2
    ulp(|ref|) + 1e-6 max|ref|. The BN output is rounded on both sides,
    one ulp apart where the float32 values before the rounding straddle a
    rounding edge; the GLU adds one: XLA:CPU computes the bfloat16
    logistic in three rounded steps (exp, 1 + e, the reciprocal), torch in
    one, and one gate in three differs by an ulp. The 1e-6 max|ref| covers
    float32 rounding of BN outputs near zero.
  * the whole generator (eval and train mode), unfused and with the eight
    BN+GLU tails fused (the JAX side's Pallas kernel in interpret mode):
    the port's GLU takes XLA:CPU's bfloat16 logistic (1 / (1 + exp(-x)),
    each step rounded; ``_xla_cpu_logistic``, held to XLA bit for bit), so
    that both sides round at the same points and what is left is float32
    summation order, which flips a bfloat16 rounding here and there. The
    yardstick is what the policy itself moves in JAX: the same run with
    TPU_BN_DTYPE float32. Each output's mean |d| is held to a share of the
    yardstick's mean |d|, measured and set with room: 0.3 in eval mode
    (measured 0.018-0.142), 0.85 in train mode (measured 0.20-0.74: each
    flip moves a channel's batch statistics and so every element of it,
    and the flips spread from 0.003 of the yardstick after the first up
    block to 0.72 at the last); the running statistics per tensor to
    ||d|| <= that share of the yardstick's ||d|| + 1e-4 ||ref||. Hidden
    codes are bfloat16 values on both sides where unfused (the fused GLU
    multiplies by a float32 logistic on both sides). The port with float32
    BatchNorm outputs (before it followed the policy) differs from JAX by
    the yardstick itself, a share of 1.0, and each port that rounds only
    some of its BatchNorms fails the bar or the bfloat16 codes
    (``test_partial_policy_fails_the_generator_check``).
  * the fused tails' gap: the port's fused generator differs from its
    unfused one (the fused affine rounds y, k and b, the product and the
    sum in bfloat16; the unfused BatchNorm rounds once) as JAX's do: mean
    |gap| within 10 % of JAX's per output, max |gap| within 1.25 x JAX's.
  * one training step (the port's GLU as above): each metric within one
    bfloat16 ulp of JAX's (a loss is a mean of functions of D logits, each
    the last rounding of a bfloat16 chain), or the float32 step's 1e-4
    |ref| + 1e-5 where no chain feeds it; the fakes, the BatchNorm
    statistics and the Adam first moments against the yardstick of the
    port's own step under the float32 policy (one run of JAX's step is
    what this file can afford), which the port with float32 BatchNorm
    outputs equals, and so fails: mean |d| and ||d|| per network <= the
    yardstick's (measured 0.46-0.66 of it), statistics per tensor |d| <=
    max|yardstick| + 1 ulp(max|ref|).
  * the JAX side compiles with ``xla_allow_excess_precision`` off: with it
    on (XLA's default) XLA may keep a bfloat16 op's float32 result where
    an upcast follows, so that the program rounds at fewer points than it
    says; off, every op rounds to its type, as un-jitted JAX and the
    port's eager ops do.
  * ``'float32'``: the port's numerics from before it followed the policy,
    bit for bit.
"""

import contextlib
import copy
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_port_generator import _ca_eps, _nchw, _perturbed, _t
from test_torch_port_step import run_steps
from test_torch_port_step import small_cfg as step_cfg
from text2img_ekl_tpu.config import cfg_from_file
from text2img_ekl_tpu.models import generator as jgen
from text2img_ekl_tpu.nn import blocks as jblocks
from text2img_ekl_tpu_torch.io_utils.weights import \
    jax_generator_to_state_dict
from text2img_ekl_tpu_torch.models import discriminator as tdisc
from text2img_ekl_tpu_torch.models import generator as tgen
from text2img_ekl_tpu_torch.nn import blocks as tblocks
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca_eval.realcls.yml')
TRAIN_CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
B = 4
TAIL_ULPS, TAIL_ATOL = 2, 1e-6
# the generator's mean |d| as a share of the float32 policy's, per mode
YARDSTICK = {'eval': 0.3, 'train': 0.85}
STEP_YARDSTICK = 1
FUSED_GAP_MEAN, FUSED_GAP_MAX = 0.1, 1.25
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
# every bfloat16 op rounds to its type (see the module's docstring)
NO_EXCESS_PRECISION = {'xla_allow_excess_precision': False}
JAX_GLOBALS = ('BN_DTYPE', 'SPLIT_JOINT_CONV', 'FUSED_BN_GLU', 'SUBPIXEL_UP',
               'PALLAS_DW')


@contextlib.contextmanager
def _jax_globals():
    """Building a JAX model sets module globals of its blocks; workers
    share one process across test files."""
    saved = {k: getattr(jblocks, k) for k in JAX_GLOBALS}
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(jblocks, k, v)


@pytest.fixture(autouse=True)
def _restore_jax_globals():
    with _jax_globals():
        yield


def _ulp(v):
    """One bfloat16 ulp of |v| (8 significand bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def _is_bf16(a) -> bool:
    """Every element of float32 ``a`` is a bfloat16 value."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return torch.equal(t.to(torch.bfloat16).float(), t)


@contextlib.contextmanager
def _float32_batchnorm():
    """The port's BatchNorm as it was before it followed TPU_BN_DTYPE:
    float32 out whatever ``bn_dtype`` says."""
    forward = tblocks.BatchNorm.forward

    def f32(self, x):
        saved, self.bn_dtype = self.bn_dtype, torch.float32
        try:
            return forward(self, x)
        finally:
            self.bn_dtype = saved

    tblocks.BatchNorm.forward = f32
    try:
        yield
    finally:
        tblocks.BatchNorm.forward = forward


def _glu_xla_cpu(x):
    """``blocks.glu`` with XLA:CPU's bfloat16 logistic: 1 / (1 + exp(-b)),
    each step rounded to bfloat16 (``torch.sigmoid`` rounds once)."""
    nc = x.shape[1] // 2
    a, b = x[:, :nc], x[:, nc:]
    if b.dtype != torch.bfloat16:
        return a * torch.sigmoid(b)
    return a * (1 / (1 + torch.exp(-b)))


@contextlib.contextmanager
def _xla_cpu_logistic():
    """The port's unfused GLUs with XLA:CPU's bfloat16 logistic."""
    saved = tblocks.glu
    tblocks.glu = _glu_xla_cpu
    try:
        yield
    finally:
        tblocks.glu = saved


def test_xla_cpu_logistic_is_emulated_bit_for_bit():
    """The JAX side's bfloat16 logistic, as XLA:CPU compiles it with
    excess precision off, is _glu_xla_cpu's gate bit for bit; torch's own
    differs by an ulp at a third of the points."""
    x = np.random.default_rng(5).standard_normal((4, 64, 8, 8)) * 4
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = jax.jit(jax.nn.sigmoid).lower(xb).compile(
        compiler_options=NO_EXCESS_PRECISION)(xb)
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    b = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    ones = torch.ones_like(b)
    gate = _glu_xla_cpu(torch.cat([ones, b], 1))
    assert gate.dtype == torch.bfloat16 and torch.equal(gate.float(), ref)
    assert (torch.sigmoid(b).float() != ref).float().mean() > 0.2


# ---- one BatchNorm tail ---------------------------------------------------

class _JaxTail(fnn.Module):
    """The JAX package's BatchNorm tails at float32 compute: bn_glu (up
    blocks, 3x3 blocks), BN -> LeakyReLU (down blocks) and a residual
    block's BN + skip."""
    kind: str

    @fnn.compact
    def __call__(self, x, skip, train):
        if self.kind == 'bn_glu':
            return jblocks.bn_glu(x, train, jnp.float32)
        y = jblocks.BatchNorm(use_running_average=not train)(x)
        if self.kind == 'bn_leaky_relu':
            return fnn.leaky_relu(y, 0.2).astype(jnp.float32)
        return (y + skip.astype(y.dtype)).astype(jnp.float32)


def _port_tail(kind, bn, x, skip):
    y = bn(x)
    if kind == 'bn_glu':
        return tblocks.GLU(torch.float32)(y)
    if kind == 'bn_leaky_relu':
        return tblocks.LeakyReLU(torch.float32)(y)
    return (y + skip.to(y.dtype)).float()


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('kind', ['bn_glu', 'bn_leaky_relu', 'bn_residual'])
def test_batchnorm_tail_matches_jax_in_bfloat16(kind, train):
    jblocks.BN_DTYPE = jnp.bfloat16
    c = 32
    rng = np.random.default_rng(len(kind) + train)
    x = (rng.standard_normal((4, 8, 8, c)) * 2 + 0.5).astype(np.float32)
    skip = rng.standard_normal((4, 8, 8, c // 2 if kind == 'bn_glu' else c)
                               ).astype(np.float32)
    m = _JaxTail(kind)
    v = m.init(jax.random.PRNGKey(0), x, skip, True)
    # running statistics off their 0/1 start, the affine off its init
    stats = {'mean': rng.normal(0.3, 0.3, c).astype(np.float32),
             'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    shift = {'scale': 0.1, 'bias': 0.2}

    def leaf(path, a):
        name = path[-1].key
        if name in stats:
            return stats[name]
        return np.asarray(a) + np.float32(shift.get(name, 0.0))

    v = jax.tree_util.tree_map_with_path(leaf, v)
    params = {p[-1].key: np.asarray(a) for p, a in
              jax.tree_util.tree_leaves_with_path(v['params'])}
    if train:
        ref, _ = m.apply(v, x, skip, True, mutable=['batch_stats'])
    else:
        ref = m.apply(v, x, skip, False)
    ref = _nchw(ref)
    outs = {}
    for name, ctx in (('bf16', contextlib.nullcontext()),
                      ('float32 BN', _float32_batchnorm())):
        bn = tblocks.BatchNorm(c, bn_dtype=torch.bfloat16).train(train)
        with torch.no_grad():
            bn.weight.copy_(_t(params['scale']))
            bn.bias.copy_(_t(params['bias']))
            bn.running_mean.copy_(_t(stats['mean']))
            bn.running_var.copy_(_t(stats['var']))
            with ctx:
                outs[name] = _port_tail(kind, bn, _t(_nchw(x)),
                                        _t(_nchw(skip))).numpy()
    assert _is_bf16(ref) and _is_bf16(outs['bf16'])
    d = np.abs(outs['bf16'] - ref)
    bound = TAIL_ULPS * _ulp(ref) + TAIL_ATOL * np.abs(ref).max()
    assert (d <= bound).all(), float((d / bound).max())
    # the port before it followed the policy: float32 values, not JAX's
    assert not _is_bf16(outs['float32 BN'])


# ---- the whole generator --------------------------------------------------

def gen_cfg(bn_dtype, fused=False):
    cfg = cfg_from_file(CFG)
    cfg.TPU_FUSED_BN_GLU = fused
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = bn_dtype
    cfg.TPU_CAPSULE_PALLAS = False
    return cfg


def _jax_runs(cfg, variables, inputs):
    """JAX's eval forward (class prior) and train forward (class one-hot)
    under ``cfg``'s policy: hidden codes, images, and the intermediates
    (the draws; in train mode also the updated BatchNorm statistics)."""
    noise, sen, cls, prior = inputs

    def draws(module, method):  # the conditioning nets' outputs
        return method == '__call__' and module.name in ('ca_net1', 'vc_net2')

    with _jax_globals():
        jG = jgen.build_generator(cfg, train_flag=False)

        def run(variables):
            key = jax.random.PRNGKey(4)
            ev, ei = jG.apply(variables, noise, sen, None, cls_prior=prior,
                              train=False, rngs={'reparam': key},
                              capture_intermediates=draws,
                              mutable=['intermediates'])
            tr, tu = jG.apply(variables, noise, sen, cls, train=True,
                              rngs={'reparam': key, 'cls_prior': key},
                              capture_intermediates=draws,
                              mutable=['intermediates', 'batch_stats'])
            return ((ev[0], jG.apply(variables, ev[0], method='image'), ei),
                    (tr[0], jG.apply(variables, tr[0], method='image'), tu))

        compiled = jax.jit(run).lower(variables).compile(
            compiler_options=NO_EXCESS_PRECISION)
        return dict(zip(('eval', 'train'), compiled(variables)))


def _port_generator(cfg, variables):
    G = tgen.build_generator(cfg, train_flag=False)
    G.load_state_dict(jax_generator_to_state_dict(variables), strict=True)
    return G


@pytest.fixture(scope='module')
def generators():
    """Perturbed weights and statistics (fresh 0/1 statistics would hide a
    wrong eval BatchNorm), inputs, JAX's runs unfused and fused, each under
    the bfloat16 policy and under float32 (the yardstick), and the port's
    generators built under the bfloat16 policy, unfused and fused."""
    cfg = gen_cfg('bfloat16')
    rng = np.random.default_rng(0)
    inputs = (rng.standard_normal((B, cfg.GAN.Z_DIM), dtype=np.float32),
              rng.standard_normal((B, cfg.TEXT.DIMENSION), dtype=np.float32),
              np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[3, 7, 11, 19]],
              rng.standard_normal((B, cfg.GAN.MANIFD_DIM), dtype=np.float32))
    with _jax_globals():
        jG = jgen.build_generator(cfg, train_flag=False)
        keys = dict(zip(('params', 'reparam', 'cls_prior'),
                        jax.random.split(jax.random.PRNGKey(0), 3)))
        init = jax.jit(functools.partial(jG.init, train=True,
                                         method='init_all'))
        variables = _perturbed(init(keys, *inputs[:3]), 1)
    runs, ports = {}, {}
    for fused in (False, True):
        for p in ('bfloat16', 'float32'):
            runs[p, fused] = _jax_runs(gen_cfg(p, fused), variables, inputs)
        ports[fused] = _port_generator(gen_cfg('bfloat16', fused), variables)
    return variables, ports, inputs, runs


def _vc_eps(inter):
    c, mu, _, std = inter['intermediates']['vc_net2']['__call__'][0]
    return (np.asarray(c) - np.asarray(mu)) / np.asarray(std)


def _port_forward(tG, mode, inputs, inter):
    """The port's hidden codes, images and module after a forward in
    ``mode`` with JAX's draws, its unfused GLUs on XLA:CPU's logistic."""
    noise, sen, cls, prior = inputs
    G = copy.deepcopy(tG)
    with torch.no_grad(), _xla_cpu_logistic():
        if mode == 'eval':
            h = G.eval()(_t(noise), _t(sen), None, cls_prior=_t(prior),
                         eps=_t(_ca_eps(inter)))[0]
        else:
            h = G.train()(_t(noise), _t(sen), _t(cls),
                          eps=_t(_ca_eps(inter)),
                          eps_cls=_t(_vc_eps(inter)))[0]
        return [x.float().numpy() for x in h], \
            [x.numpy() for x in G.image(h)], G


def _outputs(run):
    """JAX's hidden codes and images of one run, NCHW."""
    codes, imgs, _ = run
    return [_nchw(x) for x in list(codes) + list(imgs)]


def _shares(got, runs, mode, fused=False):
    """Per output (two hidden codes, two images): the port's mean |d| from
    JAX's bfloat16-policy run as a share of the float32 policy's."""
    want = _outputs(runs['bfloat16', fused][mode])
    yard = _outputs(runs['float32', fused][mode])
    assert len(got) == len(want) == 4
    out = []
    for g, w, y in zip(got, want, yard):
        assert g.shape == w.shape
        y = np.abs(y - w).mean()
        assert y > 0
        out.append(float(np.abs(g - w).mean() / y))
    return out


def _generator_check(tG, mode, inputs, runs, fused=False):
    """(the shares, whether they hold the mode's bar and the hidden codes
    are bfloat16 values where JAX's are, the port's module after the
    forward). The fused tails' GLU multiplies by a float32 logistic on
    both sides: float32 codes."""
    run = runs['bfloat16', fused][mode]
    codes, imgs, G = _port_forward(tG, mode, inputs, run[2])
    shares = _shares(codes + imgs, runs, mode, fused)
    ok = max(shares) <= YARDSTICK[mode] and all(
        _is_bf16(c) == _is_bf16(_nchw(w)) for c, w in zip(codes, run[0]))
    return shares, ok, G


def _yardstick_ok(got, want, yard, share, rtol):
    """||got - want|| <= share ||yard - want|| + rtol ||want||."""
    d = float(torch.linalg.vector_norm(got - want))
    y = float(torch.linalg.vector_norm(yard - want))
    return d <= share * y + rtol * float(torch.linalg.vector_norm(want))


@pytest.mark.parametrize('fused', [False, True], ids=['unfused', 'fused'])
@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_generator_forward_matches_jax_with_bf16_batchnorm(mode, fused,
                                                           generators):
    variables, ports, inputs, runs = generators
    shares, ok, G = _generator_check(ports[fused], mode, inputs, runs,
                                     fused)
    print('shares of the yardstick (codes, images):', shares)
    assert ok, shares
    for c in runs['bfloat16', fused][mode][0]:
        assert _is_bf16(_nchw(c)) != fused
    if mode == 'train':  # the running statistics after the train forward
        sd = G.state_dict()
        new, yard = (jax_generator_to_state_dict(
            {'params': variables['params'],
             'batch_stats': runs[p, fused][mode][2]['batch_stats']})
            for p in ('bfloat16', 'float32'))
        keys = [k for k in new if '.running_' in k]
        assert keys
        for k in keys:
            assert _yardstick_ok(sd[k], new[k], yard[k], YARDSTICK[mode],
                                 STEP_RTOL), k


def test_float32_batchnorm_is_not_the_bf16_policy(generators):
    """The port before it followed the policy: its hidden codes are
    float32 values where JAX's are bfloat16 ones, and its outputs differ
    from JAX's by the whole yardstick, over the bar in both modes."""
    _, ports, inputs, runs = generators
    for mode in ('eval', 'train'):
        with _float32_batchnorm():
            codes, imgs, _ = _port_forward(ports[False], mode, inputs,
                                           runs['bfloat16', False][mode][2])
        assert not any(_is_bf16(c) for c in codes)
        assert min(_shares(codes + imgs, runs, mode)) > YARDSTICK[mode]


# which of the port's BatchNorms (in module order) keep the policy
PARTIAL = {
    'last only': lambda i, n, k: i == k - 1,
    'all but the last': lambda i, n, k: i < k - 1,
    'stage 1 only': lambda i, n, k: not n.startswith('h_net2'),
    'stage 2 only': lambda i, n, k: n.startswith('h_net2'),
}


@pytest.mark.parametrize('partial', list(PARTIAL))
@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_partial_policy_fails_the_generator_check(mode, partial, generators):
    """A port that rounds only some of its BatchNorm outputs fails the
    check that the port passes: the bar, or bfloat16 hidden codes."""
    _, ports, inputs, runs = generators
    G = copy.deepcopy(ports[False])
    bns = [(n, m) for n, m in G.named_modules()
           if isinstance(m, tblocks.BatchNorm)]
    kept = [PARTIAL[partial](i, n, len(bns)) for i, (n, _) in enumerate(bns)]
    assert any(kept) and not all(kept)
    for keep, (_, m) in zip(kept, bns):
        if not keep:
            m.bn_dtype = torch.float32
    shares, ok, _ = _generator_check(G, mode, inputs, runs)
    assert not ok, shares


@pytest.mark.parametrize('mode', ['eval', 'train'])
def test_fused_gap_is_the_jax_packages(mode, generators):
    """The fused tails round their affine in bfloat16, the unfused
    BatchNorm its float32 result once: the port's fused generator differs
    from its unfused one as JAX's do. In train mode the JAX package's own
    gap passes 0.1 at a pixel of this run's images (chip_smoke.py phase
    12's max bar, which the flagship's fused sampler breaks at bfloat16
    BatchNorm)."""
    _, ports, inputs, runs = generators
    got = {f: sum(_port_forward(ports[f], mode, inputs,
                                runs['bfloat16', f][mode][2])[:2], [])
           for f in (False, True)}
    want = {f: _outputs(runs['bfloat16', f][mode]) for f in (False, True)}
    worst = 0.0
    for g0, g1, w0, w1 in zip(got[False], got[True], want[False],
                              want[True]):
        gap, jgap = np.abs(g1 - g0), np.abs(w1 - w0)
        print('gap mean %.3e max %.3e, JAX mean %.3e max %.3e'
              % (gap.mean(), gap.max(), jgap.mean(), jgap.max()))
        assert jgap.mean() > 0
        assert abs(gap.mean() / jgap.mean() - 1) <= FUSED_GAP_MEAN, \
            (gap.mean(), jgap.mean())
        assert gap.max() <= FUSED_GAP_MAX * jgap.max(), \
            (gap.max(), jgap.max())
        worst = max(worst, float(jgap.max()))
    if mode == 'train':  # over chip_smoke.py phase 12's max bar of 0.1
        assert worst > 0.1, worst


# ---- one training step ----------------------------------------------------

@pytest.fixture(scope='module')
def steps():
    """One step of JAX and of the port under the bfloat16 policy (the
    port's unfused GLUs on XLA:CPU's logistic), and the port's step under
    float32 (the yardstick), from the same weights and draws."""
    cfg = step_cfg()
    cfg.TPU_BN_DTYPE = 'bfloat16'
    f32 = step_cfg()
    f32.TPU_BN_DTYPE = 'float32'
    with _jax_globals(), _xla_cpu_logistic():
        out = run_steps(cfg, 1, port_cfgs=[f32],
                        compiler_options=NO_EXCESS_PRECISION)
    return out['jax'][0], out['port'][0], out['port_cfgs'][0][0]


def _norm(a):
    return float(torch.linalg.vector_norm(a))


def test_train_step_matches_jax_with_bf16_batchnorm(steps):
    j, t, yard = steps
    for k, v in j['metrics'].items():
        d = abs(t['metrics'][k] - v)
        assert d <= max(_ulp(v), STEP_RTOL * abs(v) + STEP_ATOL), (k, d)
    for want, got, ys in [(j['g_stats'], t['g_stats'], yard['g_stats'])] + \
            list(zip(j['d_stats'], t['d_stats'], yard['d_stats'])):
        assert set(want) == set(got) and want
        for k in want:
            d = float((got[k] - want[k]).abs().max())
            y = float((ys[k] - got[k]).abs().max())
            assert d <= STEP_YARDSTICK * y + \
                _ulp(float(want[k].abs().max())), (k, d, y)
    d = np.abs(t['fakes'] - j['fakes']).mean()
    y = np.abs(yard['fakes'] - t['fakes']).mean()
    assert 0 < y and d <= STEP_YARDSTICK * y, (d, y)
    nets = [(j['g_mu'], t['g_mu'], yard['g_mu'])] + \
        list(zip(j['d_mu'], t['d_mu'], yard['d_mu']))
    for want, got, ys in nets:
        assert set(want) == set(got) and want
        w, g, y = (torch.cat([m[k].flatten() for k in sorted(want)])
                   for m in (want, got, ys))
        assert _norm(g - w) <= STEP_YARDSTICK * _norm(y - g), \
            (_norm(g - w), _norm(y - g))


# ---- float32: the numerics from before the policy -------------------------

def _legacy_batchnorm(self, x):
    xf = x.float()
    if not self.training:
        return F.batch_norm(xf, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)
    mean, var = self.batch_statistics(xf)
    var = torch.clamp(var, min=0.0)
    self.update_running(mean, var)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + self.eps) * self.weight
    return (xf - mean.view(shape)) * scale.view(shape) + \
        self.bias.view(shape)


def _legacy_resblock(self, x):
    return (self.block(x) + x.float()).to(self.dtype)


def _legacy_leaky_relu(self, x):
    return F.leaky_relu(x, 0.2).to(self.dtype)


@contextlib.contextmanager
def _legacy_blocks():
    """The port's BatchNorm, ResBlock and LeakyReLU forwards as they were
    before they followed TPU_BN_DTYPE."""
    patched = ((tblocks.BatchNorm, _legacy_batchnorm),
               (tblocks.ResBlock, _legacy_resblock),
               (tblocks.LeakyReLU, _legacy_leaky_relu))
    saved = [(cls, cls.forward) for cls, _ in patched]
    for cls, fn in patched:
        cls.forward = fn
    try:
        yield
    finally:
        for cls, fn in saved:
            cls.forward = fn


@pytest.mark.parametrize('net', ['G-eval', 'G-train', 'D-train'])
def test_float32_policy_is_bitwise_unchanged(net):
    """TPU_BN_DTYPE float32 gives the port's numerics from before it
    followed the policy, forward and backward, bit for bit."""
    cfg = cfg_from_file(TRAIN_CFG)
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(1)
    if net.startswith('G'):
        model = tgen.build_generator(cfg, train_flag=True)
        args = (torch.randn((B, cfg.GAN.Z_DIM), generator=gen),
                torch.randn((B, cfg.TEXT.DIMENSION), generator=gen),
                torch.eye(cfg.GAN.ENTITY_DIM)[[1, 5, 9, 13]])
        kw = dict(eps=torch.randn((B, cfg.GAN.EMBEDDING_DIM), generator=gen),
                  eps_cls=torch.randn((B, cfg.GAN.MANIFD_DIM), generator=gen))

        def outputs(m):
            h = m(*args, **kw)[0]
            return h + m.image(h)
    else:
        model = tdisc.build_discriminators(cfg, tdisc.cond_code_width(cfg))[-1]
        size = cfg.branch_sizes()[-1]
        args = (torch.randn((B, 3, size, size), generator=gen),
                torch.randn((B, tdisc.cond_code_width(cfg)), generator=gen))

        def outputs(m):
            return m(*args)

    model.train(net.endswith('train'))
    results = []
    for ctx in (contextlib.nullcontext(), _legacy_blocks()):
        m = copy.deepcopy(model)
        with ctx:
            outs = outputs(m)
            grads = torch.autograd.grad(sum(o.float().sum() for o in outs),
                                        list(m.parameters()),
                                        allow_unused=True)
        results.append((outs, [g for g in grads if g is not None],
                        [b.clone() for b in m.buffers()]))
    for now, before in zip(*results):
        assert len(now) == len(before) > 0
        for a, b in zip(now, before):
            assert a.dtype == b.dtype and torch.equal(a, b)
