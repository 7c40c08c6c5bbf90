"""The PyTorch port's joint discriminators and train-mode BatchNorm against
the JAX package, on the CPU.

Small JointDNets (``cfg/birds_2stg_splitz_cap_ca.realcls.yml`` cut to
DF_DIM 8, so the capsule class head routes 16 capsules of length 64;
float32) are initialised in JAX, given non-trivial parameters and
BatchNorm running statistics, and moved into the port with
``jax_joint_d_to_state_dict``. The same numpy inputs then go through both,
in eval mode and in train mode; after a train-mode forward the running
statistics of both must agree.

Tolerances: outputs 1e-4 absolute and relative (float32 on both sides,
but XLA:CPU and oneDNN sum the convolutions in different orders, through
up to seven conv+BN layers); running statistics 1e-6 absolute and
relative (one batch's mean and biased variance folded in with weight
0.1, so a wrong estimator, such as torch's unbiased variance, is off by
orders of magnitude more).
"""

import copy
import functools
import os

import jax
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.config import cfg_from_file
from text2img_ekl_tpu.io_utils.torch_export import flax_joint_d_to_torch
from text2img_ekl_tpu.models import discriminator as jdisc
from text2img_ekl_tpu.models import generator as jgen
from text2img_ekl_tpu_torch.io_utils.weights import (
    jax_generator_to_state_dict, jax_joint_d_to_state_dict,
    load_pth_discriminator)
from text2img_ekl_tpu_torch.models import discriminator as tdisc
from text2img_ekl_tpu_torch.models import generator as tgen
from text2img_ekl_tpu_torch.nn.blocks import frozen_running_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
B = 3


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each of them oversubscribes the CPU (the
    port's files took 3x longer under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg(use_cap=True):
    cfg = cfg_from_file(CFG)
    cfg.GAN.GF_DIM = 8
    cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    cfg.TRAIN.D_CAPSULE = use_cap
    return cfg


def perturbed(variables, seed):
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


def jax_discriminator(cfg, index, seed=0):
    return _jax_discriminator(cfg.TRAIN.D_CAPSULE, index, seed)


@functools.lru_cache(maxsize=None)
def _jax_discriminator(use_cap, index, seed):
    """(module, variables) of small_cfg(use_cap)'s branch ``index``, built
    once per module run (the init compiles)."""
    cfg = small_cfg(use_cap)
    D = jdisc.build_discriminators(cfg, 256)[index]
    size = cfg.branch_sizes()[index]
    init = jax.jit(functools.partial(D.init, train=True))
    variables = init({'params': jax.random.PRNGKey(seed)},
                     np.zeros((2, size, size, 3), np.float32),
                     np.zeros((2, 256), np.float32))
    return D, perturbed(variables, seed + 1)


def port_discriminator(cfg, index, variables):
    D = tdisc.build_discriminators(cfg, 256)[index]
    size = cfg.branch_sizes()[index]
    D.load_state_dict(jax_joint_d_to_state_dict(variables, size),
                      strict=True)
    return D


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _inputs(size, seed):
    rng = np.random.default_rng(seed)
    return (np.tanh(rng.standard_normal((B, size, size, 3),
                                        dtype=np.float32)),
            rng.standard_normal((B, 256), dtype=np.float32))


def assert_buffers(module, jax_stats, to_state_dict):
    """The port module's running statistics equal the JAX batch_stats."""
    want = {k: v for k, v in to_state_dict(jax_stats).items()
            if '.running_' in k}
    got = module.state_dict()
    assert want, 'no statistics'
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k,
                                   **STATS_TOL)


CASES = [(0, True), (1, True), (0, False), (1, False)]  # (branch, capsule)


@pytest.mark.parametrize('index,use_cap', CASES)
def test_state_dict_equals_reference_export(index, use_cap):
    cfg = small_cfg(use_cap)
    _, variables = jax_discriminator(cfg, index)
    size = cfg.branch_sizes()[index]
    ours = jax_joint_d_to_state_dict(variables, size)
    ref = {k: v for k, v in flax_joint_d_to_torch(
        variables, size, module_prefix=False).items()
        if not k.endswith('num_batches_tracked')}
    D = tdisc.build_discriminators(cfg, 256)[index]
    assert set(ours) == set(ref) == set(D.state_dict())
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('index,use_cap', CASES)
def test_joint_d_matches_jax(index, use_cap, train):
    cfg = small_cfg(use_cap)
    jD, variables = jax_discriminator(cfg, index, seed=index)
    tD = port_discriminator(cfg, index, variables).train(train)
    size = cfg.branch_sizes()[index]
    img, cond = _inputs(size, seed=10 + index)
    if train:
        ref, new = jD.apply(variables, img, cond, train=True,
                            mutable=['batch_stats'])
    else:
        ref = jD.apply(variables, img, cond, train=False)
    with torch.no_grad():
        out = tD(_t(_nchw(img)), _t(cond))
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if train:
        assert_buffers(tD, new, functools.partial(
            jax_joint_d_to_state_dict, imsize=size))


def test_frozen_running_stats_leaves_buffers():
    cfg = small_cfg()
    _, variables = jax_discriminator(cfg, 0)
    tD = port_discriminator(cfg, 0, variables).train()
    before = {k: v.clone() for k, v in tD.state_dict().items()}
    img, cond = _inputs(64, seed=3)
    with torch.no_grad():
        with frozen_running_stats(tD):
            frozen = tD(_t(_nchw(img)), _t(cond))
        assert all(torch.equal(v, tD.state_dict()[k])
                   for k, v in before.items())
        live = tD(_t(_nchw(img)), _t(cond))
    for a, b in zip(frozen, live):
        assert torch.equal(a, b)
    assert not torch.equal(before['jointConv.1.running_mean'],
                           tD.state_dict()['jointConv.1.running_mean'])


@pytest.fixture(scope='module')
def generator_pair():
    cfg = small_cfg()
    G = jgen.build_generator(cfg, train_flag=True)
    rng = np.random.default_rng(0)
    keys = dict(zip(('params', 'reparam', 'cls_prior'),
                    jax.random.split(jax.random.PRNGKey(0), 3)))
    init = jax.jit(functools.partial(G.init, train=True, method='init_all'))
    variables = perturbed(init(
        keys, rng.standard_normal((2, cfg.GAN.Z_DIM), dtype=np.float32),
        rng.standard_normal((2, cfg.TEXT.DIMENSION), dtype=np.float32),
        np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[[1, 2]]), 1)
    tG = tgen.build_generator(cfg, train_flag=True)
    tG.load_state_dict(jax_generator_to_state_dict(variables), strict=True)
    return G, variables, tG.train()


# Train-mode forwards of single blocks: (JAX call on the bound module,
# port call, input shape NHWC or [B, C], the JAX module that owns them).
BLOCKS = {
    'batch_norm': ('G', lambda m, x: m.h_net1.bn(
        x, use_running_average=False), lambda g: g.h_net1.fc_cap[3],
        (B, 128 * 32)),
    'res_block': ('G', lambda m, x: m.h_net2.residual[0](x, True),
                  lambda g: g.h_net2.residual[0], (B, 8, 8, 8)),
    'down_block': ('D', lambda m, x: m.tower.downs[0](x, True),
                   lambda d: d.img_code_s32, (B, 8, 8, 64)),
    'squeeze_block': ('D', lambda m, x: m.tower.squeezes[0](x, True),
                      lambda d: d.img_code_s32_1, (B, 4, 4, 128)),
}


@pytest.mark.parametrize('name', sorted(BLOCKS))
def test_train_mode_block_updates_stats_like_flax(name, generator_pair):
    owner, jfn, tsub, shape = BLOCKS[name]
    if owner == 'G':
        jm, variables, tm = generator_pair
        tm = copy.deepcopy(tm)  # the module-scoped G stays fresh

        def to_sd(stats):  # the params tell the bridge the stage's kind
            return jax_generator_to_state_dict(
                {'params': variables['params'], **stats})
    else:
        cfg = small_cfg()
        jm, variables = jax_discriminator(cfg, 1, seed=4)
        tm = port_discriminator(cfg, 1, variables).train()
        to_sd = functools.partial(jax_joint_d_to_state_dict, imsize=128)
    rng = np.random.default_rng(len(name))
    # non-trivial statistics: a shifted, scaled input
    x = 1.5 * rng.standard_normal(shape, dtype=np.float32) + 0.7
    ref, new = jm.apply(variables, x, method=jfn, mutable=['batch_stats'])
    sub = tsub(tm)
    with torch.no_grad():
        out = sub(_t(_nchw(x)) if x.ndim == 4 else _t(x))
    np.testing.assert_allclose(out.numpy(), _nchw(ref) if x.ndim == 4
                               else np.asarray(ref), **TOL)
    assert_buffers(tm, new, to_sd)


def test_pth_discriminator_round_trip(tmp_path):
    """A reference-format netD .pth ('module.' prefixes, num_batches_tracked
    counters) and the port's own torch.save file load strictly."""
    cfg = small_cfg()
    _, variables = jax_discriminator(cfg, 1)
    ref = flax_joint_d_to_torch(variables, 128, module_prefix=True)
    path = tmp_path / 'netD1.pth'
    torch.save({k: torch.tensor(v) for k, v in ref.items()}, path)
    D = tdisc.build_discriminators(cfg, 256)[1]
    D.load_state_dict(load_pth_discriminator(str(path)), strict=True)
    own = tmp_path / 'own.pth'
    torch.save(D.state_dict(), own)
    D2 = tdisc.build_discriminators(cfg, 256)[1]
    D2.load_state_dict(load_pth_discriminator(str(own)), strict=True)
    for k, v in D.state_dict().items():
        assert torch.equal(v, D2.state_dict()[k])


def test_capsule_head_hands_the_kernels_contiguous_rows(monkeypatch):
    """The 16 capsules are a permuted view of the 4x4 map; the kernels
    take contiguous float32 rows only (on the card a strided view
    raises)."""
    from text2img_ekl_tpu_torch.ops import capsule_cuda
    seen = []
    apply = capsule_cuda.CapsuleRoutingFunction.apply

    def spy(x, w, iters):
        seen.append((x.is_contiguous(), x.dtype, tuple(x.shape)))
        return apply(x, w, iters)

    monkeypatch.setattr(capsule_cuda.CapsuleRoutingFunction, 'apply', spy)
    cfg = small_cfg()
    cfg.TPU_COMPUTE_DTYPE = 'bfloat16'
    D = tdisc.build_discriminators(cfg, 256)[1]
    img, cond = _inputs(128, seed=5)
    with torch.no_grad():
        D(_t(_nchw(img)), _t(cond))
    assert seen == [(True, torch.float32, (B, 16, 64))]


def test_unported_discriminators_raise():
    with pytest.raises(NotImplementedError, match='M12'):
        tdisc.DNet()
    with pytest.raises(NotImplementedError, match='M12'):
        tdisc.EntityDNet()
    with pytest.raises(NotImplementedError, match='M12'):
        tdisc.JointDNet(imsize=256)
