"""``nn.blocks.BatchNormAct`` (BatchNorm with its GLU / LeakyReLU / no
epilogue; kernel K5 on the card) on the CPU, where it is the eager chain it
replaced, bit for bit.

  * one module against ``BatchNorm`` -> ``GLU`` / ``LeakyReLU``: outputs,
    the gradients of x, weight and bias, and the running statistics equal,
    in train, eval and frozen mode, under the bfloat16 and float32 policies;
  * G and both joint Ds against copies whose every ``BatchNormAct`` and
    identity is put back to the plain pair: the same ``state_dict`` (keys,
    shapes, values), and the same outputs and gradients;
  * ``frozen_running_stats`` still freezes every BatchNorm, the K3 switch
    still builds its own modules, and the reduction passes' plan tiles the
    step's shapes as the kernel expects.

The kernels themselves run only on the card (``tests/test_torch_port_cuda.py
-k k5``, ``chip_smoke.py`` phase 18).
"""

import copy
import os

import pytest
import torch
from torch import nn

from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.models import discriminator as tdisc
from text2img_ekl_tpu_torch.models import generator as tgen
from text2img_ekl_tpu_torch.nn import blocks as tblocks
from text2img_ekl_tpu_torch.ops import bn_act
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = os.path.join(ROOT, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
POLICIES = {'bf16': (torch.bfloat16, torch.bfloat16),
            'f32': (torch.float32, torch.float32)}
B = 4


def _plain_pair(m: tblocks.BatchNormAct):
    """The modules ``m`` stands for: a ``BatchNorm`` with its parameters and
    buffers, and the activation (None without one)."""
    bn = tblocks.BatchNorm(m.weight.numel(), m.eps, m.bn_dtype)
    bn.load_state_dict(m.state_dict())
    bn.train(m.training)
    bn.update_running_stats = m.update_running_stats
    act = {None: None, 'glu': tblocks.GLU, 'leaky': tblocks.LeakyReLU}[m.act]
    return bn, None if act is None else act(m.dtype)


def _put_back(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with each ``BatchNormAct`` and the identity after
    it replaced by the plain pair, as the blocks were built before K5."""
    model = copy.deepcopy(model)
    for parent in list(model.modules()):
        names = list(parent._modules)
        for i, name in enumerate(names):
            m = parent._modules[name]
            if not isinstance(m, tblocks.BatchNormAct):
                continue
            bn, act = _plain_pair(m)
            parent._modules[name] = bn
            if act is not None:
                assert isinstance(parent._modules[names[i + 1]], nn.Identity)
                parent._modules[names[i + 1]] = act
    assert not any(isinstance(m, tblocks.BatchNormAct)
                   for m in model.modules())
    return model


def _module(act, policy, mode, c=8, seed=0):
    dtype, bn_dtype = POLICIES[policy]
    g = torch.Generator().manual_seed(seed)
    m = tblocks.BatchNormAct(c, act, dtype, bn_dtype)
    with torch.no_grad():
        m.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        m.bias.copy_(0.3 * torch.randn(c, generator=g))
        m.running_mean.copy_(0.3 + 0.3 * torch.randn(c, generator=g))
        m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    m.train(mode != 'eval')
    m.update_running_stats = mode != 'frozen'
    x = (2 * torch.randn((B, c, 5, 6), generator=g) + 0.5).to(dtype)
    return m, x, g


@pytest.mark.parametrize('policy', ['bf16', 'f32'])
@pytest.mark.parametrize('mode', ['train', 'eval', 'frozen'])
@pytest.mark.parametrize('act', ['glu', 'leaky', None],
                         ids=['glu', 'leaky', 'none'])
def test_module_is_the_chain_bit_for_bit(act, mode, policy):
    m, x, g = _module(act, policy, mode)
    bn, act_mod = _plain_pair(m)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    out = m(xs[0])
    ref = bn(xs[1])
    if act_mod is not None:
        ref = act_mod(ref)
    assert out.dtype == ref.dtype == bn_act.out_dtype(x.dtype, act,
                                                      m.bn_dtype)
    assert torch.equal(out, ref)
    dout = torch.randn(out.shape, generator=g).to(out.dtype)
    got = torch.autograd.grad(out, (xs[0], m.weight, m.bias), dout)
    want = torch.autograd.grad(ref, (xs[1], bn.weight, bn.bias), dout)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(m.buffers(), bn.buffers()):
        assert torch.equal(a, b)
    before = _module(act, policy, mode)[0]
    moved = [not torch.equal(a, b) for a, b in zip(m.buffers(),
                                                   before.buffers())]
    assert moved == [mode == 'train'] * 2


def _nets(policy):
    cfg = cfg_from_file(TRAIN_CFG)
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TPU_COMPUTE_DTYPE = cfg.TPU_BN_DTYPE = {'bf16': 'bfloat16',
                                                'f32': 'float32'}[policy]
    torch.manual_seed(0)
    G = tgen.build_generator(cfg, train_flag=True)
    Ds = tdisc.build_discriminators(cfg, tdisc.cond_code_width(cfg))
    return cfg, G, Ds


def _run(cfg, name, model):
    """Outputs and parameter gradients of a train-mode forward of the named
    network on seeded inputs."""
    gen = torch.Generator().manual_seed(1)
    if name == 'G':
        args = (torch.randn((B, cfg.GAN.Z_DIM), generator=gen),
                torch.randn((B, cfg.TEXT.DIMENSION), generator=gen),
                torch.eye(cfg.GAN.ENTITY_DIM)[[1, 5, 9, 13]])
        kw = dict(eps=torch.randn((B, cfg.GAN.EMBEDDING_DIM), generator=gen),
                  eps_cls=torch.randn((B, cfg.GAN.MANIFD_DIM),
                                      generator=gen))
        h = model(*args, **kw)[0]
        outs = h + model.image(h)
    else:
        size = cfg.branch_sizes()[int(name[1])]
        outs = model(torch.randn((B, 3, size, size), generator=gen),
                     torch.randn((B, tdisc.cond_code_width(cfg)),
                                 generator=gen))
    grads = torch.autograd.grad(sum(o.float().sum() for o in outs),
                                list(model.parameters()), allow_unused=True)
    return outs, [g for g in grads if g is not None]


@pytest.mark.parametrize('policy', ['bf16', 'f32'])
@pytest.mark.parametrize('name', ['G', 'D0', 'D1'])
def test_networks_are_the_plain_blocks(name, policy):
    """Every rank-4 BatchNorm tail is a BatchNormAct and an identity; put
    back to the plain pairs, the network has the same state_dict, keys in
    the same order, and gives the same outputs and gradients."""
    cfg, G, Ds = _nets(policy)
    model = G if name == 'G' else Ds[int(name[1])]
    model.train()
    plain = _put_back(model)
    new_sd, old_sd = model.state_dict(), plain.state_dict()
    assert list(new_sd) == list(old_sd)
    for k in new_sd:
        assert torch.equal(new_sd[k], old_sd[k]), k
    fused = [m for m in model.modules() if isinstance(m, tblocks.BatchNormAct)]
    # G: 10 rank-4 tails (8 with a GLU, a residual block's second BN x 2);
    # D0: 4 with a LeakyReLU; D1: 6
    assert len(fused) == {'G': 10, 'D0': 4, 'D1': 6}[name]
    for (o1, g1), (o2, g2) in [(_run(cfg, name, model),
                                _run(cfg, name, plain))]:
        assert len(o1) == len(o2) and len(g1) == len(g2) > 0
        for a, b in zip(list(o1) + g1, list(o2) + g2):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(model.buffers(), plain.buffers()):
        assert torch.equal(a, b)


def test_frozen_running_stats_freezes_every_batchnorm():
    cfg, G, Ds = _nets('bf16')
    for name, model in [('G', G), ('D0', Ds[0]), ('D1', Ds[1])]:
        model.train()
        bns = [m for m in model.modules() if isinstance(m, tblocks.BatchNorm)]
        assert any(isinstance(m, tblocks.BatchNormAct) for m in bns)
        before = [b.clone() for b in model.buffers()]
        with tblocks.frozen_running_stats(model):
            assert not any(m.update_running_stats for m in bns)
            _run(cfg, name, model)
        assert all(m.update_running_stats for m in bns)
        for a, b in zip(model.buffers(), before):
            assert torch.equal(a, b)
        _run(cfg, name, model)
        assert any(not torch.equal(a, b)
                   for a, b in zip(model.buffers(), before))


@pytest.mark.parametrize('fused', [False, True])
def test_k3_switch_keeps_its_modules(fused):
    """TPU_FUSED_BN_GLU builds K3's FusedBatchNormGLU at the G's eight BN ->
    GLU tails, as before; K5's module takes them otherwise, and the rest of
    the rank-4 tails either way."""
    cfg, _, _ = _nets('bf16')
    cfg.TPU_FUSED_BN_GLU = fused
    G = tgen.build_generator(cfg, train_flag=True)
    k3 = sum(isinstance(m, tblocks.FusedBatchNormGLU) for m in G.modules())
    k5 = [m.act for m in G.modules() if isinstance(m, tblocks.BatchNormAct)]
    assert k3 == (8 if fused else 0)
    assert k5.count('glu') == (0 if fused else 8) and k5.count(None) == 2
    assert len(k5) == k5.count('glu') + 2


@pytest.mark.parametrize('n,units,hw', [
    (512, 1024, 64), (512, 512, 256), (512, 256, 1024), (512, 128, 4096),
    (512, 64, 16384), (512, 32, 16384), (512, 512, 16), (512, 1024, 16),
    (512, 128, 256), (3, 12, 35), (5, 20, 36), (1, 3, 1)])
def test_reduce_plan_tiles_the_shapes(n, units, hw):
    vec = 8 if hw % 8 == 0 else 1
    tpc, cb, splits = bn_act.reduce_plan(n, units, hw, vec)
    assert tpc & (tpc - 1) == 0 and tpc * cb == bn_act.THREADS
    assert tpc <= hw // vec or tpc == 1
    assert 1 <= splits <= n
    blocks = -(-units // cb) * splits
    # small maps take several channels a block: a block reads cb * hw
    # contiguous elements of each batch row
    if hw // vec < bn_act.THREADS:
        assert cb > 1
    # big tensors fill the card with several waves of blocks
    if n * units * hw >= bn_act.TARGET_BLOCKS * bn_act.MIN_BLOCK_ELEMENTS:
        assert blocks >= bn_act.TARGET_BLOCKS // 2


def test_cpu_calls_take_the_chain_and_the_wrapper_refuses_them():
    m, x, _ = _module('glu', 'bf16', 'train')
    counters = ('calls', 'launches', 'eager_calls')
    before = [getattr(bn_act.bn_act, k) for k in counters]
    m(x)
    assert [getattr(bn_act.bn_act, k) for k in counters] == before
    with pytest.raises(ValueError):
        bn_act.bn_act(x, m.weight, m.bias, m.running_mean, m.running_var,
                      True, True, m.eps, 'glu', torch.bfloat16)
    with pytest.raises(ValueError):
        tblocks.BatchNormAct(8, 'relu')
