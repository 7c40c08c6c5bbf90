"""The port's kernels on the card (marker ``cuda``).

Run on a machine with an NVIDIA H100:
``pytest --noconftest -m cuda tests/test_torch_port_cuda.py`` (the
suite's conftest imports JAX, which the card's machine does not have).
Each test skips where ``torch.cuda.is_available()`` is false.

K1 (both forms) is held to the plain routing at the JAX Pallas kernel's
own bar (rtol 1e-4, atol 1e-5 at unit-scale outputs, tests/test_capsule.py),
with the atol scaled to the output's largest magnitude: both compute in
float32, the kernels sum in another order (the factored form through the
input length, the votes form through a tiled product). Weights are
unit-variance (scaled by 1/sqrt(in_length / 8), so that votes stay
unit-scale at in_length 512), where the routing is well conditioned; much larger
weights saturate the softmax and float32 itself drifts past 1e-4.

The variants V (``ops/capsule_variants.py``) compute K1's function and
are held to the plain routing at K1's bar, at the two head shapes with a
batch that no swept NB > 1 divides.

K2 is held to autograd through the plain routing at |d| <= 1e-3 |ref| +
1e-4 max|ref| for dx and for dW: the backward sums over more terms (dW
over every sample and input capsule) and the softmax pullback subtracts
nearly equal row sums, so float32 orders differ by more than the forward.
The JAX package's own bar for its fused backward is 2e-2 mean relative
error (tests/test_capsule_pallas_bwd.py). K2-D (the votes form: 3xTF32
tensor-core products, the routing on a cluster of blocks per sample) and
K2-G (the factored form on a cluster of blocks per sample) are also held to
that bar through their plans at every cluster size and every need_dx /
need_dw combination, and two calls must agree bit for bit (no atomics;
cluster reductions and split-K sums in a fixed order). K1-D (3xTF32 vote
product, cluster routing) is held to K1's bar through its plan at every
cluster size.

K3 (fused BN+GLU) is held to ``bn_glu_reference``: float32 at rtol/atol
1e-6 (the same float32 arithmetic, elementwise; only the exponential's and
the fused multiply-add's rounding differ); bfloat16 within one bfloat16
ulp of the reference (both round one float32 value once). K4 (3x3 conv
weight gradient) is held to ``dw3x3_reference`` at |d| <= 1e-3 |ref| + 1e-4
max|ref|: float32 sums over B*H*W up to 524,288 terms in another order;
two calls on the same inputs must agree bit for bit (fixed-order split-K).
Its float32 body (3xTF32 on the tensor cores) must also be float32-faithful:
its max error against the contraction in float64 at most twice that of
the float32 ``dw3x3_reference`` (on the card: cuBLAS, TF32 off); and it is
held within K4_EMULATION_ULPS float32 ulps of max|dW| to
``dw3x3_tf32x3_reference``, the emulation of its arithmetic that the CPU
tests (tests/test_torch_port_k4_f32.py) hold to the JAX package.

K5 (BatchNorm with its GLU / LeakyReLU / no epilogue, ``ops/bn_act.py``)
is held to the eager chain it replaces (``BatchNormAct.composition`` on the
card) at the flagship step's shapes and at ragged ones, bfloat16 and float32
policies, train, eval and frozen, by ``chip_smoke._k5_compare``, the check
``chip_smoke.py`` phase 18 makes at the benchmark's shapes, with the bars
``chip_smoke.K5_*`` (its comment gives their reasons): the BatchNorm
output within one ulp of the BatchNorm dtype on a small share of the
elements, the epilogue the eager one on that output bit for bit, the
running statistics within float32 sum-order tolerance, dx, dweight and dbias
no farther from the chain in float64 than 1.5 times the eager chain's own
distance; and two calls bit-identical.
"""

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke
from text2img_ekl_tpu_torch import spans
from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.ops import bn_act
from text2img_ekl_tpu_torch.ops import bn_glu
from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
from text2img_ekl_tpu_torch.ops import capsule_variants as cv
from text2img_ekl_tpu_torch.ops import conv_dw
from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
from text2img_ekl_tpu_torch.ops.capsule_cuda import capsule_routing
from text2img_ekl_tpu_torch.train.state import create_train_state
from text2img_ekl_tpu_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda

K2_RTOL, K2_ATOL = 1e-3, 1e-4
# K4's float32 body against its emulation (dw3x3_tf32x3_reference), in
# float32 ulps of max|dW|: the tensor cores sum a K-step's products in
# another order and rounding than the emulation's float32 matmul: 4.5-7.0
# ulps apart on an H100 at the flagship's three shapes and the two below
# (tools/bench_conv_dw_torch.py --dtype float32 [--shape], seed 0)
K4_EMULATION_ULPS = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _inputs(shape_x, shape_w, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape_x, dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal(shape_w, dtype=np.float32)
                         / np.float32(np.sqrt(shape_w[-1] / 8)))
    return x.to(device), w.to(device)


def assert_k1_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4,
                               atol=1e-5 * np.abs(ref).max())


def assert_k2_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=K2_RTOL,
                               atol=K2_ATOL * np.abs(ref).max())


@pytest.mark.parametrize('shape', [
    (320, 48, 8, 1024, 32),   # flagship G head, 32 images x 10 captions
    (3, 13, 8, 1000, 32),     # ragged: odd capsule counts
    (2, 16, 8, 512, 16),      # out_length 16 (the EXCHANGE branches)
    (1, 48, 8, 6000, 32),     # more output capsules than fit 48 KB of smem
    (32, 16, 512, 201, 16),   # flagship D class head (votes form)
    (3, 5, 24, 37, 16),       # votes form, ragged
])
def test_k1_matches_plain_routing(card, shape):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card)
    kernel = (cc.routing_fwd_factored if in_len == 8 else
              cc.routing_fwd_votes)
    before = kernel.launches
    with torch.no_grad():
        out = capsule_routing(x, w, 3)
        ref = capsule_linear(x, w, 3, 'dynamic')
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.shape == (bsz, out_caps, out_len)
    assert_k1_close(out, ref)


@pytest.mark.parametrize('in_len', [8, 64])
def test_k1_iteration_counts(card, in_len):
    x, w = _inputs((4, 16, in_len), (256, 32, in_len), card, seed=1)
    with torch.no_grad():
        for iters in (1, 2, 5):
            assert_k1_close(capsule_routing(x, w, iters),
                            capsule_linear(x, w, iters, 'dynamic'))


def _plain_grads(x, w, dv, iters):
    xd = x.detach().requires_grad_(True)
    wd = w.detach().requires_grad_(True)
    out = capsule_linear(xd, wd, iters, 'dynamic')
    return torch.autograd.grad(out, (xd, wd), dv)


@pytest.mark.parametrize('shape', [
    (32, 48, 8, 1024, 32),    # flagship G head
    (32, 16, 512, 201, 16),   # flagship D class head
    (3, 13, 8, 1000, 32),     # factored, ragged
    (3, 5, 24, 37, 16),       # votes, ragged
])
@pytest.mark.parametrize('iters', [1, 3])
def test_k2_matches_plain_autograd(card, shape, iters):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=2)
    rng = np.random.default_rng(3)
    dv = torch.from_numpy(rng.standard_normal((bsz, out_caps, out_len),
                                              dtype=np.float32)).to(card)
    kernel = (cc.routing_bwd_factored if in_len == 8 else
              cc.routing_bwd_votes)
    before = kernel.launches
    xk = x.clone().requires_grad_(True)
    wk = w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad(capsule_routing(xk, wk, iters), (xk, wk), dv)
    ref_dx, ref_dw = _plain_grads(x, w, dv, iters)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert_k2_close(dx, ref_dx)
    assert_k2_close(dw, ref_dw)
    # no weight gradient when the weight needs none
    dx_only, dw_none = kernel(x, w, dv, iters, True, False)
    assert dw_none is None
    assert_k2_close(dx_only, ref_dx)


# K2-D (votes form) through its plan: the flagship, the ragged votes shape,
# J smaller than every cluster but 1 and 2, I != 16 with an odd in_length
# (the products' 4-byte copies) and out_length 32
K2D_SHAPES = [(32, 16, 512, 201, 16), (3, 5, 24, 37, 16), (4, 16, 64, 3, 16),
              (6, 10, 37, 50, 32)]


def _k2d_inputs(shape, device, seed=2):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len),
                   device, seed=seed)
    dv = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (bsz, out_caps, out_len), dtype=np.float32)).to(device)
    return x, w, dv


def _k2d_plan(shape, cluster=None):
    return cc.votes_bwd_plan(*shape, 3, sms=torch.cuda.get_device_properties(
        0).multi_processor_count, cluster=cluster)


@pytest.mark.parametrize('shape', K2D_SHAPES)
@pytest.mark.parametrize('cluster', [1, 2, 4, 8])
def test_k2d_every_cluster_size_and_need_matches_plain_autograd(card, shape,
                                                                cluster):
    """K2-D forced through the plan at each cluster size, for each
    need_dx / need_dw combination, against autograd through the plain
    routing at K2's bar."""
    x, w, dv = _k2d_inputs(shape, card)
    plan = _k2d_plan(shape, cluster)
    assert plan.cluster == min(cluster, shape[3])
    ref_dx, ref_dw = _plain_grads(x, w, dv, 3)
    for need_dx, need_dw in ((True, True), (True, False), (False, True),
                             (False, False)):
        before = cc.routing_bwd_votes.launches
        dx, dw = cc.routing_bwd_votes(x, w, dv, 3, need_dx, need_dw,
                                      plan=plan)
        torch.cuda.synchronize()
        assert cc.routing_bwd_votes.launches == before + (need_dx or need_dw)
        assert (dx is None) != need_dx and (dw is None) != need_dw
        if need_dx:
            assert_k2_close(dx, ref_dx)
        if need_dw:
            assert_k2_close(dw, ref_dw)


def test_k2d_default_plan_at_the_flagship(card):
    """The wrapper's own plan at the flagship: clusters of 4 on an H100's
    132 SMs (128 blocks), the plan's shared memory as the library counts
    it, and the result within K2's bar."""
    shape = K2D_SHAPES[0]
    plan = _k2d_plan(shape)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert (plan.cluster, plan.blocks) == (4, 128)
    x, w, dv = _k2d_inputs(shape, card, seed=5)
    dx, dw = cc.routing_bwd_votes(x, w, dv, 3)
    ref_dx, ref_dw = _plain_grads(x, w, dv, 3)
    assert_k2_close(dx, ref_dx)
    assert_k2_close(dw, ref_dw)
    smem = cc._kernels()['bwd_votes_smem']
    for s in K2D_SHAPES:
        for c in (1, 2, 4, 8):
            p = _k2d_plan(s, c)
            assert smem(s[1], s[3], s[4], 3, p.cluster,
                        int(p.votes_in_smem)) == p.smem_bytes


def test_k2d_is_deterministic(card):
    """No atomics; the cluster reductions combine in rank order and dx's
    split-K partials sum in split order: two calls give the same bits."""
    x, w, dv = _k2d_inputs(K2D_SHAPES[0], card, seed=7)
    first = cc.routing_bwd_votes(x, w, dv, 3)
    second = cc.routing_bwd_votes(x, w, dv, 3)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_k2d_refused_launch_raises(card):
    """A launch that the library or the card refuses raises and counts no
    launch; nothing falls back: a cluster of 16 (beyond the portable 8),
    and the votes kept in shared memory at a cluster of 1, 425 KB a
    block."""
    shape = K2D_SHAPES[0]
    x, w, dv = _k2d_inputs(shape, card)
    before = cc.routing_bwd_votes.launches
    plan = _k2d_plan(shape)
    with pytest.raises(RuntimeError, match='failed to launch'):
        cc.routing_bwd_votes(x, w, dv, 3, plan=plan._replace(cluster=16))
    one = _k2d_plan(shape, 1)
    with pytest.raises(RuntimeError, match='failed to launch'):
        cc.routing_bwd_votes(x, w, dv, 3, plan=one._replace(
            votes_in_smem=True))
    assert cc.routing_bwd_votes.launches == before


# K2-G (factored form) through its plan: the flagship G head, ragged
# capsule counts, out_length 16, J smaller than most clusters, and an odd
# input-capsule count
K2G_SHAPES = [(32, 48, 8, 1024, 32), (3, 13, 8, 1000, 32), (2, 16, 8, 512, 16),
              (4, 48, 8, 3, 32), (5, 7, 8, 129, 16)]


def _k2g_plan(shape, cluster=None):
    bsz, in_caps, _, out_caps, out_len = shape
    return cc.factored_bwd_plan(
        bsz, in_caps, out_caps, 3,
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        cluster=cluster, max_clusters=cc.card_clusters(
            torch.device('cuda', 0), in_caps, out_caps, out_len, 3))


@pytest.mark.parametrize('shape', K2G_SHAPES)
@pytest.mark.parametrize('cluster', [1, 2, 3, 4, 8])
def test_k2g_every_cluster_size_and_need_matches_plain_autograd(card, shape,
                                                                cluster):
    """K2-G forced through the plan at each cluster size (at 1 and 2 the
    stashes, couplings and logit gradient of the flagship live in the
    scratch), for each need_dx / need_dw combination, against autograd
    through the plain routing at K2's bar."""
    x, w, dv = _k2d_inputs(shape, card, seed=4)
    plan = _k2g_plan(shape, cluster)
    assert plan.cluster == min(cluster, shape[3])
    ref_dx, ref_dw = _plain_grads(x, w, dv, 3)
    for need_dx, need_dw in ((True, True), (True, False), (False, True),
                             (False, False)):
        before = cc.routing_bwd_factored.launches
        dx, dw = cc.routing_bwd_factored(x, w, dv, 3, need_dx, need_dw,
                                         plan=plan)
        torch.cuda.synchronize()
        assert cc.routing_bwd_factored.launches == before + (need_dx or
                                                             need_dw)
        assert (dx is None) != need_dx and (dw is None) != need_dw
        if need_dx:
            assert_k2_close(dx, ref_dx)
        if need_dw:
            assert_k2_close(dw, ref_dw)


def test_k2g_default_plan_at_the_flagship(card):
    """The wrapper's own plan at the flagship G head: the largest cluster
    whose 32 clusters the card holds at once (3 or 4 on an H100's 132 SMs),
    everything in shared memory; the plan's shared memory and scratch as the
    library counts them."""
    shape = K2G_SHAPES[0]
    plan = _k2g_plan(shape)
    held = cc.card_clusters(torch.device('cuda', 0), 48, 1024, 32, 3)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert plan.cluster in (3, 4) and plan.in_smem
        assert held(plan.cluster, True) >= 32
        assert plan.cluster == 4 or 0 < held(4, True) < 32
    x, w, dv = _k2d_inputs(shape, card, seed=6)
    dx, dw = cc.routing_bwd_factored(x, w, dv, 3)
    ref_dx, ref_dw = _plain_grads(x, w, dv, 3)
    assert_k2_close(dx, ref_dx)
    assert_k2_close(dw, ref_dw)
    lib = cc._kernels()
    for s in K2G_SHAPES:
        for c in cc.FACTORED_CLUSTER_SIZES:
            p = _k2g_plan(s, c)
            assert lib['bwd_smem'](s[1], s[3], 3, p.cluster,
                                   int(p.in_smem)) == p.smem_bytes
            big = lib['bwd_scratch'](s[1], s[3], 3, p.cluster)
            assert big == cc._factored_floats(s[1], s[3], 3, p.cluster)[1]


def test_k2g_is_deterministic(card):
    """No atomics; the cluster reductions and dx's sum over the slices
    combine in rank order: two calls give the same bits."""
    x, w, dv = _k2d_inputs(K2G_SHAPES[0], card, seed=8)
    first = cc.routing_bwd_factored(x, w, dv, 3)
    second = cc.routing_bwd_factored(x, w, dv, 3)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_k2g_refused_launch_raises(card):
    """A launch that the library or the card refuses raises and counts no
    launch; nothing falls back: a cluster of 16, and everything kept in
    shared memory at a cluster of 1 (over 400 KB a block)."""
    shape = K2G_SHAPES[0]
    x, w, dv = _k2d_inputs(shape, card)
    before = cc.routing_bwd_factored.launches
    plan = _k2g_plan(shape)
    with pytest.raises(RuntimeError, match='failed to launch'):
        cc.routing_bwd_factored(x, w, dv, 3, plan=plan._replace(cluster=16))
    one = _k2g_plan(shape, 1)
    with pytest.raises(RuntimeError, match='failed to launch'):
        cc.routing_bwd_factored(x, w, dv, 3, plan=one._replace(in_smem=True))
    assert cc.routing_bwd_factored.launches == before


# K1-G (factored form) through its plan: the flagship G head at the
# training batch and at the sampler's, ragged capsule counts, out_length 16,
# J smaller than most clusters
K1G_SHAPES = [(32, 48, 8, 1024, 32), (320, 48, 8, 1024, 32),
              (3, 13, 8, 1000, 32), (2, 16, 8, 512, 16), (4, 48, 8, 3, 32)]


def _k1g_plan(shape, cluster=None):
    bsz, in_caps, _, out_caps, out_len = shape
    return cc.factored_fwd_plan(
        bsz, in_caps, out_caps, 3,
        sms=torch.cuda.get_device_properties(0).multi_processor_count,
        cluster=cluster, max_clusters=cc.fwd_card_clusters(
            torch.device('cuda', 0), in_caps, out_caps, out_len))


@pytest.mark.parametrize('shape', K1G_SHAPES)
@pytest.mark.parametrize('cluster', [1, 2, 3, 4, 8])
def test_k1g_every_plan_matches_plain_routing(card, shape, cluster):
    """K1-G forced through the plan at each cluster size (at a cluster of
    1 the flagship's couplings live in the scratch) against the plain
    routing at K1's bar, at 3 passes and at 1."""
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=12)
    plan = _k1g_plan(shape, cluster)
    assert plan.cluster == min(cluster, out_caps)
    for iters in (3, 1):
        before = cc.routing_fwd_factored.launches
        with torch.no_grad():
            out = cc.routing_fwd_factored(x, w, iters, plan=plan)
            ref = capsule_linear(x, w, iters, 'dynamic')
        torch.cuda.synchronize()
        assert cc.routing_fwd_factored.launches == before + 1
        assert_k1_close(out, ref)


def test_k1g_default_plan_at_the_flagship(card):
    """The wrapper's own plan: at the training batch the largest cluster
    whose 32 clusters the card holds at once (3 or 4 on an H100's 132 SMs);
    at the sampler's batch, which no cluster holds in one wave,
    FACTORED_FWD_MULTI_WAVE; the couplings in shared memory; the
    plan's shared memory and scratch as the library counts them."""
    held = cc.fwd_card_clusters(torch.device('cuda', 0), 48, 1024, 32)
    train, sampler = _k1g_plan(K1G_SHAPES[0]), _k1g_plan(K1G_SHAPES[1])
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert train.cluster in (3, 4)
        assert train.in_smem and held(train.cluster, True) >= 32
        assert train.cluster == 4 or 0 < held(4, True) < 32
        assert sampler.cluster == cc.FACTORED_FWD_MULTI_WAVE
    lib = cc._kernels()
    for s in K1G_SHAPES:
        for c in cc.FACTORED_CLUSTER_SIZES:
            p = _k1g_plan(s, c)
            assert lib['fwd_smem'](s[1], s[3], p.cluster,
                                   int(p.in_smem)) == p.smem_bytes
            big = lib['fwd_scratch'](s[1], s[3], p.cluster)
            assert big == cc._factored_fwd_floats(s[1], s[3], p.cluster)[1]
    x, w = _inputs((320, 48, 8), (1024, 32, 8), card, seed=13)
    with torch.no_grad():
        assert_k1_close(capsule_routing(x, w, 3),
                        capsule_linear(x, w, 3, 'dynamic'))


@pytest.mark.parametrize('bsz', [32, 320])
def test_k1g_is_deterministic(card, bsz):
    """The softmax statistics combine in rank order: two calls give the
    same bits."""
    x, w = _inputs((bsz, 48, 8), (1024, 32, 8), card, seed=14)
    with torch.no_grad():
        first = capsule_routing(x, w, 3)
        second = capsule_routing(x, w, 3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k1g_refused_launch_raises(card):
    """A launch that the library or the card refuses raises and counts no
    launch; nothing falls back: a cluster of 16, and the couplings kept in
    shared memory at a cluster of 1 (238 KB a block)."""
    shape = K1G_SHAPES[0]
    x, w = _inputs((32, 48, 8), (1024, 32, 8), card)
    before = cc.routing_fwd_factored.launches
    plan = _k1g_plan(shape)
    with torch.no_grad():
        for bad in (plan._replace(cluster=16, blocks=32 * 16),
                    _k1g_plan(shape, 1)._replace(in_smem=True)):
            with pytest.raises(RuntimeError, match='failed to launch'):
                cc.routing_fwd_factored(x, w, 3, plan=bad)
    assert cc.routing_fwd_factored.launches == before


def _k1d_plan(shape, cluster=None):
    return cc.votes_fwd_plan(*shape, sms=torch.cuda.get_device_properties(
        0).multi_processor_count, cluster=cluster)


@pytest.mark.parametrize('shape', K2D_SHAPES)
@pytest.mark.parametrize('cluster', [1, 2, 4, 8])
@pytest.mark.parametrize('iters', [1, 3])
def test_k1d_every_cluster_size_matches_plain_routing(card, shape, cluster,
                                                      iters):
    """K1-D (3xTF32 vote product, routing on a cluster) forced through the
    plan at each cluster size (at 1 the flagship's votes stay in L2)
    against the plain routing at K1's bar."""
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=9)
    plan = _k1d_plan(shape, cluster)
    assert plan.cluster == min(cluster, out_caps)
    before = cc.routing_fwd_votes.launches
    with torch.no_grad():
        out = cc.routing_fwd_votes(x, w, iters, plan=plan)
        ref = capsule_linear(x, w, iters, 'dynamic')
    torch.cuda.synchronize()
    assert cc.routing_fwd_votes.launches == before + 1
    assert_k1_close(out, ref)


def test_k1d_default_plan_at_the_flagship(card):
    """The wrapper's own plan at the flagship D head: clusters of 4 (128
    blocks) with the vote slices in shared memory; its shared memory as the
    library counts it."""
    shape = K2D_SHAPES[0]
    plan = _k1d_plan(shape)
    if torch.cuda.get_device_properties(0).multi_processor_count == 132:
        assert (plan.cluster, plan.blocks, plan.votes_in_smem) == (4, 128,
                                                                   True)
    smem = cc._kernels()['fwd_votes_smem']
    for s in K2D_SHAPES:
        for c in (1, 2, 4, 8):
            p = _k1d_plan(s, c)
            assert smem(s[1], s[3], s[4], p.cluster,
                        int(p.votes_in_smem)) == p.smem_bytes


def test_k1d_is_deterministic(card):
    bsz, in_caps, in_len, out_caps, out_len = K2D_SHAPES[0]
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=10)
    with torch.no_grad():
        first = capsule_routing(x, w, 3)
        second = capsule_routing(x, w, 3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k1d_refused_launch_raises(card):
    """A cluster of 16, and the votes kept in shared memory at a cluster of
    1 (245 KB a block): the launch raises and counts nothing."""
    shape = K2D_SHAPES[0]
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card)
    before = cc.routing_fwd_votes.launches
    with torch.no_grad():
        with pytest.raises(RuntimeError, match='failed to launch'):
            cc.routing_fwd_votes(x, w, 3, plan=_k1d_plan(shape)._replace(
                cluster=16))
        with pytest.raises(RuntimeError, match='failed to launch'):
            cc.routing_fwd_votes(x, w, 3, plan=_k1d_plan(shape, 1)._replace(
                votes_in_smem=True))
    assert cc.routing_fwd_votes.launches == before


def test_kernels_raise_on_what_they_do_not_take(card):
    x, w = _inputs((2, 6, 8), (10, 32, 8), card)
    with torch.no_grad():
        with pytest.raises(TypeError):
            capsule_routing(x.double(), w.double())
        with pytest.raises(ValueError):  # out_length 8
            capsule_routing(x, w[:, :8].contiguous())
        with pytest.raises(ValueError):  # in_length mismatch
            capsule_routing(x[..., :4].contiguous(), w)
        with pytest.raises(ValueError):  # not contiguous
            capsule_routing(x.transpose(0, 1), w)
        with pytest.raises(ValueError):  # x on the card, weight on the CPU
            capsule_routing(x, w.cpu())
        with pytest.raises(ValueError):  # factored form: > 512 in capsules
            capsule_routing(torch.zeros((1, 600, 8), device=card), w)


# the NB values tools/bench_capsule_torch.py sweeps (its SWEEP)
V_SWEEP = [('forward_stored', 8), ('forward_stored', 1), ('forward_seq', 2),
           ('forward_seq', 4), ('forward_seq', 1), ('forward_recompute', 8),
           ('forward_recompute', 16), ('forward_recompute', 32),
           ('forward_recompute', 1)]


@pytest.mark.parametrize('shape', [
    (35, 48, 8, 1024, 32),    # generator head, ragged for every NB > 1
    (35, 16, 512, 201, 16),   # discriminator class head, ragged
])
@pytest.mark.parametrize('name,nb', V_SWEEP)
def test_variants_match_plain_routing(card, shape, name, nb):
    bsz, in_caps, in_len, out_caps, out_len = shape
    x, w = _inputs((bsz, in_caps, in_len), (out_caps, out_len, in_len), card,
                   seed=4)
    fn = getattr(cv, name)
    before = fn.launches
    with torch.no_grad():
        out = fn(x, w, 3, nb=nb)
        ref = capsule_linear(x, w, 3, 'dynamic')
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.shape == (bsz, out_caps, out_len)
    assert_k1_close(out, ref)


@pytest.mark.parametrize('in_len', [8, 64])
def test_variants_iteration_counts(card, in_len):
    x, w = _inputs((5, 16, in_len), (256, 32, in_len), card, seed=5)
    with torch.no_grad():
        for iters in (1, 2, 5):
            ref = capsule_linear(x, w, iters, 'dynamic')
            for name in ('forward_stored', 'forward_seq',
                         'forward_recompute'):
                assert_k1_close(getattr(cv, name)(x, w, iters, nb=3), ref)


def test_variants_raise_on_what_they_do_not_take(card):
    x, w = _inputs((2, 6, 8), (10, 32, 8), card)
    for name in ('forward_stored', 'forward_seq', 'forward_recompute'):
        fn = getattr(cv, name)
        with pytest.raises(RuntimeError, match='no backward'):
            fn(x.clone().requires_grad_(True), w)
        with torch.no_grad():
            with pytest.raises(ValueError):  # x on the card, W on the CPU
                fn(x, w.cpu())
            with pytest.raises(TypeError):
                fn(x.double(), w.double())
            with pytest.raises(ValueError):  # out_length 8
                fn(x, w[:, :8].contiguous())
            with pytest.raises(ValueError):  # not contiguous
                fn(x.transpose(0, 1), w)
            with pytest.raises(ValueError):  # nb
                fn(x, w, nb=0)


def _tiny_step_inputs(**switches):
    """The flagship at GF/DF_DIM 8, batch 4, float32, with a seeded host
    batch and draws: (cfg, batch, draws), numpy."""
    cfg = cfg_from_file(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'cfg',
        'birds_2stg_splitz_cap_ca.realcls.yml'))
    for k, v in switches.items():
        setattr(cfg, k, v)
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_BN_DTYPE = 'float32'
    rng = np.random.default_rng(0)
    labels = rng.integers(0, cfg.GAN.ENTITY_DIM, 4)
    host = {
        'real': tuple(rng.integers(0, 256, (4, 3, s, s), dtype=np.uint8)
                      for s in cfg.branch_sizes()),
        'wrong': tuple(rng.integers(0, 256, (4, 3, s, s), dtype=np.uint8)
                       for s in cfg.branch_sizes()),
        'txt': rng.standard_normal((4, cfg.TEXT.DIMENSION),
                                   dtype=np.float32),
        'cls_onehot': np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[labels],
        'real_cp': np.eye(cfg.GAN.ENTITY_DIM + 1, dtype=np.float32)[labels]}
    draws = {'noise': rng.standard_normal((4, cfg.GAN.Z_DIM),
                                          dtype=np.float32),
             'eps': rng.standard_normal((4, cfg.GAN.EMBEDDING_DIM),
                                        dtype=np.float32),
             'eps_cls': rng.standard_normal((4, cfg.GAN.MANIFD_DIM),
                                            dtype=np.float32)}
    return cfg, host, draws


def _on(dev, tree):
    def put(a):
        if isinstance(a, tuple):
            return tuple(torch.from_numpy(x).to(dev) for x in a)
        return torch.from_numpy(a).to(dev)

    return {k: put(v) for k, v in tree.items()}


def _tiny_step_metrics(card, **switches):
    """One training step at GF/DF_DIM 8, batch 4, float32 (TF32 off), on the
    CPU and on the card from the same seeded weights, batch and draws:
    (metrics by device, the card's launches of every kernel)."""
    cfg, host, draws = _tiny_step_inputs(**switches)
    metrics = {}
    for dev in ('cpu', card):
        state = create_train_state(cfg, dev, seed=0)
        cc.reset_launches()
        bn_glu.bn_glu_kernel.launches = conv_dw.dw3x3_kernel.launches = 0
        m, fakes = make_train_step(cfg)(state, _on(dev, host), 0,
                                        _on(dev, draws))
        metrics[str(dev)] = {k: float(v) for k, v in m.items()}
    launches = dict(cc.launches(), K3=bn_glu.bn_glu_kernel.launches,
                    K4=conv_dw.dw3x3_kernel.launches)
    return metrics, launches


def _assert_metrics_close(metrics):
    for k, v in metrics['cpu'].items():
        np.testing.assert_allclose(metrics['cuda'][k], v, rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_tiny_step_on_the_card_matches_the_cpu(card):
    """Every metric within 1e-3 relative (cuDNN and oneDNN sum convolutions
    in other orders), and the kernels, not the plain routing, ran on the
    card."""
    metrics, launches = _tiny_step_metrics(card)
    assert launches == {'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6, 'K3': 0,
                        'K4': 0}
    _assert_metrics_close(metrics)


def test_tiny_fused_step_on_the_card_matches_the_cpu(card):
    """The same with TPU_FUSED_BN_GLU and TPU_PALLAS_DW: K3 at the eight
    BN+GLU tails of G, K4 at the seven G convs inside the envelope."""
    metrics, launches = _tiny_step_metrics(card, TPU_FUSED_BN_GLU=True,
                                           TPU_PALLAS_DW=True)
    assert launches == {'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6, 'K3': 8,
                        'K4': 7}
    _assert_metrics_close(metrics)


def test_spans_on_the_card(card, monkeypatch):
    """A CUDA-only profiler session turns the spans on. The capsule
    backward runs on autograd's device thread, where its span joins the
    backward phase that called ``backward()``; every span has device
    milliseconds, and the phases take all but 5 % of the step's. A second
    step after ``spans.clear()`` makes no new timing event."""
    from torch.profiler import ProfilerActivity, profile
    cfg, host, draws = _tiny_step_inputs()
    state = create_train_state(cfg, card, seed=0)
    step = make_train_step(cfg)
    batch, draws = _on(card, host), _on(card, draws)
    step(state, batch, 0, draws)  # kernels built and loaded
    threads = {}
    enter = spans.Span.__enter__

    def noting(self):
        threads.setdefault(self.name, set()).add(threading.get_ident())
        return enter(self)

    monkeypatch.setattr(spans.Span, '__enter__', noting)
    spans.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        step(state, batch, 1, draws)
        torch.cuda.synchronize()
    (unit,) = spans.units('step')
    spans.clear()
    sp = unit['spans']
    by_id = {s['id']: s for s in sp}
    assert threads['capsule.bwd'].isdisjoint(threads['step'])
    assert {by_id[s['parent']]['name'] for s in sp
            if s['name'] == 'capsule.bwd'} == {'step.d_backward',
                                                'step.g_backward'}
    kernels = {}
    for s in sp:
        if s['name'].startswith('capsule.'):
            kernels[s['attrs']['kernel']] = \
                kernels.get(s['attrs']['kernel'], 0) + 1
    assert kernels == {'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6}
    assert all(s['device_ms'] is not None and s['device_ms'] >= 0
               for s in sp)
    root = sp[0]
    phases = sum(s['device_ms'] for s in sp if s['parent'] == root['id'])
    assert 0.95 * root['device_ms'] <= phases <= root['device_ms']
    # the cleared step's timing events serve the next one
    made = []
    event = torch.cuda.Event

    def making(**kw):
        made.append(kw)
        return event(**kw)

    monkeypatch.setattr(torch.cuda, 'Event', making)
    with profile(activities=[ProfilerActivity.CUDA]):
        step(state, batch, 2, draws)
        torch.cuda.synchronize()
    assert made == [] and len(spans.units('step')) == 1
    spans.clear()


def _bn_glu_inputs(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    c2 = shape[1]

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    y = put(rng.standard_normal(shape)).to(dtype)
    return (y, put(rng.normal(0.0, 0.3, c2)), put(rng.uniform(0.5, 1.5, c2)),
            put(1.0 + rng.normal(0.0, 0.1, c2)), put(rng.normal(0.0, 0.1, c2)))


@pytest.mark.parametrize('shape', [
    (32, 1024, 8, 8),      # flagship stage 1, the first up block
    (32, 128, 64, 64),     # flagship 64 px tails
    (4, 64, 128, 128),     # the stage-2 upsample's tail, cut in batch
    (3, 24, 5, 7),         # ragged H*W: the scalar path
    (5, 16),               # [B, 2C]: one element per plane
])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k3_matches_reference(card, shape, dtype):
    y, mean, var, scale, bias = _bn_glu_inputs(shape, dtype, card)
    before = bn_glu.bn_glu_kernel.launches
    with torch.no_grad():
        out = bn_glu.fused_bn_glu(y, mean, var, scale, bias)
        ref = bn_glu.bn_glu_reference(y, mean, var, scale, bias)
    torch.cuda.synchronize()
    assert bn_glu.bn_glu_kernel.launches == before + 1
    assert out.shape == ref.shape and out.dtype == dtype
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    else:  # one bfloat16 ulp: 2^(exponent - 7)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out - ref) <= ulp).all()


@pytest.mark.parametrize('shape', [(32, 128, 64, 64), (3, 24, 5, 7), (5, 16)])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k3_bfloat16_affine_matches_reference(card, shape, dtype):
    """The affine in bfloat16 (TPU_BN_DTYPE bfloat16): the same rounded
    products and sums as the plain version; the output one ulp of its type
    apart at most (float32: 1e-6)."""
    y, mean, var, scale, bias = _bn_glu_inputs(shape, dtype, card, seed=2)
    before = bn_glu.bn_glu_kernel.launches
    with torch.no_grad():
        out = bn_glu.fused_bn_glu(y, mean, var, scale, bias, torch.bfloat16)
        ref = bn_glu.bn_glu_reference(y, mean, var, scale, bias,
                                      torch.bfloat16)
    torch.cuda.synchronize()
    assert bn_glu.bn_glu_kernel.launches == before + 1
    assert out.dtype == dtype
    out, ref = out.float().cpu().numpy(), ref.float().cpu().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert (np.abs(out - ref) <= ulp).all()


def test_k3_backward_matches_plain_autograd(card):
    inputs = [t.requires_grad_(True) for t in
              _bn_glu_inputs((4, 32, 16, 16), torch.float32, card, seed=1)]
    dz = torch.randn((4, 16, 16, 16), device=card)
    got = torch.autograd.grad(bn_glu.fused_bn_glu(*inputs), inputs, dz)
    want = torch.autograd.grad(bn_glu.bn_glu_reference(*inputs), inputs, dz)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)


def assert_k4_close(out, ref):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize('shape', [
    (32, 64, 64, 128),     # (B, C, H, F): flagship ResBlock conv 1
    (32, 64, 64, 64),      # flagship ResBlock conv 2
    (32, 64, 128, 64),     # flagship stage-2 upsample conv
    (4, 32, 32, 16),       # a 32 px map
    (3, 8, 64, 24),        # C and F below one block tile
    (2, 16, 256, 8),       # 256 px: four slabs per row
])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k4_matches_reference(card, shape, dtype):
    b, c, h, f = shape
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((b, c, h, h), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, f, h, h), dtype=np.float32))
    x, dy = x.to(card).to(dtype), dy.to(card).to(dtype)
    before = conv_dw.dw3x3_kernel.launches
    out = conv_dw.dw3x3(x, dy)
    ref = conv_dw.dw3x3_reference(x, dy)
    torch.cuda.synchronize()
    assert conv_dw.dw3x3_kernel.launches == before + 1
    assert out.shape == (f, c, 3, 3) and out.dtype == torch.float32
    assert_k4_close(out, ref)


def _k4_inputs(shape, dtype, device, seed=3):
    b, c, h, f = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, c, h, h), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, f, h, h), dtype=np.float32))
    return x.to(device).to(dtype), dy.to(device).to(dtype)


@pytest.mark.parametrize('w', [32, 64, 128, 256, 512])
@pytest.mark.parametrize('c', [3, 16, 64])
@pytest.mark.parametrize('bf', [(1, 72), (3, 8), (32, 128), (3, 64)])
def test_k4_bf16_at_ragged_shapes(card, w, c, bf):
    """The bf16 body (TMA + wgmma) inside the envelope: one-slab to
    eight-slab rows (W 32 takes 32-column K-steps), channel counts that
    leave most of a 64-row TMA box out of bounds, F below, at and across
    64-row f tiles."""
    b, f = bf
    b = min(b, {256: 8, 512: 1}.get(w, b))  # keep the large maps small
    x, dy = _k4_inputs((b, c, w, f), torch.bfloat16, card)
    before = conv_dw.dw3x3_kernel.launches
    out = conv_dw.dw3x3(x, dy)
    ref = conv_dw.dw3x3_reference(x, dy)
    torch.cuda.synchronize()
    assert conv_dw.dw3x3_kernel.launches == before + 1
    assert_k4_close(out, ref)


@pytest.mark.parametrize('w', [32, 64, 128, 256, 512])
@pytest.mark.parametrize('c', [3, 16, 64])
@pytest.mark.parametrize('bf', [(1, 72), (3, 8), (32, 128), (3, 64)])
def test_k4_float32_at_ragged_shapes(card, w, c, bf):
    """The float32 body (3xTF32 wgmma on the same TMA ring) inside the
    envelope: one to sixteen 32-column K-steps a row, channel counts that
    leave most of a 32-row x box out of bounds (C 3) or fill one or two c
    tiles, F below, at and across 64-row f tiles."""
    b, f = bf
    b = min(b, {256: 8, 512: 1}.get(w, b))  # keep the large maps small
    x, dy = _k4_inputs((b, c, w, f), torch.float32, card)
    before = conv_dw.dw3x3_kernel.launches
    out = conv_dw.dw3x3(x, dy)
    ref = conv_dw.dw3x3_reference(x, dy)
    torch.cuda.synchronize()
    assert conv_dw.dw3x3_kernel.launches == before + 1
    assert_k4_close(out, ref)


@pytest.mark.parametrize('f', [128, 64])
def test_k4_float32_is_faithful_at_the_flagship(card, f):
    """At the flagship's 64 px shapes (K = 131,072): the 3xTF32 body's max
    error against the float64 contraction is at most twice that of the
    float32 plain version."""
    x, dy = _k4_inputs((32, 64, 64, f), torch.float32, card)
    exact = conv_dw.dw3x3_reference(x, dy, torch.float64)
    err = float((conv_dw.dw3x3(x, dy).double() - exact).abs().max())
    f32 = float((conv_dw.dw3x3_reference(x, dy).double() - exact)
                .abs().max())
    assert err <= 2 * f32, (err, f32)


def _ulps(out, ref):
    """max |out - ref| in float32 ulps of max|ref| (2^(e - 23) for max|ref|
    in [2^e, 2^(e+1)))."""
    scale = float(ref.abs().max())
    return float((out - ref).abs().max()) / 2.0 ** (
        math.floor(math.log2(scale)) - 23)


@pytest.mark.parametrize('shape', [
    (4, 64, 64, 72),     # (B, C, H, F): runs of 16 K-steps, 2 x 2 tiles
    (8, 16, 128, 64),    # runs of 32 K-steps across 4 column slabs a row
])
def test_k4_float32_matches_its_emulation(card, shape):
    """The float32 body against ``dw3x3_tf32x3_reference`` with the card's
    plan: the emulation that the CPU tests hold to JAX's ``dw3x3_v2`` and
    to float64 has the body's split, terms, per-K-step partials and run
    sums, so the two differ only by the order of the sums inside a K-step,
    within K4_EMULATION_ULPS float32 ulps of max|dW|; single TF32 (hi.hi
    alone) lies far outside that.
    The plain float32 contraction also lies a few ulps from the emulation:
    the bar cannot tell orders of summation apart, which the float64 rule
    of test_k4_float32_is_faithful_at_the_flagship judges."""
    b, c, h, f = shape
    x, dy = _k4_inputs(shape, torch.float32, card)
    p = conv_dw.plan(b, c, h, h, f, False,
                     torch.cuda.get_device_properties(card)
                     .multi_processor_count)
    out = conv_dw.dw3x3(x, dy)
    emulated = conv_dw.dw3x3_tf32x3_reference(x, dy, p.chunk)
    single = conv_dw.dw3x3_tf32x3_reference(x, dy, p.chunk, terms=1)
    torch.cuda.synchronize()
    assert _ulps(out, emulated) <= K4_EMULATION_ULPS, _ulps(out, emulated)
    assert _ulps(single, emulated) > 100 * K4_EMULATION_ULPS


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape,sms', [
    ((3, 16, 32, 64), 5),     # runs of 20 rows start inside images 0 and 1
    ((3, 16, 128, 64), 7),    # runs of 110 K-steps cross slabs and images
])
def test_k4_split_boundaries_mid_image(card, shape, sms, dtype):
    """Plans for fewer SMs than the card has put split boundaries inside
    an image (and, at 128 px, across column slabs and images), where a
    run re-loads the x rows above its first row."""
    b, c, h, f = shape
    x, dy = _k4_inputs(shape, dtype, card)
    p = conv_dw.plan(b, c, h, h, f, dtype == torch.bfloat16, sms)
    assert p.chunk % h != 0
    out = conv_dw.run_plan(x, dy, p)
    torch.cuda.synchronize()
    assert_k4_close(out, conv_dw.dw3x3_reference(x, dy))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_k4_is_deterministic(card, dtype):
    """Split-K partials summed in a fixed order, no atomics: two calls on
    the same inputs give the same bits."""
    x, dy = _k4_inputs((32, 64, 64, 128), dtype, card)
    first = conv_dw.dw3x3(x, dy)
    second = conv_dw.dw3x3(x, dy)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k4_refused_launch_raises(card):
    """What the library refuses raises and counts no launch: a bf16 tensor
    whose data is not 16-byte aligned (TMA cannot map it), and a split
    plan that leaves K-steps out."""
    x, dy = _k4_inputs((2, 16, 32, 8), torch.bfloat16, card)
    shifted = torch.empty(x.numel() + 1, device=card, dtype=x.dtype)
    shifted[1:].copy_(x.flatten())
    x_odd = shifted[1:].view(x.shape)
    assert x_odd.is_contiguous() and x_odd.data_ptr() % 16 != 0
    before = conv_dw.dw3x3_kernel.launches
    with pytest.raises(RuntimeError, match='failed to launch'):
        conv_dw.dw3x3(x_odd, dy)
    p = conv_dw.plan(2, 16, 32, 32, 8, True, 4)
    with pytest.raises(RuntimeError, match='failed to launch'):
        conv_dw.run_plan(x, dy, p._replace(splits=p.splits - 1))
    assert conv_dw.dw3x3_kernel.launches == before


def test_k4_float32_refused_launch_raises(card):
    """The float32 body maps x through TMA too: a float32 x whose data is
    not 16-byte aligned raises and counts no launch."""
    x, dy = _k4_inputs((2, 16, 32, 8), torch.float32, card)
    shifted = torch.empty(x.numel() + 1, device=card, dtype=x.dtype)
    shifted[1:].copy_(x.flatten())
    x_odd = shifted[1:].view(x.shape)
    assert x_odd.is_contiguous() and x_odd.data_ptr() % 16 != 0
    before = conv_dw.dw3x3_kernel.launches
    with pytest.raises(RuntimeError, match='failed to launch'):
        conv_dw.dw3x3(x_odd, dy)
    assert conv_dw.dw3x3_kernel.launches == before


def test_conv3x3_dw_backward_matches_plain_autograd(card):
    x = torch.randn((4, 16, 64, 64), device=card, requires_grad=True)
    w = (0.1 * torch.randn((32, 16, 3, 3), device=card)).requires_grad_(True)
    dy = torch.randn((4, 32, 64, 64), device=card)
    got = torch.autograd.grad(conv_dw.conv3x3_dw(x, w), (x, w), dy)
    want = torch.autograd.grad(torch.nn.functional.conv2d(x, w, None, 1, 1),
                               (x, w), dy)
    for g, r in zip(got, want):
        assert_k4_close(g, r)


def test_k3_k4_raise_on_what_they_do_not_take(card):
    y, mean, var, scale, bias = _bn_glu_inputs((2, 8, 4, 4), torch.float32,
                                               card)
    k, b = bn_glu.fold_affine(mean, var, scale, bias)
    with pytest.raises(ValueError):  # y on the card, k and b on the CPU
        bn_glu.bn_glu_kernel(y, k.cpu(), b.cpu())
    with pytest.raises(ValueError):
        bn_glu.fused_bn_glu(y, mean.cpu(), var, scale, bias)
    with pytest.raises(TypeError):
        bn_glu.bn_glu_kernel(y.double(), k, b)
    with pytest.raises(TypeError):
        bn_glu.bn_glu_kernel(y.half(), k, b)
    with pytest.raises(ValueError):  # not contiguous
        bn_glu.bn_glu_kernel(y.transpose(2, 3), k, b)
    with pytest.raises(ValueError):  # odd channel count
        bn_glu.bn_glu_kernel(y[:, :7], k[:7], b[:7])
    x = torch.randn((2, 8, 32, 32), device=card)
    dy = torch.randn((2, 16, 32, 32), device=card)
    with pytest.raises(ValueError):  # x on the card, dy on the CPU
        conv_dw.dw3x3(x, dy.cpu())
    with pytest.raises(TypeError):
        conv_dw.dw3x3(x.double(), dy.double())
    with pytest.raises(TypeError):
        conv_dw.dw3x3(x, dy.bfloat16())
    with pytest.raises(ValueError):  # not contiguous
        conv_dw.dw3x3(x.transpose(2, 3), dy)
    with pytest.raises(ValueError):  # 16 px: outside the envelope
        conv_dw.dw3x3(x[:, :, :16, :16].contiguous(),
                      dy[:, :, :16, :16].contiguous())
    with pytest.raises(ValueError):  # F = 3: outside the envelope
        conv_dw.dw3x3(x, dy[:, :3].contiguous())


# ---- K5: BatchNorm with its epilogue ----------------------------------------

K5_SHAPES = [
    ((512, 128, 64, 64), 'glu'),     # the G's 64 px tails at batch 512
    ((512, 64, 128, 128), 'glu'),    # the stage-2 upsample's tail
    ((512, 512, 4, 4), 'leaky'),     # the Ds' 4x4 maps
    ((512, 64, 64, 64), None),       # a residual block's second BatchNorm
    ((5, 24, 5, 7), 'glu'),          # ragged batch and H*W: single elements
    ((3, 40, 6, 6), 'leaky'),
    ((7, 8, 3, 3), None),
]


@pytest.mark.parametrize('mode', ['train', 'eval', 'frozen'])
@pytest.mark.parametrize('policy', ['bf16', 'f32'])
@pytest.mark.parametrize('shape,act', K5_SHAPES)
def test_k5_matches_the_eager_chain(card, shape, act, policy, mode):
    m, x, dout = chip_smoke._k5_module(shape, act, policy, mode, card)
    chip_smoke._k5_compare(m, x, dout)


@pytest.mark.parametrize('shape,act', [K5_SHAPES[0], K5_SHAPES[2],
                                       K5_SHAPES[4]])
def test_k5_is_deterministic(card, shape, act):
    m, x, dout = chip_smoke._k5_module(shape, act, 'bf16', 'train', card,
                                       seed=3)
    a = chip_smoke._k5_run(m, x, dout, kernel=True)
    b = chip_smoke._k5_run(m, x, dout, kernel=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_k5_raises_on_what_it_does_not_take(card):
    m, x, _ = chip_smoke._k5_module((4, 16, 8, 8), 'glu', 'bf16', 'train',
                                    card)
    args = (m.weight, m.bias, m.running_mean, m.running_var, True, True,
            1e-5, 'glu', torch.bfloat16)
    with pytest.raises(TypeError):
        bn_act.bn_act(x.half(), *args)
    with pytest.raises(TypeError):
        bn_act.bn_act(x.double(), *args)
    with pytest.raises(ValueError):  # channels-last: not contiguous NCHW
        bn_act.bn_act(x.to(memory_format=torch.channels_last), *args)
    with pytest.raises(ValueError):  # rank 3
        bn_act.bn_act(x[0], *args)
    with pytest.raises(ValueError):  # rank 2
        bn_act.bn_act(x[:, :, 0, 0].contiguous(), *args)
    with pytest.raises(ValueError):  # x on the CPU
        bn_act.bn_act(x.cpu(), *args)
    with pytest.raises(ValueError):  # odd channel count under a GLU
        bn_act.bn_act(x[:, :15].contiguous(), *args)
    with pytest.raises(ValueError):  # parameters on the CPU
        bn_act.bn_act(x, m.weight.cpu(), *args[1:])
    with pytest.raises(ValueError):
        bn_act.bn_act(x, *args[:7], 'relu', torch.bfloat16)


def test_k5_takes_every_rank4_batchnorm_of_a_step(card):
    """One training step at GF/DF_DIM 8, batch 4, on the card: K5 runs once
    for each of the 50 rank-4 BatchNorm calls a forward hook counts, each
    with its backward (6 kernels), and no rank-4 BatchNorm takes the eager
    chain (``chip_smoke._k5_calls`` raises otherwise)."""
    cfg, host, draws = _tiny_step_inputs()
    state = create_train_state(cfg, card, seed=0)
    calls, launches = chip_smoke._k5_calls(
        (state.G, *state.Ds),
        lambda: make_train_step(cfg)(state, _on(card, host), 0,
                                     _on(card, draws)))
    assert len(calls) == 50
    assert launches == 6 * len(calls)
