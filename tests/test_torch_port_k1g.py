"""K1-G, the capsule-routing forward at the generator head, on the CPU: its
launch plan, its cluster-split algorithm in plain PyTorch against the JAX
package, and the microbenchmark's refusal to profile without a card.

The kernel (``csrc/capsule_routing.cu``, the passes in
``csrc/capsule_common.cuh::factored_forward``) runs only on the card
(``tests/test_torch_port_cuda.py``). What the CPU can check is what
surrounds it: ``factored_fwd_plan``, the pure-Python plan the wrapper hands
the kernel; and ``factored_fwd_reference``, the kernel's algorithm (the
output capsules split into the plan's slices, each slice's softmax
statistics combined in rank order, the votes never formed), which must
hold K1's bar, |d| <= 1e-4 |ref| + 1e-5 max|ref|, against the JAX
package's Pallas forward (``capsule_pallas._forward``, in interpret mode,
as its variants are run in tests/test_torch_port_capsule_variants.py) and
its plain routing, at every cluster size, with unit-variance weights
(routing neither uniform nor saturated, ROADMAP F14).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_port_k1d_k2g import (FACTORED_SHAPES, G_HEAD, H100_CLUSTERS,
                                     K1_ATOL, K1_RTOL, _bar_use, _bench,
                                     _check_slices, _inputs)
from text2img_ekl_tpu.ops import capsule as jcap
from text2img_ekl_tpu.ops import capsule_pallas as jcp
from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
from torch_port_threads import one_torch_thread  # noqa: F401


# ---- the plan --------------------------------------------------------------

@pytest.mark.parametrize('shape', FACTORED_SHAPES)
@pytest.mark.parametrize('sms', [132, 114, 16])
@pytest.mark.parametrize('cluster', [None, 1, 2, 3, 4, 8])
def test_factored_fwd_plan_invariants(shape, cluster, sms):
    """On an H100 SXM (132 SMs), an H100 PCIe (114) and a card too small
    to hold most batches in one wave (16)."""
    b, i, _, j, _ = shape
    p = cc.factored_fwd_plan(b, i, j, 3, sms=sms, cluster=cluster)
    assert 1 <= p.cluster <= min(8, j)
    assert p.cluster in cc.FACTORED_CLUSTER_SIZES or p.cluster == j
    if cluster is not None:
        assert p.cluster == min(cluster, j)
    elif b * p.cluster > sms:  # no cluster holds the batch in one wave
        assert p.cluster == min(cc.FACTORED_FWD_MULTI_WAVE, j)
    assert p.blocks == b * p.cluster
    _check_slices(p, j)
    assert p.smem_bytes <= cc.MAX_SMEM_BYTES
    assert p.smem_bytes == cc.factored_fwd_smem_bytes(i, j, p.cluster,
                                                      p.in_smem)
    assert p.in_smem == (cc.factored_fwd_smem_bytes(
        i, j, p.cluster, True) <= cc.MAX_SMEM_BYTES)
    small, big = cc._factored_fwd_floats(i, j, p.cluster)
    assert small % 4 == 0 and big % 4 == 0  # float4 rows stay aligned
    assert p.scratch_numel == (0 if p.in_smem else p.blocks * big)
    # the forward keeps no stashes: it needs less than the backward
    assert p.smem_bytes <= cc.factored_bwd_smem_bytes(i, j, 3, p.cluster,
                                                      p.in_smem) or \
        not p.in_smem


def test_factored_fwd_plan_at_the_flagship():
    """The G head at the training batch: clusters of 4 (128 blocks) where
    the card holds all 32 at once, else, on an H100, which holds 30,
    clusters of 3: 96 blocks of 341-342 output capsules, the couplings in
    84 KB of shared memory; at a cluster of 2, 120 KB; at 1 the couplings
    (200 KB) go to the scratch. At the sampler's B = 320 no cluster holds
    the batch in one wave: FACTORED_FWD_MULTI_WAVE."""
    b, i, _, j, _ = G_HEAD
    p = cc.factored_fwd_plan(b, i, j, 3, sms=132)
    assert (p.cluster, p.blocks, p.in_smem) == (4, 128, True)
    h100 = cc.factored_fwd_plan(
        b, i, j, 3, sms=132, max_clusters=lambda c, _: H100_CLUSTERS[c])
    assert (h100.cluster, h100.blocks, h100.in_smem) == (3, 96, True)
    assert h100.slices == ((0, 341), (341, 682), (682, 1024))
    assert h100.smem_bytes == 84096
    assert cc.factored_fwd_plan(b, i, j, 3, cluster=2).smem_bytes == 120256
    one = cc.factored_fwd_plan(b, i, j, 3, cluster=1)
    assert (one.in_smem, one.blocks) == (False, 32)
    assert one.scratch_numel == 32 * 48 * 1040
    # a card that cannot say (0) is taken to hold them all; one that holds
    # too few clusters of every size takes the multi-wave choice
    assert cc.factored_fwd_plan(b, i, j, 3, sms=132,
                                max_clusters=lambda *_: 0).cluster == 4
    c = cc.FACTORED_FWD_MULTI_WAVE
    few = cc.factored_fwd_plan(b, i, j, 3, sms=132,
                               max_clusters=lambda *_: 8)
    assert few.cluster == c
    sampler = cc.factored_fwd_plan(320, i, j, 3, sms=132)
    assert (sampler.cluster, sampler.blocks) == (c, 320 * c)
    assert sampler.in_smem


def test_factored_fwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match='cluster 5'):
        cc.factored_fwd_plan(32, 48, 1024, 3, cluster=5)
    with pytest.raises(ValueError, match='R >= 1'):
        cc.factored_fwd_plan(32, 48, 1024, 0)
    with pytest.raises(ValueError, match='shared memory'):
        cc.factored_fwd_plan(2, 5000, 1024, 3, cluster=1)


# ---- K1-G's algorithm ------------------------------------------------------

@pytest.fixture
def pallas_forward(monkeypatch):
    """The JAX package's Pallas routing forward with its pallas_call in
    interpret mode (its TPU compiler parameters dropped)."""
    def pallas_call(*args, **kwargs):
        kwargs.pop('compiler_params', None)
        return pl.pallas_call(*args, interpret=True, **kwargs)

    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                                    if not n.startswith('_')})
    shim.pallas_call = pallas_call
    monkeypatch.setattr(jcp, 'pl', shim)
    return jcp._forward


@pytest.mark.parametrize('out_len', [16, 32])
@pytest.mark.parametrize('cluster', [1, 2, 3, 4, 8])
def test_factored_fwd_reference_matches_jax(cluster, out_len,
                                            pallas_forward):
    """The cluster-split algorithm at a narrow G-like head, 37 output
    capsules split unevenly, against the JAX package's Pallas forward and
    its plain routing, at K1's bar, at 3 passes and at 1."""
    x, w, _ = _inputs((3, 12, 8, 37, out_len), seed=21)
    for iters in (3, 1):
        got = cc.factored_fwd_reference(torch.from_numpy(x),
                                        torch.from_numpy(w), iters, cluster)
        kernel = np.array(pallas_forward(jnp.asarray(x), jnp.asarray(w),
                                           iters))
        plain = np.array(jcap.dynamic_routing(
            jcap.compute_votes(jnp.asarray(x), jnp.asarray(w)), iters))
        for ref in (kernel, plain):
            assert _bar_use(got, torch.from_numpy(ref), K1_RTOL,
                            K1_ATOL) <= 1


@pytest.mark.parametrize('cluster', [1, 2, 3, 4, 8])
def test_factored_fwd_reference_at_the_generator_head(cluster,
                                                      pallas_forward):
    """All 1024 output capsules of the flagship G head in the slices of
    every cluster size, at a batch of 2, against the JAX package's Pallas
    forward and the port's plain routing."""
    shape = (2,) + G_HEAD[1:]
    x, w, _ = _inputs(shape, seed=22)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = cc.factored_fwd_reference(xt, wt, 3, cluster)
    ref = torch.from_numpy(np.array(pallas_forward(jnp.asarray(x),
                                                     jnp.asarray(w), 3)))
    use = _bar_use(got, ref, K1_RTOL, K1_ATOL)
    print('cluster %d uses %.4f of K1\'s bar' % (cluster, use))
    assert use <= 1
    assert _bar_use(got, capsule_linear(xt, wt, 3, 'dynamic'), K1_RTOL,
                    K1_ATOL) <= 1


def test_factored_fwd_reference_is_the_backward_reference_forward():
    """K2-G's reference runs the same forward passes (the shared
    ``_factored_forward``): its gradients through a plain autograd of
    K1-G's reference agree with it at K2's bar."""
    x, w, dv = (torch.from_numpy(a) for a in _inputs((2, 9, 8, 21, 16), 23))
    xd, wd = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = cc.factored_fwd_reference(xd, wd, 3, 4)
    want = torch.autograd.grad(out, (xd, wd), dv)
    got = cc.factored_bwd_reference(x, w, dv, 3, 4)
    for g, ref in zip(got, want):
        assert _bar_use(g, ref, 1e-3, 1e-4) <= 1


# ---- the microbenchmark on the CPU -----------------------------------------

@pytest.mark.parametrize('batch', ['32', '320'])
def test_bench_profile_of_k1g_needs_the_card(batch):
    """--profile at the G head reads K1-G's device time: it refuses the
    CPU."""
    proc = _bench('--profile', '--shape', '48,8,1024,32', '--batch', batch,
                  '--device', 'cpu')
    assert proc.returncode != 0
    assert '--profile reads device time' in proc.stderr
