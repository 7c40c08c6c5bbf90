"""K1-D and K2-G, the capsule-routing forward at the discriminator class
head and the backward at the generator head, on the CPU: their launch
plans, K2-G's cluster-split algorithm in plain PyTorch against the JAX
package, and the 3xTF32 emulation of K1-D's vote product.

The kernels (``csrc/capsule_routing.cu``, ``csrc/capsule_routing_bwd.cu``)
run only on the card (``tests/test_torch_port_cuda.py``). What the CPU can
check is what surrounds them: ``votes_fwd_plan`` and ``factored_bwd_plan``,
the pure-Python plans the wrappers hand the kernels; and the algorithms:
``factored_bwd_reference`` (K2-G's slices, per-slice softmax statistics and
rank-order sums) must hold K2's bar, |d| <= 1e-3 |ref| + 1e-4 max|ref|,
against ``jax.vjp`` of the JAX package's routing at every cluster size;
``votes_fwd_reference`` with the 3xTF32 product emulated must hold K1's bar,
|d| <= 1e-4 |ref| + 1e-5 max|ref|, against the plain routing at the
flagship head, where single TF32 misses it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.ops import capsule as jcap
from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, 'tools', 'bench_capsule_torch.py')
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-3, 1e-4
D_HEAD = (32, 16, 512, 201, 16)    # B, I, L, J, O: the D class head
G_HEAD = (32, 48, 8, 1024, 32)     # the G head at the training batch


def _inputs(shape, seed):
    """x, a unit-variance weight scaled by 1/sqrt(L / 8) (votes of unit
    scale, ROADMAP F14) and dv, from a numpy seed."""
    b, i, l, j, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, i, l), dtype=np.float32)
    w = rng.standard_normal((j, o, l), dtype=np.float32) / np.float32(
        np.sqrt(l / 8))
    dv = rng.standard_normal((b, j, o), dtype=np.float32)
    return x, w, dv


def _bar_use(out, ref, rtol, atol):
    """max over elements of |d| / (rtol |ref| + atol max|ref|): <= 1 holds
    the bar."""
    d = (out - ref).abs()
    return float((d / (rtol * ref.abs() + atol * ref.abs().max())).max())


def _check_slices(p, j):
    starts = [s for s, _ in p.slices]
    assert len(p.slices) == p.cluster and starts[0] == 0
    assert p.slices[-1][1] == j
    assert all(a[1] == c[0] for a, c in zip(p.slices, p.slices[1:]))
    sizes = [e - s for s, e in p.slices]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-j // p.cluster)


# ---- the plans -------------------------------------------------------------

FACTORED_SHAPES = [
    G_HEAD,
    (3, 13, 8, 1000, 32),     # ragged
    (2, 16, 8, 512, 16),      # out_length 16 (the EXCHANGE branches)
    (4, 48, 8, 3, 32),        # J smaller than most clusters
    (64, 48, 8, 1024, 32),    # a batch of 64: two blocks per sample
    (1, 48, 8, 2000, 32),     # many output capsules: only a cluster fits
]


@pytest.mark.parametrize('shape', FACTORED_SHAPES)
@pytest.mark.parametrize('cluster', [None, 1, 2, 3, 4, 8])
def test_factored_bwd_plan_invariants(shape, cluster):
    b, i, _, j, _ = shape
    p = cc.factored_bwd_plan(b, i, j, 3, sms=132, cluster=cluster)
    assert 1 <= p.cluster <= min(8, j)
    assert p.cluster in cc.FACTORED_CLUSTER_SIZES or p.cluster == j
    if cluster is not None:
        assert p.cluster == min(cluster, j)
    else:
        assert b * p.cluster <= 132 or p.cluster == 1
    assert p.blocks == b * p.cluster
    _check_slices(p, j)
    assert p.smem_bytes <= cc.MAX_SMEM_BYTES
    assert p.smem_bytes == cc.factored_bwd_smem_bytes(i, j, 3, p.cluster,
                                                      p.in_smem)
    assert p.in_smem == (cc.factored_bwd_smem_bytes(
        i, j, 3, p.cluster, True) <= cc.MAX_SMEM_BYTES)
    small, big = cc._factored_floats(i, j, 3, p.cluster)
    assert small % 4 == 0 and big % 4 == 0  # float4 rows stay aligned
    assert p.scratch_numel == (0 if p.in_smem else p.blocks * big)


# what an H100 (132 SMs) reports for the flagship G head: how many
# clusters of each size it holds at once (one block of 512 threads per SM;
# its GPCs leave SMs over at clusters of 4 and 8)
H100_CLUSTERS = {1: 132, 2: 66, 3: 40, 4: 30, 8: 15}


def test_factored_bwd_plan_at_the_flagship():
    """B=32, 48 -> 1024 x 32 at 3 passes on 132 SMs: clusters of 4, 128
    blocks of 256 output capsules, everything in 163 KB of shared memory,
    where the card holds all 32 clusters at once; on an H100, which holds
    30, clusters of 3, 96 blocks of 341-342 capsules in 218 KB. At clusters
    of 1 and 2 the stashes, couplings and logit gradient go to the
    scratch."""
    b, i, _, j, _ = G_HEAD
    p = cc.factored_bwd_plan(b, i, j, 3, sms=132)
    assert (p.cluster, p.blocks, p.in_smem, p.scratch_numel) == (4, 128,
                                                                 True, 0)
    assert p.slices == ((0, 256), (256, 512), (512, 768), (768, 1024))
    assert p.smem_bytes == 166976
    h100 = cc.factored_bwd_plan(
        b, i, j, 3, sms=132, max_clusters=lambda c, _: H100_CLUSTERS[c])
    assert (h100.cluster, h100.blocks, h100.in_smem) == (3, 96, True)
    assert h100.slices == ((0, 341), (341, 682), (682, 1024))
    assert h100.smem_bytes == 223104 <= cc.MAX_SMEM_BYTES
    # a card that cannot say (0) is taken to hold them all
    assert cc.factored_bwd_plan(b, i, j, 3, sms=132,
                                max_clusters=lambda c, _: 0).cluster == 4
    # one that holds too few clusters of every size > 1: one block a sample
    assert cc.factored_bwd_plan(b, i, j, 3, sms=132,
                                max_clusters=lambda c, _: 8).cluster == 1
    for c, blocks in ((1, 32), (2, 64)):
        q = cc.factored_bwd_plan(b, i, j, 3, sms=132, cluster=c)
        assert (q.blocks, q.in_smem) == (blocks, False)
        assert q.scratch_numel == blocks * cc._factored_floats(i, j, 3, c)[1]
    assert cc.factored_bwd_plan(b, i, j, 3, sms=132, cluster=8).in_smem
    # one block per sample where the card has fewer SMs than samples
    assert cc.factored_bwd_plan(b, i, j, 3, sms=16).cluster == 1


def test_factored_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match='cluster 5'):
        cc.factored_bwd_plan(32, 48, 1024, 3, cluster=5)
    with pytest.raises(ValueError, match='shared memory'):
        cc.factored_bwd_plan(2, 5000, 1024, 3, cluster=1)


VOTES_SHAPES = [
    D_HEAD,
    (3, 5, 24, 37, 16),       # ragged
    (4, 16, 64, 3, 16),       # J smaller than most clusters
    (6, 10, 37, 50, 32),      # I != 16, odd L, out_length 32
    (64, 16, 512, 201, 16),   # a batch of 64
    (1, 16, 512, 1, 16),      # one output capsule
]


@pytest.mark.parametrize('shape', VOTES_SHAPES)
@pytest.mark.parametrize('cluster', [None, 1, 2, 4, 8])
def test_votes_fwd_plan_invariants(shape, cluster):
    b, i, l, j, o = shape
    p = cc.votes_fwd_plan(b, i, l, j, o, sms=132, cluster=cluster)
    assert 1 <= p.cluster <= min(8, j)
    if cluster is not None:
        assert p.cluster == min(cluster, j)
    # the forward and the backward of one head split it alike
    assert p.cluster == cc.votes_bwd_plan(b, i, l, j, o, 3, sms=132,
                                          cluster=cluster).cluster
    assert p.blocks == b * p.cluster
    _check_slices(p, j)
    assert p.smem_bytes <= cc.MAX_SMEM_BYTES
    assert p.smem_bytes == cc.votes_fwd_smem_bytes(i, j, o, p.cluster,
                                                   p.votes_in_smem)
    assert p.votes_in_smem == (cc.votes_fwd_smem_bytes(
        i, j, o, p.cluster, True) <= cc.MAX_SMEM_BYTES)
    assert p.votes_numel == b * i * j * o


def test_votes_fwd_plan_at_the_flagship():
    """The D class head at B=32: clusters of 4, 128 blocks, each with its
    50-51 capsule vote slice (52 KB) in shared memory; at a cluster of 1 the
    206 KB of a sample's votes do not fit beside the rest."""
    p = cc.votes_fwd_plan(*D_HEAD, sms=132)
    assert (p.cluster, p.blocks, p.votes_in_smem) == (4, 128, True)
    assert p.slices == ((0, 50), (50, 100), (100, 150), (150, 201))
    assert p.smem_bytes == 62272
    one = cc.votes_fwd_plan(*D_HEAD, sms=132, cluster=1)
    assert (one.blocks, one.votes_in_smem, one.smem_bytes) == (32, False,
                                                               38848)


def test_votes_fwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match='cluster 5'):
        cc.votes_fwd_plan(*D_HEAD, cluster=5)
    with pytest.raises(ValueError, match='shared memory'):
        cc.votes_fwd_plan(2, 64, 64, 3000, 32, cluster=1)


# ---- K2-G's algorithm ------------------------------------------------------

@pytest.mark.parametrize('out_len', [16, 32])
@pytest.mark.parametrize('cluster', [1, 2, 4, 8])
def test_factored_bwd_reference_matches_jax_vjp(cluster, out_len):
    """The cluster-split factored backward (per-slice statistics and sums
    combined in rank order) against jax.vjp of the JAX package's routing at
    a narrow G-like head, 37 output capsules split unevenly, at K2's bar;
    both gradients, and each one alone."""
    x, w, dv = _inputs((3, 12, 8, 37, out_len), seed=11)

    def ref(x_, w_):
        return jcap.dynamic_routing(jcap.compute_votes(x_, w_), 3)

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    want = [np.array(g) for g in vjp(jnp.asarray(dv))]
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dv), 3,
            cluster)
    for got, ref_g in zip(cc.factored_bwd_reference(*args), want):
        assert _bar_use(got, torch.from_numpy(ref_g), K2_RTOL, K2_ATOL) <= 1
    dx, none = cc.factored_bwd_reference(*args, need_dw=False)
    assert none is None
    assert _bar_use(dx, torch.from_numpy(want[0]), K2_RTOL, K2_ATOL) <= 1
    none, dw = cc.factored_bwd_reference(*args, need_dx=False)
    assert none is None
    assert _bar_use(dw, torch.from_numpy(want[1]), K2_RTOL, K2_ATOL) <= 1


@pytest.mark.parametrize('iters', [1, 2])
def test_factored_bwd_reference_other_pass_counts(iters):
    x, w, dv = (torch.from_numpy(a) for a in _inputs((2, 9, 8, 21, 16), 12))
    ref = cc._plain_backward(x, w, dv, iters, True, True)
    for got, want in zip(cc.factored_bwd_reference(x, w, dv, iters, 4), ref):
        assert _bar_use(got, want, K2_RTOL, K2_ATOL) <= 1


def test_factored_bwd_reference_at_the_generator_head():
    """All 1024 output capsules in the flagship's four slices of 256, at a
    batch of 2, against plain autograd."""
    shape = (2,) + G_HEAD[1:]
    x, w, dv = (torch.from_numpy(a) for a in _inputs(shape, 13))
    plan = cc.factored_bwd_plan(*G_HEAD[:2], G_HEAD[3], 3)
    ref = cc._plain_backward(x, w, dv, 3, True, True)
    got = cc.factored_bwd_reference(x, w, dv, 3, plan.cluster)
    for what, g, want in zip(('dx', 'dW'), got, ref):
        use = _bar_use(g, want, K2_RTOL, K2_ATOL)
        print('%s uses %.4f of K2\'s bar' % (what, use))
        assert use <= 1


# ---- K1-D's product at 3xTF32 ------------------------------------------------

@pytest.mark.parametrize('seed', [0, 1, 2])
def test_emulated_tf32x3_forward_holds_k1_bar_at_the_flagship(seed):
    """K1-D's algorithm with its vote product emulated at 3xTF32 against the
    plain routing at x [32, 16, 512], W [201, 16, 512], at K1's bar; single
    TF32 misses that bar."""
    x, w, _ = (torch.from_numpy(a) for a in _inputs(D_HEAD, seed))
    ref = capsule_linear(x, w, 3, 'dynamic')
    x3 = cc.votes_fwd_reference(x, w, 3, matmul=cc.tf32x3_matmul_reference)
    x1 = cc.votes_fwd_reference(
        x, w, 3, matmul=lambda a, b: cc.round_tf32(a) @ cc.round_tf32(b))
    use3 = _bar_use(x3, ref, K1_RTOL, K1_ATOL)
    use1 = _bar_use(x1, ref, K1_RTOL, K1_ATOL)
    print('seed %d: 3xTF32 uses %.4f of K1\'s bar (max_abs_err %.3e), single '
          'TF32 %.3f (max_abs_err %.3e)' % (
              seed, use3, float((x3 - ref).abs().max()), use1,
              float((x1 - ref).abs().max())))
    assert use3 <= 1.0
    assert use1 > 1.0


def test_votes_fwd_reference_with_float32_products_is_the_routing():
    x, w, _ = (torch.from_numpy(a) for a in _inputs((3, 5, 24, 37, 16), 4))
    got = cc.votes_fwd_reference(x, w, 3)
    ref = capsule_linear(x, w, 3, 'dynamic')
    assert _bar_use(got, ref, 1e-5, 1e-6) <= 1


# ---- the microbenchmark on the CPU -----------------------------------------

def _bench(*argv):
    env = {k: v for k, v in os.environ.items() if k != 'T2I_JAX_CACHE'}
    env['OMP_NUM_THREADS'] = '1'
    return subprocess.run([sys.executable, BENCH, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('shape,bwd', [('16,512,201,16', False),
                                       ('48,8,1024,32', True)])
def test_bench_runs_on_the_cpu(shape, bwd):
    """The forward at the D head and forward + backward at the G head, on
    the CPU, where the wrappers take the plain routing."""
    proc = _bench(*(['--bwd'] if bwd else []), '--shape', shape, '--batch',
                  '2', '--device', 'cpu')
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith('card: cpu (host clock)')
    assert any(line.startswith('K1 B=2 %s: ' % shape) and
               line.endswith(': ok') for line in lines)
    timed = 'K1+K2 forward+backward B=2' if bwd else 'plain B=2 %s: ' % shape
    assert any(line.startswith(timed) for line in lines)


@pytest.mark.parametrize('argv', [['--profile'], ['--bwd', '--profile'],
                                  ['--variants', '--profile']])
def test_bench_profile_needs_the_card(argv):
    """--profile reads device time: it refuses the CPU, and the variant
    sweep."""
    proc = _bench(*argv, '--device', 'cpu')
    assert proc.returncode != 0
    assert '--profile reads device time' in proc.stderr
