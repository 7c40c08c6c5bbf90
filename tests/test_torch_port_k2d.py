"""K2-D, the capsule-routing backward at the discriminator class head, on
the CPU: its launch plan, the 3xTF32 emulation of its products, and its
algorithm in plain PyTorch against the JAX package and plain autograd.

The kernel (``csrc/capsule_routing_bwd.cu``, ``csrc/gemm_tf32x3.cuh``)
runs only on the card (``tests/test_torch_port_cuda.py``). What the CPU
can check is what surrounds it: ``votes_bwd_plan``, the pure-Python plan
the wrapper hands the kernel; ``round_tf32``, which rounds as
``cvt.rna.tf32.f32`` does; and ``votes_bwd_reference``, K2-D's algorithm
(vote product, routing recomputed and reversed with its stashes, two
pullback products), whose products ``tf32x3_matmul_reference`` emulates.
With the emulated products it must hold K2's bar, |d| <= 1e-3 |ref| +
1e-4 max|ref|, against plain autograd at the flagship head; single TF32
misses that bar, and its error is printed, not asserted.
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
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, 'tools', 'bench_capsule_torch.py')
K2_RTOL, K2_ATOL = 1e-3, 1e-4
FLAGSHIP = (32, 16, 512, 201, 16)   # B, I, L, J, O: the D class head


def _inputs(shape, seed):
    """x, a unit-variance weight scaled by 1/sqrt(L / 8) (votes of unit
    scale) and dv, from a numpy seed."""
    b, i, l, j, o = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, i, l), dtype=np.float32)
    w = rng.standard_normal((j, o, l), dtype=np.float32) / np.float32(
        np.sqrt(l / 8))
    dv = rng.standard_normal((b, j, o), dtype=np.float32)
    return x, w, dv


def _bar_use(out, ref):
    """max over elements of |d| / (rtol |ref| + atol max|ref|): <= 1 holds
    K2's bar."""
    d = (out - ref).abs()
    return float((d / (K2_RTOL * ref.abs() + K2_ATOL * ref.abs().max()))
                 .max())


# ---- the plan --------------------------------------------------------------

PLAN_SHAPES = [
    FLAGSHIP,
    (3, 5, 24, 37, 16),      # ragged
    (4, 16, 64, 3, 16),      # J smaller than most clusters
    (6, 10, 37, 50, 32),     # I != 16, odd L, out_length 32
    (64, 16, 512, 201, 16),  # a batch of 64: two blocks per sample
    (1, 16, 512, 1, 16),     # one output capsule
]


@pytest.mark.parametrize('shape', PLAN_SHAPES)
@pytest.mark.parametrize('cluster', [None, 1, 2, 4, 8])
def test_votes_bwd_plan_invariants(shape, cluster):
    b, i, l, j, o = shape
    p = cc.votes_bwd_plan(b, i, l, j, o, 3, sms=132, cluster=cluster)
    assert p.cluster in cc.CLUSTER_SIZES or p.cluster == j
    assert 1 <= p.cluster <= min(8, j)
    if cluster is not None:
        assert p.cluster == min(cluster, j)
    assert p.blocks == b * p.cluster
    # the slices cover J exactly, in order, none empty, sizes within one
    starts = [s for s, _ in p.slices]
    assert len(p.slices) == p.cluster and starts[0] == 0
    assert p.slices[-1][1] == j
    assert all(a[1] == c[0] for a, c in zip(p.slices, p.slices[1:]))
    sizes = [e - s for s, e in p.slices]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert max(sizes) == -(-j // p.cluster)
    assert p.smem_bytes <= cc.MAX_SMEM_BYTES
    assert p.smem_bytes == cc.votes_bwd_smem_bytes(i, j, o, 3, p.cluster,
                                                   p.votes_in_smem)
    assert p.votes_in_smem == (cc.votes_bwd_smem_bytes(
        i, j, o, 3, p.cluster, True) <= cc.MAX_SMEM_BYTES)
    assert p.votes_numel == b * i * j * o
    # dx's split: whole 32-deep steps, every run non-empty, K covered
    k = j * o
    assert p.dx_chunk % cc.GEMM_BK == 0
    assert (p.dx_splits - 1) * p.dx_chunk < k <= p.dx_splits * p.dx_chunk
    assert p.partial_numel == (p.dx_splits * b * i * l if p.dx_splits > 1
                               else 0)


def test_votes_bwd_plan_at_the_flagship():
    """B=32, 16 -> 201 x 16 at 3 passes on 132 SMs: clusters of 4, 128
    blocks in one wave, each holding its 50-51 capsule vote slice; dx's
    20 output tiles split 6 ways."""
    p = cc.votes_bwd_plan(*FLAGSHIP, 3, sms=132)
    assert (p.cluster, p.blocks, p.votes_in_smem) == (4, 128, True)
    assert p.slices == ((0, 50), (50, 100), (100, 150), (150, 201))
    assert p.smem_bytes == 107968
    assert (p.dx_splits, p.dx_chunk) == (6, 544)
    # one block per sample where the card has fewer SMs than samples
    assert cc.votes_bwd_plan(*FLAGSHIP, 3, sms=16).cluster == 1
    # at a cluster of 1 the votes do not fit beside the stashes
    one = cc.votes_bwd_plan(*FLAGSHIP, 3, sms=132, cluster=1)
    assert not one.votes_in_smem and one.blocks == 32


def test_votes_bwd_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match='cluster 3'):
        cc.votes_bwd_plan(*FLAGSHIP, 3, cluster=3)
    with pytest.raises(ValueError, match='shared memory'):
        cc.votes_bwd_plan(2, 64, 64, 2000, 32, 3, cluster=1)


# ---- tf32 rounding and the 3xTF32 product ------------------------------------

def _f32(bits):
    return np.array(bits, dtype=np.uint32).view(np.float32)


@pytest.mark.parametrize('value,want', [
    (1.0, 1.0),
    (0.0, 0.0),
    (-0.0, -0.0),
    (1 + 2 ** -10, 1 + 2 ** -10),                 # a tf32 value stays
    (1 + 2 ** -11, 1 + 2 ** -10),                 # tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),           # tie, negative
    (1 + 2 ** -10 + 2 ** -11, 1 + 2 ** -9),       # tie from an odd value
    (1 + 2 ** -11 - 2 ** -23, 1.0),               # just under the tie
    (1 + 2 ** -11 + 2 ** -23, 1 + 2 ** -10),      # just over it
    (2 - 2 ** -11, 2.0),                          # carries into the exponent
    (3.0 * 2 ** -135, 3.0 * 2 ** -135),           # subnormal, a tf32 value
    (2.0 ** -137, 2.0 ** -136),                   # subnormal tie
    (2.0 ** -140, 0.0),                           # under half a tf32 step
])
def test_round_tf32_hand_picked(value, want):
    got = cc.round_tf32(torch.tensor([value], dtype=torch.float32))
    assert got.item() == np.float32(want)
    assert np.signbit(got.numpy()[0]) == np.signbit(np.float32(want))


def test_round_tf32_ties_and_specials_by_bits():
    """Bit patterns: the 13 dropped bits at exactly half round away from
    zero (the kept field increments), below half truncate; infinities and
    NaN pass unchanged."""
    x = torch.from_numpy(_f32([0x3F801000, 0x3F800FFF, 0xBF803000,
                               0x7F800000, 0xFF800000, 0x7FC00000]))
    got = cc.round_tf32(x).numpy().view(np.uint32)
    assert list(got[:3]) == [0x3F802000, 0x3F800000, 0xBF804000]
    assert list(got[3:5]) == [0x7F800000, 0xFF800000]
    assert np.isnan(cc.round_tf32(x).numpy()[5])
    # every result has its 13 low bits clear
    r = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    bits = cc.round_tf32(torch.from_numpy(r)).numpy().view(np.uint32)
    assert not (bits & 0x1FFF).any()


def test_tf32x3_product_is_float32_faithful():
    """Against a float64 product: the 3xTF32 emulation within a few
    float32 roundings of the sum, single TF32 about 2^-11 relative."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 512), dtype=np.float32)
    b = rng.standard_normal((512, 48), dtype=np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    x3 = cc.tf32x3_matmul_reference(at, bt).double().numpy()
    f32 = (at @ bt).double().numpy()
    x1 = (cc.round_tf32(at) @ cc.round_tf32(bt)).double().numpy()
    err = {k: float((np.abs(v - exact) / scale).max())
           for k, v in (('3xTF32', x3), ('float32', f32), ('TF32', x1))}
    print('max |error| / (|a| |b|):', err)
    assert err['3xTF32'] < 4 * max(err['float32'], 2 ** -24)
    assert err['TF32'] > 30 * err['3xTF32']


# ---- K2-D's algorithm --------------------------------------------------------

def test_votes_bwd_reference_matches_jax_vjp():
    """The plain algorithm with float32 products against jax.vjp of the JAX
    package's routing at a narrow D-like head (the JAX package sends this
    head to XLA autodiff): K2's plain twin, at the gradient tolerance of
    tests/test_torch_port_capsule.py."""
    x, w, dv = _inputs((2, 16, 64, 37, 16), seed=3)

    def ref(x_, w_):
        return jcap.dynamic_routing(jcap.compute_votes(x_, w_), 3)

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    for got, want in zip(cc.votes_bwd_reference(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(dv),
            3), vjp(jnp.asarray(dv))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_emulated_tf32x3_backward_holds_k2_bar_at_the_flagship(seed):
    """K2-D's algorithm with its products emulated at 3xTF32 against plain
    autograd, dx and dW at x [32, 16, 512], W [201, 16, 512]; single TF32's
    error is printed beside it (it misses the bar)."""
    x, w, dv = (torch.from_numpy(a) for a in _inputs(FLAGSHIP, seed))
    ref = cc._plain_backward(x, w, dv, 3, True, True)
    x3 = cc.votes_bwd_reference(x, w, dv, 3,
                                matmul=cc.tf32x3_matmul_reference)
    x1 = cc.votes_bwd_reference(
        x, w, dv, 3, matmul=lambda a, b: cc.round_tf32(a) @ cc.round_tf32(b))
    for what, got, one, want in zip(('dx', 'dW'), x3, x1, ref):
        use3, use1 = _bar_use(got, want), _bar_use(one, want)
        print('seed %d %s: 3xTF32 uses %.4f of the bar (max_abs_err %.3e), '
              'single TF32 %.3f (max_abs_err %.3e)'
              % (seed, what, use3, float((got - want).abs().max()), use1,
                 float((one - want).abs().max())))
        assert use3 <= 1.0


@pytest.mark.parametrize('need', [(True, True), (True, False),
                                  (False, True)])
def test_votes_bwd_reference_honours_needs(need):
    x, w, dv = (torch.from_numpy(a) for a in _inputs((3, 5, 24, 37, 16), 4))
    dx, dw = cc.votes_bwd_reference(x, w, dv, 2, *need)
    ref = cc._plain_backward(x, w, dv, 2, True, True)
    for got, want, wanted in zip((dx, dw), ref, need):
        if not wanted:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


# ---- the microbenchmark on the CPU -----------------------------------------

def test_bench_bwd_runs_on_the_cpu_at_the_d_head():
    env = {k: v for k, v in os.environ.items() if k != 'T2I_JAX_CACHE'}
    env['OMP_NUM_THREADS'] = '1'
    proc = subprocess.run(
        [sys.executable, BENCH, '--bwd', '--shape', '16,512,201,16',
         '--batch', '2', '--device', 'cpu'], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith('card: cpu (host clock)')
    for what in ('dx', 'dW'):
        assert any(line.startswith('K1+K2 B=2 16,512,201,16 %s: ' % what)
                   and line.endswith(': ok') for line in lines), what
    assert any(line.startswith('K1+K2 forward+backward B=2') for line in
               lines)
    # --profile reads device time and refuses the CPU
    proc = subprocess.run(
        [sys.executable, BENCH, '--bwd', '--profile', '--device', 'cpu'],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '--profile reads device time' in \
        proc.stderr
