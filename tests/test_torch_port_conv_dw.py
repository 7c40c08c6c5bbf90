"""K4's split plan and its microbenchmark on the CPU.

``ops.conv_dw.plan`` is the pure-Python part of the 3x3 conv weight
gradient's launch: how many K-steps (image row segments), output tiles and
split-K blocks a call takes, and the float32 scratch the blocks' partial
sums need, for the bf16 and the float32 (3xTF32) body. The kernel itself
runs only on the card (tests/test_torch_port_cuda.py); here the plan's
invariants, its values at the flagship's shapes on an H100 (132 SMs), and
CPU runs of tools/bench_conv_dw_torch.py on the plain version in both
types.
"""

import os
import subprocess
import sys

import pytest
import torch

from text2img_ekl_tpu_torch.ops import conv_dw
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, 'tools', 'bench_conv_dw_torch.py')
H100_SMS = 132


@pytest.mark.parametrize('bf16', [True, False])
@pytest.mark.parametrize('shape', [
    (32, 64, 64, 128),    # (B, C, H, F): flagship ResBlock conv 1
    (32, 64, 128, 64),    # flagship stage-2 upsample conv
    (1, 3, 32, 8),        # one 32 px image, C and F below a tile
    (3, 16, 64, 72),      # F one tile and a ragged one
    (2, 16, 256, 8),      # four column slabs per row
    (1, 64, 512, 200),    # eight slabs, four f tiles
])
@pytest.mark.parametrize('sms', [1, 5, H100_SMS])
def test_plan_covers_every_step_once(shape, bf16, sms):
    """The splits' runs of ``chunk`` K-steps cover the call's K-steps with
    no empty split, and the blocks fill at most the SMs they were planned
    for, one block per SM (a bf16 K-step is min(W, 64) columns, a float32
    one 32: one 128-byte operand row)."""
    b, c, h, f = shape
    p = conv_dw.plan(b, c, h, h, f, bf16, sms)
    assert p.slab_cols == (min(h, 64) if bf16 else 32)
    assert p.steps == b * h * (h // p.slab_cols)
    tiles = -(-f // 64) * (1 if bf16 else -(-c // 32))
    assert p.tiles == tiles
    assert p.splits * p.chunk >= p.steps > (p.splits - 1) * p.chunk
    assert p.splits == 1 or p.tiles * (p.splits - 1) < sms
    assert p.partial_numel == p.splits * f * c * 9


def test_plan_at_the_flagship():
    """The three shapes of the flagship step with TPU_PALLAS_DW on an H100:
    one bf16 block per SM; the partials take 18.9-19.3 MB (about the size
    of dy at 64 px)."""
    want = {(32, 64, 64, 128): (2048, 2, 64, 32),
            (32, 64, 64, 64): (2048, 1, 128, 16),
            (32, 64, 128, 64): (8192, 1, 131, 63)}
    for (b, c, h, f), (steps, tiles, splits, chunk) in want.items():
        p = conv_dw.plan(b, c, h, h, f, True, H100_SMS)
        assert (p.steps, p.tiles, p.splits, p.chunk) == (steps, tiles,
                                                         splits, chunk)
        assert p.tiles * p.splits <= H100_SMS
        assert 18.8e6 < 4 * p.partial_numel < 19.4e6


def test_plan_at_the_flagship_float32():
    """The same shapes in float32 (TPU_COMPUTE_DTYPE float32): 32-column
    K-steps, 64 f x 32 c tiles, one block per SM (132 at all three shapes);
    the partials take 9.7 MB."""
    want = {(32, 64, 64, 128): (4096, 4, 33, 125),
            (32, 64, 64, 64): (4096, 2, 66, 63),
            (32, 64, 128, 64): (16384, 2, 66, 249)}
    for (b, c, h, f), (steps, tiles, splits, chunk) in want.items():
        p = conv_dw.plan(b, c, h, h, f, False, H100_SMS)
        assert (p.slab_cols, p.steps, p.tiles, p.splits, p.chunk) == (
            32, steps, tiles, splits, chunk)
        assert p.tiles * p.splits == H100_SMS
        assert 4 * p.partial_numel == 9732096


def test_plan_splits_mid_image():
    """A plan for 5 SMs over 3 images of 32 rows: the runs of 20 rows start
    at rows 20 and 40, inside images 0 and 1, which the card test of K4 at
    this plan exercises (a run re-loads the x rows above its first row)."""
    p = conv_dw.plan(3, 16, 32, 32, 64, True, 5)
    assert (p.steps, p.splits, p.chunk) == (96, 5, 20)
    assert [s * p.chunk % 32 for s in range(1, p.splits)] == [20, 8, 28, 16]


def _bench(*args):
    env = dict(os.environ, OMP_NUM_THREADS='1')
    return subprocess.run([sys.executable, BENCH, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_runs_on_the_cpu():
    """The microbenchmark's CPU run: dw3x3 takes the plain version, checks
    it against itself bit for bit, and labels its times as host clock."""
    proc = _bench('--device', 'cpu', '--shape', '2,8,32,16')
    assert proc.returncode == 0, proc.stderr
    assert 'card: cpu (host clock)' in proc.stdout
    assert 'K4 x [2,8,32,32] dy F=16' in proc.stdout
    assert 'bit-identical over two calls' in proc.stdout
    assert 'cuDNN' not in proc.stdout and 'bound' not in proc.stdout


def test_bench_runs_on_the_cpu_in_float32():
    """``--dtype float32``: the same CPU run on float32 inputs, with the
    plain version's error against the float64 contraction printed."""
    proc = _bench('--device', 'cpu', '--dtype', 'float32', '--shape',
                  '2,8,32,16')
    assert proc.returncode == 0, proc.stderr
    assert 'card: cpu (host clock); K4 float32' in proc.stdout
    assert 'K4 x [2,8,32,32] dy F=16' in proc.stdout
    assert 'max_abs_err vs float64' in proc.stdout
    assert 'cuDNN' not in proc.stdout and 'bound' not in proc.stdout


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = _bench('--shape', '2,8,32,16')
    assert proc.returncode != 0 and 'K4 x' not in proc.stdout
