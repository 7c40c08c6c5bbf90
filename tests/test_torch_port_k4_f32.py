"""K4's float32 body on the CPU: its arithmetic, emulated in plain PyTorch,
against the JAX package and against float64.

The body (``csrc/conv3x3_dw.cu::dw_tf32x3_kernel``) runs only on the card
(tests/test_torch_port_cuda.py). It takes float32 on the tensor cores as
three tf32 products: x and dy split into hi = tf32(v) and lo = tf32(v -
hi), each 32-column K-step summed as lo.hi + hi.lo + hi.hi into a fresh
float32 partial, the partials added in IEEE float32 over each split-K run
and the runs in order. ``ops.conv_dw.dw3x3_tf32x3_reference`` emulates
that arithmetic (up to the order of the sums inside a K-step), and here it
is held to:

  (a) JAX's ``dw3x3_v2`` (Pallas, interpret mode, float32) at the K4 bar,
      |d| <= 1e-3 |ref| + 1e-4 max|ref|;
  (b) float32 faithfulness: at K = B*H*W = 8,192 its max error against
      the contraction in float64 is at most twice that of the plain float32
      contraction (``dw3x3_reference``);
  (c) and single TF32 (hi.hi alone) fails (b), so the rule has teeth.

The split-K runs are the plan's on an H100 (132 SMs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.ops import conv_dw as jconv_dw
from text2img_ekl_tpu_torch.ops import capsule_cuda, conv_dw, tf32
from torch_port_threads import one_torch_thread  # noqa: F401

H100_SMS = 132
K4_RTOL, K4_ATOL = 1e-3, 1e-4
FAITHFUL = (2, 16, 64, 24)   # (B, C, H, F): K = 2 * 64 * 64 = 8,192


def _inputs(shape, seed):
    """x [B, C, H, H] and dy [B, F, H, H] ~ N(0, 1), seeded, NCHW."""
    b, c, h, f = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, c, h, h), dtype=np.float32),
            rng.standard_normal((b, f, h, h), dtype=np.float32))


def _emulate(x, dy, terms=3):
    b, c, h, f = x.shape[0], x.shape[1], x.shape[2], dy.shape[1]
    chunk = conv_dw.plan(b, c, h, h, f, False, H100_SMS).chunk
    return conv_dw.dw3x3_tf32x3_reference(torch.from_numpy(x),
                                          torch.from_numpy(dy), chunk, terms)


def _max_err_vs_float64(shape, terms):
    """(max error of the emulation, of the float32 contraction) against
    the float64 contraction."""
    x, dy = _inputs(shape, 5)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    exact = conv_dw.dw3x3_reference(tx, tdy, torch.float64)
    got = _emulate(x, dy, terms).double()
    f32 = conv_dw.dw3x3_reference(tx, tdy).double()
    return float((got - exact).abs().max()), float((f32 - exact).abs().max())


def test_round_tf32_is_shared():
    """K1-D's and K2-D's emulations round as K4's does: one function."""
    assert capsule_cuda.round_tf32 is tf32.round_tf32


@pytest.mark.parametrize('shape', [
    (2, 8, 32, 16),     # (B, C, H, F): one K-step per row
    (1, 16, 64, 24),    # two K-steps per row, F and C below a tile
])
def test_tf32x3_emulation_matches_jax(shape):
    x, dy = _inputs(shape, 2)
    nhwc = (0, 2, 3, 1)
    want = np.asarray(jconv_dw.dw3x3_v2(
        jnp.asarray(x.transpose(nhwc)), jnp.asarray(dy.transpose(nhwc)),
        interpret=True)).transpose(3, 2, 0, 1)  # [ky, kx, c, f] -> [f, c, ..]
    got = _emulate(x, dy).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=K4_RTOL,
                               atol=K4_ATOL * np.abs(want).max())


def test_tf32x3_emulation_is_float32_faithful():
    err, f32_err = _max_err_vs_float64(FAITHFUL, 3)
    print('max |error| vs float64: 3xTF32 %.3e, float32 %.3e'
          % (err, f32_err))
    assert err <= 2 * f32_err


def test_single_tf32_is_not_faithful():
    err, f32_err = _max_err_vs_float64(FAITHFUL, 1)
    print('max |error| vs float64: 1xTF32 %.3e, float32 %.3e'
          % (err, f32_err))
    assert err > 2 * f32_err
