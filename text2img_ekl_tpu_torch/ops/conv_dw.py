"""K4: the weight gradient of a 3x3 stride-1 SAME bias-free convolution as
a hand-written CUDA kernel, and the conv whose backward uses it.

Replaces ``text2img_ekl_tpu/ops/conv_dw.py``: ``dw3x3`` (``_dw_kernel``)
and ``dw3x3_v2`` (``_dw_kernel_v2``), two TPU bodies of one function,

    dW[f, c, ky, kx] = sum_{b, y, x} x[b, c, y+ky-1, x+kx-1] dy[b, f, y, x]

accumulated in float32, and ``conv3x3_dw``, the conv whose custom VJP
computes dW with it. The port's layouts are PyTorch's: x [B, C, H, W], dy
[B, F, H, W], dW [F, C, 3, 3] (the conv weight's). The kernel
(``csrc/conv3x3_dw.cu``) contracts on the tensor cores (TMA-fed ``wgmma``)
with float32 sums: bfloat16 inputs as they are, float32 inputs
float32-faithfully as three tf32 products (3xTF32, whose arithmetic
``dw3x3_tf32x3_reference`` emulates), into split-K partial sums in a
scratch and a fixed-order sum of them; ``plan`` is the split that the
wrapper hands it.

``dw3x3`` runs ``dw3x3_reference`` for tensors on the CPU, and only there;
for CUDA tensors it launches the kernel or raises, also on a shape outside
``dw_supported``, the JAX package's envelope, which ``nn.blocks.Conv3x3``
uses to route exactly as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .tf32 import round_tf32

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (text2img_ekl_tpu/ops/conv_dw.py:_TILE_FOR_W) row tile per width: the
# envelope needs H divisible by it
_TILE_FOR_W = {32: 32, 64: 64, 128: 128, 256: 64, 512: 16}
# the kernel's tiles (csrc/conv3x3_dw.cu), one block per SM. A K-step is
# one image row segment: min(W, 64) columns in bf16, 32 in float32. A bf16
# block owns 64 output x all (<= 64) input channels x 9 taps, a float32
# block 64 x 32 (its running sums and a K-step's partial fill the
# registers).
TILE_F, MAX_SLAB_COLS = 64, 64
F32_TILE_C, F32_STEP_COLS = 32, 32


class DwPlan(NamedTuple):
    """How K4 splits one call: ``steps`` K-steps of ``slab_cols`` columns,
    ``tiles`` output tiles (bf16: 64 f each; float32: 64 f x 32 c), each
    summed by ``splits`` blocks over runs of ``chunk`` K-steps (the last
    run may be shorter, none is empty); the float32 scratch holds
    ``partial_numel`` = splits x F x C x 9 values. The float32 body adds
    each K-step's 3xTF32 tensor-core partial to its block's running sum
    in IEEE float32."""
    slab_cols: int
    steps: int
    tiles: int
    splits: int
    chunk: int
    partial_numel: int


def plan(B: int, C: int, H: int, W: int, F: int, bf16: bool,
         sms: int) -> DwPlan:
    """Enough (tile, split) blocks to fill ``sms`` SMs once, at least one
    K-step each."""
    cols = min(W, MAX_SLAB_COLS) if bf16 else F32_STEP_COLS
    steps = B * H * (W // cols)
    tiles = -(-F // TILE_F)
    if not bf16:
        tiles *= -(-C // F32_TILE_C)
    want = max(1, min(steps, -(-sms // tiles)))
    chunk = -(-steps // want)
    splits = -(-steps // chunk)
    return DwPlan(cols, steps, tiles, splits, chunk, splits * F * C * 9)


_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None
_sms = {}


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library('conv3x3_dw').conv3x3_dw
        f.argtypes = [_P] * 4 + [_I] * 9 + [_P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def dw_supported(H: int, W: int, C: int, F: int) -> bool:
    """The JAX package's envelope for its Pallas dW
    (``text2img_ekl_tpu/ops/conv_dw.py:75-84``, default tile): square maps
    of 32 to 512 px, C <= 64, and W and F multiples of 8."""
    return (H == W and W in _TILE_FOR_W and C <= 64 and
            H % _TILE_FOR_W[W] == 0 and W % 8 == 0 and F % 8 == 0)


def dw3x3_reference(x: torch.Tensor, dy: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch: nine shifted contractions over the zero-padded x in
    ``dtype`` (float32: K4's twin on the CPU; float64: the yardstick of the
    float32 body's faithfulness); x [B, C, H, W], dy [B, F, H, W] -> dW [F,
    C, 3, 3] in ``dtype``."""
    h, w = x.shape[2:]
    xp = F.pad(x.to(dtype), (1, 1, 1, 1))
    dyf = dy.to(dtype)
    taps = [torch.einsum('bfhw,bchw->fc', dyf,
                         xp[:, :, ky:ky + h, kx:kx + w])
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, -1).view(dy.shape[1], x.shape[1], 3, 3)


def dw3x3_tf32x3_reference(x: torch.Tensor, dy: torch.Tensor, chunk: int,
                           terms: int = 3) -> torch.Tensor:
    """The float32 body's arithmetic in plain PyTorch, for the tests (the
    wrapper never calls it): x and dy split into tf32 hi = tf32(v) and lo =
    tf32(v - hi); each K-step (an image row segment of F32_STEP_COLS
    columns) contracted as lo.hi + hi.lo + hi.hi into a fresh float32
    partial; the partials of each split-K run of ``chunk`` K-steps (the
    plan's) added one after another to a float32 sum from zero, and the
    runs' sums added in order, on the inputs' device. ``terms=1`` keeps
    hi.hi alone (single TF32). Up to the order of the sums inside a
    K-step."""
    b, c, h, w = x.shape
    f = dy.shape[1]
    cols = F32_STEP_COLS

    def steps(t):  # [B, R, H, W] -> [K-steps, R, cols], the kernel's order
        r = t.shape[1]
        return t.reshape(b, r, h, w // cols, cols).permute(
            0, 3, 2, 1, 4).reshape(-1, r, cols)

    def split(t):
        hi = round_tf32(t)
        return hi, round_tf32(t - hi)

    dh, dl = (steps(v) for v in split(dy.float()))
    xp = F.pad(x.float(), (1, 1, 1, 1))
    taps = []
    for ky in range(3):
        for kx in range(3):
            xh, xl = (steps(v) for v in split(
                xp[:, :, ky:ky + h, kx:kx + w].contiguous()))
            part = dh @ xh.transpose(1, 2)
            if terms == 3:
                part = dl @ xh.transpose(1, 2) + dh @ xl.transpose(1, 2) + \
                    part
            taps.append(part)
    parts = torch.stack(taps, -1)  # [K-steps, F, C, 9]
    out = parts.new_zeros(parts.shape[1:])
    for run in parts.split(chunk):
        acc = torch.zeros_like(out)
        for p in run:
            acc += p
        out += acc
    return out.view(f, c, 3, 3)


def dw3x3(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW [F, C, 3, 3] float32 of a 3x3 stride-1 pad-1 bias-free conv, from
    its input x [B, C, H, W] and output gradient dy [B, F, H, W]: the plain
    contractions on the CPU, K4 on the card."""
    if x.device.type == 'cpu' and dy.device.type == 'cpu':
        return dw3x3_reference(x, dy)
    return dw3x3_kernel(x, dy)


def dw3x3_kernel(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K4 on the card; raises on what it does not take."""
    if x.device.type != 'cuda' or dy.device != x.device:
        raise ValueError('dw3x3: x and dy must lie on one CUDA device, got '
                         '%s and %s' % (x.device, dy.device))
    if x.dtype not in DTYPES or dy.dtype != x.dtype:
        raise TypeError('dw3x3: x and dy must both be float32 or bfloat16, '
                        'got %s and %s' % (x.dtype, dy.dtype))
    if x.dim() != 4 or dy.dim() != 4 or x.shape[0] != dy.shape[0] or \
            x.shape[2:] != dy.shape[2:]:
        raise ValueError('dw3x3: x [B, C, H, W] and dy [B, F, H, W], got %s '
                         'and %s' % (tuple(x.shape), tuple(dy.shape)))
    bsz, c, h, w = x.shape
    f = dy.shape[1]
    if not dw_supported(h, w, c, f):
        raise ValueError('dw3x3: H=%d W=%d C=%d F=%d is outside the kernel\'s '
                         'envelope (dw_supported)' % (h, w, c, f))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError('dw3x3: x and dy must be contiguous')
    if bsz == 0:
        return torch.zeros((f, c, 3, 3), device=x.device, dtype=torch.float32)
    dev = _device_index(x.device)
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return run_plan(x, dy, plan(bsz, c, h, w, f, x.dtype == torch.bfloat16,
                                _sms[dev]))


def run_plan(x: torch.Tensor, dy: torch.Tensor, p: DwPlan) -> torch.Tensor:
    """Launch K4 with the split ``p`` on inputs that ``dw3x3_kernel`` has
    checked; raises where the library refuses the launch."""
    bsz, c, h, w = x.shape
    f = dy.shape[1]
    out = torch.empty((f, c, 3, 3), device=x.device, dtype=torch.float32)
    partial = torch.empty(p.partial_numel, device=x.device,
                          dtype=torch.float32)
    err = _kernel()(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                    out.data_ptr(), bsz, c, h, w, f, p.splits, p.chunk,
                    DTYPES[x.dtype], _device_index(x.device),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError('conv3x3_dw failed to launch: CUDA error %d' % err)
    dw3x3_kernel.launches += 1
    return out


# Launches of the kernel (CUDA calls only): a run reads it to show that its
# path went through K4.
dw3x3_kernel.launches = 0


class Conv3x3DW(torch.autograd.Function):
    """3x3 stride-1 pad-1 bias-free conv of x with ``w.to(x.dtype)`` whose
    weight gradient is ``dw3x3`` (``text2img_ekl_tpu/ops/conv_dw.py:248-279``).
    The cast is inside, so dW returns in float32 without the round trip
    through x's type that plain autograd makes; dx is the transposed conv,
    as the JAX package leaves it to XLA."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w.to(x.dtype), None, 1, 1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, w.to(x.dtype), dy, 1, 1)
        if ctx.needs_input_grad[1]:
            dw = dw3x3(x.contiguous(), dy).to(w.dtype)
        return dx, dw


def conv3x3_dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] conv w [F, C, 3, 3] (float32 parameter), stride 1, pad
    1, no bias, in x's type; dW by ``dw3x3``."""
    return Conv3x3DW.apply(x, w)
