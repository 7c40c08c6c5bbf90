"""K5: BatchNorm with its activation epilogue (GLU, LeakyReLU or none) as
hand-written CUDA kernels, forward and backward, train and eval, behind a
``torch.autograd.Function``.

Replaces no Pallas kernel: XLA fused the JAX package's BatchNorm chains on
the TPU. The kernels (``csrc/bn_act.cu``) keep the numerics of the port's
eager chain ``nn.blocks.BatchNorm`` -> ``GLU`` / ``LeakyReLU``: flax's
float32 statistics (mean and E[x^2] - mean^2, biased, the variance clipped
at 0 before use and before the running update ``0.9 old + 0.1 batch``), the
affine ``(x - mean) * (rsqrt(var + eps) * w) + b`` in float32 rounded to
the BatchNorm dtype, the epilogue in that dtype with PyTorch's rounding
points, and a backward that rounds the activation's gradient where
autograd's bfloat16 ops round and does the BatchNorm part in float32. The
statistics are summed in another order than ATen's (fixed, so two runs give
the same bits), so outputs may sit an ulp of the BatchNorm dtype away from
the eager chain's.

``bn_act`` takes CUDA tensors of rank 4 only and launches the kernels or
raises; the module ``nn.blocks.BatchNormAct`` runs the eager chain for
everything else. ``bn_act.calls`` counts its forwards, ``bn_act.launches``
the kernels those forwards and their backwards launched (a train forward 3,
an eval forward 1, a backward 3, or 2 where dx is not wanted), and
``bn_act.eager_calls`` the rank-4 BatchNorm calls on CUDA that took the eager
chain instead (``nn.blocks.BatchNorm.forward`` adds to it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build

ACTS = {None: 0, 'glu': 1, 'leaky': 2}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
# Blocks a reduction pass aims at: 4 waves of 8 blocks on each of an
# H100's 132 SMs; each block takes at least MIN_BLOCK_ELEMENTS elements.
TARGET_BLOCKS = 4 * 8 * 132
MIN_BLOCK_ELEMENTS = 8192

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double
_fns = {}


def _kernel(name: str):
    if name not in _fns:
        lib = _build.library('bn_act')
        for fn, args in (
                ('bn_act_stats_fwd', [_P, _I, _L, _I, _L, _I, _I, _I, _I, _P,
                                      _D, _P, _P, _P, _I, _I, _P]),
                ('bn_act_apply_fwd', [_P, _I, _P, _P, _P, _P, _F, _P, _I, _I,
                                      _L, _I, _L, _I, _I, _P]),
                ('bn_act_bwd', [_P, _I, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                                _L, _I, _L, _I, _I, _I, _I, _P, _D, _P, _P,
                                _P, _P, _I, _P])):
            f = getattr(lib, fn)
            f.argtypes = args
            f.restype = ctypes.c_int
            _fns[fn] = f
    return _fns[name]


def reduce_plan(n: int, units: int, hw: int, vec: int):
    """(tpc, cb, splits) of a reduction pass over [n, units, hw] in vectors
    of ``vec`` elements: ``tpc`` threads a channel (the largest power of two
    up to 256 that a plane's vectors fill), ``cb = 256 / tpc`` channels a
    block, and the batch cut into ``splits`` ranges, enough for
    ``TARGET_BLOCKS`` blocks where each still takes ``MIN_BLOCK_ELEMENTS``."""
    v = hw // vec
    tpc = 1 << (min(THREADS, v).bit_length() - 1)
    cb = THREADS // tpc
    groups = -(-units // cb)
    splits = min(n, -(-TARGET_BLOCKS // groups),
                 n * cb * hw // MIN_BLOCK_ELEMENTS)
    return tpc, cb, max(1, splits)


def out_dtype(x_dtype: torch.dtype, act: Optional[str],
              bn_dtype: torch.dtype) -> torch.dtype:
    """The output's type: the BatchNorm dtype without an epilogue (a
    residual block's second BatchNorm, summed in that type), else x's, the
    compute dtype."""
    return bn_dtype if act is None else x_dtype


def _vec(hw: int, *tensors) -> int:
    """1 where the kernels may read and write 16-byte vectors: whole vectors
    a plane and every pointer 16-byte aligned; else 0 (single elements)."""
    return int(hw % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def _check(x, weight, bias, running_mean, running_var, act, bn_dtype):
    if x.device.type != 'cuda':
        raise ValueError('bn_act: x must lie on a CUDA device, got %s'
                         % x.device)
    if x.dim() != 4:
        raise ValueError('bn_act: x must be [N, C, H, W], got %s'
                         % (tuple(x.shape),))
    if x.dtype not in DTYPES or bn_dtype not in DTYPES:
        raise TypeError('bn_act: x and the BatchNorm dtype must be float32 '
                        'or bfloat16, got %s and %s' % (x.dtype, bn_dtype))
    if act not in ACTS:
        raise ValueError('bn_act: act must be None, glu or leaky, got %r'
                         % (act,))
    if not x.is_contiguous():
        raise ValueError('bn_act: x must be contiguous NCHW')
    c = x.shape[1]
    if act == 'glu' and c % 2:
        raise ValueError('bn_act: a GLU needs an even channel count, got %d'
                         % c)
    for name, t in (('weight', weight), ('bias', bias),
                    ('running_mean', running_mean),
                    ('running_var', running_var)):
        if t.shape != (c,) or t.dtype != torch.float32 or \
                t.device != x.device or not t.is_contiguous():
            raise ValueError('bn_act: %s must be float32 [%d] on %s, got %s '
                             '%s on %s' % (name, c, x.device, tuple(t.shape),
                                           t.dtype, t.device))
    if x.numel() == 0:
        raise ValueError('bn_act: x is empty')


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(x, weight, bias, running_mean, running_var, training, update,
             eps, act, bn_dtype):
    """-> (out, mean, var): the statistics the output was normalised with
    (the batch's, var unclipped, or the running buffers)."""
    n, c, h, w = x.shape
    hw = h * w
    if training:
        vec = _vec(hw, x)
        tpc, cb, splits = reduce_plan(n, c, hw, 8 if vec else 1)
        part = torch.empty((2, splits, c), device=x.device,
                           dtype=torch.float32)
        stats = torch.empty((2, c), device=x.device, dtype=torch.float32)
        err = _kernel('bn_act_stats_fwd')(
            x.data_ptr(), DTYPES[x.dtype], n, c, hw, vec, tpc, cb, splits,
            part.data_ptr(), float(n * hw), stats.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), int(update),
            x.device.index, _stream(x))
        if err:
            raise RuntimeError('bn_act_stats_fwd failed to launch: CUDA '
                               'error %d' % err)
        bn_act.launches += 2
        mean, var = stats[0], stats[1]
    else:
        mean, var = running_mean, running_var
    co = c // 2 if act == 'glu' else c
    out = torch.empty((n, co, h, w), device=x.device,
                      dtype=out_dtype(x.dtype, act, bn_dtype))
    vec = _vec(hw, x, out)
    err = _kernel('bn_act_apply_fwd')(
        x.data_ptr(), DTYPES[x.dtype], mean.data_ptr(), var.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), eps, out.data_ptr(),
        DTYPES[bn_dtype], ACTS[act], n, c, hw, vec, x.device.index,
        _stream(x))
    if err:
        raise RuntimeError('bn_act_apply_fwd failed to launch: CUDA error %d'
                           % err)
    bn_act.launches += 1
    bn_act.calls += 1
    return out, mean, var


def _backward(dout, x, mean, var, weight, bias, training, eps, act,
              bn_dtype, want_dx, want_dw, want_db):
    """-> (dx or None, dweight or None, dbias or None)."""
    n, c, h, w = x.shape
    hw = h * w
    dout = dout.contiguous()
    if dout.dtype != out_dtype(x.dtype, act, bn_dtype):
        raise TypeError('bn_act: the output gradient must be %s, got %s'
                        % (out_dtype(x.dtype, act, bn_dtype), dout.dtype))
    dx = torch.empty_like(x) if want_dx else None
    dw = torch.empty_like(weight) if want_dw else None
    db = torch.empty_like(bias) if want_db else None
    vec = _vec(hw, *(t for t in (x, dout, dx) if t is not None))
    co = c // 2 if act == 'glu' else c
    tpc, cb, splits = reduce_plan(n, co, hw, 8 if vec else 1)
    part = torch.empty((2, splits, c), device=x.device, dtype=torch.float32)
    coef = torch.empty((3, c), device=x.device, dtype=torch.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _kernel('bn_act_bwd')(
        x.data_ptr(), DTYPES[x.dtype], dout.data_ptr(), mean.data_ptr(),
        var.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
        DTYPES[bn_dtype], ACTS[act], int(training), n, c, hw, vec, tpc, cb,
        splits, part.data_ptr(), float(n * hw), coef.data_ptr(), ptr(dw),
        ptr(db), ptr(dx), x.device.index, _stream(x))
    if err:
        raise RuntimeError('bn_act_bwd failed to launch: CUDA error %d' % err)
    bn_act.launches += 2 if dx is None else 3
    return dx, dw, db


class BnActFunction(torch.autograd.Function):
    """K5 forward, and K5 backward from x and the saved per-channel
    statistics (nothing of float32 size is saved)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, training,
                update, eps, act, bn_dtype):
        out, mean, var = _forward(x, weight, bias, running_mean, running_var,
                                  training, update, eps, act, bn_dtype)
        if not training:  # the buffers may change before backward
            mean, var = mean.clone(), var.clone()
        ctx.save_for_backward(x, mean, var, weight, bias)
        ctx.conf = (training, eps, act, bn_dtype)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, mean, var, weight, bias = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return (None,) * 10
        dx, dw, db = _backward(dout, x, mean, var, weight, bias, *ctx.conf,
                               need[0], need[1], need[2])
        return (dx, dw, db) + (None,) * 7


def bn_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           running_mean: torch.Tensor, running_var: torch.Tensor,
           training: bool, update: bool, eps: float, act: Optional[str],
           bn_dtype: torch.dtype) -> torch.Tensor:
    """BatchNorm over dim 1 of x [N, C, H, W] (float32 or bfloat16,
    contiguous, on CUDA) then the epilogue ``act`` ('glu': [N, C/2, H, W],
    'leaky', or None), in train mode with the batch's statistics (folded
    into the running buffers in place where ``update``) or in eval mode with
    the running ones. The output is of x's type with an epilogue and of
    ``bn_dtype`` without one; differentiable in x, weight and bias."""
    _check(x, weight, bias, running_mean, running_var, act, bn_dtype)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return BnActFunction.apply(x, weight, bias, running_mean,
                                   running_var, training, update, eps, act,
                                   bn_dtype)
    return _forward(x, weight, bias, running_mean, running_var, training,
                    update, eps, act, bn_dtype)[0]


# bn_act's forwards on CUDA
bn_act.calls = 0
# kernels launched: a train forward's statistics pass, finalize and apply
# pass, an eval forward's apply pass, a backward's sums pass, finalize and
# dx pass
bn_act.launches = 0
# rank-4 BatchNorm calls on CUDA that took the eager chain
bn_act.eager_calls = 0
