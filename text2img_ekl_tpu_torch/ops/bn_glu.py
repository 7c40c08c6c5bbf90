"""K3: the fused BatchNorm-normalise + GLU tail as a hand-written CUDA
kernel, behind a ``torch.autograd.Function``.

Replaces ``text2img_ekl_tpu/ops/bn_glu.py`` (``_fwd_kernel`` via
``_fused_fwd``, entry ``fused_bn_glu``): one pass reads y [.., 2C] once and
writes ``(y k + b)[:C] * sigmoid((y k + b)[C:])`` once, with the folded
affine ``k = rsqrt(var + eps) * scale`` and ``b = bias - mean * k`` in
float32. The port keeps PyTorch's NCHW layout, so the channel halves are
``y[:, :C]`` and ``y[:, C:]``. The kernel (``csrc/bn_glu.cu``) computes
the affine in the BatchNorm dtype (``compute_dtype``, the config's
``TPU_BN_DTYPE``: float32, or bfloat16 with y, k and b rounded to it and
the product and the sum each rounded, as the JAX kernel's bfloat16
arithmetic), the GLU in float32, and writes y's type (bfloat16 or
float32).

``fused_bn_glu`` runs ``bn_glu_reference`` for tensors on the CPU, and only
there; for CUDA tensors it launches the kernel or raises. Like the JAX
custom VJP, the backward recomputes through the plain composition
(``bn_glu_composition``, the GLU in the BatchNorm dtype, as JAX's
``bn_glu_reference``) under autograd: the TPU kernel has no backward
kernel, so K3 has none either. In float32 the two plain functions are one.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

EPS = 1e-5
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _build.library('bn_glu').bn_glu_fwd
        f.argtypes = [_P] * 4 + [_L, _I, _L, _I, _I, _I, _P]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def fold_affine(mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32):
    """(k, b) as float32 tensors: ``k = rsqrt(var + eps) * scale``, ``b =
    bias - mean * k`` in float32 (``text2img_ekl_tpu/ops/bn_glu.py:97-99``),
    each rounded to ``compute_dtype`` (the JAX kernel's ``astype``)."""
    k = torch.rsqrt(var.float() + EPS) * scale.float()
    b = bias.float() - mean.float() * k
    return k.to(compute_dtype).float(), b.to(compute_dtype).float()


def _normalise(y, mean, var, scale, bias, compute_dtype):
    """The affine y k + b over dim 1 in ``compute_dtype``."""
    k, b = fold_affine(mean, var, scale, bias, compute_dtype)
    shape = (1, -1) + (1,) * (y.dim() - 2)
    if compute_dtype == torch.float32:
        return y.float() * k.view(shape) + b.view(shape)
    cd = compute_dtype
    return y.to(cd) * k.to(cd).view(shape) + b.to(cd).view(shape)


def bn_glu_reference(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32
                     ) -> torch.Tensor:
    """Plain PyTorch: y [B, 2C, ...] -> [B, C, ...] in y's type, the
    normalisation in ``compute_dtype`` and the GLU in float32 (K3's twin on
    the CPU, as the JAX kernel computes)."""
    xn = _normalise(y, mean, var, scale, bias, compute_dtype)
    c = xn.shape[1] // 2
    return (xn[:, :c].float() * torch.sigmoid(xn[:, c:].float())).to(y.dtype)


def bn_glu_composition(y: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """The chain the fused tail's backward differentiates, the normalisation
    and the GLU both in ``compute_dtype`` (JAX's ``bn_glu_reference``)."""
    xn = _normalise(y, mean, var, scale, bias, compute_dtype)
    c = xn.shape[1] // 2
    return (xn[:, :c] * torch.sigmoid(xn[:, c:])).to(y.dtype)


def bn_glu_kernel(y: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """K3 on the card: y [B, 2C, ...] (bfloat16 or float32, contiguous), k
    and b [2C] float32 -> [B, C, ...] in y's type, the affine in
    ``compute_dtype`` (float32 or bfloat16)."""
    if y.device.type != 'cuda' or k.device != y.device or \
            b.device != y.device:
        raise ValueError('bn_glu: y, k and b must lie on one CUDA device, '
                         'got %s, %s and %s' % (y.device, k.device, b.device))
    if y.dtype not in DTYPES:
        raise TypeError('bn_glu: y must be float32 or bfloat16, got %s'
                        % y.dtype)
    if y.dim() < 2 or y.shape[1] % 2:
        raise ValueError('bn_glu: y [B, 2C, ...] with an even channel count, '
                         'got %s' % (tuple(y.shape),))
    if compute_dtype not in DTYPES:
        raise TypeError('bn_glu: compute_dtype must be float32 or bfloat16, '
                        'got %s' % compute_dtype)
    c2 = y.shape[1]
    if k.shape != (c2,) or b.shape != (c2,) or k.dtype != torch.float32 or \
            b.dtype != torch.float32:
        raise ValueError('bn_glu: k and b must be float32 [%d], got %s %s and '
                         '%s %s' % (c2, tuple(k.shape), k.dtype,
                                    tuple(b.shape), b.dtype))
    if not (y.is_contiguous() and k.is_contiguous() and b.is_contiguous()):
        raise ValueError('bn_glu: y, k and b must be contiguous')
    out = torch.empty((y.shape[0], c2 // 2) + tuple(y.shape[2:]),
                      device=y.device, dtype=y.dtype)
    if out.numel() == 0:
        return out
    hw = y[0, 0].numel()
    err = _kernel()(y.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(),
                    y.shape[0], c2 // 2, hw, DTYPES[y.dtype],
                    DTYPES[compute_dtype], y.device.index,
                    torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError('bn_glu_fwd failed to launch: CUDA error %d' % err)
    bn_glu_kernel.launches += 1
    return out


# Launches of the kernel (CUDA calls only): a run reads it to show that its
# path went through K3.
bn_glu_kernel.launches = 0


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


class FusedBNGLUFunction(torch.autograd.Function):
    """The fused tail with K3 as the forward on CUDA tensors and the plain
    version on CPU tensors; the backward recomputes through the plain
    composition."""

    @staticmethod
    def forward(ctx, y, mean, var, scale, bias, compute_dtype):
        ctx.save_for_backward(y, mean, var, scale, bias)
        ctx.compute_dtype = compute_dtype
        if _on_cpu(y, mean, var, scale, bias):
            return bn_glu_reference(y, mean, var, scale, bias, compute_dtype)
        if any(t.device != y.device for t in (mean, var, scale, bias)):
            raise ValueError('bn_glu: y, mean, var, scale and bias must lie '
                             'on one device')
        return bn_glu_kernel(y, *fold_affine(mean, var, scale, bias,
                                             compute_dtype), compute_dtype)

    @staticmethod
    def backward(ctx, dz):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(
                bn_glu_composition(*inputs, ctx.compute_dtype), wanted, dz))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None,)


def fused_bn_glu(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """BatchNorm normalise with (mean, var, scale, bias) [2C] in
    ``compute_dtype`` (the BatchNorm dtype), then GLU over dim 1: y [B, 2C,
    ...] -> [B, C, ...] in y's type, differentiable in all five inputs."""
    return FusedBNGLUFunction.apply(y, mean, var, scale, bias, compute_dtype)
