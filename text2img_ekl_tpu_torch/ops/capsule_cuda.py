"""K1 and K2: capsule dynamic routing and its backward as hand-written CUDA
kernels, behind one ``torch.autograd.Function``.

Replaces ``text2img_ekl_tpu/ops/capsule_pallas.py``: ``_routing_kernel``
(K1, the forward) and ``_bwd_kernel`` (K2, the backward), which the JAX
package wraps in a ``jax.custom_vjp``. The sources say what bounds each
kernel on Hopper and what the design does about it:

- in_length 8 (the generator head): the factored forward
  (``csrc/capsule_routing.cu``, ``capsule_routing_fwd``) and backward
  (``csrc/capsule_routing_bwd.cu``, ``capsule_routing_bwd``), in which the
  6.3 MB-per-sample vote tensor never exists;
- any other in_length (the discriminator class head, 512): the vote tensor
  is materialised by a tiled float32 product, then routed
  (``capsule_routing_votes_fwd``) or reversed (``capsule_routing_votes_bwd``).

Both forms are kernels; the in_length picks the form. ``capsule_routing``
runs the plain routing (``capsule.capsule_linear``) for tensors on the
CPU, and only there; for CUDA tensors it launches the kernels or raises.
The JAX package's VMEM-size fallbacks and its backward gate (XLA autodiff
where the weight outweighs the votes) are TPU facts with no counterpart
here. Like the JAX custom VJP, the forward saves only ``(x, weight)`` and
the backward recomputes the routing.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .capsule import capsule_linear

FACTORED_IN_LENGTH = 8    # the factored kernels' capsule rows are two float4
OUT_LENGTHS = (16, 32)    # instantiated templates (csrc/*.cu)
MAX_IN_CAPSULES = 512     # factored form: one thread per input capsule in
                          # the reductions
MAX_SMEM_BYTES = 232448   # dynamic shared memory one block may use on sm_90

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        fwd_lib = _build.library('capsule_routing')
        bwd_lib = _build.library('capsule_routing_bwd')

        def fn(lib, name, argtypes, restype=ctypes.c_int):
            f = getattr(lib, name)
            f.argtypes = argtypes
            f.restype = restype
            return f

        size = ctypes.c_size_t
        _fns = dict(
            fwd=fn(fwd_lib, 'capsule_routing_fwd', [_P] * 3 + [_I] * 6 + [_P]),
            fwd_smem=fn(fwd_lib, 'capsule_routing_smem_bytes', [_I] * 2, size),
            fwd_votes=fn(fwd_lib, 'capsule_routing_votes_fwd',
                         [_P] * 4 + [_I] * 7 + [_P]),
            fwd_votes_smem=fn(fwd_lib, 'capsule_routing_votes_smem_bytes',
                              [_I] * 3, size),
            bwd=fn(bwd_lib, 'capsule_routing_bwd', [_P] * 8 + [_I] * 6 + [_P]),
            bwd_smem=fn(bwd_lib, 'capsule_routing_bwd_smem_bytes', [_I] * 3,
                        size),
            bwd_scratch=fn(bwd_lib, 'capsule_routing_bwd_scratch_floats',
                           [_I] * 4, size),
            bwd_votes=fn(bwd_lib, 'capsule_routing_votes_bwd',
                         [_P] * 7 + [_I] * 7 + [_P]),
            bwd_votes_smem=fn(bwd_lib, 'capsule_routing_votes_bwd_smem_bytes',
                              [_I] * 4, size))
    return _fns


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError('%s failed to launch: CUDA error %d' % (name, err))


def _check_smem(need: int, what: str) -> None:
    if need > MAX_SMEM_BYTES:
        raise ValueError('capsule_routing: %s needs %d bytes of shared '
                         'memory, more than %d' % (what, need, MAX_SMEM_BYTES))


def _shapes(x: torch.Tensor, weight: torch.Tensor,
            num_iterations: int) -> Tuple[int, int, int, int, int]:
    """Validate CUDA arguments; returns (B, in, in_length, out,
    out_length)."""
    if x.device.type != 'cuda' or weight.device != x.device:
        raise ValueError('capsule_routing: x and weight must both be on the '
                         'CPU or on one CUDA device, got %s and %s'
                         % (x.device, weight.device))
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError('capsule_routing: float32 only, got %s and %s'
                        % (x.dtype, weight.dtype))
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError('capsule_routing: x [B, in, L] and weight '
                         '[out, out_length, L], got %s and %s'
                         % (tuple(x.shape), tuple(weight.shape)))
    bsz, in_caps, in_len = x.shape
    out_caps, out_len, w_in_len = weight.shape
    if in_len != w_in_len:
        raise ValueError('capsule_routing: in_length %d != weight in_length '
                         '%d' % (in_len, w_in_len))
    if out_len not in OUT_LENGTHS:
        raise ValueError('capsule_routing: the kernels take out_length in '
                         '%s, got %d' % (OUT_LENGTHS, out_len))
    if in_caps < 1 or out_caps < 1 or in_len < 1:
        raise ValueError('capsule_routing: empty capsule dimension in %s x %s'
                         % (tuple(x.shape), tuple(weight.shape)))
    if in_len == FACTORED_IN_LENGTH and in_caps > MAX_IN_CAPSULES:
        raise ValueError('capsule_routing: the factored kernels take at '
                         'most %d input capsules, got %d'
                         % (MAX_IN_CAPSULES, in_caps))
    if num_iterations < 1:
        raise ValueError('capsule_routing: num_iterations >= 1')
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError('capsule_routing: x and weight must be contiguous')
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError('capsule_routing: x and weight must be 16-byte '
                         'aligned')
    return bsz, in_caps, in_len, out_caps, out_len


def routing_fwd_factored(x: torch.Tensor, weight: torch.Tensor,
                         num_iterations: int) -> torch.Tensor:
    """K1, factored form: x [B, in, 8], weight [out, out_length, 8] ->
    [B, out, out_length], on the card."""
    bsz, in_caps, _, out_caps, out_len = _shapes(x, weight, num_iterations)
    out = torch.empty((bsz, out_caps, out_len), device=x.device,
                      dtype=torch.float32)
    if bsz == 0:
        return out
    k = _kernels()
    _check_smem(k['fwd_smem'](in_caps, out_caps), '%d in / %d out capsules'
                % (in_caps, out_caps))
    _check_launch(k['fwd'](x.data_ptr(), weight.data_ptr(), out.data_ptr(),
                           bsz, in_caps, out_caps, out_len, num_iterations,
                           x.device.index, _stream(x)), 'capsule_routing_fwd')
    routing_fwd_factored.launches += 1
    return out


def routing_fwd_votes(x: torch.Tensor, weight: torch.Tensor,
                      num_iterations: int) -> torch.Tensor:
    """K1, materialised votes: x [B, in, L], weight [out, out_length, L] ->
    [B, out, out_length], on the card."""
    bsz, in_caps, in_len, out_caps, out_len = _shapes(x, weight,
                                                      num_iterations)
    out = torch.empty((bsz, out_caps, out_len), device=x.device,
                      dtype=torch.float32)
    if bsz == 0:
        return out
    k = _kernels()
    _check_smem(k['fwd_votes_smem'](in_caps, out_caps, out_len),
                'routing %d x %d votes' % (in_caps, out_caps))
    votes = torch.empty((bsz, in_caps, out_caps, out_len), device=x.device,
                        dtype=torch.float32)
    _check_launch(k['fwd_votes'](
        x.data_ptr(), weight.data_ptr(), votes.data_ptr(), out.data_ptr(),
        bsz, in_caps, in_len, out_caps, out_len, num_iterations,
        x.device.index, _stream(x)), 'capsule_routing_votes_fwd')
    routing_fwd_votes.launches += 1
    return out


def _grad_outputs(x, weight, need_dx, need_dw):
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(weight) if need_dw else None
    return dx, dw


def routing_bwd_factored(x: torch.Tensor, weight: torch.Tensor,
                         dv: torch.Tensor, num_iterations: int,
                         need_dx: bool = True, need_dw: bool = True):
    """K2, factored form: (dx [B, in, 8] or None, dweight [out,
    out_length, 8] summed over the batch, or None), on the card."""
    bsz, in_caps, _, out_caps, out_len = _shapes(x, weight, num_iterations)
    dv = dv.contiguous()
    if dv.shape != (bsz, out_caps, out_len) or dv.dtype != torch.float32:
        raise ValueError('capsule_routing: output gradient %s %s'
                         % (tuple(dv.shape), dv.dtype))
    dx, dw = _grad_outputs(x, weight, need_dx, need_dw)
    if bsz == 0 or not (need_dx or need_dw):
        if dw is not None:
            dw.zero_()
        return dx, dw
    k = _kernels()
    _check_smem(k['bwd_smem'](in_caps, out_caps, num_iterations),
                'the backward of %d in / %d out capsules'
                % (in_caps, out_caps))
    per = k['bwd_scratch'](in_caps, out_caps, out_len, num_iterations)
    scratch = torch.empty(bsz * per, device=x.device, dtype=torch.float32)
    fp = fq = None
    if need_dw:
        pairs = 2 * num_iterations - 1
        fp = torch.empty((bsz, pairs, out_caps, out_len), device=x.device,
                         dtype=torch.float32)
        fq = torch.empty((bsz, pairs, out_caps, FACTORED_IN_LENGTH),
                         device=x.device, dtype=torch.float32)
    _check_launch(k['bwd'](
        x.data_ptr(), weight.data_ptr(), dv.data_ptr(), _ptr(dx), _ptr(dw),
        scratch.data_ptr(), _ptr(fp), _ptr(fq), bsz, in_caps, out_caps,
        out_len, num_iterations, x.device.index, _stream(x)),
        'capsule_routing_bwd')
    routing_bwd_factored.launches += 1
    return dx, dw


def routing_bwd_votes(x: torch.Tensor, weight: torch.Tensor,
                      dv: torch.Tensor, num_iterations: int,
                      need_dx: bool = True, need_dw: bool = True):
    """K2, materialised votes: (dx [B, in, L] or None, dweight [out,
    out_length, L] summed over the batch, or None), on the card."""
    bsz, in_caps, in_len, out_caps, out_len = _shapes(x, weight,
                                                      num_iterations)
    dv = dv.contiguous()
    if dv.shape != (bsz, out_caps, out_len) or dv.dtype != torch.float32:
        raise ValueError('capsule_routing: output gradient %s %s'
                         % (tuple(dv.shape), dv.dtype))
    dx, dw = _grad_outputs(x, weight, need_dx, need_dw)
    if bsz == 0 or not (need_dx or need_dw):
        if dw is not None:
            dw.zero_()
        return dx, dw
    k = _kernels()
    _check_smem(k['bwd_votes_smem'](in_caps, out_caps, out_len,
                                    num_iterations),
                'the backward of %d x %d votes' % (in_caps, out_caps))
    votes = torch.empty((bsz, in_caps, out_caps, out_len), device=x.device,
                        dtype=torch.float32)
    dvotes = torch.empty_like(votes)
    _check_launch(k['bwd_votes'](
        x.data_ptr(), weight.data_ptr(), dv.data_ptr(), _ptr(dx), _ptr(dw),
        votes.data_ptr(), dvotes.data_ptr(), bsz, in_caps, in_len, out_caps,
        out_len, num_iterations, x.device.index, _stream(x)),
        'capsule_routing_votes_bwd')
    routing_bwd_votes.launches += 1
    return dx, dw


# Launches of each kernel (CUDA calls only): a run reads them to show that
# its path went through the kernels. On the flagship: K1-G and K2-G are the
# factored pair (generator head), K1-D and K2-D the votes pair
# (discriminator class heads).
routing_fwd_factored.launches = 0
routing_fwd_votes.launches = 0
routing_bwd_factored.launches = 0
routing_bwd_votes.launches = 0
KERNELS = {'K1-G': routing_fwd_factored, 'K1-D': routing_fwd_votes,
           'K2-G': routing_bwd_factored, 'K2-D': routing_bwd_votes}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _plain_backward(x, weight, dv, num_iterations, need_dx, need_dw):
    """Autograd through the plain routing: K2's twin on the CPU."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_(need_dx)
        wd = weight.detach().requires_grad_(need_dw)
        out = capsule_linear(xd, wd, num_iterations, 'dynamic')
        inputs = [t for t, need in ((xd, need_dx), (wd, need_dw)) if need]
        grads = iter(torch.autograd.grad(out, inputs, dv))
    return (next(grads) if need_dx else None,
            next(grads) if need_dw else None)


def _on_cpu(x, weight) -> bool:
    return x.device.type == 'cpu' and weight.device.type == 'cpu'


class CapsuleRoutingFunction(torch.autograd.Function):
    """Dynamic routing with a hand-written forward (K1) and backward (K2)
    on CUDA tensors; on CPU tensors the plain routing and its autograd."""

    @staticmethod
    def forward(ctx, x, weight, num_iterations):
        ctx.save_for_backward(x, weight)
        ctx.num_iterations = num_iterations
        if _on_cpu(x, weight):
            return capsule_linear(x, weight, num_iterations, 'dynamic')
        if x.shape[-1] == FACTORED_IN_LENGTH:
            return routing_fwd_factored(x, weight, num_iterations)
        return routing_fwd_votes(x, weight, num_iterations)

    @staticmethod
    def backward(ctx, dv):
        x, weight = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        if _on_cpu(x, weight):
            bwd = _plain_backward
        elif x.shape[-1] == FACTORED_IN_LENGTH:
            bwd = routing_bwd_factored
        else:
            bwd = routing_bwd_votes
        dx, dw = bwd(x, weight, dv.float(), ctx.num_iterations, need_dx,
                     need_dw)
        return dx, dw, None


def capsule_routing(x: torch.Tensor, weight: torch.Tensor,
                    num_iterations: int = 3) -> torch.Tensor:
    """Shared-weight dynamic routing: x [B, in, L] float32, weight
    [out, out_length, L] float32 -> [B, out, out_length] float32,
    differentiable in both."""
    if not _on_cpu(x, weight):
        _shapes(x, weight, num_iterations)
    return CapsuleRoutingFunction.apply(x, weight, num_iterations)
