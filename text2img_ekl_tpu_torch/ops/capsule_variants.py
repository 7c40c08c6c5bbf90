"""V: the three batch-blocked capsule-routing variants as hand-written CUDA
kernels (bench-only).

Counterparts of ``tools/capsule_variants.py``'s ``forward_stored``,
``forward_seq`` and ``forward_recompute``, the experimental redesigns of
K1 that ``tools/bench_capsule_torch.py --variants`` measures against it.
Each computes K1's function, dynamic routing of x [B, in, L] through a
weight [out, out_length, L] shared over the input capsules, with NB samples
per thread block, and differs in where the votes live
(``csrc/capsule_variants.cu`` says what bounds each on Hopper):

- ``forward_stored``: the votes of a block's NB samples are computed once
  into a device scratch of B samples' votes and routed together;
- ``forward_seq``: a block routes its NB samples one after another through
  one votes buffer it reuses (ceil(B / NB) buffers);
- ``forward_recompute``: no votes are kept; at in_length 8 every pass works
  through K1's factored algebra, at any other in_length it recomputes the
  votes tile by tile in shared memory.

The names, defaults and layouts are the JAX functions'. Their ``vmem_mb``
(a TPU VMEM limit) has no counterpart and is not taken. On CPU tensors each
runs the plain routing (``capsule.capsule_linear``) over the batch padded
to a multiple of ``nb`` with zero samples and cuts the padding off, as the
JAX functions pad and cut; on CUDA tensors it launches its kernel or
raises (the kernel routes only the real samples, since the padding never
reaches the output). There is no gradient: the JAX variants have no VJP,
and a call that would need one raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .capsule import capsule_linear
from .capsule_cuda import _check_launch, _check_smem, _on_cpu, _shapes, _stream

STORED, SEQ, RECOMPUTE = 0, 1, 2   # the `kind` of csrc/capsule_variants.cu

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        lib = _build.library('capsule_variants')

        def fn(name, argtypes, restype=ctypes.c_int):
            f = getattr(lib, name)
            f.argtypes = argtypes
            f.restype = restype
            return f

        size = ctypes.c_size_t
        _fns = dict(
            fwd=fn('capsule_variants_fwd', [_I] + [_P] * 4 + [_I] * 8 + [_P]),
            smem=fn('capsule_variants_smem_bytes', [_I] * 6, size),
            scratch=fn('capsule_variants_scratch_floats', [_I] * 7, size))
    return _fns


def _plain(x, weight, num_iterations, nb):
    """The plain routing over the batch padded to a multiple of nb."""
    bsz = x.shape[0]
    pad = -bsz % nb
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
    return capsule_linear(x, weight, num_iterations, 'dynamic')[:bsz]


def _forward(kind, wrapper, x, weight, num_iterations, nb):
    name = wrapper.__name__
    if nb < 1:
        raise ValueError('%s: nb >= 1, got %d' % (name, nb))
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError('%s has no backward (the JAX variant has no VJP): '
                           'call it under torch.no_grad()' % name)
    if _on_cpu(x, weight):
        return _plain(x, weight, num_iterations, nb)
    bsz, in_caps, in_len, out_caps, out_len = _shapes(
        x, weight, num_iterations, who=name, factored_limit=False)
    out = torch.empty((bsz, out_caps, out_len), device=x.device,
                      dtype=torch.float32)
    if bsz == 0:
        return out
    k = _kernels()
    _check_smem(k['smem'](kind, in_caps, in_len, out_caps, out_len, nb),
                'NB=%d samples of %d x %d capsules' % (nb, in_caps, out_caps),
                who=name)
    scratch = torch.empty(k['scratch'](kind, bsz, in_caps, in_len, out_caps,
                                       out_len, nb),
                          device=x.device, dtype=torch.float32)
    _check_launch(k['fwd'](kind, x.data_ptr(), weight.data_ptr(),
                           scratch.data_ptr(), out.data_ptr(), bsz, in_caps,
                           in_len, out_caps, out_len, num_iterations, nb,
                           x.device.index, _stream(x)), name)
    wrapper.launches += 1
    return out


def forward_stored(x: torch.Tensor, weight: torch.Tensor,
                   num_iterations: int = 3, nb: int = 2) -> torch.Tensor:
    """V-stored: x [B, in, L], weight [out, out_length, L] float32 ->
    [B, out, out_length]; NB samples per block, every vote of them stored
    (a device scratch of B x in x out x out_length floats)."""
    return _forward(STORED, forward_stored, x, weight, num_iterations, nb)


def forward_seq(x: torch.Tensor, weight: torch.Tensor,
                num_iterations: int = 3, nb: int = 2) -> torch.Tensor:
    """V-seq: as ``forward_stored``, but a block routes its NB samples one
    after another through one reused votes buffer."""
    return _forward(SEQ, forward_seq, x, weight, num_iterations, nb)


def forward_recompute(x: torch.Tensor, weight: torch.Tensor,
                      num_iterations: int = 3, nb: int = 8) -> torch.Tensor:
    """V-recompute: as ``forward_stored``, but no votes are kept: every pass
    recomputes what it needs from x and the weight."""
    return _forward(RECOMPUTE, forward_recompute, x, weight, num_iterations,
                    nb)


# Launches of each kernel (CUDA calls only); 0 on the training and serving
# paths, which never call the variants.
forward_stored.launches = 0
forward_seq.launches = 0
forward_recompute.launches = 0
KERNELS = {'V-stored': forward_stored, 'V-seq': forward_seq,
           'V-recompute': forward_recompute}
