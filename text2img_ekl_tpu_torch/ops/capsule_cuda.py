"""K1 and K2: capsule dynamic routing and its backward as hand-written CUDA
kernels, behind one ``torch.autograd.Function``.

Replaces ``text2img_ekl_tpu/ops/capsule_pallas.py``: ``_routing_kernel``
(K1, the forward) and ``_bwd_kernel`` (K2, the backward), which the JAX
package wraps in a ``jax.custom_vjp``. The sources say what bounds each
kernel on Hopper and what the design does about it:

- in_length 8 (the generator head): the factored forward
  (``csrc/capsule_routing.cu``, ``capsule_routing_fwd``, K1-G) and backward
  (``csrc/capsule_routing_bwd.cu``, ``capsule_routing_bwd``, K2-G), in which
  the 6.3 MB-per-sample vote tensor never exists. Both route each sample on
  a cluster of blocks that split the output capsules, through one forward
  pass (``csrc/capsule_common.cuh::factored_forward``, which K2-G runs with
  stashes), as ``factored_fwd_plan`` and ``factored_bwd_plan`` choose;
  ``factored_fwd_reference`` and ``factored_bwd_reference`` are their
  algorithms, slices and rank-order sums included, in plain PyTorch;
- any other in_length (the discriminator class head, 512): the vote tensor
  is materialised by a float32-faithful 3xTF32 product on the tensor cores
  (``csrc/gemm_tf32x3.cuh``), then routed (``capsule_routing_votes_fwd``,
  K1-D) or reversed (``capsule_routing_votes_bwd``, K2-D, which adds two
  more products) on a cluster of blocks per sample, as ``votes_fwd_plan``
  and ``votes_bwd_plan`` choose. ``votes_fwd_reference`` and
  ``votes_bwd_reference`` are their algorithms in plain PyTorch, and
  ``tf32x3_matmul_reference`` emulates their products.

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
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import spans
from . import _build
from .capsule import capsule_linear, dynamic_routing
from .tf32 import round_tf32

FACTORED_IN_LENGTH = 8    # the factored kernels' capsule rows are two float4
OUT_LENGTHS = (16, 32)    # instantiated templates (csrc/*.cu)
MAX_IN_CAPSULES = 512     # factored form: one thread per input capsule in
                          # the reductions
MAX_SMEM_BYTES = 232448   # dynamic shared memory one block may use on sm_90
# The cluster sizes the routing plans pick from (8 is the portable maximum),
# and the 3xTF32 products' block tile (rows, columns, K depth;
# csrc/gemm_tf32x3.cuh)
CLUSTER_SIZES = (1, 2, 4, 8)
# K2-G's blocks hold one per SM, and a cluster's blocks must share a GPC of
# the card: clusters of 3 pack where those of 4 leave SMs over
FACTORED_CLUSTER_SIZES = (1, 2, 3, 4, 8)
# K1-G's cluster where no cluster holds the batch in one wave (the
# sampler's B=320): the size that the card's sweep found fastest (PERF.md
# §6): a block takes about 21 us plus 0.06 us a capsule of its slice, so
# fewer, larger blocks win
FACTORED_FWD_MULTI_WAVE = 2
GEMM_BM, GEMM_BN, GEMM_BK = 128, 104, 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = None
_sms = {}
_clusters = {}
_fwd_plans = {}


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
            fwd=fn(fwd_lib, 'capsule_routing_fwd',
                   [_P] * 5 + [_I] * 8 + [_P]),
            fwd_smem=fn(fwd_lib, 'capsule_routing_fwd_smem_bytes', [_I] * 4,
                        size),
            fwd_scratch=fn(fwd_lib, 'capsule_routing_fwd_scratch_floats',
                           [_I] * 3, size),
            fwd_clusters=fn(fwd_lib, 'capsule_routing_fwd_max_clusters',
                            [_I] * 6),
            fwd_votes=fn(fwd_lib, 'capsule_routing_votes_fwd',
                         [_P] * 4 + [_I] * 9 + [_P]),
            fwd_votes_smem=fn(fwd_lib, 'capsule_routing_votes_smem_bytes',
                              [_I] * 5, size),
            bwd=fn(bwd_lib, 'capsule_routing_bwd', [_P] * 9 + [_I] * 8 + [_P]),
            bwd_smem=fn(bwd_lib, 'capsule_routing_bwd_smem_bytes', [_I] * 5,
                        size),
            bwd_scratch=fn(bwd_lib, 'capsule_routing_bwd_scratch_floats',
                           [_I] * 4, size),
            bwd_clusters=fn(bwd_lib, 'capsule_routing_bwd_max_clusters',
                            [_I] * 7),
            bwd_votes=fn(bwd_lib, 'capsule_routing_votes_bwd',
                         [_P] * 8 + [_I] * 11 + [_P]),
            bwd_votes_smem=fn(bwd_lib, 'capsule_routing_votes_bwd_smem_bytes',
                              [_I] * 6, size))
    return _fns


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _sm_count(device: torch.device) -> int:
    if device.index not in _sms:
        _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device.index]


def _check_launch(err: int, name: str) -> None:
    if err:
        raise RuntimeError('%s failed to launch: CUDA error %d' % (name, err))


def _check_smem(need: int, what: str, who: str = 'capsule_routing') -> None:
    if need > MAX_SMEM_BYTES:
        raise ValueError('%s: %s needs %d bytes of shared memory, more than '
                         '%d' % (who, what, need, MAX_SMEM_BYTES))


def _shapes(x: torch.Tensor, weight: torch.Tensor, num_iterations: int,
            who: str = 'capsule_routing',
            factored_limit: bool = True) -> Tuple[int, int, int, int, int]:
    """Validate CUDA arguments; returns (B, in, in_length, out,
    out_length). ``who`` names the caller in the errors; ``factored_limit``
    applies the factored kernels' input-capsule limit at in_length 8."""
    if x.device.type != 'cuda' or weight.device != x.device:
        raise ValueError('%s: x and weight must both be on the CPU or on one '
                         'CUDA device, got %s and %s'
                         % (who, x.device, weight.device))
    if x.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError('%s: float32 only, got %s and %s'
                        % (who, x.dtype, weight.dtype))
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError('%s: x [B, in, L] and weight [out, out_length, L], '
                         'got %s and %s'
                         % (who, tuple(x.shape), tuple(weight.shape)))
    bsz, in_caps, in_len = x.shape
    out_caps, out_len, w_in_len = weight.shape
    if in_len != w_in_len:
        raise ValueError('%s: in_length %d != weight in_length %d'
                         % (who, in_len, w_in_len))
    if out_len not in OUT_LENGTHS:
        raise ValueError('%s: the kernels take out_length in %s, got %d'
                         % (who, OUT_LENGTHS, out_len))
    if in_caps < 1 or out_caps < 1 or in_len < 1:
        raise ValueError('%s: empty capsule dimension in %s x %s'
                         % (who, tuple(x.shape), tuple(weight.shape)))
    if factored_limit and in_len == FACTORED_IN_LENGTH and \
            in_caps > MAX_IN_CAPSULES:
        raise ValueError('%s: the factored kernels take at most %d input '
                         'capsules, got %d' % (who, MAX_IN_CAPSULES, in_caps))
    if num_iterations < 1:
        raise ValueError('%s: num_iterations >= 1' % who)
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError('%s: x and weight must be contiguous' % who)
    if x.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError('%s: x and weight must be 16-byte aligned' % who)
    return bsz, in_caps, in_len, out_caps, out_len


class FactoredFwdPlan(NamedTuple):
    """How K1-G runs one call: W's planes, then the routing on ``cluster``
    blocks of 512 threads per sample (``blocks`` in all), rank r
    owning the output capsules ``slices[r]`` = [j0, j1), with
    ``smem_bytes`` of shared memory per block; its couplings stay in shared
    memory where ``in_smem``, else in a scratch of ``scratch_numel``
    floats."""
    cluster: int
    slices: Tuple[Tuple[int, int], ...]
    blocks: int
    smem_bytes: int
    in_smem: bool
    scratch_numel: int


def _factored_fwd_floats(I: int, J: int, cluster: int) -> Tuple[int, int]:
    """(floats always in shared memory, floats in shared memory or the
    scratch) per block of K1-G (``csrc/capsule_routing.cu::
    factored_fwd_layout``): x [I][8], a [nj][8], a row scale [I] and two
    exchange rows of 2 I floats, rounded up to whole float4; the couplings
    [I][ldp]; nj = ceil(J / cluster), ldp = nj rounded up to 32, plus 16."""
    nj = -(-J // cluster)
    ldp = -(-nj // 32) * 32 + 16
    small = I * FACTORED_IN_LENGTH + FACTORED_IN_LENGTH * nj + 5 * I
    return -(-small // 4) * 4, I * ldp


def factored_fwd_smem_bytes(I: int, J: int, cluster: int,
                            in_smem: bool) -> int:
    """Shared memory per block of K1-G's routing."""
    small, big = _factored_fwd_floats(I, J, cluster)
    return 4 * (small + (big if in_smem else 0))


def _factored_fwd_plan_at(B, I, J, cluster) -> FactoredFwdPlan:
    cluster = min(cluster, J)
    small, big = _factored_fwd_floats(I, J, cluster)
    keep = 4 * (small + big) <= MAX_SMEM_BYTES
    smem = factored_fwd_smem_bytes(I, J, cluster, keep)
    _check_smem(smem, 'the forward of %d in / %d out capsules at a cluster '
                'of %d' % (I, J, cluster))
    return FactoredFwdPlan(cluster, _slices(J, cluster), B * cluster, smem,
                           keep, 0 if keep else B * cluster * big)


def factored_fwd_plan(B: int, I: int, J: int, R: int, sms: int = 132,
                      cluster: Optional[int] = None,
                      max_clusters: Optional[Callable[[int, bool], int]] = None
                      ) -> FactoredFwdPlan:
    """K1-G's launch plan for x [B, I, 8], weight [J, O, 8] and R routing
    passes on a card of ``sms`` SMs: the couplings in shared memory where
    they fit, else in a scratch; raises ValueError where even the rest does
    not fit. ``cluster`` (one of ``FACTORED_CLUSTER_SIZES``, at most J)
    where given. Else, as ``factored_bwd_plan``: the largest cluster whose B
    clusters all run at once, B x cluster blocks one per SM, no more than the
    ``max_clusters(cluster, in_smem)`` that the card holds at once
    where that function is given and knows (3 at the flagship's B = 32 on
    an H100, 96 blocks of 341-342 output capsules); where no cluster holds
    the batch in one wave (the sampler's B = 320), the card's fastest in
    its sweep, ``FACTORED_FWD_MULTI_WAVE``. R sets no size: the forward
    keeps no stashes."""
    if R < 1:
        raise ValueError('factored_fwd_plan: R >= 1 routing passes')
    if cluster is not None:
        if cluster not in FACTORED_CLUSTER_SIZES:
            raise ValueError('factored_fwd_plan: cluster %d not in %s'
                             % (cluster, FACTORED_CLUSTER_SIZES))
        return _factored_fwd_plan_at(B, I, J, cluster)
    for c in sorted(FACTORED_CLUSTER_SIZES, reverse=True)[:-1]:
        if B * c > sms:
            continue
        p = _factored_fwd_plan_at(B, I, J, c)
        held = max_clusters(p.cluster, p.in_smem) if max_clusters else 0
        if held <= 0 or held >= B:
            return p
    return _factored_fwd_plan_at(B, I, J, FACTORED_FWD_MULTI_WAVE)


def fwd_card_clusters(device: torch.device, I: int, J: int, O: int
                      ) -> Callable[[int, bool], int]:
    """max_clusters for ``factored_fwd_plan``: what the card reports
    (``capsule_routing_fwd_max_clusters``), asked once per shape."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index

    def held(cluster: int, in_smem: bool) -> int:
        key = ('fwd', index, I, J, O, cluster, in_smem)
        if key not in _clusters:
            _clusters[key] = _kernels()['fwd_clusters'](
                I, J, O, cluster, int(in_smem), index)
        return _clusters[key]
    return held


def routing_fwd_factored(x: torch.Tensor, weight: torch.Tensor,
                         num_iterations: int,
                         plan: Optional[FactoredFwdPlan] = None
                         ) -> torch.Tensor:
    """K1-G, factored form: x [B, in, 8], weight [out, out_length, 8] ->
    [B, out, out_length], on the card, run as ``plan`` says (default:
    ``factored_fwd_plan`` for this card)."""
    bsz, in_caps, _, out_caps, out_len = _shapes(x, weight, num_iterations)
    out = torch.empty((bsz, out_caps, out_len), device=x.device,
                      dtype=torch.float32)
    if bsz == 0:
        return out
    if plan is None:  # the card's plan for this shape, made once
        key = (x.device.index, bsz, in_caps, out_caps, out_len,
               num_iterations)
        if key not in _fwd_plans:
            _fwd_plans[key] = factored_fwd_plan(
                bsz, in_caps, out_caps, num_iterations, _sm_count(x.device),
                max_clusters=fwd_card_clusters(x.device, in_caps, out_caps,
                                               out_len))
        plan = _fwd_plans[key]
    if plan.blocks != bsz * plan.cluster or plan.slices[-1][1] != out_caps:
        raise ValueError('capsule_routing: %s does not fit x %s, weight %s'
                         % (plan, tuple(x.shape), tuple(weight.shape)))
    k = _kernels()
    planes = torch.empty_like(weight)  # W's rows as float4 planes
    scratch = None
    if not plan.in_smem:
        scratch = torch.empty(plan.scratch_numel, device=x.device,
                              dtype=torch.float32)
    _check_launch(k['fwd'](
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), planes.data_ptr(),
        _ptr(scratch), bsz, in_caps, out_caps, out_len, num_iterations,
        plan.cluster, int(plan.in_smem), x.device.index, _stream(x)),
        'capsule_routing_fwd')
    routing_fwd_factored.launches += 1
    return out


class VotesFwdPlan(NamedTuple):
    """How K1-D runs one call: the vote product, then the routing on
    ``cluster`` blocks per sample (``blocks`` in all), rank r owning the
    output capsules ``slices[r]`` = [j0, j1), with ``smem_bytes`` of shared
    memory per block, which holds the block's vote slice where
    ``votes_in_smem``; the scratch u of ``votes_numel`` floats."""
    cluster: int
    slices: Tuple[Tuple[int, int], ...]
    blocks: int
    smem_bytes: int
    votes_in_smem: bool
    votes_numel: int


def _cluster_size(B: int, J: int, sms: int, cluster: Optional[int],
                  who: str) -> int:
    """The largest of ``CLUSTER_SIZES`` whose B x cluster blocks run in one
    wave of one block per SM, or ``cluster`` where given; never more than
    J, so that no slice is empty."""
    if cluster is None:
        fits = [c for c in CLUSTER_SIZES if B * c <= sms]
        cluster = max(fits) if fits else 1
    elif cluster not in CLUSTER_SIZES:
        raise ValueError('%s: cluster %d not in %s'
                         % (who, cluster, CLUSTER_SIZES))
    return min(cluster, J)


def _slices(J: int, cluster: int) -> Tuple[Tuple[int, int], ...]:
    """J split as evenly as integers allow, rank r from r J / cluster."""
    return tuple((r * J // cluster, (r + 1) * J // cluster)
                 for r in range(cluster))


def votes_fwd_smem_bytes(I: int, J: int, O: int, cluster: int,
                         votes_in_smem: bool) -> int:
    """Shared memory per block of K1-D's routing
    (``csrc/capsule_routing.cu::votes_fwd_smem_floats``): the vote slice
    [I][nj][O] where kept, the couplings and the logits [I][nj], the
    outputs [nj][O] and two exchange rows of 2 I floats,
    nj = ceil(J / cluster)."""
    nj = -(-J // cluster)
    return 4 * ((I * nj * O if votes_in_smem else 0) + 2 * I * nj + nj * O +
                4 * I)


def votes_fwd_plan(B: int, I: int, L: int, J: int, O: int, sms: int = 132,
                   cluster: Optional[int] = None) -> VotesFwdPlan:
    """K1-D's launch plan for x [B, I, L], weight [J, O, L] on a card of
    ``sms`` SMs: the cluster as ``votes_bwd_plan`` chooses it (4 at the
    flagship's B = 32: 128 blocks), the vote slice in shared memory where
    it fits; raises ValueError where even the rest does not."""
    cluster = _cluster_size(B, J, sms, cluster, 'votes_fwd_plan')
    keep = votes_fwd_smem_bytes(I, J, O, cluster, True) <= MAX_SMEM_BYTES
    smem = votes_fwd_smem_bytes(I, J, O, cluster, keep)
    _check_smem(smem, 'routing %d x %d votes at a cluster of %d'
                % (I, J, cluster))
    return VotesFwdPlan(cluster, _slices(J, cluster), B * cluster, smem, keep,
                        B * I * J * O)


def routing_fwd_votes(x: torch.Tensor, weight: torch.Tensor,
                      num_iterations: int,
                      plan: Optional[VotesFwdPlan] = None) -> torch.Tensor:
    """K1-D, materialised votes: x [B, in, L], weight [out, out_length, L]
    -> [B, out, out_length], on the card, run as ``plan`` says (default:
    ``votes_fwd_plan`` for this card)."""
    bsz, in_caps, in_len, out_caps, out_len = _shapes(x, weight,
                                                      num_iterations)
    out = torch.empty((bsz, out_caps, out_len), device=x.device,
                      dtype=torch.float32)
    if bsz == 0:
        return out
    if plan is None:
        plan = votes_fwd_plan(bsz, in_caps, in_len, out_caps, out_len,
                              _sm_count(x.device))
    if plan.votes_numel != bsz * in_caps * out_caps * out_len:
        raise ValueError('capsule_routing: %s does not fit x %s, weight %s'
                         % (plan, tuple(x.shape), tuple(weight.shape)))
    k = _kernels()
    votes = torch.empty(plan.votes_numel, device=x.device,
                        dtype=torch.float32)
    _check_launch(k['fwd_votes'](
        x.data_ptr(), weight.data_ptr(), votes.data_ptr(), out.data_ptr(),
        bsz, in_caps, in_len, out_caps, out_len, num_iterations, plan.cluster,
        int(plan.votes_in_smem), x.device.index, _stream(x)),
        'capsule_routing_votes_fwd')
    routing_fwd_votes.launches += 1
    return out


def _grad_outputs(x, weight, need_dx, need_dw):
    dx = torch.empty_like(x) if need_dx else None
    dw = torch.empty_like(weight) if need_dw else None
    return dx, dw


class FactoredBwdPlan(NamedTuple):
    """How K2-G runs one call: the routing reversal on ``cluster`` blocks
    per sample (``blocks`` in all), rank r owning the output capsules
    ``slices[r]`` = [j0, j1), with ``smem_bytes`` of shared memory per
    block; its stashes, couplings and logit gradient stay in shared memory
    where ``in_smem``, else in a scratch of ``scratch_numel`` floats."""
    cluster: int
    slices: Tuple[Tuple[int, int], ...]
    blocks: int
    smem_bytes: int
    in_smem: bool
    scratch_numel: int


def _factored_floats(I: int, J: int, R: int, cluster: int
                     ) -> Tuple[int, int]:
    """(floats always in shared memory, floats in shared memory or the
    scratch) per block of K2-G (``csrc/capsule_routing_bwd.cu::
    factored_layout``): x and the dx partial [I][8], a (forward) or e
    (reverse) [nj][8], the statistics [R][I] twice, a row scale [I] and two
    exchange rows of 2 I floats, rounded up to whole float4; the stashes of
    a and y [R][nj][8], c and db [I][ldp]; nj = ceil(J / cluster), ldp = nj
    rounded up to 32, plus 16."""
    nj = -(-J // cluster)
    ldp = -(-nj // 32) * 32 + 16
    small = 2 * I * FACTORED_IN_LENGTH + FACTORED_IN_LENGTH * nj + \
        2 * R * I + 5 * I
    return -(-small // 4) * 4, 2 * R * FACTORED_IN_LENGTH * nj + 2 * I * ldp


def factored_bwd_smem_bytes(I: int, J: int, R: int, cluster: int,
                            in_smem: bool) -> int:
    """Shared memory per block of K2-G."""
    small, big = _factored_floats(I, J, R, cluster)
    return 4 * (small + (big if in_smem else 0))


def _factored_plan_at(B, I, J, R, cluster) -> FactoredBwdPlan:
    cluster = min(cluster, J)
    small, big = _factored_floats(I, J, R, cluster)
    keep = 4 * (small + big) <= MAX_SMEM_BYTES
    smem = factored_bwd_smem_bytes(I, J, R, cluster, keep)
    _check_smem(smem, 'the backward of %d in / %d out capsules at a cluster '
                'of %d' % (I, J, cluster))
    return FactoredBwdPlan(cluster, _slices(J, cluster), B * cluster, smem,
                           keep, 0 if keep else B * cluster * big)


def factored_bwd_plan(B: int, I: int, J: int, R: int, sms: int = 132,
                      cluster: Optional[int] = None,
                      max_clusters: Optional[Callable[[int, bool], int]] = None
                      ) -> FactoredBwdPlan:
    """K2-G's launch plan for x [B, I, 8], weight [J, O, 8] and R routing
    passes on a card of ``sms`` SMs: everything in shared memory where it
    fits, else the stashes, couplings and logit gradient in a scratch;
    raises ValueError where even the rest does not fit. The cluster is
    ``cluster`` where given (one of ``FACTORED_CLUSTER_SIZES``, at most J),
    else the largest of them whose B clusters all run at once: B x cluster
    blocks of one per SM, and no more than the ``max_clusters(cluster,
    in_smem)`` that the card holds at once, where that function is given
    and knows (a positive count). At the flagship's B = 32 on an H100: 4
    where all 32 clusters of 4 fit, else 3 (96 blocks of 341-342 output
    capsules)."""
    if cluster is not None:
        if cluster not in FACTORED_CLUSTER_SIZES:
            raise ValueError('factored_bwd_plan: cluster %d not in %s'
                             % (cluster, FACTORED_CLUSTER_SIZES))
        return _factored_plan_at(B, I, J, R, cluster)
    for c in sorted(FACTORED_CLUSTER_SIZES, reverse=True)[:-1]:
        if B * c > sms:
            continue
        p = _factored_plan_at(B, I, J, R, c)
        held = max_clusters(p.cluster, p.in_smem) if max_clusters else 0
        if held <= 0 or held >= B:
            return p
    return _factored_plan_at(B, I, J, R, 1)


def card_clusters(device: torch.device, I: int, J: int, O: int, R: int
                  ) -> Callable[[int, bool], int]:
    """max_clusters for ``factored_bwd_plan``: what the card reports
    (``capsule_routing_bwd_max_clusters``), asked once per shape."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index

    def held(cluster: int, in_smem: bool) -> int:
        key = (index, I, J, O, R, cluster, in_smem)
        if key not in _clusters:
            _clusters[key] = _kernels()['bwd_clusters'](
                I, J, O, R, cluster, int(in_smem), index)
        return _clusters[key]
    return held


def routing_bwd_factored(x: torch.Tensor, weight: torch.Tensor,
                         dv: torch.Tensor, num_iterations: int,
                         need_dx: bool = True, need_dw: bool = True,
                         plan: Optional[FactoredBwdPlan] = None):
    """K2-G, factored form: (dx [B, in, 8] or None, dweight [out,
    out_length, 8] summed over the batch, or None), on the card, run as
    ``plan`` says (default: ``factored_bwd_plan`` for this card)."""
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
    if plan is None:
        plan = factored_bwd_plan(
            bsz, in_caps, out_caps, num_iterations, _sm_count(x.device),
            max_clusters=card_clusters(x.device, in_caps, out_caps, out_len,
                                        num_iterations))
    k = _kernels()
    planes = torch.empty_like(weight)  # W's rows as float4 planes
    scratch = None
    if not plan.in_smem:
        scratch = torch.empty(plan.scratch_numel, device=x.device,
                              dtype=torch.float32)
    fp = fq = None
    if need_dw:  # the dW factors: two pairs a routing pass
        pairs = 2 * num_iterations
        fp = torch.empty((bsz, pairs, out_caps, out_len), device=x.device,
                         dtype=torch.float32)
        fq = torch.empty((bsz, pairs, out_caps, FACTORED_IN_LENGTH),
                         device=x.device, dtype=torch.float32)
    _check_launch(k['bwd'](
        x.data_ptr(), weight.data_ptr(), dv.data_ptr(), _ptr(dx), _ptr(dw),
        planes.data_ptr(), _ptr(scratch), _ptr(fp), _ptr(fq), bsz, in_caps,
        out_caps, out_len, num_iterations, plan.cluster, int(plan.in_smem),
        x.device.index, _stream(x)), 'capsule_routing_bwd')
    routing_bwd_factored.launches += 1
    return dx, dw


class VotesBwdPlan(NamedTuple):
    """How K2-D runs one call: the routing on ``cluster`` blocks per sample
    (``blocks`` in all), rank r owning the output capsules
    ``slices[r]`` = [j0, j1), with ``smem_bytes`` of shared memory per
    block, which holds the block's vote slice where ``votes_in_smem``; the
    scratch u and du of ``votes_numel`` floats each; dx's product split
    over K = J O into ``dx_splits`` runs of ``dx_chunk``, with a
    ``partial_numel``-float scratch where it splits."""
    cluster: int
    slices: Tuple[Tuple[int, int], ...]
    blocks: int
    smem_bytes: int
    votes_in_smem: bool
    votes_numel: int
    dx_splits: int
    dx_chunk: int
    partial_numel: int


def votes_bwd_smem_bytes(I: int, J: int, O: int, R: int, cluster: int,
                         votes_in_smem: bool) -> int:
    """Shared memory per block of K2-D's routing
    (``csrc/capsule_routing_bwd.cu::cluster_smem_floats``): the vote slice
    [I][nj][O] where kept, the stashes c and db [R][I][nj] and s, ds and v
    [R][nj][O], the logits [I][nj], dv [nj][O] and two exchange rows of
    2 I floats, nj = ceil(J / cluster)."""
    nj = -(-J // cluster)
    return 4 * ((I * nj * O if votes_in_smem else 0) + 2 * R * I * nj +
                3 * R * nj * O + I * nj + nj * O + 4 * I)


def votes_bwd_plan(B: int, I: int, L: int, J: int, O: int, R: int,
                   sms: int = 132, cluster: Optional[int] = None
                   ) -> VotesBwdPlan:
    """K2-D's launch plan for x [B, I, L], weight [J, O, L] and R routing
    passes on a card of ``sms`` SMs. The cluster is the largest of
    ``CLUSTER_SIZES`` whose B x cluster blocks run in one wave of one block
    per SM (4 at the flagship's B = 32: 128 blocks), or ``cluster`` where
    given; never more than J, so that no slice is empty. Slices split J as
    evenly as integers allow (rank r from r J / C). The vote slice stays in
    shared memory where it fits; raises ValueError where even the stashes
    do not. dx's product (B I x L in tiles of 128 x 104, one block per SM)
    splits its K into runs of whole 32-deep steps, as many as fill the SMs
    once."""
    cluster = _cluster_size(B, J, sms, cluster, 'votes_bwd_plan')
    keep = votes_bwd_smem_bytes(I, J, O, R, cluster, True) <= MAX_SMEM_BYTES
    smem = votes_bwd_smem_bytes(I, J, O, R, cluster, keep)
    if smem > MAX_SMEM_BYTES:
        raise ValueError('capsule_routing: the backward of %d x %d votes '
                         'needs %d bytes of shared memory per block at a '
                         'cluster of %d, more than %d'
                         % (I, J, smem, cluster, MAX_SMEM_BYTES))
    steps = -(-J * O // GEMM_BK)
    tiles = -(-B * I // GEMM_BM) * -(-L // GEMM_BN)
    splits = max(1, min(steps, sms // tiles))
    chunk = -(-steps // splits) * GEMM_BK
    splits = -(-J * O // chunk)
    return VotesBwdPlan(cluster, _slices(J, cluster), B * cluster, smem, keep,
                        B * I * J * O, splits, chunk,
                        splits * B * I * L if splits > 1 else 0)


def routing_bwd_votes(x: torch.Tensor, weight: torch.Tensor,
                      dv: torch.Tensor, num_iterations: int,
                      need_dx: bool = True, need_dw: bool = True,
                      plan: Optional[VotesBwdPlan] = None):
    """K2-D, materialised votes: (dx [B, in, L] or None, dweight [out,
    out_length, L] summed over the batch, or None), on the card, run as
    ``plan`` says (default: ``votes_bwd_plan`` for this card)."""
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
    if plan is None:
        plan = votes_bwd_plan(bsz, in_caps, in_len, out_caps, out_len,
                              num_iterations, _sm_count(x.device))
    if plan.votes_numel != bsz * in_caps * out_caps * out_len or \
            plan.partial_numel < (plan.dx_splits * bsz * in_caps * in_len
                                  if plan.dx_splits > 1 else 0):
        raise ValueError('capsule_routing: %s does not fit x %s, weight %s'
                         % (plan, tuple(x.shape), tuple(weight.shape)))
    k = _kernels()
    votes = torch.empty(plan.votes_numel, device=x.device,
                        dtype=torch.float32)
    dvotes = torch.empty_like(votes)
    partial = None
    if need_dx and plan.dx_splits > 1:
        partial = torch.empty(plan.partial_numel, device=x.device,
                              dtype=torch.float32)
    _check_launch(k['bwd_votes'](
        x.data_ptr(), weight.data_ptr(), dv.data_ptr(), _ptr(dx), _ptr(dw),
        votes.data_ptr(), dvotes.data_ptr(), _ptr(partial), bsz, in_caps,
        in_len, out_caps, out_len, num_iterations, plan.cluster,
        int(plan.votes_in_smem), plan.dx_splits, plan.dx_chunk,
        x.device.index, _stream(x)), 'capsule_routing_votes_bwd')
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


def tf32x3_matmul_reference(a: torch.Tensor, b: torch.Tensor
                            ) -> torch.Tensor:
    """a @ b as K2-D's products compute it (``csrc/gemm_tf32x3.cuh``): each
    float32 operand split into hi = tf32(v) and lo = tf32(v - hi), and
    lo.hi + hi.lo + hi.hi accumulated in float32 (lo.lo dropped); up to the
    order of the float32 sums."""
    ah = round_tf32(a)
    bh = round_tf32(b)
    al = round_tf32(a - ah)
    bl = round_tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _squash_grad(n2: torch.Tensor):
    """The squash scale g(n2) and dg/dn2 as the kernels compute them."""
    inv1, rs = 1 / (1 + n2), torch.rsqrt(n2 + 1e-8)
    return (n2 * inv1 * rs,
            inv1 * rs - n2 * inv1 * inv1 * rs - 0.5 * n2 * inv1 * rs ** 3)


def votes_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                        dv: torch.Tensor, num_iterations: int,
                        need_dx: bool = True, need_dw: bool = True,
                        matmul=torch.matmul):
    """K2-D's algorithm in plain PyTorch: the vote product u = x W^T, the
    routing recomputed with its stashes (c, s, v of every pass), reversed
    through the squash, the softmax and the agreement update into du, and
    dx = du W, dW = du^T x. ``matmul`` computes the three products
    (``tf32x3_matmul_reference`` emulates the kernel's). Returns (dx or
    None, dW or None)."""
    bsz, in_caps, in_len = x.shape
    out_caps, out_len = weight.shape[:2]
    x2 = x.reshape(bsz * in_caps, in_len)
    w2 = weight.reshape(out_caps * out_len, in_len)
    u = matmul(x2, w2.t()).view(bsz, in_caps, out_caps, out_len)
    logits = torch.zeros((bsz, in_caps, out_caps), dtype=u.dtype,
                         device=u.device)
    cs, ss, vs = [], [], []
    for r in range(num_iterations):
        c = torch.softmax(logits, dim=2)
        s = torch.einsum('bij,bijo->bjo', c, u)
        n2 = (s * s).sum(-1, keepdim=True)
        v = s * (n2 / (1 + n2) * torch.rsqrt(n2 + 1e-8))
        cs.append(c)
        ss.append(s)
        vs.append(v)
        if r < num_iterations - 1:
            logits = logits + torch.einsum('bijo,bjo->bij', u, v)
    du = torch.zeros_like(u)
    grad_v, db = dv, 0
    for r in reversed(range(num_iterations)):
        s, c = ss[r], cs[r]
        g, gp = _squash_grad((s * s).sum(-1, keepdim=True))
        ds = grad_v * g + s * (2 * (grad_v * s).sum(-1, keepdim=True) * gp)
        dc = torch.einsum('bijo,bjo->bij', u, ds)
        db = c * (dc - (c * dc).sum(2, keepdim=True)) + db
        du = du + c[..., None] * ds[:, None]
        if r > 0:
            du = du + db[..., None] * vs[r - 1][:, None]
            grad_v = torch.einsum('bij,bijo->bjo', db, u)
    du2 = du.reshape(bsz * in_caps, out_caps * out_len)
    return (matmul(du2, w2).view(x.shape) if need_dx else None,
            matmul(du2.t(), x2).view(weight.shape) if need_dw else None)


def votes_fwd_reference(x: torch.Tensor, weight: torch.Tensor,
                        num_iterations: int,
                        matmul=torch.matmul) -> torch.Tensor:
    """K1-D's algorithm in plain PyTorch: the vote product u = x W^T,
    computed by ``matmul`` (``tf32x3_matmul_reference`` emulates the
    kernel's), then the plain routing over u."""
    bsz, in_caps, in_len = x.shape
    out_caps, out_len = weight.shape[:2]
    u = matmul(x.reshape(bsz * in_caps, in_len),
               weight.reshape(out_caps * out_len, in_len).t())
    return dynamic_routing(u.view(bsz, in_caps, out_caps, out_len),
                           num_iterations)


def _factored_forward(x, w, num_iterations, slices):
    """The factored forward passes over the output capsules split into
    ``slices``: each slice's (max, sum of exp) of every logit row, combined
    over the slices in rank order, the couplings c = exp(b - max_slice)
    exp(max_slice - max) / sum, y_j = sum_i c_ij x_i, a_j += W_j^T v_j with
    v_j = squash(W_j y_j). Returns (a and y of every pass, (max, 1/sum) of
    every pass, the last pass's v)."""
    a = x.new_zeros((x.shape[0], w.shape[0], x.shape[2]))
    stash_a, stash_y, stats = [], [], []
    for r in range(num_iterations):
        logits = torch.einsum('bil,bjl->bij', x, a)
        parts = []
        for j0, j1 in slices:
            mq = logits[:, :, j0:j1].amax(2, keepdim=True)
            pq = torch.exp(logits[:, :, j0:j1] - mq)
            parts.append((mq, pq.sum(2, keepdim=True), pq))
        m = parts[0][0]
        for mq, _, _ in parts[1:]:
            m = torch.maximum(m, mq)
        z = 0
        for mq, zq, _ in parts:
            z = z + zq * torch.exp(mq - m)
        zi = 1 / z
        c = torch.cat([pq * (torch.exp(mq - m) * zi) for mq, _, pq in parts],
                      2)
        y = torch.einsum('bij,bil->bjl', c, x)
        stash_a.append(a)
        stash_y.append(y)
        stats.append((m, zi))
        s = torch.einsum('jol,bjl->bjo', w, y)
        g, _ = _squash_grad((s * s).sum(-1, keepdim=True))
        if r < num_iterations - 1:
            a = a + torch.einsum('bjo,jol->bjl', g * s, w)
    return stash_a, stash_y, stats, g * s


def factored_fwd_reference(x: torch.Tensor, weight: torch.Tensor,
                           num_iterations: int,
                           cluster: int = 1) -> torch.Tensor:
    """K1-G's algorithm in plain PyTorch, for x [B, I, 8] and weight [J, O,
    8]: the output capsules split into ``cluster`` slices as
    ``factored_fwd_plan`` splits them, each slice's softmax statistics
    combined in rank order, the votes never formed (``_factored_forward``);
    returns the last pass's v [B, J, O]."""
    slices = _slices(weight.shape[0], min(cluster, weight.shape[0]))
    return _factored_forward(x, weight, num_iterations, slices)[3]


def factored_bwd_reference(x: torch.Tensor, weight: torch.Tensor,
                           dv: torch.Tensor, num_iterations: int,
                           cluster: int = 1, need_dx: bool = True,
                           need_dw: bool = True):
    """K2-G's algorithm in plain PyTorch, for x [B, I, 8] and weight [J, O,
    8]: the output capsules split into ``cluster`` slices as
    ``factored_bwd_plan`` splits them, the votes never formed. Forward:
    ``_factored_forward``, the a_j and y_j of every pass stashed. Reverse,
    per pass: ds_j through the squash, e_j =
    W_j^T ds_j, the couplings recomputed, rho_i = sum_j c_ij x_i . e_j
    summed over the slices in rank order, the logit gradient db, each
    slice's part of dx and the previous pass's dv_j = W_j z_j with z_j =
    sum_i db_ij x_i; dx summed over the slices in rank order, dW from the
    factors (ds_j, y_j) and (v_j, z_j). Returns (dx or None, dW or None)."""
    out_caps = weight.shape[0]
    R = num_iterations
    slices = _slices(out_caps, min(cluster, out_caps))
    w = weight
    stash_a, stash_y, stats, _ = _factored_forward(x, w, R, slices)
    dx_parts = [x.new_zeros(x.shape) for _ in slices]
    dw = torch.zeros_like(w)
    grad_v, db = dv, None
    for r in reversed(range(R)):
        y = stash_y[r]
        s = torch.einsum('jol,bjl->bjo', w, y)
        g, gp = _squash_grad((s * s).sum(-1, keepdim=True))
        ds = grad_v * g + s * (2 * (grad_v * s).sum(-1, keepdim=True) * gp)
        e = torch.einsum('bjo,jol->bjl', ds, w)
        dw = dw + torch.einsum('bjo,bjl->jol', ds, y)
        m, zi = stats[r]
        c = torch.exp(torch.einsum('bil,bjl->bij', x, stash_a[r]) - m) * zi
        dc = torch.einsum('bil,bjl->bij', x, e)
        rho = 0
        for j0, j1 in slices:
            rho = rho + (c * dc)[:, :, j0:j1].sum(2, keepdim=True)
        if r > 0:
            db = c * (dc - rho) + (0 if db is None else db)
            t = stash_a[r] - stash_a[r - 1]
        for part, (j0, j1) in zip(dx_parts, slices):
            part += torch.einsum('bij,bjl->bil', c[:, :, j0:j1],
                                 e[:, j0:j1])
            if r > 0:
                part += torch.einsum('bij,bjl->bil', db[:, :, j0:j1],
                                     t[:, j0:j1])
        if r > 0:
            zr = torch.einsum('bij,bil->bjl', db, x)
            grad_v = torch.einsum('jol,bjl->bjo', w, zr)
            sp = torch.einsum('jol,bjl->bjo', w, stash_y[r - 1])
            gprev, _ = _squash_grad((sp * sp).sum(-1, keepdim=True))
            dw = dw + torch.einsum('bjo,bjl->jol', gprev * sp, zr)
    dx = dx_parts[0]
    for part in dx_parts[1:]:
        dx = dx + part
    return (dx if need_dx else None), (dw if need_dw else None)


def _on_cpu(x, weight) -> bool:
    return x.device.type == 'cpu' and weight.device.type == 'cpu'


def _plain_forward(x, weight, num_iterations):
    return capsule_linear(x, weight, num_iterations, 'dynamic')


def _form(x, weight, backward: bool):
    """(the head a call serves, the name of the kernel that runs it in
    ``KERNELS``, or 'plain' on the CPU, and its function): the in_length
    picks the form."""
    head = 'G' if x.shape[-1] == FACTORED_IN_LENGTH else 'D'
    if _on_cpu(x, weight):
        return head, 'plain', _plain_backward if backward else _plain_forward
    name = ('K2-' if backward else 'K1-') + head
    return head, name, KERNELS[name]


class CapsuleRoutingFunction(torch.autograd.Function):
    """Dynamic routing with a hand-written forward (K1) and backward (K2)
    on CUDA tensors; on CPU tensors the plain routing and its autograd.
    Each call is a ``capsule.fwd`` or ``capsule.bwd`` span (``spans.py``)
    that names its head and kernel."""

    @staticmethod
    def forward(ctx, x, weight, num_iterations):
        ctx.save_for_backward(x, weight)
        ctx.num_iterations = num_iterations
        head, kernel, fwd = _form(x, weight, backward=False)
        with spans.span('capsule.fwd', head=head, kernel=kernel):
            return fwd(x, weight, num_iterations)

    @staticmethod
    def backward(ctx, dv):
        x, weight = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        head, kernel, bwd = _form(x, weight, backward=True)
        with spans.span('capsule.bwd', head=head, kernel=kernel):
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
