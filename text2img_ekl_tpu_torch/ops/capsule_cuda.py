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
  is materialised, then routed (``capsule_routing_votes_fwd``, a tiled
  float32 product and one block per sample) or reversed
  (``capsule_routing_votes_bwd``, K2-D: float32-faithful 3xTF32 products on
  the tensor cores and a cluster of blocks per sample, as
  ``votes_bwd_plan`` chooses). ``votes_bwd_reference`` is K2-D's algorithm
  in plain PyTorch, and ``tf32x3_matmul_reference`` emulates its products.

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
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .capsule import capsule_linear

FACTORED_IN_LENGTH = 8    # the factored kernels' capsule rows are two float4
OUT_LENGTHS = (16, 32)    # instantiated templates (csrc/*.cu)
MAX_IN_CAPSULES = 512     # factored form: one thread per input capsule in
                          # the reductions
MAX_SMEM_BYTES = 232448   # dynamic shared memory one block may use on sm_90
# K2-D (csrc/capsule_routing_bwd.cu, csrc/gemm_tf32x3.cuh): the cluster
# sizes its plan picks from (8 is the portable maximum), and the products'
# block tile (rows, columns, K depth)
CLUSTER_SIZES = (1, 2, 4, 8)
GEMM_BM, GEMM_BN, GEMM_BK = 128, 104, 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = None
_sms = {}


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
    if cluster is None:
        fits = [c for c in CLUSTER_SIZES if B * c <= sms]
        cluster = max(fits) if fits else 1
    elif cluster not in CLUSTER_SIZES:
        raise ValueError('votes_bwd_plan: cluster %d not in %s'
                         % (cluster, CLUSTER_SIZES))
    cluster = min(cluster, J)
    slices = tuple((r * J // cluster, (r + 1) * J // cluster)
                   for r in range(cluster))
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
    return VotesBwdPlan(cluster, slices, B * cluster, smem, keep,
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


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest tf32 value (10 stored significand bits),
    ties away from zero, by bit arithmetic on the float32 pattern, as
    ``cvt.rna.tf32.f32`` rounds; infinities and NaNs pass unchanged."""
    bits = a.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(a), rounded, a.float())


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
        n2 = (s * s).sum(-1, keepdim=True)
        inv1, rs = 1 / (1 + n2), torch.rsqrt(n2 + 1e-8)
        g = n2 * inv1 * rs
        gp = inv1 * rs - n2 * inv1 * inv1 * rs - 0.5 * n2 * inv1 * rs ** 3
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
