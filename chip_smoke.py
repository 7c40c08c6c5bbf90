#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (built for
an H100: the kernels compile for sm_90a). Phases, each printing what it
found; any failure raises and exits non-zero:

  1. build the CUDA kernels from text2img_ekl_tpu_torch/csrc with nvcc, one
     process per source, all at once; print ptxas's registers and spills
     per kernel and, from cuobjdump -sass, the tensor-core instructions of
     the 3xTF32 product kernels of K1-D and K2-D and of K4's float32 body
     (with its registers and spills, which must not grow);
  2. hold the factored capsule-routing forward (K1-G) to the plain PyTorch
     routing on the card, float32 with TF32 off, at the sampler's batch
     (B=320) and the training batch (B=32) of the generator head and at a
     ragged shape, with the plan it takes and with every cluster size of
     its sweep; check that two calls give the same bits;
  3. drive the serving path: the port's CondGANTrainer.evaluate on
     cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml (synthetic data, full
     width GF_DIM 64, 32 images x 10 captions, 2 batches) with a seeded
     random generator (BatchNorm statistics set from one random batch)
     saved to a .pth; check that K1-G ran once per sampler call and that
     the expected PNGs were written;
  4. the same weights and draws at B=4: the generator on the card (K1)
     against the generator on the CPU (plain routing), float32 with float32
     BatchNorm; and the config's compute and BatchNorm dtypes (bfloat16) on
     the card against the same reference;
  5. time K1-G against the plain routing at the sampler's shape (B=320):
     its plan, its device time by kernel (W planes, routing), its bound and
     its sweep over cluster sizes in turns; and the caption
     sampler's images/s at the config's compute dtype;
  6. the same for K1-G at the training batch (B=32); hold K1-D (the votes
     form, the discriminator class head) to the plain routing at B=32 and
     at a ragged shape; time it beside its bound (the 3xTF32 vote product
     and the routing) and sweep its cluster size;
  7. hold K2-G and K2-D (the backward kernels) to autograd through the
     plain routing at B=32, and time kernels and plain versions; K2-G with
     its plan and a sweep of its cluster size; K2-D both with dx and dW and
     with dx only, with its plan (cluster size, blocks) and its bound split
     into the 3xTF32 products and the routing;
  8. drive the training path: CondGANTrainer.train(max_steps=3) on
     cfg/birds_2stg_splitz_cap_ca.realcls.yml at full width (GF_DIM and
     DF_DIM 64, batch 32, 64 and 128 px, bf16 compute) on synthetic data;
     check finite losses, that G and D parameters moved, and the kernel
     launches per step; time the step;
  9. one step on the card against one on the CPU at GF/DF_DIM 16, batch 4,
     float32 compute and BatchNorm (TF32 off for matmuls and cuDNN), same
     weights and draws; once as configured and once with TPU_FUSED_BN_GLU
     and TPU_PALLAS_DW on;
 10. hold K3 (the fused BN+GLU) to its plain version at every flagship
     tail shape: bfloat16 in and out with the affine in bfloat16 (the
     flagship's BatchNorm dtype) and in float32, and float32 throughout;
     time each;
 11. hold K4 (the 3x3 conv weight gradient) to its plain version at every
     flagship shape inside the envelope, bfloat16 and float32, check that
     two calls on the same inputs are bit-identical and that the float32
     body (3xTF32) is float32-faithful (its max error against the float64
     contraction at most twice the float32 plain version's), and time it in
     turns with cuDNN's weight gradient (the yardstick; the port never
     calls it) and the plain version, with each time over its bound (the
     float32 body's at 3xTF32 on the tensor cores) and over cuDNN's;
 12. the flagship sampler with TPU_FUSED_BN_GLU on (eval mode, B=320):
     K3's launches per call, images against the unfused sampler on the
     same weights (held to the bars with float32 BatchNorm on both sides,
     to the mean bar with the config's bfloat16 BatchNorm, where the max
     is reported), both timed in turns;
 13. drive the training path with both switches on: train(max_steps=2) at
     full width, the launches of all six kernels per step; then the step
     with both switches off and on, timed in turns in this one call; and
     one full-width step with both switches in float32 compute and
     BatchNorm, the path of K4's float32 body, with its launches;
 14. drive the capsule microbenchmark's variant sweep
     (tools/bench_capsule_torch.py --variants) at the generator head, B=32
     and B=320, and the discriminator head, B=32: it holds the three
     batch-blocked routing variants (V-stored, V-seq, V-recompute) at every
     NB it sweeps to the plain routing at K1's bar and times each in turns
     with K1; check the launches of every kernel in that run;
 15. checkpoint and resume on the card at the flagship's full width (bf16,
     batch 32, a snapshot every epoch, no IS stream; every trainer's loader
     repeats the same 2 batches): run A trains 4 steps; run B trains 2 and
     writes state_epoch0, and a new trainer on its directory resumes (step
     2, epoch 1) and trains 2 more, launching the kernels of 2 steps and a
     run; A's and B's final parameters, BatchNorm buffers, Adam moments and
     steps must be bit-identical; the snapshot's bytes on disk and its save
     and restore seconds; a SIGTERM after a step writes a snapshot, train()
     returns and the handlers are restored.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, where
torch finds no CUDA device or the package is not beside this file.
"""

from __future__ import annotations

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(ROOT, 'cfg', 'birds_2stg_splitz_cap_ca_eval.realcls.yml')
TRAIN_CFG = os.path.join(ROOT, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
WORK = os.path.join(ROOT, 'output', 'chip_smoke')

FLAGSHIP = (320, 48, 1024, 32)   # B = 32 images x 10 captions
RAGGED = (3, 13, 1000, 32)
# the training path's capsule heads at batch 32: (B, in, in_length, out,
# out_length)
G_HEAD = (32, 48, 8, 1024, 32)
D_HEAD = (32, 16, 512, 201, 16)
D_RAGGED = (3, 5, 24, 37, 16)
ITERS = 3
# K1 vs the plain routing: |d| <= K1_RTOL |ref| + K1_ATOL max|ref|, the JAX
# Pallas kernel's bar (rtol 1e-4, atol 1e-5 at unit-scale outputs) with
# the atol scaled to the output's magnitude
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# K2 vs autograd through the plain routing, for dx and for dW: the
# backward sums over more terms (dW over every sample and input capsule)
# and the softmax pullback subtracts nearly equal row sums
K2_RTOL, K2_ATOL = 1e-3, 1e-4
IMAGE_ATOL = 1e-3                # CUDA vs CPU generator, tanh images
BATCHES = 2
TRAIN_STEPS = 3
# launches per training step on the flagship, counted from the step's
# code (text2img_ekl_tpu_torch/train/step.py): phase 2 runs 3 forwards
# (real, wrong, fake) through each of the 2 D class heads but only 2
# backwards, since the wrong pass's class log-probs enter no loss
# (errD_cls = ce(real) + ce(fake)); phase 3 runs one more forward and
# backward per D; the G head runs one forward and one backward. The epoch
# grid adds one K1-G launch per run.
# The variants V run on the microbenchmark's path only (phase 14).
V_ZERO = {'V-stored': 0, 'V-seq': 0, 'V-recompute': 0}
PER_STEP = dict(V_ZERO, **{'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6,
                           'K3': 0, 'K4': 0})
PER_RUN = dict(V_ZERO, **{'K1-G': 1, 'K1-D': 0, 'K2-G': 0, 'K2-D': 0,
                          'K3': 0, 'K4': 0})
# with TPU_FUSED_BN_GLU and TPU_PALLAS_DW: K3 at the 8 BN+GLU tails of each
# G forward (the step's and the epoch grid's); K4 at the 5 G convs whose
# weight gradient lies inside the envelope (two ResBlocks' two convs at
# 64 px, the stage-2 upsample conv at 128 px; the joint conv and the
# stage-1 convs have C > 64, the toRGB convs F = 3, the D convs run at 4x4)
SWITCHES = {'TPU_FUSED_BN_GLU': True, 'TPU_PALLAS_DW': True}
PER_STEP_FUSED = dict(PER_STEP, K3=8, K4=5)
PER_RUN_FUSED = dict(PER_RUN, K3=8)
FUSED_TRAIN_STEPS = 2
# K3's inputs at the flagship, batch 32, NCHW: the BN input of each fused
# tail [B, 2C, H, W] and its launches per G forward
K3_SHAPES = (((32, 1024, 8, 8), 1), ((32, 512, 16, 16), 1),
             ((32, 256, 32, 32), 1), ((32, 128, 64, 64), 4),
             ((32, 64, 128, 128), 1))
# K4's inputs at the flagship: (x [B, C, H, W], F) and launches per step
K4_SHAPES = (((32, 64, 64, 64), 128, 2), ((32, 64, 64, 64), 64, 2),
             ((32, 64, 128, 128), 64, 1))
# phase 14: the microbenchmark runs (batch, --shape); the first is the
# record's shape for V (the sampler's batch at the generator head)
V_RUNS = ((320, '48,8,1024,32'), (32, '48,8,1024,32'), (32, '16,512,201,16'))
# K3 vs its plain version: float32 |d| <= 1e-6 |ref| + 1e-6; bfloat16 one
# bfloat16 ulp of the reference (both round one float32 value once)
K3_TOL = 1e-6
# K4 vs its plain version: |d| <= 1e-3 |ref| + 1e-4 max|ref| (float32 sums
# over up to 524,288 terms in another order)
K4_RTOL, K4_ATOL = 1e-3, 1e-4
# ptxas's spill stores and loads (bytes) in K4's float32 body: its 128
# registers hold the running sums, a K-step's partial and A's fragments, and
# 16 bytes of run-loop state spill, reloaded once a run (none in the K-step
# loop); more means a spill that may have moved into the loop
K4_F32_SPILLS = (16, 56)
# CUDA vs CPU step (float32): metrics |d| <= 1e-3 |ref| + 1e-5; first
# moments per tensor ||d|| <= 1e-2 ||ref|| + 1e-5 max|ref over the net|
# (cuDNN and oneDNN sum convolutions in other orders; a LeakyReLU input
# within rounding of zero takes the other slope; biases that feed a
# BatchNorm have zero gradient in exact arithmetic)
STEP_RTOL, STEP_ATOL = 1e-3, 1e-5
MOMENT_RTOL, MOMENT_ATOL = 1e-2, 1e-5
# the card's peaks (H100 SXM data sheet): float32 outside the tensor cores,
# dense bfloat16 on the tensor cores (the bound of a bf16 kernel: the TPU
# kernels contract bf16 on the matrix unit) and device-memory bandwidth
F32_FLOPS, BF16_FLOPS, HBM_BYTES = 67e12, 989e12, 3.35e12
# dense TF32 on the tensor cores: the vote products of K1-D and K2-D run
# there, each float32 product as three tf32 ones (3xTF32)
TF32_FLOPS = 495e12


def _cuobjdump():
    """The toolkit's cuobjdump, or Triton's copy of it."""
    import importlib.util
    found = shutil.which('cuobjdump')
    cands = [found] if found else []
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cands.append(os.path.join(home, 'bin', 'cuobjdump'))
    spec = importlib.util.find_spec('triton')
    if spec and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), 'backends',
                                  'nvidia', 'bin', 'cuobjdump'))
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError('cuobjdump not found (PATH, $CUDA_HOME/bin, '
                       'triton): the SASS of the products cannot be shown')


def _tensor_core_sass(lib, who, names=('gemm_tf32x3', 'gemm_kernel')):
    """{3xTF32 kernel (mangled name): {tensor-core opcode: count}} from
    cuobjdump -sass of ``lib``, for the kernels whose names hold all of
    ``names`` (by default the 3xTF32 product kernels); raises where ``lib``
    has no such kernel or one has none of the tf32 MMA instructions (HGMMA
    / HMMA ... TF32). ``who`` names the kernels they belong to."""
    sass = subprocess.run([_cuobjdump(), '-sass', str(lib)],
                          capture_output=True, text=True,
                          check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            fn = line.split('Function :')[1].strip()
            if all(n in fn for n in names):
                found[fn] = {}
            continue
        if fn in found:
            for word in line.replace(';', ' ').split():
                if word.startswith(('HGMMA', 'HMMA')):
                    found[fn][word] = found[fn].get(word, 0) + 1
    if not found or not all(any('TF32' in op for op in ops)
                            for ops in found.values()):
        raise AssertionError('%s kernels without tf32 tensor-core '
                             'instructions: %s' % (who, found))
    return found


def _ptxas_usage(log, name):
    """(registers, spill store bytes, spill load bytes) that ptxas reported
    for the kernel whose mangled name holds ``name``, from a build log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if 'Compiling entry function' in line and name in line:
            regs = spills = None
            for nxt in lines[i + 1:i + 5]:
                words = nxt.replace(',', ' ').split()
                if 'spill' in nxt:
                    spills = (int(words[words.index('spill') - 2]),
                              int(words[words.index('spill', words.index(
                                  'spill') + 1) - 2]))
                if 'registers' in nxt:
                    regs = int(words[words.index('registers') - 1])
            return regs, spills[0], spills[1]
    raise AssertionError('ptxas reported no kernel %s' % name)


def _errors(out, ref, rtol, atol):
    """max |out - ref|, max relative error where |ref| > 1e-3 max|ref|,
    max|ref|, and whether every element is within the bound."""
    diff = (out - ref).abs()
    scale = float(ref.abs().max())
    big = ref.abs() > 1e-3 * scale
    rel = float((diff[big] / ref.abs()[big]).max()) if bool(big.any()) \
        else 0.0
    ok = bool((diff <= rtol * ref.abs() + atol * scale).all())
    return float(diff.max()), rel, scale, ok


def _seeded_generator(cfg, build_generator, dev):
    """A random generator whose every layer carries signal: a fresh init
    routes to outputs near 1e-7, which BatchNorm's fresh 0/1 statistics
    pass on as near-zeros, so the images would hardly depend on the
    capsule stage. Capsule weights are drawn unit-variance and every
    BatchNorm's running statistics are set from one random batch."""
    import torch
    from text2img_ekl_tpu_torch.nn import blocks
    torch.manual_seed(0)
    G = build_generator(cfg, train_flag=False).to(dev)
    momentum = blocks.BN_MOMENTUM
    with torch.no_grad():
        cap = G.h_net1.fc_cap[1].weight
        cap.copy_(torch.randn(cap.shape, device=dev))
        blocks.BN_MOMENTUM = 0.0  # running statistics := this batch's
        try:
            b = 64
            G.train()(torch.randn((b, cfg.GAN.Z_DIM), device=dev),
                      torch.randn((b, cfg.TEXT.DIMENSION), device=dev) * 0.03,
                      torch.eye(cfg.GAN.ENTITY_DIM, device=dev)[
                          torch.randint(0, cfg.GAN.ENTITY_DIM, (b,))])
        finally:
            blocks.BN_MOMENTUM = momentum
    return {k: v.cpu() for k, v in G.state_dict().items()}


def _time_ms(fn, iters):
    import torch
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _best_ms(fns, iters=20):
    """Best of two CUDA-event runs of each function, in turns (a, b, b, a);
    returns name -> (best ms, all ms)."""
    times = {name: [] for name in fns}
    names = list(fns)
    for name in names + names[::-1]:
        _time_ms(fns[name], 3)  # warm up
        times[name].append(_time_ms(fns[name], iters))
    return {name: (min(t), t) for name, t in times.items()}


def _bound(flops, nbytes, peak=F32_FLOPS):
    """(least ms, what bounds it) from operations and bytes."""
    return _bound_parts([(flops, peak)], nbytes)


def _bound_parts(parts, nbytes):
    """(least ms, what bounds it) of work done in parts [(operations,
    peak of the units that do them)] that moves ``nbytes``."""
    t_ops, t_bytes = sum(f / p for f, p in parts), nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def _k1_work(shape, factored):
    """(flops, bytes) of one routing forward. Bytes: x and W read once,
    the output written once. Operations, per pass and sample, as the
    kernel's algorithm needs them: factored (in_length L = 8) b_ij = x_i.a_j
    and y_j = sum_i c_ij x_i (4L per pair, +3 for the softmax), s_j = W_j y_j
    and a_j += W_j^T v_j (4 O L per output capsule, +3 O for the squash);
    votes form: the vote product 2 B I L J O once, then s and the agreement
    (4 I J O per pass) and the softmax and squash."""
    b, i, l, j, o = shape
    nbytes = 4 * (b * i * l + j * o * l + b * j * o)
    if factored:
        flops = ITERS * b * ((4 * l + 3) * i * j + (4 * o * l + 3 * o) * j)
    else:
        flops = 2 * b * i * l * j * o + ITERS * b * (
            4 * i * j * o + 3 * i * j + 3 * j * o)
    return flops, nbytes


def _k2_work(shape, factored):
    """Work of one routing backward: the forward recomputed, the reverse
    passes (about 2.5x a forward pass: squash, softmax and agreement
    pullbacks) and the weight gradient (the sum over the batch). Bytes: x,
    W and dv read, dx and dW written. Factored form: (flops, bytes), with 2
    (2R-1) B J O L for dW's outer products. Votes form: ((flops of the
    three products u = x W^T, dx = du W, dW = du^T x, each 2 B I L J O;
    flops of the routing, R B (10 I J O + 9 I J + 9 J O)), bytes)."""
    b, i, l, j, o = shape
    nbytes = 4 * (2 * b * i * l + 2 * j * o * l + b * j * o)
    if factored:
        fwd, _ = _k1_work(shape, factored)
        rev = ITERS * b * ((10 * l + 6) * i * j + 8 * o * l * j) \
            + 2 * (2 * ITERS - 1) * b * j * o * l
        return fwd + rev, nbytes
    return ((6 * b * i * l * j * o,
             ITERS * b * (10 * i * j * o + 9 * i * j + 9 * j * o)), nbytes)


def _k1d_bound(shape):
    """K1-D's (least ms, what bounds it, product ms, routing ms, bytes ms):
    the vote product at the TF32 tensor-core peak, done three times
    (3xTF32), the routing at the float32 SIMT peak."""
    b, i, l, j, o = shape
    flops, nbytes = _k1_work(shape, False)
    product = 2 * b * i * l * j * o
    bound_ms, bound_by = _bound_parts(
        [(3 * product, TF32_FLOPS), (flops - product, F32_FLOPS)], nbytes)
    return (bound_ms, bound_by, 3 * product / TF32_FLOPS * 1e3,
            (flops - product) / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3)


def _k2d_bound(shape):
    """K2-D's (least ms, what bounds it, products ms, routing ms, bytes
    ms): the products at the TF32 tensor-core peak, done three times
    (3xTF32), the routing at the float32 SIMT peak."""
    (products, routing), nbytes = _k2_work(shape, False)
    bound_ms, bound_by = _bound_parts(
        [(3 * products, TF32_FLOPS), (routing, F32_FLOPS)], nbytes)
    return (bound_ms, bound_by, 3 * products / TF32_FLOPS * 1e3,
            routing / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3)


def _k3_work(shape, itemsize):
    """(flops, bytes) of one fused BN+GLU: y [B, 2C, H, W] read once, the
    four [2C] vectors read once, out [B, C, H, W] written once; per output
    two affines (4), the logistic (4, counting exp as one) and the product
    (1)."""
    b, c2 = shape[:2]
    out = b * c2 // 2 * math.prod(shape[2:])
    return 9 * out, itemsize * 3 * out + 4 * 4 * c2


def _k4_work(x_shape, f, itemsize):
    """(flops, bytes) of one 3x3 weight gradient: 2 F 9C B H W operations;
    x and dy read once, dW (float32) written once."""
    b, c, h, w = x_shape
    return (2 * f * 9 * c * b * h * w,
            itemsize * b * h * w * (c + f) + 4 * f * c * 9)


def _pinned_kinks(nets, leaky_relu, masks, replay):
    """Forward hooks on every LeakyReLU of ``nets``. Recording, they append
    to ``masks`` which inputs of each call were positive; replaying, each
    call takes the recorded branch (x or 0.2 x), so that a second run goes
    through the same pieces of the piecewise-linear networks. An input
    within rounding of zero takes the other slope under another summation
    order (ROADMAP F10), which moves a whole receptive field's gradient.
    Returns (hook handles, [flips pinned])."""
    import torch
    calls, flips = iter(masks), [0]

    def hook(module, args, out):
        x = args[0]
        if not replay:
            masks.append(x > 0)
            return None
        mask = next(calls).to(x.device)
        flips[0] += int((mask != (x > 0)).sum())
        return torch.where(mask, x, 0.2 * x).to(module.dtype)

    return [m.register_forward_hook(hook) for net in nets
            for m in net.modules() if isinstance(m, leaky_relu)], flips


def _capsule_inputs(rng, shape, dev):
    """x and a unit-variance weight (scaled by 1/sqrt(in_length / 8) so
    that votes stay unit-scale at in_length 512), seeded."""
    import numpy as np
    import torch
    b, i, l, j, o = shape
    x = torch.from_numpy(rng.standard_normal((b, i, l), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((j, o, l), dtype=np.float32)
                         / np.float32(np.sqrt(l / 8)))
    return x.to(dev), w.to(dev)


def _step_batch(rng, cfg, dev):
    """A seeded uint8 batch and draws for one step at ``cfg``."""
    import numpy as np
    import torch
    b = cfg.TRAIN.BATCH_SIZE
    labels = rng.integers(0, cfg.GAN.ENTITY_DIM, b)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    batch = {
        'real': tuple(put(rng.integers(0, 256, (b, 3, s, s), dtype=np.uint8))
                      for s in cfg.branch_sizes()),
        'wrong': tuple(put(rng.integers(0, 256, (b, 3, s, s),
                                        dtype=np.uint8))
                       for s in cfg.branch_sizes()),
        'txt': put(rng.standard_normal((b, cfg.TEXT.DIMENSION),
                                       dtype=np.float32) * 0.4),
        'cls_onehot': put(np.eye(cfg.GAN.ENTITY_DIM, dtype=np.float32)[
            labels]),
        'real_cp': put(np.eye(cfg.GAN.ENTITY_DIM + 1, dtype=np.float32)[
            labels]),
    }
    draws = {'noise': put(rng.standard_normal((b, cfg.GAN.Z_DIM),
                                              dtype=np.float32)),
             'eps': put(rng.standard_normal((b, cfg.GAN.EMBEDDING_DIM),
                                            dtype=np.float32)),
             'eps_cls': put(rng.standard_normal((b, cfg.GAN.MANIFD_DIM),
                                                dtype=np.float32))}
    return batch, draws


class _Repeat:
    """A loader whose every epoch hands out the same host batches; SIGTERM
    is raised just before the batch of index ``signal_at`` (counted over
    epochs), if given."""

    def __init__(self, batches, signal_at=None):
        self.batches, self.signal_at, self.n = batches, signal_at, 0

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        import signal
        for batch in self.batches:
            if self.n == self.signal_at:
                signal.raise_signal(signal.SIGTERM)
            self.n += 1
            yield batch


def _state_groups(state):
    """{group: {name: tensor}} of a training state's checkpoint dict (G and
    D parameters and BatchNorm buffers, Adam exp_avg and exp_avg_sq), and
    {name: Adam step} for every parameter with Adam state."""
    from text2img_ekl_tpu_torch.train.state import train_state_dict
    sd = train_state_dict(state)
    groups, steps = {}, {}
    nets = [('G', state.G, sd['G'], sd['g_opt'])] + [
        ('D%d' % i, D, d, o) for i, (D, d, o) in enumerate(
            zip(state.Ds, sd['Ds'], sd['d_opts']))]
    for net, module, msd, osd in nets:
        kind = net[0]
        names = [n for n, _ in module.named_parameters()]
        for k, v in msd.items():
            g = '%s parameters' % kind if k in names else \
                '%s BatchNorm buffers' % kind
            groups.setdefault(g, {})['%s.%s' % (net, k)] = v
        for i, s in osd['state'].items():
            name = '%s.%s' % (net, names[i])
            for m in ('exp_avg', 'exp_avg_sq'):
                groups.setdefault('%s Adam %s' % (kind, m), {})[name] = s[m]
            steps[name] = float(s['step'])
    return groups, steps


def _compare_states(a, b):
    """Per group of ``_state_groups``: (max |a - b|, bit-identical); and
    whether the Adam steps are equal."""
    import torch
    ga, sa = _state_groups(a)
    gb, sb = _state_groups(b)
    out = {}
    for g, ta in ga.items():
        tb = gb[g]
        if ta.keys() != tb.keys():
            raise AssertionError('%s: other tensors' % g)
        diff, same = 0.0, True
        for k, v in ta.items():
            w = tb[k]
            if torch.equal(v, w):
                continue
            same = False
            diff = max(diff, float((v.float() - w.float()).abs().max()))
        out[g] = (diff, same)
    return out, sa == sb


def _checkpoint_phase(tcfg, reset_launches, launches, card):
    """15. checkpoint and resume on the card, at the flagship's full width
    with a snapshot every epoch and no IS stream: run A trains 4 steps;
    run B trains 2, writes state_epoch0, and a new trainer on its directory
    resumes (step 2, epoch 1) and trains 2 more. A's and B's final states
    must be bit-identical, and the resumed run launch the kernels of 2
    steps and a run.
    Then a SIGTERM after a step saves and returns."""
    import signal
    import torch
    from text2img_ekl_tpu_torch.data import DataLoader, SyntheticTextDataset
    from text2img_ekl_tpu_torch.io_utils.checkpoint import (
        STATE_FILE, restore_train_state, save_train_state)
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer

    cfg = copy.deepcopy(tcfg)
    cfg.TRAIN.SNAPSHOT_INTERVAL = 1
    cfg.TPU_IS_EVERY = 0
    bsz = cfg.TRAIN.BATCH_SIZE
    ds = SyntheticTextDataset(
        num_items=2 * bsz, base_size=cfg.TREE.BASE_SIZE,
        branch_num=cfg.TREE.BRANCH_NUM, entity_dim=cfg.GAN.ENTITY_DIM,
        text_dim=cfg.TEXT.DIMENSION, train_pairs=True,
        uint8_output=bool(cfg.TPU_UINT8_INPUT))
    # the loader draws each item's wrong image and caption from a generator
    # seeded by (seed, epoch, index), and a new loader starts at epoch 0
    # (ROADMAP F17): one epoch's batches, repeated, are the same in every
    # epoch of every trainer
    batches = list(DataLoader(ds, bsz, shuffle=False,
                              num_workers=int(cfg.WORKERS)))
    root = os.path.join(WORK, 'resume')

    def trainer(name, signal_at=None):
        return CondGANTrainer(cfg, os.path.join(root, name),
                              data_loader=_Repeat(batches, signal_at),
                              device='cuda')

    a = trainer('a')
    sa = a.train(max_steps=4)
    ma = a.last_metrics
    b1 = trainer('b')
    b1.train(max_steps=2)
    if os.listdir(b1.model_dir) != ['state_epoch0']:
        raise AssertionError('run B wrote %s' % os.listdir(b1.model_dir))
    b2 = trainer('b')
    torch.cuda.synchronize()
    reset_launches()
    sb = b2.train(max_steps=2)
    torch.cuda.synchronize()
    got, mb = launches(), b2.last_metrics
    want = {k: 2 * PER_STEP[k] + PER_RUN[k] for k in PER_STEP}
    saved = b1.ckpt.path(0)
    nbytes = os.path.getsize(os.path.join(saved, STATE_FILE))
    # save and restore alone, timed, and the round trip on the card
    probe = os.path.join(root, 'probe', 'state_epoch0')
    fresh = create_train_state(cfg, 'cuda', seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_train_state(probe, b1.state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore_train_state(probe, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    trip, trip_steps = _compare_states(b1.state, fresh)
    if not (all(same for _, same in trip.values()) and trip_steps
            and fresh.step == b1.state.step == 2):
        raise AssertionError('save -> restore on the card changed the '
                             'state: %s' % trip)
    del fresh, b1
    print('phase 15 snapshot of the flagship state (%s compute, batch %d, '
          'step 2) on %s: %d bytes on disk (%.3f GB); save %.3f s, restore '
          'into a fresh state (seed 1) %.3f s; the restored state is '
          'bit-identical, Adam steps included'
          % (cfg.TPU_COMPUTE_DTYPE, bsz, card, nbytes, nbytes / 1e9, save_s,
             restore_s))
    if got != want:
        raise AssertionError('the resumed run launched %s, want %s (2 steps '
                             'x %s + %s)' % (got, want, PER_STEP, PER_RUN))
    groups, steps_same = _compare_states(sa, sb)
    if sa.step != sb.step or not steps_same:
        raise AssertionError('steps differ: run A %d, run B %d; Adam steps '
                             'equal %s' % (sa.step, sb.step, steps_same))
    same_metrics = ma == mb
    for g, (diff, same) in groups.items():
        print('phase 15 run A (4 steps) vs run B (2 + resume + 2): %s max '
              'abs diff %.3e, %s' % (g, diff, 'bit-identical' if same else
                                     'NOT bit-identical'))
    print('phase 15 resumed run: state.step %d = %d, Adam steps equal; '
          'metrics %s; launches %s (want %s)'
          % (sb.step, sa.step, 'bit-identical' if same_metrics else
             'differ', got, want))
    if not (same_metrics and all(same for _, same in groups.values())):
        raise AssertionError('the resumed run is not bit-identical to the '
                             'uninterrupted one')
    del sa, sb, a, b2

    # SIGTERM after a step: a snapshot of that epoch, train() returns, the
    # handlers are restored
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    c = trainer('c', signal_at=0)
    sc = c.train(max_steps=2)
    names = os.listdir(c.model_dir)
    step_on_disk = torch.load(os.path.join(c.ckpt.path(0), STATE_FILE),
                              map_location='cpu', weights_only=True,
                              mmap=True)['step']
    after = {s: signal.getsignal(s) for s in before}
    print('phase 15 SIGTERM raised before the first batch: train() returned '
          'after %d step(s), wrote %s (step %d on disk); handlers restored %s'
          % (sc.step, names, step_on_disk, after == before))
    if names != ['state_epoch0'] or sc.step != 1 or step_on_disk != 1 or \
            after != before:
        raise AssertionError('the SIGTERM save failed')
    del sc, c
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch finds no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from text2img_ekl_tpu_torch.config import cfg_from_file
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.nn.blocks import LeakyReLU
    from text2img_ekl_tpu_torch.ops import _build
    from text2img_ekl_tpu_torch.ops import bn_glu, conv_dw
    from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
    from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
    from text2img_ekl_tpu_torch.ops.capsule_cuda import capsule_routing
    from text2img_ekl_tpu_torch.train.sample import (caption_sample,
                                                     sample_images)
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.step import make_train_step
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    from text2img_ekl_tpu_torch.ops import capsule_variants as cv
    from tools import bench_capsule_torch as bench

    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print('card: %s (torch %s, CUDA %s)' % (card, torch.__version__,
                                            torch.version.cuda))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    kernels = dict(cc.KERNELS, K3=bn_glu.bn_glu_kernel,
                   K4=conv_dw.dw3x3_kernel, **cv.KERNELS)

    def reset_launches():
        for fn in kernels.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in kernels.items()}

    # 1. build
    t0 = time.perf_counter()
    libs = _build.build()
    print('phase 1 build: %.2f s -> %s' % (
        time.perf_counter() - t0,
        ', '.join(os.path.relpath(p, ROOT) for p in libs.values())))
    for lib in libs.values():
        for line in lib.with_suffix('.log').read_text().splitlines():
            if 'registers' in line or 'spill' in line or 'entry' in line:
                print('  ptxas: %s' % line.strip())
    for who, stem in (('K1-D', 'capsule_routing'),
                      ('K2-D', 'capsule_routing_bwd')):
        sass = _tensor_core_sass(libs[stem], who)
        print('phase 1 SASS (cuobjdump -sass): %s\'s %d product kernels '
              '(gemm_tf32x3::gemm_kernel, one per operand layout and copy '
              'width) issue %s' % (who, len(sass), '; '.join(sorted({
                  ', '.join('%d x %s' % (n, op) for op, n in
                            sorted(ops.items()))
                  for ops in sass.values()}))))
    sass = _tensor_core_sass(libs['conv3x3_dw'], 'K4\'s float32 body',
                             ('dw_tf32x3_kernel',))
    regs, spill_st, spill_ld = _ptxas_usage(
        libs['conv3x3_dw'].with_suffix('.log').read_text(), 'dw_tf32x3_kernel')
    print('phase 1 SASS (cuobjdump -sass): K4\'s float32 body '
          '(dw_tf32x3_kernel) issues %s; ptxas: %d registers, %d bytes spill '
          'stores, %d bytes spill loads'
          % ('; '.join(', '.join('%d x %s' % (n, op) for op, n in
                                 sorted(ops.items()))
                       for ops in sass.values()), regs, spill_st, spill_ld))
    if spill_st > K4_F32_SPILLS[0] or spill_ld > K4_F32_SPILLS[1]:
        raise AssertionError('K4\'s float32 body spills more than %d / %d '
                             'bytes (stores / loads): %d / %d'
                             % (*K4_F32_SPILLS, spill_st, spill_ld))

    # 2. K1-G against the plain routing
    rng = np.random.default_rng(0)

    def k1_inputs(shape, weights):
        bsz, in_caps, out_caps, out_len = shape
        x = torch.from_numpy(rng.standard_normal((bsz, in_caps, 8),
                                                 dtype=np.float32)).to(dev)
        if weights == 'init':  # CapsuleLinear's orthogonal init
            w = torch.empty((out_caps, out_len, 8))
            torch.nn.init.orthogonal_(w.view(out_caps, -1))
        else:  # unit variance: routing neither uniform nor saturated
            w = torch.from_numpy(rng.standard_normal(
                (out_caps, out_len, 8), dtype=np.float32))
        return x, w.to(dev)

    err = {name: 0.0 for name in kernels}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.no_grad():
        for shape, weights in ((FLAGSHIP, 'N(0,1)'), (FLAGSHIP, 'init'),
                               (G_HEAD[:2] + G_HEAD[3:], 'N(0,1)'),
                               (RAGGED, 'N(0,1)')):
            x, w = k1_inputs(shape, weights)
            out = capsule_routing(x, w, ITERS)
            again = capsule_routing(x, w, ITERS)
            ref = capsule_linear(x, w, ITERS, 'dynamic')
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError('K1-G: two calls on the same inputs '
                                     'differ')
            max_abs, max_rel, scale, ok = _errors(out, ref, K1_RTOL, K1_ATOL)
            plan = cc.factored_fwd_plan(
                shape[0], shape[1], shape[2], ITERS, sms,
                max_clusters=cc.fwd_card_clusters(dev, *shape[1:]))
            print('phase 2 K1-G %s weights %s (clusters of %d): max|ref| '
                  '%.3e, max_abs_err %.3e, max_rel_err %.3e (where |ref| > '
                  '1e-3 max|ref|); bound |d| <= %.0e |ref| + %.0e max|ref|: '
                  '%s; two calls bit-identical'
                  % (shape, weights, plan.cluster, scale,
                     max_abs, max_rel, K1_RTOL, K1_ATOL,
                     'ok' if ok else 'FAIL'))
            if not ok:
                raise AssertionError('K1-G disagrees with the plain routing')
            err['K1-G'] = max(err['K1-G'], max_abs)
            if weights == 'init':
                continue
            worst = 0.0
            for key, p in bench.fwd_sweep_plans(shape[0], shape[1], shape[2],
                                                sms).items():
                got = cc.routing_fwd_factored(x, w, ITERS, plan=p)
                max_abs, _, _, ok = _errors(got, ref, K1_RTOL, K1_ATOL)
                if not ok:
                    raise AssertionError('K1-G at a cluster of %d disagrees '
                                         'with the plain routing' % key)
                worst = max(worst, max_abs)
            print('phase 2 K1-G %s: every cluster size of the sweep within '
                  'the bound, worst max_abs_err %.3e' % (shape, worst))
        flagship_x, flagship_w = k1_inputs(FLAGSHIP, 'N(0,1)')

    def k1g_timing(phase, shape, x, w):
        """K1-G at x, w of ``shape`` (B, in, out, out_length) against the
        plain routing in turns, its plan and device time by kernel, its
        bound and its cluster sweep."""
        b_, i_, j_, o_ = shape
        held = cc.fwd_card_clusters(dev, i_, j_, o_)
        plan = cc.factored_fwd_plan(b_, i_, j_, ITERS, sms, max_clusters=held)
        with torch.no_grad():
            best = _best_ms({
                'kernel': lambda: capsule_routing(x, w, ITERS),
                'plain': lambda: capsule_linear(x, w, ITERS, 'dynamic')})
            trace = bench._label(bench.kernel_trace(
                lambda: capsule_routing(x, w, ITERS)))
            plans = bench.fwd_sweep_plans(b_, i_, j_, sms)
            sweep = bench.cluster_sweep(
                'phase %d K1-G at %s on %s:' % (phase, shape, card), plans,
                lambda p: cc.routing_fwd_factored(x, w, ITERS, plan=p), dev)
        bound_ms, bound_by = _bound(*_k1_work((b_, i_, 8, j_, o_), True))
        print('phase %d K1-G at %s on %s: kernel %.4f ms, plain %.4f ms (best '
              'of 2 x 20, in turns; all: kernel %s plain %s); device %s; '
              'bound %.4f ms (%s), kernel / bound %.2f; plan on %d SMs: '
              'clusters of %d, %d blocks, %d B of shared memory a block '
              '(couplings in it: %s); clusters the card holds at once: %s'
              % (phase, shape, card, best['kernel'][0], best['plain'][0],
                 ['%.4f' % t for t in best['kernel'][1]],
                 ['%.4f' % t for t in best['plain'][1]],
                 '; '.join('%s %.1f us' % kv for kv in trace) or
                 'not recorded', bound_ms, bound_by,
                 best['kernel'][0] / bound_ms, sms, plan.cluster,
                 plan.blocks, plan.smem_bytes, plan.in_smem,
                 ', '.join('%d of C=%d' % (held(p.cluster, p.in_smem), c)
                           for c, p in plans.items())))
        return {'ms': best['kernel'][0], 'plain_ms': best['plain'][0],
                'shape': list(shape), 'cluster': plan.cluster,
                'blocks': plan.blocks,
                'device_us': dict(trace), 'bound_ms': bound_ms,
                'sweep': {k: list(v) for k, v in sweep.items()}}

    # 3. the serving path
    shutil.rmtree(WORK, ignore_errors=True)
    cfg = cfg_from_file(CFG)
    cfg.TPU_SYNTHETIC_DATA = True
    assert cfg.GAN.GF_DIM == 64 and cfg.TRAIN.BATCH_SIZE == 32
    net_g = os.path.join(WORK, 'run_seed0', 'Model', 'netG_epoch_0.pth')
    os.makedirs(os.path.dirname(net_g))
    state = _seeded_generator(cfg, build_generator, dev)
    torch.save(state, net_g)
    cfg.TRAIN.NET_G = net_g
    trainer = CondGANTrainer(cfg, os.path.join(WORK, 'eval_run'),
                             device='cuda')
    reset_launches()
    t0 = time.perf_counter()
    save_dir = trainer.evaluate(max_batches=BATCHES)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = launches()
    pngs = []
    for d, _, files in os.walk(save_dir):
        pngs += [os.path.join(d, f) for f in files if f.endswith('.png')]
    want = BATCHES * cfg.TRAIN.BATCH_SIZE * 10
    from PIL import Image
    shapes = {np.asarray(Image.open(p)).shape for p in pngs}
    print('phase 3 evaluate: launches %s for %d sampler calls, %d PNGs '
          '(want %d) of shape %s in %.2f s'
          % (eval_launches, BATCHES, len(pngs), want, sorted(shapes), eval_s))
    if eval_launches != dict(PER_RUN, **{'K1-G': BATCHES}):
        raise AssertionError('K1-G did not run once per sampler call')
    if len(pngs) != want or shapes != {(cfg.imsize, cfg.imsize, 3)}:
        raise AssertionError('evaluate wrote the wrong PNGs')

    # 4. CUDA generator (K1) against CPU generator (plain), float32; and
    #    the config's compute dtype on the card against the same reference
    f32 = copy.deepcopy(cfg)
    f32.TPU_COMPUTE_DTYPE = 'float32'
    f32.TPU_BN_DTYPE = 'float32'
    gens = {}
    for name, device, c in (('cuda', 'cuda', f32), ('cpu', 'cpu', f32),
                            ('cuda-' + cfg.TPU_COMPUTE_DTYPE, 'cuda', cfg)):
        g = build_generator(c, train_flag=False)
        g.load_state_dict(state, strict=True)
        gens[name] = (g.to(device).eval(), device)
    n_cap, bsz = 2, 4
    draws = dict(
        noise=rng.standard_normal((n_cap, bsz, cfg.GAN.Z_DIM),
                                  dtype=np.float32),
        emb=rng.standard_normal((n_cap, bsz, cfg.TEXT.DIMENSION),
                                dtype=np.float32) * 0.03,
        cls_prior=rng.standard_normal((n_cap, bsz, cfg.GAN.MANIFD_DIM),
                                      dtype=np.float32),
        eps=rng.standard_normal((n_cap, bsz, cfg.GAN.EMBEDDING_DIM),
                                dtype=np.float32))
    outs = {}
    before = cc.routing_fwd_factored.launches
    for name, (g, device) in gens.items():
        t = {k: torch.from_numpy(v).to(device) for k, v in draws.items()}
        flat = {k: v.reshape(n_cap * bsz, -1) for k, v in t.items()}
        imgs = sample_images(g, flat['noise'], flat['emb'],
                             cls_prior=flat['cls_prior'], eps=flat['eps'])
        u8 = caption_sample(g, t['noise'], t['emb'],
                            cls_prior=t['cls_prior'], eps=t['eps'])
        outs[name] = ([i.cpu() for i in imgs], u8.cpu())
    img_err = max(float((a - b).abs().max())
                  for a, b in zip(outs['cuda'][0], outs['cpu'][0]))
    u8_err = int((outs['cuda'][1].int() - outs['cpu'][1].int()).abs().max())
    finite = all(bool(torch.isfinite(i).all()) for i in outs['cuda'][0])
    if cc.routing_fwd_factored.launches - before != 4:
        raise AssertionError('the CUDA generators did not run K1-G')
    print('phase 4 CUDA vs CPU generator, float32, at B=%d x %d captions: '
          'max image diff %.3e (bound %.0e), max uint8 diff %d (bound 1), '
          'finite %s, shapes %s'
          % (bsz, n_cap, img_err, IMAGE_ATOL, u8_err, finite,
             [tuple(i.shape) for i in outs['cuda'][0]]))
    if not (finite and img_err <= IMAGE_ATOL and u8_err <= 1):
        raise AssertionError('the CUDA generator disagrees with the CPU one')
    low = [(a - b).abs() for a, b in zip(outs['cuda-' + cfg.TPU_COMPUTE_DTYPE]
                                         [0], outs['cpu'][0])]
    low_mean = max(float(d.mean()) for d in low)
    low_max = max(float(d.max()) for d in low)
    print('phase 4 CUDA %s compute, %s BatchNorm vs CPU float32: mean image '
          'diff %.3e (bound 1e-2), max %.3e (bound 1e-1)'
          % (cfg.TPU_COMPUTE_DTYPE, cfg.TPU_BN_DTYPE, low_mean, low_max))
    if not (low_mean <= 1e-2 and low_max <= 0.1):
        raise AssertionError('the %s generator drifts from float32'
                             % cfg.TPU_COMPUTE_DTYPE)

    # 5. timings of K1-G and the sampler
    timing = {}
    extra = {'K1-G': k1g_timing(5, FLAGSHIP, flagship_x, flagship_w)}

    G = trainer.G
    b, c = cfg.TRAIN.BATCH_SIZE, 10
    noise = torch.randn((c, b, cfg.GAN.Z_DIM), device=dev)
    emb = torch.randn((c, b, cfg.TEXT.DIMENSION), device=dev) * 0.03
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def sample():
        return caption_sample(G, noise, emb, generator=gen)

    out = sample()
    torch.cuda.synchronize()
    if tuple(out.shape) != (c, b, cfg.imsize, cfg.imsize, 3) or \
            out.dtype != torch.uint8:
        raise AssertionError('sampler output %s %s' % (tuple(out.shape),
                                                       out.dtype))
    sample_ms = _time_ms(sample, 10)
    print('phase 5 sampler (%s, %d images per call, [%d, %d, %d, %d, 3] '
          'uint8) on %s: %.3f ms per call, %.1f images/s; evaluate with '
          'PNG writes: %.1f images/s'
          % (cfg.TPU_COMPUTE_DTYPE, b * c, c, b, cfg.imsize, cfg.imsize,
             card, sample_ms, b * c * 1e3 / sample_ms, want / eval_s))
    del trainer, G, gens, outs

    # 6. K1-D (votes form) against the plain routing; both forward forms
    #    timed at the training path's batch
    x, w = _capsule_inputs(rng, G_HEAD, dev)
    k1g = k1g_timing(6, G_HEAD[:2] + G_HEAD[3:], x, w)
    timing['K1-G'] = (k1g.pop('ms'), k1g.pop('plain_ms'),
                      _k1_work(G_HEAD, True), G_HEAD)
    for key in ('shape', 'bound_ms'):  # the record's own
        k1g.pop(key)
    extra['K1-G'] = dict(k1g, sampler=extra['K1-G'])
    with torch.no_grad():
        for shape in (D_HEAD, D_RAGGED):
            x, w = _capsule_inputs(rng, shape, dev)
            before = cc.routing_fwd_votes.launches
            out = capsule_routing(x, w, ITERS)
            ref = capsule_linear(x, w, ITERS, 'dynamic')
            torch.cuda.synchronize()
            if cc.routing_fwd_votes.launches != before + 1:
                raise AssertionError('K1-D did not launch')
            max_abs, max_rel, scale, ok = _errors(out, ref, K1_RTOL, K1_ATOL)
            print('phase 6 K1-D %s: max|ref| %.3e, max_abs_err %.3e, '
                  'max_rel_err %.3e; bound |d| <= %.0e |ref| + %.0e '
                  'max|ref|: %s' % (shape, scale, max_abs, max_rel, K1_RTOL,
                                    K1_ATOL, 'ok' if ok else 'FAIL'))
            if not ok:
                raise AssertionError('K1-D disagrees with the plain routing')
            err['K1-D'] = max(err['K1-D'], max_abs)
        x, w = _capsule_inputs(rng, D_HEAD, dev)
        best = _best_ms({
            'kernel': lambda: capsule_routing(x, w, ITERS),
            'plain': lambda: capsule_linear(x, w, ITERS, 'dynamic')})
        timing['K1-D'] = (best['kernel'][0], best['plain'][0],
                          _k1_work(D_HEAD, False), D_HEAD)
        plan = cc.votes_fwd_plan(*D_HEAD, sms)
        bound_ms, bound_by, prod_ms, route_ms, bytes_ms = _k1d_bound(D_HEAD)
        print('phase 6 K1-D at %s on %s: kernel %.4f ms, plain %.4f ms (best '
              'of 2 x 20); bound %.4f ms (%s: the vote product done three '
              'times (3xTF32) at %.0f TFLOP/s %.4f ms + routing at %.0f '
              'TFLOP/s %.4f ms; bytes %.4f ms), kernel / bound %.2f; plan on '
              '%d SMs: clusters of %d, %d blocks, %d B of shared memory a '
              'block (votes in it: %s)'
              % (D_HEAD, card, best['kernel'][0], best['plain'][0], bound_ms,
                 bound_by, TF32_FLOPS / 1e12, prod_ms, F32_FLOPS / 1e12,
                 route_ms, bytes_ms, best['kernel'][0] / bound_ms, sms,
                 plan.cluster, plan.blocks, plan.smem_bytes,
                 plan.votes_in_smem))
        sweep = bench.cluster_sweep(
            'phase 6 K1-D on %s:' % card, bench.sweep_plans(
                lambda c: cc.votes_fwd_plan(*D_HEAD, sms, cluster=c)),
            lambda p: cc.routing_fwd_votes(x, w, ITERS, plan=p), dev, ('u',))
        extra['K1-D'] = {'cluster': plan.cluster, 'blocks': plan.blocks,
                         'bound_product_ms': prod_ms,
                         'bound_routing_ms': route_ms,
                         'sweep': {c: list(v) for c, v in sweep.items()}}

    # 7. K2-G and K2-D against autograd through the plain routing
    for name, shape, kernel in (('K2-G', G_HEAD, cc.routing_bwd_factored),
                                ('K2-D', D_HEAD, cc.routing_bwd_votes)):
        x, w = _capsule_inputs(rng, shape, dev)
        dv = torch.from_numpy(rng.standard_normal(
            (shape[0], shape[3], shape[4]), dtype=np.float32)).to(dev)
        before = kernel.launches
        xk, wk = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        dx, dw = torch.autograd.grad(capsule_routing(xk, wk, ITERS),
                                     (xk, wk), dv)

        def plain():
            xp = x.detach().requires_grad_(True)
            wp = w.detach().requires_grad_(True)
            return torch.autograd.grad(capsule_linear(xp, wp, ITERS,
                                                      'dynamic'), (xp, wp),
                                       dv)

        ref_dx, ref_dw = plain()
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError('%s did not launch' % name)
        for what, got, ref in (('dx', dx, ref_dx), ('dW', dw, ref_dw)):
            max_abs, max_rel, scale, ok = _errors(got, ref, K2_RTOL, K2_ATOL)
            print('phase 7 %s %s %s: max|ref| %.3e, max_abs_err %.3e, '
                  'max_rel_err %.3e; bound |d| <= %.0e |ref| + %.0e '
                  'max|ref|: %s' % (name, shape, what, scale, max_abs,
                                    max_rel, K2_RTOL, K2_ATOL,
                                    'ok' if ok else 'FAIL'))
            if not ok:
                raise AssertionError('%s %s disagrees with plain autograd'
                                     % (name, what))
            err[name] = max(err[name], max_abs)
        fns = {'kernel': lambda: kernel(x, w, dv, ITERS, True, True),
               'plain': plain}
        # dx only: the generator phase of the step, for K2-D
        got, none = kernel(x, w, dv, ITERS, True, False)
        max_abs, max_rel, scale, ok = _errors(got, ref_dx, K2_RTOL, K2_ATOL)
        print('phase 7 %s %s dx only: max_abs_err %.3e; bound |d| <= %.0e '
              '|ref| + %.0e max|ref|: %s' % (
                  name, shape, max_abs, K2_RTOL, K2_ATOL,
                  'ok' if ok and none is None else 'FAIL'))
        if not ok or none is not None:
            raise AssertionError('%s with dx only disagrees with plain '
                                 'autograd' % name)
        fns['kernel dx only'] = lambda: kernel(x, w, dv, ITERS, True, False)
        best = _best_ms(fns, iters=10)
        timing[name] = (best['kernel'][0], best['plain'][0],
                        _k2_work(shape, name == 'K2-G'), shape)
        print('phase 7 %s at %s on %s: kernel %.4f ms with dx and dW, %.4f '
              'ms with dx only, plain autograd (forward + backward) %.4f ms '
              '(best of 2 x 10, in turns)'
              % (name, shape, card, best['kernel'][0],
                 best['kernel dx only'][0], best['plain'][0]))
        if name == 'K2-G':
            b_, i_, _, j_, o_ = shape
            plan = cc.factored_bwd_plan(
                b_, i_, j_, ITERS, sms, max_clusters=cc.card_clusters(
                    dev, i_, j_, o_, ITERS))
            bound_ms, bound_by = _bound(*_k2_work(shape, True))
            print('phase 7 K2-G bound %.4f ms (%s), kernel / bound %.2f; plan '
                  'on %d SMs: clusters of %d, %d blocks, %d B of shared '
                  'memory a block (stashes, couplings and logit gradient in '
                  'it: %s)' % (bound_ms, bound_by,
                               best['kernel'][0] / bound_ms, sms,
                               plan.cluster, plan.blocks, plan.smem_bytes,
                               plan.in_smem))
            sweep = bench.cluster_sweep(
                'phase 7 K2-G on %s:' % card, bench.sweep_plans(
                    lambda c: cc.factored_bwd_plan(b_, i_, j_, ITERS, sms,
                                                   cluster=c),
                    cc.FACTORED_CLUSTER_SIZES),
                lambda p: kernel(x, w, dv, ITERS, True, True, plan=p), dev)
            extra['K2-G'] = {'ms_dx_only': best['kernel dx only'][0],
                             'cluster': plan.cluster, 'blocks': plan.blocks,
                             'sweep': {c: list(v) for c, v in sweep.items()}}
    plan = cc.votes_bwd_plan(*D_HEAD, ITERS, sms)
    bound_ms, bound_by, prod_ms, route_ms, bytes_ms = _k2d_bound(D_HEAD)
    (products, routing), nbytes = _k2_work(D_HEAD, False)
    f32_ms = _bound(products + routing, nbytes)[0]
    print('phase 7 K2-D plan on %d SMs: routing on clusters of %d blocks, %d '
          'blocks in all, %d B of shared memory a block (votes in it: %s); '
          'dx product split %d ways' % (sms, plan.cluster, plan.blocks,
                                        plan.smem_bytes, plan.votes_in_smem,
                                        plan.dx_splits))
    print('phase 7 K2-D bound %.4f ms (%s): products %.3f GFLOP done three '
          'times (3xTF32) at %.0f TFLOP/s %.4f ms + routing %.4f GFLOP at %.0f '
          'TFLOP/s %.4f ms; bytes %.2f MB at %.2f TB/s %.4f ms (all at the '
          'float32 peak, as before the tensor cores: %.4f ms); kernel / '
          'bound %.2f' % (bound_ms, bound_by, products / 1e9,
                          TF32_FLOPS / 1e12, prod_ms, routing / 1e9,
                          F32_FLOPS / 1e12, route_ms, nbytes / 1e6,
                          HBM_BYTES / 1e12, bytes_ms, f32_ms,
                          timing['K2-D'][0] / bound_ms))
    extra['K2-D'] = {'ms_dx_only': best['kernel dx only'][0],
                     'cluster': plan.cluster, 'blocks': plan.blocks,
                     'bound_products_ms': prod_ms,
                     'bound_routing_ms': route_ms, 'float32_bound_ms': f32_ms}

    # 8. the training path
    tcfg = cfg_from_file(TRAIN_CFG)
    tcfg.TPU_SYNTHETIC_DATA = True
    assert (tcfg.GAN.GF_DIM, tcfg.GAN.DF_DIM, tcfg.TRAIN.BATCH_SIZE,
            tcfg.branch_sizes()) == (64, 64, 32, [64, 128])
    trainer = CondGANTrainer(tcfg, os.path.join(WORK, 'train_run'),
                             device='cuda')
    initial = create_train_state(tcfg, 'cpu', seed=0)
    reset_launches()
    t0 = time.perf_counter()
    tstate = trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launches()
    metrics = trainer.last_metrics
    finite = all(np.isfinite(v) for v in metrics.values())
    moved = {}
    for name, before_m, after_m in [('G', initial.G, tstate.G)] + [
            ('D%d' % k, a, b_) for k, (a, b_) in
            enumerate(zip(initial.Ds, tstate.Ds))]:
        after_p = dict(after_m.named_parameters())
        moved[name] = sum(
            not torch.equal(p, after_p[n].detach().cpu())
            for n, p in before_m.named_parameters())
    want_launches = {k: TRAIN_STEPS * PER_STEP[k] + PER_RUN[k]
                     for k in PER_STEP}
    grids = sorted(os.listdir(trainer.image_dir))
    print('phase 8 train(max_steps=%d), %s compute, batch %d: %.2f s; '
          'launches %s (want %s: per step %s, per run %s); finite losses %s '
          '(errD %.4f errG %.4f); parameters moved %s; grids %s'
          % (TRAIN_STEPS, tcfg.TPU_COMPUTE_DTYPE, tcfg.TRAIN.BATCH_SIZE,
             train_s, train_launches, want_launches, PER_STEP, PER_RUN,
             finite, metrics['errD'], metrics['errG'], moved, grids))
    if train_launches != want_launches:
        raise AssertionError('the training path did not launch the kernels '
                             'as expected')
    if not finite or len(metrics) < 14:
        raise AssertionError('training metrics %s' % metrics)
    if not all(moved.values()):
        raise AssertionError('some network did not move: %s' % moved)
    if len(grids) != 1 + len(tcfg.branch_sizes()):
        raise AssertionError('epoch grids %s' % grids)
    step_fn = make_train_step(tcfg)
    batch = trainer._device_batch(next(iter(trainer.data_loader)))
    seed = [1000]

    def one_step():
        seed[0] += 1
        step_fn(tstate, batch, seed[0])

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    step_times = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(5):
            one_step()
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t0) / 5 * 1e3)
    step_ms = min(step_times)
    print('phase 8 train step on %s, %s compute, batch %d: %.2f ms per step '
          '(best of 2 x 5, host clock with synchronize; all %s), %.1f train '
          'images/s' % (card, tcfg.TPU_COMPUTE_DTYPE, tcfg.TRAIN.BATCH_SIZE,
                        step_ms, ['%.2f' % t for t in step_times],
                        tcfg.TRAIN.BATCH_SIZE * 1e3 / step_ms))
    for name in cc.KERNELS:
        ms = timing[name][0]
        print('phase 8 %s: %d launches per step x %.4f ms = %.1f%% of a step'
              % (name, PER_STEP[name], ms, 100 * PER_STEP[name] * ms
                 / step_ms))
    del trainer, tstate, initial, batch

    # 9. one step on the card against one on the CPU, float32, as
    #    configured and with both kernel switches on; the CPU step takes the
    #    card step's LeakyReLU branches (F10)
    for switches in ({}, SWITCHES):
        scfg = copy.deepcopy(tcfg)
        scfg.GAN.GF_DIM = scfg.GAN.DF_DIM = 16
        scfg.TRAIN.BATCH_SIZE = 4
        scfg.TPU_COMPUTE_DTYPE = 'float32'
        scfg.TPU_BN_DTYPE = 'float32'
        for k, v in switches.items():
            setattr(scfg, k, v)
        results, masks = {}, []
        for device in ('cuda', 'cpu'):
            st = create_train_state(scfg, device, seed=0)
            batch, draws = _step_batch(np.random.default_rng(5), scfg, device)
            hooks, flips = _pinned_kinks(st.Ds, LeakyReLU, masks,
                                         replay=device == 'cpu')
            reset_launches()
            m, _ = make_train_step(scfg)(st, batch, 0, draws)
            for h in hooks:
                h.remove()
            if device == 'cuda':
                torch.cuda.synchronize()
                step_launches = launches()
            names = {p: n for n, p in st.G.named_parameters()}
            moments = [{names[p]: s['exp_avg'].cpu()
                        for p, s in st.g_opt.state.items()}]
            for D, opt in zip(st.Ds, st.d_opts):
                names = {p: n for n, p in D.named_parameters()}
                moments.append({names[p]: s['exp_avg'].cpu()
                                for p, s in opt.state.items()})
            results[device] = ({k: float(v) for k, v in m.items()}, moments)
        (cm, cmom), (pm, pmom) = results['cuda'], results['cpu']
        worst_metric = max(abs(cm[k] - v) / (STEP_RTOL * abs(v) + STEP_ATOL)
                           for k, v in pm.items())
        worst_moment = 0.0
        for got, want_m in zip(cmom, pmom):
            net_max = max(float(v.abs().max()) for v in want_m.values())
            for k, v in want_m.items():
                e = float(torch.linalg.vector_norm(got[k] - v))
                worst_moment = max(worst_moment, e / (
                    MOMENT_RTOL * float(torch.linalg.vector_norm(v))
                    + MOMENT_ATOL * net_max))
        # at GF_DIM 16 the envelope holds 7 G convs: stage 1's 32 and 64 px
        # up-convs besides the stage-2 ResBlock and upsample convs
        want_step = dict(PER_STEP, K3=8, K4=7) if switches else PER_STEP
        print('phase 9 CUDA vs CPU step (GF/DF 16, batch 4, float32, '
              'switches %s): metrics errD %.6f vs %.6f, errG %.6f vs %.6f; '
              'worst metric at %.3f of its bound (|d| <= %.0e |ref| + %.0e), '
              'worst Adam first moment at %.3f of its bound (||d|| <= %.0e '
              '||ref|| + %.0e max|ref|); %d LeakyReLU inputs of %d calls '
              'pinned to the card\'s branch; card launches %s (want %s)'
              % (switches or 'off', cm['errD'], pm['errD'], cm['errG'],
                 pm['errG'], worst_metric, STEP_RTOL, STEP_ATOL, worst_moment,
                 MOMENT_RTOL, MOMENT_ATOL, flips[0], len(masks),
                 step_launches, want_step))
        if worst_metric > 1 or worst_moment > 1:
            raise AssertionError('the CUDA step disagrees with the CPU step')
        if step_launches != want_step:
            raise AssertionError('the CUDA step did not launch the kernels '
                                 'as expected')

    # 10. K3 against its plain version at the flagship's tail shapes: (y's
    #     type, the affine's type), the flagship's first
    k3_modes = ((torch.bfloat16, torch.bfloat16),
                (torch.bfloat16, torch.float32),
                (torch.float32, torch.float32))
    k3 = {}
    with torch.no_grad():
        for dtype, bn_dt in k3_modes:
            for shape, per_fwd in K3_SHAPES:
                c2 = shape[1]
                y = torch.randn(shape, device=dev).to(dtype)
                mean = 0.3 * torch.randn(c2, device=dev)
                var = torch.rand(c2, device=dev) + 0.5
                scale = 1.0 + 0.1 * torch.randn(c2, device=dev)
                bias = 0.1 * torch.randn(c2, device=dev)
                kk, bb = bn_glu.fold_affine(mean, var, scale, bias, bn_dt)
                before = bn_glu.bn_glu_kernel.launches
                out = bn_glu.bn_glu_kernel(y, kk, bb, bn_dt)
                ref = bn_glu.bn_glu_reference(y, mean, var, scale, bias,
                                              bn_dt)
                torch.cuda.synchronize()
                if bn_glu.bn_glu_kernel.launches != before + 1:
                    raise AssertionError('K3 did not launch')
                outf, reff = out.float(), ref.float()
                diff = (outf - reff).abs()
                if dtype == torch.float32:
                    ok = bool((diff <= K3_TOL * reff.abs() + K3_TOL).all())
                    what = '|d| <= %.0e |ref| + %.0e' % (K3_TOL, K3_TOL)
                else:  # one bfloat16 ulp: 2^(exponent - 7)
                    ulp = torch.exp2(torch.floor(torch.log2(
                        reff.abs().clamp_min(1e-30))) - 7)
                    ok = bool((diff <= ulp).all())
                    what = '|d| <= one bfloat16 ulp of ref'
                big = reff.abs() > 1e-3 * float(reff.abs().max())
                rel = float((diff[big] / reff.abs()[big]).max())
                best = _best_ms({
                    'kernel': lambda: bn_glu.bn_glu_kernel(y, kk, bb, bn_dt),
                    'plain': lambda: bn_glu.bn_glu_reference(
                        y, mean, var, scale, bias, bn_dt)})
                flops, nbytes = _k3_work(shape, y.element_size())
                bound_ms, bound_by = _bound(
                    flops, nbytes,
                    BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
                k3[(dtype, bn_dt, shape)] = (best['kernel'][0],
                                             best['plain'][0], bound_ms,
                                             bound_by, per_fwd)
                print('phase 10 K3 %s, affine in %s, %s -> %s: max_abs_err '
                      '%.3e, max_rel_err %.3e; bound %s: %s; kernel %.4f ms, '
                      'plain %.4f ms (best of 2 x 20), bound %.4f ms (%s)'
                      % (str(dtype).split('.')[-1],
                         str(bn_dt).split('.')[-1], list(shape),
                         list(out.shape), float(diff.max()), rel, what,
                         'ok' if ok else 'FAIL', best['kernel'][0],
                         best['plain'][0], bound_ms, bound_by))
                if not ok:
                    raise AssertionError('K3 disagrees with its plain '
                                         'version')
                if (dtype, bn_dt) == k3_modes[0]:
                    err['K3'] = max(err['K3'], float(diff.max()))
                del y, out, ref
    for mode in k3_modes:
        tot = [sum(k3[mode + (sh,)][i] * n for sh, n in K3_SHAPES)
               for i in range(3)]
        print('phase 10 K3 per G forward (8 launches), %s, affine in %s: '
              'kernel %.4f ms, plain %.4f ms, bound %.4f ms'
              % (str(mode[0]).split('.')[-1], str(mode[1]).split('.')[-1],
                 *tot))
        if mode == k3_modes[0]:
            timing['K3'] = (tot[0], tot[1], tot[2], max(
                k3[mode + (sh,)][2:4] for sh, _ in K3_SHAPES)[1], None,
                            'per G forward: %s' % ', '.join(
                                '%d x %s' % (n, list(sh))
                                for sh, n in K3_SHAPES))

    # 11. K4 against its plain version and cuDNN's weight gradient
    k4 = {}
    for dtype in (torch.bfloat16, torch.float32):
        for x_shape, f, per_step in K4_SHAPES:
            b_, c_, h_, w_ = x_shape
            x = torch.randn(x_shape, device=dev).to(dtype)
            dy = torch.randn((b_, f, h_, w_), device=dev).to(dtype)
            wgt = torch.randn((f, c_, 3, 3), device=dev).to(dtype)
            before = conv_dw.dw3x3_kernel.launches
            out = conv_dw.dw3x3(x, dy)
            again = conv_dw.dw3x3(x, dy)
            ref = conv_dw.dw3x3_reference(x, dy)
            torch.cuda.synchronize()
            if conv_dw.dw3x3_kernel.launches != before + 2:
                raise AssertionError('K4 did not launch')
            if not torch.equal(out, again):
                raise AssertionError('K4: two calls on the same inputs differ')
            max_abs, max_rel, scale, ok = _errors(out, ref, K4_RTOL, K4_ATOL)
            faithful = ''
            if dtype == torch.float32:
                # the 3xTF32 body against the float64 contraction, beside
                # the float32 plain version (cuBLAS, TF32 off)
                exact = conv_dw.dw3x3_reference(x, dy, torch.float64)
                f64_err = (float((out.double() - exact).abs().max()),
                           float((ref.double() - exact).abs().max()))
                del exact
                faithful = ('; vs float64: kernel %.3e, plain float32 %.3e '
                            '(ratio %.2f, bound 2): %s' % (
                                *f64_err, f64_err[0] / f64_err[1],
                                'ok' if f64_err[0] <= 2 * f64_err[1]
                                else 'FAIL'))

            def library():
                return torch.ops.aten.convolution_backward(
                    dy, x, wgt, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                    1, [False, True, False])[1]

            lib = library().float()
            lib_abs, _, _, _ = _errors(lib, ref, K4_RTOL, K4_ATOL)
            best = _best_ms({
                'kernel': lambda: conv_dw.dw3x3_kernel(x, dy),
                'library': library,
                'plain': lambda: conv_dw.dw3x3_reference(x, dy)}, iters=10)
            flops, nbytes = _k4_work(x_shape, f, x.element_size())
            # bf16 on the tensor cores; float32 there too, as three tf32
            # products (3xTF32)
            bound_ms, bound_by = (
                _bound(flops, nbytes, BF16_FLOPS) if dtype == torch.bfloat16
                else _bound(3 * flops, nbytes, TF32_FLOPS))
            k4[(dtype, x_shape, f)] = (best['kernel'][0], best['plain'][0],
                                       bound_ms, best['library'][0], bound_by,
                                       max_abs)
            print('phase 11 K4 %s x %s dy %s: max|ref| %.3e, max_abs_err '
                  '%.3e, max_rel_err %.3e (cuDNN wgrad max_abs_err %.3e); '
                  'bound |d| <= %.0e |ref| + %.0e max|ref|: %s%s; two calls '
                  'bit-identical; kernel %.4f ms, cuDNN wgrad %.4f ms, plain '
                  '%.4f ms (best of 2 x 10, in turns), bound %.4f ms (%s); '
                  'kernel / bound %.2f, kernel / cuDNN %.3f'
                  % (str(dtype).split('.')[-1], list(x_shape),
                     [b_, f, h_, w_], scale, max_abs, max_rel, lib_abs,
                     K4_RTOL, K4_ATOL, 'ok' if ok else 'FAIL', faithful,
                     best['kernel'][0], best['library'][0],
                     best['plain'][0], bound_ms, bound_by,
                     best['kernel'][0] / bound_ms,
                     best['kernel'][0] / best['library'][0]))
            if not ok:
                raise AssertionError('K4 disagrees with its plain version')
            if faithful.endswith('FAIL'):
                raise AssertionError('K4\'s float32 body is not float32-'
                                     'faithful')
            if dtype == torch.bfloat16:
                err['K4'] = max(err['K4'], max_abs)
            del x, dy, out, again, ref, lib
    for dtype in (torch.bfloat16, torch.float32):
        tot = [sum(k4[(dtype, xs, f)][i] * n for xs, f, n in K4_SHAPES)
               for i in range(4)]
        print('phase 11 K4 per step (5 launches), %s: kernel %.4f ms, plain '
              '%.4f ms, bound %.4f ms, cuDNN wgrad %.4f ms; kernel / bound '
              '%.2f, kernel / cuDNN %.3f'
              % (str(dtype).split('.')[-1], *tot, tot[0] / tot[2],
                 tot[0] / tot[3]))
        if dtype == torch.float32:
            simt = sum(n * _bound(*_k4_work(xs, f, 4))[0]
                       for xs, f, n in K4_SHAPES)
            print('phase 11 K4 per step, float32: kernel %.4f ms against its '
                  'bound at the TF32 tensor-core peak done three times '
                  '(3xTF32) %.4f ms, the float32 SIMT peak\'s %.4f ms and '
                  'cuDNN\'s float32 wgrad (TF32 off) %.4f ms'
                  % (tot[0], tot[2], simt, tot[3]))
            # the float32 body's own record, totals over the 5 launches of
            # a full-width float32 step; its launches are counted in that
            # step (phase 13: the flagship trains in bf16)
            extra['K4'] = {'float32': {
                'name': 'dw_tf32x3_kernel', 'launches': None,
                'max_abs_err': max(k4[(dtype, xs, f)][5]
                                   for xs, f, _ in K4_SHAPES),
                'ms': tot[0], 'plain_ms': tot[1], 'bound_ms': tot[2],
                'bound_by': max((k4[(dtype, xs, f)][2], k4[(dtype, xs, f)][4])
                                for xs, f, _ in K4_SHAPES)[1],
                'bound_simt_ms': simt, 'library_ms': tot[3]}}
        if dtype == torch.bfloat16:
            timing['K4'] = (tot[0], tot[1], tot[2], max(
                (k4[(dtype, xs, f)][2], k4[(dtype, xs, f)][4])
                for xs, f, _ in K4_SHAPES)[1], tot[3],
                            'per step: %s' % ', '.join(
                                '%d x x %s dy F=%d' % (n, list(xs), f)
                                for xs, f, n in K4_SHAPES))

    # 12. the sampler with K3, against the unfused sampler. The images are
    #     held to both bars with float32 BatchNorm on both sides (fusion
    #     alone), and to the mean bar at the config's bfloat16 BatchNorm.
    #     There the fused tails round their affine in bfloat16 as the JAX
    #     kernel does, and the unfused ones round the float32 result once:
    #     the JAX package's own fused and unfused generators differ by up to
    #     0.18 at one pixel of tests/test_torch_port_bn_dtype.py's small
    #     run, which holds the port's gap to JAX's; the max is reported
    fcfg = copy.deepcopy(cfg)
    fcfg.TPU_FUSED_BN_GLU = True
    samplers = {}
    for name, c in (('off', cfg), ('on', fcfg)):
        for bn in (c.TPU_BN_DTYPE, 'float32'):
            cb = copy.deepcopy(c)
            cb.TPU_BN_DTYPE = bn
            g = build_generator(cb, train_flag=False)
            g.load_state_dict(state, strict=True)
            samplers[name if bn == c.TPU_BN_DTYPE else name + ' float32 BN'] \
                = g.to(dev).eval()
    b, c = cfg.TRAIN.BATCH_SIZE, 10
    noise = torch.randn((c, b, cfg.GAN.Z_DIM), device=dev)
    emb = torch.randn((c, b, cfg.TEXT.DIMENSION), device=dev) * 0.03
    gens = {name: torch.Generator(device=dev) for name in samplers}

    def sampler(name):
        return caption_sample(samplers[name], noise, emb,
                              generator=gens[name])

    reset_launches()
    out = sampler('on')
    torch.cuda.synchronize()
    sampler_launches = launches()
    want = dict(PER_RUN, **{'K1-G': 1, 'K3': 8})
    if tuple(out.shape) != (c, b, cfg.imsize, cfg.imsize, 3) or \
            sampler_launches != want:
        raise AssertionError('fused sampler: output %s, launches %s (want '
                             '%s)' % (tuple(out.shape), sampler_launches,
                                      want))
    flat = dict(noise=noise.reshape(c * b, -1), sen=emb.reshape(c * b, -1),
                cls_prior=torch.randn((c * b, cfg.GAN.MANIFD_DIM),
                                      device=dev),
                eps=torch.randn((c * b, cfg.GAN.EMBEDDING_DIM), device=dev))
    imgs = {name: sample_images(g, flat['noise'], flat['sen'],
                                cls_prior=flat['cls_prior'], eps=flat['eps'])
            for name, g in samplers.items()}
    fin = all(bool(torch.isfinite(i).all()) for name in imgs
              for i in imgs[name])
    gap = {}
    for bn in ('', ' float32 BN'):
        diffs = [(a - b_).abs() for a, b_ in zip(imgs['on' + bn],
                                                 imgs['off' + bn])]
        gap[bn] = (max(float(d.mean()) for d in diffs),
                   max(float(d.max()) for d in diffs))
    best = _best_ms({'off': lambda: sampler('off'),
                     'on': lambda: sampler('on')}, iters=10)
    print('phase 12 sampler with TPU_FUSED_BN_GLU (%s compute, %s '
          'BatchNorm, %d images per call): launches %s; %.3f ms per call '
          'fused vs %.3f ms unfused (best of 2 x 10; all: fused %s unfused '
          '%s); images vs the unfused sampler on the same weights, finite %s: '
          'with float32 BatchNorm mean diff %.3e (bound 1e-2), max %.3e '
          '(bound 1e-1); with %s BatchNorm mean diff %.3e (bound 1e-2), max '
          '%.3e (reported)'
          % (cfg.TPU_COMPUTE_DTYPE, cfg.TPU_BN_DTYPE, b * c, sampler_launches,
             best['on'][0], best['off'][0],
             ['%.3f' % t for t in best['on'][1]],
             ['%.3f' % t for t in best['off'][1]], fin,
             *gap[' float32 BN'], cfg.TPU_BN_DTYPE, *gap['']))
    d_mean, d_max = gap[' float32 BN']
    if not (fin and d_mean <= 1e-2 and d_max <= 0.1 and gap[''][0] <= 1e-2):
        raise AssertionError('the fused sampler disagrees with the unfused')
    del samplers, imgs, diffs, out

    # 13. the training path with both switches on
    fcfg = copy.deepcopy(tcfg)
    for k, v in SWITCHES.items():
        setattr(fcfg, k, v)
    trainer = CondGANTrainer(fcfg, os.path.join(WORK, 'train_fused'),
                             device='cuda')
    reset_launches()
    t0 = time.perf_counter()
    fstate = trainer.train(max_steps=FUSED_TRAIN_STEPS)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches = launches()
    metrics = trainer.last_metrics
    want = {k: FUSED_TRAIN_STEPS * PER_STEP_FUSED[k] + PER_RUN_FUSED[k]
            for k in PER_STEP_FUSED}
    finite = all(np.isfinite(v) for v in metrics.values())
    print('phase 13 train(max_steps=%d) with %s, %s compute, batch %d: '
          '%.2f s; launches %s (want %s: per step %s, per run %s); finite '
          'losses %s (errD %.4f errG %.4f)'
          % (FUSED_TRAIN_STEPS, SWITCHES, fcfg.TPU_COMPUTE_DTYPE,
             fcfg.TRAIN.BATCH_SIZE, fused_s, fused_launches, want,
             PER_STEP_FUSED, PER_RUN_FUSED, finite, metrics['errD'],
             metrics['errG']))
    if fused_launches != want:
        raise AssertionError('the training path with both switches did not '
                             'launch the kernels as expected')
    if not finite or len(metrics) < 14:
        raise AssertionError('training metrics %s' % metrics)
    batch = trainer._device_batch(next(iter(trainer.data_loader)))
    runs = {'off': (make_train_step(tcfg),
                    create_train_state(tcfg, 'cuda', seed=0)),
            'on': (make_train_step(fcfg), fstate)}
    seed = [2000]

    def five_steps(name):
        fn, st = runs[name]
        for _ in range(5):
            seed[0] += 1
            fn(st, batch, seed[0])

    step_times = {'off': [], 'on': []}
    for name in ('off', 'on'):
        five_steps(name)  # warm up
    torch.cuda.synchronize()
    for name in ('off', 'on', 'on', 'off'):
        t0 = time.perf_counter()
        five_steps(name)
        torch.cuda.synchronize()
        step_times[name].append((time.perf_counter() - t0) / 5 * 1e3)
    print('phase 13 train step on %s, %s compute, batch %d, in turns (off, '
          'on, on, off; 5 steps each, host clock with synchronize): switches '
          'off %.2f ms (all %s), on %.2f ms (all %s)'
          % (card, fcfg.TPU_COMPUTE_DTYPE, fcfg.TRAIN.BATCH_SIZE,
             min(step_times['off']), ['%.2f' % t for t in step_times['off']],
             min(step_times['on']), ['%.2f' % t for t in step_times['on']]))
    for name in ('K3', 'K4'):
        print('phase 13 %s: %s at %.4f ms = %.1f%% of a step with both '
              'switches' % (name, timing[name][5], timing[name][0],
                            100 * timing[name][0] / min(step_times['on'])))
    # the float32 body's path: one full-width step with both switches and
    # TPU_COMPUTE_DTYPE / TPU_BN_DTYPE float32, its launches counted alone;
    # they are the float32 record's, whose times phase 11 totals over the
    # same 5 launches
    f32cfg = copy.deepcopy(fcfg)
    f32cfg.TPU_COMPUTE_DTYPE = f32cfg.TPU_BN_DTYPE = 'float32'
    f32state = create_train_state(f32cfg, 'cuda', seed=0)
    f32step = make_train_step(f32cfg)
    reset_launches()
    m32, _ = f32step(f32state, batch, 3000)
    torch.cuda.synchronize()
    f32_launches = launches()
    finite = all(np.isfinite(float(v)) for v in m32.values())
    print('phase 13 train step with %s, float32 compute and BatchNorm, batch '
          '%d: launches %s (want %s); finite losses %s (errD %.4f errG %.4f)'
          % (SWITCHES, f32cfg.TRAIN.BATCH_SIZE, f32_launches, PER_STEP_FUSED,
             finite, float(m32['errD']), float(m32['errG'])))
    if f32_launches != PER_STEP_FUSED:
        raise AssertionError('the float32 step with both switches did not '
                             'launch the kernels as expected')
    if not finite:
        raise AssertionError('float32 step metrics %s' % m32)
    extra['K4']['float32']['launches'] = f32_launches['K4']
    del trainer, fstate, runs, batch, f32state

    # 14. the microbenchmark's variant sweep, the path that runs V
    reset_launches()
    bench_runs = [bench.run(bench.parse_args(
        ['--variants', '--batch', str(b_), '--shape', sh]))
        for b_, sh in V_RUNS]
    torch.cuda.synchronize()
    v_launches = launches()
    # per sweep entry one parity call and two timed runs, each after a
    # warm-up; the bench runs no backward and no K3 or K4
    per_entry = 1 + 2 * (bench.WARM + bench.TIMED)
    want_v = {k: 0 for k in kernels if k not in ('K1-G', 'K1-D')}
    for name, nbs in bench.SWEEP:
        want_v[name] = len(V_RUNS) * len(nbs) * per_entry
    got_v = {k: v_launches[k] for k in want_v}
    print('phase 14 bench_capsule_torch --variants x %d runs: launches %s '
          '(K1-G %d, K1-D %d as the yardstick); want %s'
          % (len(V_RUNS), got_v, v_launches['K1-G'], v_launches['K1-D'],
             want_v))
    if got_v != want_v or not (v_launches['K1-G'] and v_launches['K1-D']):
        raise AssertionError('the variant sweep did not launch the kernels '
                             'as expected')
    v_record = {}
    for res in bench_runs:
        shape = tuple(res['shape'])
        bound_ms, bound_by = _bound(*_k1_work(shape, shape[2] == 8))
        rows = {(r['name'], r['nb']): r for r in res['rows']}
        plain_ms = rows[('plain', None)]['ms']
        for name, nbs in bench.SWEEP:
            for nb in nbs:
                r = rows[(name, nb)]
                print('phase 14 %s NB=%d at %s on %s: %.4f ms, K1 %.4f ms in '
                      'turns (%.2fx K1), plain %.4f ms, bound %.4f ms (%s), '
                      'max_abs_err %.3e'
                      % (name, nb, list(shape), card, r['ms'], r['k1_ms'],
                         r['ms'] / r['k1_ms'], plain_ms, bound_ms, bound_by,
                         r['max_abs_err']))
                err[name] = max(err[name], r['max_abs_err'])
                rec = v_record.setdefault(name, {'sweep': []})
                rec['sweep'].append([list(shape), nb, r['ms'], r['k1_ms']])
                if res is bench_runs[0] and r['ms'] < rec.get('ms', math.inf):
                    rec.update(ms=r['ms'], plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by,
                               shape=list(shape), nb=nb)

    # 15. checkpoint and resume on the card
    _checkpoint_phase(tcfg, reset_launches, launches, card)

    shutil.rmtree(WORK, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',
                                        'text2img_ekl_tpu'))
    print('imported JAX or JAX-package modules: %s' % (bad or 'none'))
    if bad:
        raise AssertionError('the port imported %s' % bad)
    csrc, jops = 'text2img_ekl_tpu_torch/csrc/', 'text2img_ekl_tpu/ops/'
    sources = {
        'K1-G': (csrc + 'capsule_routing.cu', jops + 'capsule_pallas.py:32'),
        'K1-D': (csrc + 'capsule_routing.cu', jops + 'capsule_pallas.py:32'),
        'K2-G': (csrc + 'capsule_routing_bwd.cu',
                 jops + 'capsule_pallas.py:114'),
        'K2-D': (csrc + 'capsule_routing_bwd.cu',
                 jops + 'capsule_pallas.py:114'),
        'K3': (csrc + 'bn_glu.cu', jops + 'bn_glu.py:48'),
        'K4': (csrc + 'conv3x3_dw.cu', jops + 'conv_dw.py:136'),
        'V-stored': (csrc + 'capsule_variants.cu',
                     'tools/capsule_variants.py:83'),
        'V-seq': (csrc + 'capsule_variants.cu',
                  'tools/capsule_variants.py:143'),
        'V-recompute': (csrc + 'capsule_variants.cu',
                        'tools/capsule_variants.py:218')}
    record = []
    for name, fn in kernels.items():
        more = extra.get(name, {})
        if name in cc.KERNELS:
            ms, plain_ms, work, shape = timing[name]
            if name == 'K2-D':
                bound_ms, bound_by = _k2d_bound(shape)[:2]
            elif name == 'K1-D':
                bound_ms, bound_by = _k1d_bound(shape)[:2]
            else:
                bound_ms, bound_by = _bound(*work)
            library_ms, shape, n = None, list(shape), train_launches[name]
        elif name in cv.KERNELS:  # the record shape's fastest NB
            v = v_record[name]
            ms, plain_ms, bound_ms, bound_by = (v['ms'], v['plain_ms'],
                                                v['bound_ms'], v['bound_by'])
            library_ms, shape, n = None, v['shape'], v_launches[name]
            more = {'nb': v['nb'], 'sweep': v['sweep']}
        else:  # totals over the flagship's launches per G forward / step
            ms, plain_ms, bound_ms, bound_by, library_ms, shape = timing[name]
            n = fused_launches[name]
        record.append(dict({
            'name': '%s %s' % (name, fn.__name__), 'route': 'cuda',
            'source': sources[name][0], 'replaces': sources[name][1],
            'launches': n, 'max_abs_err': err[name],
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms,
            'shape': shape}, **more))
    print(card)
    print(json.dumps({'kernels': record}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
