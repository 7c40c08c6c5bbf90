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
     returns and the handlers are restored;
 16. the Inception towers (random weights from a seed; no Inception
     weights are in the repository): (a) the 51-class slim tower on 8
     generator-range images at 128 px and the 1,008-class fid tower on 8
     0..255 images, float32 on the card (TF32 off) against the CPU (pool_3,
     probabilities, IS), and the bf16 in-training tower against float32;
     (b) the flagship trains with TPU_IS_EVERY 1 for 6 epochs of its
     16-batch synthetic epoch (96 steps, 3,072 pooled fakes): the IS is
     printed once, at epoch 5, and logged, no protected snapshot is
     written, and the kernels' launches per step do not change; then the
     step with and without the stream, in turns; (c) evaluate with
     TPU_EVAL_DIRECT on phase 3's config and weights (640 images, no PNG):
     its one-split IS against is_of_dir_torch.py on phase 3's PNGs, its FID
     against fid_torch.py --save_stats of that directory; (d) the tower's
     images/s, float32 at batch 64 and bf16 at batch 32;
 17. the native host paths (csrc/*.cpp, built with g++ into build/): (a)
     build the JPEG decoder and the PNG writer and print what the host
     offers (g++'s version, jpeglib.h, png.h, libjpeg, libpng); a half
     whose header or library is missing prints "phase 17 <half> SKIPPED"
     and its checks run on the PIL fallback instead; (b) phase 3's
     evaluate gave the native writer a batch per caption row and flushed
     with no error; evaluate with T2I_NATIVE_WRITE 1 and 0 in turns (1, 0,
     0, 1), images/s each, the sampler's uint8 stacks the same in every
     turn, one batch's PNGs equal to its stack, and the two directories
     the same names and pixels; (c) train(max_steps=3) at full width on 96
     fabricated 500x375 CUB JPEGs with TPU_NATIVE_DECODE: every batch from
     the native decoder, finite losses, phase 8's launches per step; the
     epoch's time against synthetic data; tools/bench_loader_torch.py
     --n 256 --bs 32;
 18. K5 (BatchNorm with its GLU / LeakyReLU / no epilogue): one flagship
     training step (batch 32) and one sampler call, in which K5 ran once
     (3 kernels a train forward and 3 a backward, 1 an eval forward) for
     every rank-4 BatchNorm call a forward hook records, at the shapes of
     K5_STEP_CALLS, and no rank-4 BatchNorm on the card took the eager
     chain; then at each of those shapes at the benchmark's batches
     (train at 512, the sampler's eval at 320), bfloat16: K5's output,
     gradients and running statistics against the eager chain it
     replaces (the card tests' bars), and its forward and backward device
     time, each from a cold L2, against its bound (bytes / 3.35 TB/s,
     which no time may beat) and the eager chain's, totalled over the
     step's calls.

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
# K5's rank-4 BatchNorm calls in a flagship training step, batch aside:
# ((C, H, W), epilogue, forwards a step), each forward with its backward:
# the G's 10; 4 passes through each D (three in its update, one in G's
# loss) with 4 and 6. Phase 18 holds the calls a forward hook records in a
# step to this table, and runs K5 at these shapes at K5_BATCH, the
# benchmark's training batch.
K5_STEP_CALLS = (((1024, 8, 8), 'glu', 1), ((512, 16, 16), 'glu', 1),
                 ((256, 32, 32), 'glu', 1), ((128, 64, 64), 'glu', 4),
                 ((64, 64, 64), None, 2), ((64, 128, 128), 'glu', 1),
                 ((128, 16, 16), 'leaky', 4), ((256, 8, 8), 'leaky', 4),
                 ((512, 4, 4), 'leaky', 16), ((128, 32, 32), 'leaky', 4),
                 ((256, 16, 16), 'leaky', 4), ((512, 8, 8), 'leaky', 4),
                 ((1024, 4, 4), 'leaky', 4))
K5_BATCH = 512
# K5 against the eager chain it replaces (BatchNormAct.composition) on the
# same inputs, here and in the card tests (tests/test_torch_port_cuda.py),
# through _k5_compare. Both compute the statistics in float32, summed in
# other orders (eval: cuDNN's inference kernel folds the affine otherwise),
# so a BatchNorm output may round to its neighbouring value of the BatchNorm
# dtype. An activation carries such a flip on: a GLU's gate through its
# logistic to several ulps of its output (3.0 measured on an H100, in eval
# mode at the sampler's batch of 320). So the BatchNorm part and the epilogue
# are held apart. Bars: K5's BatchNorm output (epilogue=False) within
# K5_FWD_ULPS ulps of the BatchNorm dtype + K5_FWD_ATOL max|ref| (values
# within float32 rounding of zero) of the chain's; K5's output the eager
# activation of that BatchNorm output bit for bit; in bfloat16 at most
# K5_FWD_SHARE of the elements of either differ at all (measured: at most
# 5e-5; in float32 every element of a channel moves with its statistics); the
# running statistics within K5_STATS_RTOL |ref| + K5_STATS_ATOL max|ref|; dx,
# dweight and dbias no farther from the chain evaluated in float64 than
# K5_GRAD_RATIO times the eager chain's own distance (L2), + K5_GRAD_FLOOR of
# the float64 gradient's norm (float32 rounding of a channel's sums: the
# ratio read 0.06-1.05 at the step's shapes and up to 1.95 where both sit
# ~3e-7 of the norm apart at [7, 8, 3, 3]).
K5_FWD_ULPS = 1
K5_FWD_ATOL = 1e-6
K5_FWD_SHARE = 1e-3
K5_STATS_RTOL, K5_STATS_ATOL = 1e-5, 1e-6
K5_GRAD_RATIO = 1.5
K5_GRAD_FLOOR = 1e-6
K5_POLICIES = {'bf16': ('bfloat16', 'bfloat16'),
               'f32': ('float32', 'float32')}
# a timed call waits behind a sleep kernel of this many cycles (~5 ms on
# an H100), long enough for the host to queue all of the call first
SLEEP_CYCLES = 10_000_000
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
    """Forward hooks on every LeakyReLU of ``nets``, the modules and the
    epilogues of ``BatchNormAct`` (act 'leaky'). Recording, they append to
    ``masks`` which inputs of each call were positive (an epilogue's from
    the sign of its output, which is its input's); replaying, each call
    takes the recorded branch (x or 0.2 x), so that a second run goes
    through the same pieces of the piecewise-linear networks (a replayed
    ``BatchNormAct`` runs with ``epilogue=False``, and the hook applies the
    branch to its BatchNorm output). An input within rounding of zero
    takes the other slope under another summation order (ROADMAP F10),
    which moves a whole receptive field's gradient. Returns (hook handles,
    [flips pinned])."""
    import torch
    from text2img_ekl_tpu_torch.nn.blocks import BatchNormAct
    calls, flips = iter(masks), [0]

    def hook(module, args, out):
        x = args[0]
        if not replay:
            masks.append(x > 0)
            return None
        mask = next(calls).to(x.device)
        flips[0] += int((mask != (x > 0)).sum())
        return torch.where(mask, x, 0.2 * x).to(module.dtype)

    def bn_pre(module, args, kwargs):
        return args, dict(kwargs, epilogue=False)

    def bn_hook(module, args, out):
        if not replay:
            masks.append(out > 0)
            return None
        return hook(module, (out,), out)

    handles = []
    for net in nets:
        for m in net.modules():
            if isinstance(m, leaky_relu):
                handles.append(m.register_forward_hook(hook))
            elif isinstance(m, BatchNormAct) and m.act == 'leaky':
                if replay:
                    handles.append(m.register_forward_pre_hook(
                        bn_pre, with_kwargs=True))
                handles.append(m.register_forward_hook(bn_hook))
    return handles, flips


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


# phase 16: the towers' bars. Card float32 against the CPU's: pool_3 and
# logits |d| <= 1e-3 max|ref|, probabilities |d| <= 1e-4, IS 1e-4
# relative; the float32 tower with cuDNN's TF32 on (PyTorch's default)
# bit-identical to it with TF32 off (the tower turns TF32 off itself). The
# bf16 in-training tower against the card's float32 one: pool_3 |d| <= 4e-2
# max|ref| (the CPU's bf16 tower reads 1.4e-2 and 1.5e-2 from its float32
# one on these inputs; the logits gap is printed), IS 1e-2 relative. Direct
# eval against the PNG route: IS 1e-4 relative (the CLI prints 4
# decimals), FID against the PNG directory's own statistics below 1e-3 of
# their sigma's trace.
TOWER_POOL_TOL, TOWER_PROB_TOL, TOWER_IS_RTOL = 1e-3, 1e-4, 1e-4
BF16_POOL_RTOL, BF16_IS_RTOL = 4e-2, 1e-2
DIRECT_IS_RTOL, DIRECT_FID_TRACE = 1e-4, 1e-3
# the IS stream's run: TPU_IS_EVERY 1 over 6 epochs of the 16-batch
# synthetic epoch, 96 steps and 3,072 pooled fakes: one score, at epoch 5
STREAM_EPOCHS = 6
# the gate's cost per step: pairs of 5-step turns without and with it
GATE_PAIRS = 12


def _captured(fn, *args, **kw):
    """fn's result and what it printed; the print goes on to stdout."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def _printed(text, tag):
    line = [ln for ln in text.splitlines() if ln.startswith(tag)][-1]
    return [float(v) for v in line[len(tag):].split(' +- ')]


def _tower_phase(card):
    """16a. The towers on the card against the CPU, and bf16 against
    float32."""
    import torch
    from text2img_ekl_tpu_torch.eval.inception_score import (
        InceptionScorer, compute_inception_score)
    from text2img_ekl_tpu_torch.io_utils.weights import (
        RANDOM_INCEPTION_SEED, random_inception)
    from text2img_ekl_tpu_torch.models.inception_v3 import (
        preprocess_frozen, preprocess_gan_output)
    gen = torch.Generator().manual_seed(16)
    gan = torch.rand((8, 3, 128, 128), generator=gen) * 2 - 1
    pixels = torch.randint(0, 256, (8, 128, 128, 3), generator=gen,
                           dtype=torch.uint8)
    for flavor, n, images in (('slim', 51, gan), ('fid', 1008, pixels)):
        sd = random_inception(RANDOM_INCEPTION_SEED, n, flavor)
        kw = dict(finetuned=flavor == 'slim', flavor=flavor)
        scorers = {'cpu': InceptionScorer(sd, n, device='cpu', **kw),
                   'cuda': InceptionScorer(sd, n, device='cuda', **kw),
                   'bf16': InceptionScorer(sd, n, device='cuda',
                                           dtype=torch.bfloat16, **kw)}
        probs, logits, pool3 = {}, {}, {}
        for name, s in scorers.items():
            x = images.to(s.device)
            with torch.no_grad():
                if flavor == 'slim':
                    probs[name] = s.predict_batch(x).cpu()
                    pre = preprocess_gan_output(x)
                else:
                    probs[name] = s.predict_uint8(x).cpu()
                    pre = preprocess_frozen(x.permute(0, 3, 1, 2))
                logits[name], ep = s.model(pre)
                logits[name], pool3[name] = logits[name].cpu(), \
                    ep['pool_3'].cpu()
                if name == 'cuda':
                    torch.backends.cudnn.allow_tf32 = True
                    try:
                        tf32_on = s.model(pre)[1]['pool_3'].cpu()
                    finally:
                        torch.backends.cudnn.allow_tf32 = False
        score = {k: compute_inception_score(p.numpy())[0]
                 for k, p in probs.items()}

        def gap(got, ref):
            return (float((got - ref).abs().max()), float(ref.abs().max()))

        pool_err, ref = gap(pool3['cuda'], pool3['cpu'])
        logit_err, logit_ref = gap(logits['cuda'], logits['cpu'])
        prob_err = float((probs['cuda'] - probs['cpu']).abs().max())
        bf16_pool, bf16_ref = gap(pool3['bf16'], pool3['cuda'])
        bf16_logit, bf16_logit_ref = gap(logits['bf16'], logits['cuda'])
        bf16_prob = float((probs['bf16'] - probs['cuda']).abs().max())
        print('phase 16a %s tower (%d classes, 8 images %s) on %s, float32 '
              'vs the CPU: pool_3 max|ref| %.4e, max_abs_err %.3e (bar %.1e '
              'x max|ref|); logits max|ref| %.4e, max_abs_err %.3e (same '
              'bar); probabilities max_abs_err %.3e (bar %.0e); IS %.8f vs '
              '%.8f; with cuDNN TF32 on, pool_3 bit-identical: %s'
              % (flavor, n, 'in [-1, 1] at 128 px' if flavor == 'slim' else
                 'of 0..255 at 128 px', card, ref, pool_err, TOWER_POOL_TOL,
                 logit_ref, logit_err, prob_err, TOWER_PROB_TOL,
                 score['cuda'], score['cpu'], torch.equal(tf32_on,
                                                          pool3['cuda'])))
        print('phase 16a %s bf16 tower vs float32 on %s: pool_3 max_abs_err '
              '%.3e, %.3e of max|ref| (bar %.0e); logits %.3e of max|ref| '
              '%.4e; largest probability gap %.3e; IS %.8f vs %.8f (bar %.0e '
              'relative)'
              % (flavor, card, bf16_pool, bf16_pool / bf16_ref,
                 BF16_POOL_RTOL, bf16_logit / bf16_logit_ref, bf16_logit_ref,
                 bf16_prob, score['bf16'], score['cuda'], BF16_IS_RTOL))
        if not (pool_err <= TOWER_POOL_TOL * ref
                and logit_err <= TOWER_POOL_TOL * logit_ref
                and prob_err <= TOWER_PROB_TOL
                and abs(score['cuda'] - score['cpu'])
                <= TOWER_IS_RTOL * score['cpu']):
            raise AssertionError('the %s tower on the card disagrees with '
                                 'the CPU' % flavor)
        if not torch.equal(tf32_on, pool3['cuda']):
            raise AssertionError('the float32 %s tower ran in TF32' % flavor)
        if not (bf16_pool <= BF16_POOL_RTOL * bf16_ref
                and abs(score['bf16'] - score['cuda'])
                <= BF16_IS_RTOL * score['cuda']):
            raise AssertionError('the bf16 %s tower disagrees with the '
                                 'float32 one' % flavor)


def _device_busy_ms(fn, calls=5):
    """The device's busy time a call of ``fn``: the sum of the device
    activities torch.profiler records over ``calls`` calls, after one;
    0 where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if str(e.device_type).endswith('CUDA')) / calls / 1e3


def _k5_module(shape, act, policy, mode, device, seed=0):
    """A BatchNormAct with random affine and running statistics, in
    ``mode`` (train, eval or frozen), its input x [B, C, H, W] and an output
    gradient."""
    import numpy as np
    import torch
    from text2img_ekl_tpu_torch.nn.blocks import BatchNormAct
    from text2img_ekl_tpu_torch.ops import bn_act
    dtype, bn_dtype = (getattr(torch, t) for t in K5_POLICIES[policy])
    rng = np.random.default_rng(seed)
    c = shape[1]

    def put(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

    m = BatchNormAct(c, act, dtype, bn_dtype).to(device)
    with torch.no_grad():
        m.weight.copy_(put(rng.normal(1.0, 0.3, c)))
        m.bias.copy_(put(rng.normal(0.0, 0.3, c)))
        m.running_mean.copy_(put(rng.normal(0.3, 0.3, c)))
        m.running_var.copy_(put(rng.uniform(0.5, 1.5, c)))
    m.train(mode != 'eval')
    m.update_running_stats = mode != 'frozen'
    x = (put(rng.standard_normal(shape, dtype=np.float32)) * 2 + 0.5
         ).to(dtype)
    oshape = (shape[0], c // 2) + tuple(shape[2:]) if act == 'glu' \
        else tuple(shape)
    dout = put(rng.standard_normal(oshape, dtype=np.float32)).to(
        bn_act.out_dtype(dtype, act, bn_dtype))
    return m, x, dout


def _k5_run(m, x, dout, kernel):
    """(out, dx, dweight, dbias, running_mean, running_var) of a copy of
    ``m`` through K5 or the eager chain; K5's counters move by one call and
    its forward's and backward's launches."""
    import torch
    from text2img_ekl_tpu_torch.ops import bn_act
    m = copy.deepcopy(m)
    xg = x.clone().requires_grad_(True)
    calls, launches = bn_act.bn_act.calls, bn_act.bn_act.launches
    out = m(xg) if kernel else m.composition(xg)
    dx, dw, db = torch.autograd.grad(out, (xg, m.weight, m.bias), dout)
    torch.cuda.synchronize()
    # a forward's 3 kernels in train mode, 1 in eval, and a backward's 3
    want = (calls + kernel, launches + kernel * ((3 if m.training else 1)
                                                 + 3))
    if (bn_act.bn_act.calls, bn_act.bn_act.launches) != want:
        raise AssertionError('K5 counted %d calls and %d launches, not %s'
                             % (bn_act.bn_act.calls, bn_act.bn_act.launches,
                                want))
    return (out.detach(), dx, dw, db, m.running_mean.clone(),
            m.running_var.clone())


def _k5_float64(m, x, dout):
    """(out, dx, dweight, dbias) of the chain in float64: the statistics,
    the affine, the activation and its gradient, and the BatchNorm
    gradient in closed form."""
    import torch
    from text2img_ekl_tpu_torch.nn.blocks import _BF16_SLOPE
    xd, dd = x.double(), dout.double()
    w, b = m.weight.detach().double(), m.bias.detach().double()
    shape = (1, -1, 1, 1)
    dims = (0, 2, 3)
    if m.training:
        mean = xd.mean(dims)
        var = torch.clamp((xd * xd).mean(dims) - mean * mean, min=0.0)
    else:
        mean, var = m.running_mean.double(), m.running_var.double()
    rstd = torch.rsqrt(var + m.eps)
    xhat = (xd - mean.view(shape)) * rstd.view(shape)
    y = xhat * w.view(shape) + b.view(shape)
    if m.act == 'glu':
        c = y.shape[1] // 2
        a, s = y[:, :c], torch.sigmoid(y[:, c:])
        out = a * s
        dy = torch.cat([dd * s, dd * a * s * (1 - s)], 1)
    elif m.act == 'leaky':
        slope = _BF16_SLOPE if m.bn_dtype == torch.bfloat16 else 0.2
        out = torch.where(y > 0, y, slope * y)
        dy = torch.where(y > 0, dd, slope * dd)
    else:
        out, dy = y, dd
    db = dy.sum(dims)
    dw = (dy * xhat).sum(dims)
    dxhat = dy * w.view(shape)
    if m.training:
        count = x.numel() // x.shape[1]
        dx = rstd.view(shape) * (dxhat - dxhat.sum(dims, keepdim=True) / count
                                 - xhat * (dxhat * xhat).sum(
                                     dims, keepdim=True) / count)
    else:
        dx = dxhat * rstd.view(shape)
    return out, dx, dw, db


def _k5_ulps(out, ref, dtype):
    """(the worst |out - ref| over its bar, K5_FWD_ULPS ulps of ``dtype``
    + K5_FWD_ATOL max|ref|; the share of elements that differ)."""
    import torch
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    big = torch.maximum(o.abs(), r.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big))
                     - (7 if dtype == torch.bfloat16 else 23))
    bound = K5_FWD_ULPS * ulp + K5_FWD_ATOL * r.abs().max()
    return float((d / bound).max()), float((d > 0).float().mean())


def _k5_compare(m, x, dout):
    """K5 against the eager chain on the same module, input and output
    gradient, to the K5_* bars: the BatchNorm output, the epilogue on it,
    the output, the running statistics (updated in train mode, untouched in
    eval and frozen), and dx, dweight and dbias against the chain in
    float64. Raises AssertionError where one misses its bar; returns
    {'max_abs_err': the output's largest |d|, 'share': the share of output
    elements that differ, 'grad_ratio': the worst gradient's distance from
    float64 over the eager chain's, 'max_ulps': the output's largest |d| in
    ulps of its dtype (with the bar's atol)}."""
    import torch
    from text2img_ekl_tpu_torch.nn.blocks import _EPILOGUES
    got = _k5_run(m, x, dout, kernel=True)
    want = _k5_run(m, x, dout, kernel=False)
    if got[0].dtype != want[0].dtype or got[0].shape != want[0].shape:
        raise AssertionError('K5 gave %s %s, the chain %s %s' % (
            got[0].dtype, tuple(got[0].shape), want[0].dtype,
            tuple(want[0].shape)))
    # the BatchNorm part: K5 without its epilogue against the chain's
    # BatchNorm, a neighbouring rounding at most, on a small share of the
    # elements in bfloat16
    with torch.no_grad():
        y = copy.deepcopy(m)(x, epilogue=False)
        y_ref = copy.deepcopy(m).composition(x, epilogue=False)
    worst, share = _k5_ulps(y, y_ref, m.bn_dtype)
    if worst > 1 or (m.bn_dtype == torch.bfloat16 and share > K5_FWD_SHARE):
        raise AssertionError('K5 BatchNorm output off the chain: %.3f of '
                             'its bar, %.2e of the elements differ'
                             % (worst, share))
    # the epilogue: the eager activation of K5's own BatchNorm output, bit
    # for bit
    if not torch.equal(got[0], y if m.act is None else
                       _EPILOGUES[m.act](y, m.dtype)):
        raise AssertionError('K5\'s output is not the eager %s of its '
                             'BatchNorm output' % m.act)
    o, r = got[0].float(), want[0].float()
    d = (o - r).abs()
    share = float((d > 0).float().mean())
    if m.bn_dtype == torch.bfloat16 and share > K5_FWD_SHARE:
        raise AssertionError('K5 output off the chain at %.2e of the '
                             'elements' % share)
    # running statistics
    for name, g, w0, w in zip(('running_mean', 'running_var'), got[4:],
                              (m.running_mean, m.running_var), want[4:]):
        if m.training and m.update_running_stats:
            tol = K5_STATS_RTOL * w.abs() + K5_STATS_ATOL * w.abs().max()
            if torch.equal(w, w0) or bool(((g - w).abs() > tol).any()):
                raise AssertionError('K5 %s off the chain or not updated'
                                     % name)
        elif not (torch.equal(g, w0) and torch.equal(w, w0)):
            raise AssertionError('%s moved in %s mode' % (
                name, 'eval' if not m.training else 'frozen'))
    # backward against the chain in float64
    ref = _k5_float64(m, x, dout)
    ratio = 0.0
    for name, g, w, f in zip(('dx', 'dweight', 'dbias'), got[1:4],
                             want[1:4], ref[1:]):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError('K5 %s is %s %s, the chain\'s %s %s' % (
                name, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape)))
        e_k = float(torch.linalg.vector_norm(g.double() - f))
        e_e = float(torch.linalg.vector_norm(w.double() - f))
        floor = K5_GRAD_FLOOR * float(torch.linalg.vector_norm(f))
        if e_k > K5_GRAD_RATIO * e_e + floor:
            raise AssertionError('K5 %s %.3e from float64, the chain %.3e '
                                 '(bar %.1fx + %.2e)' % (
                                     name, e_k, e_e, K5_GRAD_RATIO, floor))
        ratio = max(ratio, e_k / max(e_e, 1e-300))
    out = {'max_abs_err': float(d.max()), 'share': share,
           'grad_ratio': ratio,
           'max_ulps': K5_FWD_ULPS * _k5_ulps(got[0], want[0], m.dtype)[0]}
    del got, want, ref
    torch.cuda.empty_cache()
    return out


def _cold_device_ms(fn, reps=5):
    """Median card ms of one call of ``fn``, by CUDA events around it: each
    call starts on a cold L2 (a 256 MiB read just before it, so that its
    inputs come from HBM) and behind a sleep kernel (SLEEP_CYCLES), so that
    the host has queued the whole call before the card starts it and the
    events time the card's work alone."""
    import statistics
    import torch
    flush = torch.zeros(1 << 26, dtype=torch.float32, device='cuda')
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _k5_calls(nets, run):
    """Runs ``run()`` with forward hooks on every BatchNorm of ``nets`` and
    K5's counters at 0. Returns ([(x's shape, epilogue) of each rank-4
    call], K5's launches); raises unless K5 counted one call for each, and
    no rank-4 BatchNorm on the card took the eager chain."""
    import torch
    from text2img_ekl_tpu_torch.nn.blocks import BatchNorm
    from text2img_ekl_tpu_torch.ops import bn_act
    seen = []

    def hook(mod, args, out):
        if args[0].dim() == 4:
            seen.append((tuple(args[0].shape), getattr(mod, 'act', 'plain')))

    hooks = [mod.register_forward_hook(hook) for net in nets
             for mod in net.modules() if isinstance(mod, BatchNorm)]
    k = bn_act.bn_act
    k.calls = k.launches = k.eager_calls = 0
    run()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    if k.calls != len(seen) or k.eager_calls:
        raise AssertionError('a rank-4 BatchNorm did not take K5: %d calls, '
                             'K5 counted %d, the eager chain %d'
                             % (len(seen), k.calls, k.eager_calls))
    return seen, k.launches


def _bn_act_phase(tcfg, ecfg, card):
    """18. K5's calls in one flagship training step and in one sampler
    call, as forward hooks record them, against its counters and
    K5_STEP_CALLS; then, at each of those shapes at the benchmark's batches
    (the step's at K5_BATCH in train mode, the sampler's at its own in eval
    mode), bfloat16: K5 against the eager chain to the card tests' bars
    (``_k5_compare``), and its forward and backward card time
    (``_cold_device_ms``) against its bound (bytes / 3.35 TB/s, which it
    may not beat) and the eager chain's. Returns the kernel record, its
    totals weighted by the calls the step made."""
    import collections
    import numpy as np
    import torch
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.train.sample import caption_sample
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.step import make_train_step
    dev = torch.device('cuda')
    # the calls: a flagship step, then a sampler call
    state = create_train_state(tcfg, dev, seed=0)
    batch, draws = _step_batch(np.random.default_rng(18), tcfg, dev)
    step_calls, step_launches = _k5_calls(
        (state.G, *state.Ds),
        lambda: make_train_step(tcfg)(state, batch, 0, draws))
    G = build_generator(ecfg, train_flag=False).to(dev).eval()
    b = ecfg.TRAIN.BATCH_SIZE
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sample_calls, sample_launches = _k5_calls((G,), lambda: caption_sample(
        G, torch.randn((10, b, ecfg.GAN.Z_DIM), device=dev),
        torch.randn((10, b, ecfg.TEXT.DIMENSION), device=dev),
        generator=gen))
    del state, batch, draws, G
    torch.cuda.empty_cache()
    table = {(chw, act): n for chw, act, n in K5_STEP_CALLS}
    step = collections.Counter((shape[1:], act) for shape, act in step_calls)
    print('phase 18 one flagship step (batch %d) on %s: %d rank-4 '
          'BatchNorm calls, K5 %d calls and %d launches; one sampler call '
          '(batch %d): %d calls, %d launches; the eager chain 0'
          % (tcfg.TRAIN.BATCH_SIZE, card, len(step_calls), len(step_calls),
             step_launches, 10 * b, len(sample_calls), sample_launches))
    if step != table:
        raise AssertionError('the step\'s rank-4 BatchNorms %s are not '
                             'K5_STEP_CALLS' % sorted(step.items(), key=str))
    # a train forward launches 3 kernels and its backward 3; eval 1
    if step_launches != 6 * len(step_calls) or \
            sample_launches != len(sample_calls):
        raise AssertionError('K5 launched %d kernels in the step, %d in the '
                             'sampler call' % (step_launches,
                                               sample_launches))
    if not all((shape[1:], act) in table for shape, act in sample_calls):
        raise AssertionError('the sampler ran a BatchNorm the step did not: '
                             '%s' % sample_calls)
    # K5 against the eager chain and its bound at the benchmark's batches
    cases = [((K5_BATCH,) + chw, act, n, 'train')
             for chw, act, n in K5_STEP_CALLS]
    cases += [(shape, act, n, 'eval') for (shape, act), n
              in collections.Counter(sample_calls).items()]
    keys = ('k_fwd', 'k_bwd', 'e_fwd', 'e_bwd', 'b_fwd', 'b_bwd')
    tot = {mode: dict.fromkeys(keys, 0.0) for mode in ('train', 'eval')}
    err = dict.fromkeys(('max_abs_err', 'share', 'grad_ratio', 'max_ulps'),
                        0.0)
    for shape, act, n, mode in cases:
        m, x, dout = _k5_module(shape, act, 'bf16', mode, dev, seed=18)
        e = _k5_compare(m, x, dout)
        err = {k: max(err[k], e[k]) for k in err}
        t, out = dict.fromkeys(keys, 0.0), None
        if mode == 'train':
            x.requires_grad_(True)
            out = m(x)
            t['k_fwd'] = _cold_device_ms(lambda: m(x))
            t['k_bwd'] = _cold_device_ms(lambda: torch.autograd.grad(
                out, (x, m.weight, m.bias), dout, retain_graph=True))
            out = m.composition(x)
            t['e_fwd'] = _cold_device_ms(lambda: m.composition(x))
            t['e_bwd'] = _cold_device_ms(lambda: torch.autograd.grad(
                out, (x, m.weight, m.bias), dout, retain_graph=True))
            # each input read once, each output written once: x and out
            # forward; x, dout and dx backward
            t['b_bwd'] = (2 * x.nbytes + dout.nbytes) / HBM_BYTES * 1e3
        else:
            with torch.no_grad():
                t['k_fwd'] = _cold_device_ms(lambda: m(x))
                t['e_fwd'] = _cold_device_ms(lambda: m.composition(x))
        t['b_fwd'] = (x.nbytes + dout.nbytes) / HBM_BYTES * 1e3
        print('phase 18 K5 %s %s x%d %s on %s: forward %.4f ms (bound %.4f, '
              'eager %.4f), backward %.4f ms (bound %.4f, eager %.4f); vs '
              'the eager chain max_abs_err %.3e (%.2f ulps), %.2e of the '
              'elements, gradients %.2fx its distance from float64'
              % (list(shape), act, n, mode, card, t['k_fwd'], t['b_fwd'],
                 t['e_fwd'], t['k_bwd'], t['b_bwd'], t['e_bwd'],
                 e['max_abs_err'], e['max_ulps'], e['share'],
                 e['grad_ratio']))
        if t['k_fwd'] < t['b_fwd'] or t['k_bwd'] < t['b_bwd']:
            raise AssertionError('K5 timed under its bytes bound: the '
                                 'timing missed work')
        for key in keys:
            tot[mode][key] += n * t[key]
        del m, x, dout, out
        torch.cuda.empty_cache()
    tr, ev = tot['train'], tot['eval']
    ms = tr['k_fwd'] + tr['k_bwd']
    bound_ms = tr['b_fwd'] + tr['b_bwd']
    plain_ms = tr['e_fwd'] + tr['e_bwd']
    print('phase 18 K5 a batch-%d step (%d calls, each with its backward, '
          'bf16) on %s: %.3f ms (forward %.3f, backward %.3f) against its '
          'bound %.3f ms (%.1f%%) and the eager chain %.3f ms (forward '
          '%.3f, backward %.3f); a sampler call (batch %d, eval): %.3f ms '
          'against %.3f and the eager chain %.3f'
          % (K5_BATCH, len(step_calls), card, ms, tr['k_fwd'], tr['k_bwd'],
             bound_ms, 100 * bound_ms / ms, plain_ms, tr['e_fwd'],
             tr['e_bwd'], 10 * b, ev['k_fwd'], ev['b_fwd'], ev['e_fwd']))
    return {'name': 'K5 bn_act', 'route': 'cuda',
            'source': 'text2img_ekl_tpu_torch/csrc/bn_act.cu',
            'replaces': 'none (XLA fused these ops on the TPU)',
            'launches': step_launches, 'max_abs_err': err['max_abs_err'],
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': 'bytes', 'library_ms': None,
            'shape': 'the %d rank-4 BatchNorm calls of a batch-%d step'
                     % (len(step_calls), K5_BATCH),
            'share_differing': err['share'], 'max_ulps': err['max_ulps'],
            'grad_ratio': err['grad_ratio'],
            'sample_ms': ev['k_fwd'], 'sample_plain_ms': ev['e_fwd']}


def _tower_rate_phase(card):
    """16d. images/s of the tower (slim, 51 classes) on 128 px generator
    output, float32 and bf16, each at batch 32 (the IS stream's) and 64;
    beside each, the device's busy time a batch (the sum of its kernels'
    times, torch.profiler) and its share of the batch's time."""
    import torch
    from text2img_ekl_tpu_torch.eval.inception_score import InceptionScorer
    from text2img_ekl_tpu_torch.io_utils.weights import (
        RANDOM_INCEPTION_SEED, random_inception)
    sd = random_inception(RANDOM_INCEPTION_SEED, 51, 'slim')
    rates = {}
    for name, dtype in (('float32', None), ('bf16', torch.bfloat16)):
        s = InceptionScorer(sd, 51, dtype=dtype, device='cuda')
        for bsz in (32, 64):
            x = torch.rand((bsz, 3, 128, 128), device='cuda') * 2 - 1
            best = _best_ms({'tower': lambda: s.predict_batch(x)}, 10)
            busy = _device_busy_ms(lambda: s.predict_batch(x))
            ms = best['tower'][0]
            rates[name, bsz] = bsz * 1e3 / ms
            print('phase 16d tower %s at batch %d on %s: %.3f ms a batch '
                  '(best of 2 x 10, CUDA events; all %s), %.1f images/s; '
                  'device busy %s'
                  % (name, bsz, card, ms,
                     ['%.3f' % t for t in best['tower'][1]], rates[name, bsz],
                     '%.3f ms a batch (%.0f %% of the best)'
                     % (busy, 100 * busy / ms) if busy else 'not recorded'))
    return rates


def _is_stream_phase(tcfg, reset_launches, launches, card):
    """16b. The flagship trains with the IS stream on every step until the
    gate scores once; then the step with and without the stream, in
    turns."""
    import numpy as np
    import torch
    from text2img_ekl_tpu_torch.train.step import make_train_step
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = copy.deepcopy(tcfg)
    cfg.TPU_IS_EVERY = 1
    cfg.TRAIN.MAX_EPOCH = STREAM_EPOCHS
    cfg.TRAIN.SNAPSHOT_INTERVAL = 1000
    trainer = CondGANTrainer(cfg, os.path.join(WORK, 'is_stream'),
                             device='cuda')
    assert trainer.num_batches == 16, trainer.num_batches
    # the synthetic epoch's batches, drawn once and handed out every epoch:
    # the host-side synthesis of 512 images an epoch would take most of the
    # phase's time
    trainer.data_loader = _Repeat(list(trainer.data_loader))
    steps = STREAM_EPOCHS * trainer.num_batches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, out = _captured(trainer.train)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    got = launches()
    want = {k: steps * PER_STEP[k] + STREAM_EPOCHS * PER_RUN[k]
            for k in PER_STEP}
    with open(os.path.join(trainer.log_dir, 'metrics.jsonl')) as f:
        logged = [json.loads(line) for line in f]
    scores = [m['inception_score'] for m in logged if 'inception_score' in m]
    model = os.listdir(trainer.model_dir)
    lines = [ln for ln in out.splitlines() if ' IS: ' in ln]
    print('phase 16b train() with TPU_IS_EVERY 1, %s compute, batch %d, %d '
          'epochs of %d batches: %.2f s for %d steps; IS lines %s; '
          'inception_score logged %s; Model/ holds %s; launches %s (want %s)'
          % (cfg.TPU_COMPUTE_DTYPE, cfg.TRAIN.BATCH_SIZE, STREAM_EPOCHS,
             trainer.num_batches, train_s, state.step, lines, scores, model,
             got, want))
    if state.step != steps or len(lines) != 1 or \
            not lines[0].startswith('Epoch5 IS: '):
        raise AssertionError('the IS stream did not score once, at epoch 5')
    if len(scores) != 1 or not np.isfinite(scores[0]):
        raise AssertionError('inception_score was not logged: %s' % logged)
    if 'Inception weights are random' not in out or any(
            m.startswith('.protect_epoch') for m in model):
        raise AssertionError('random weights must not write a protected '
                             'snapshot: %s' % model)
    if got != want:
        raise AssertionError('the IS stream changed the kernels\' launches '
                             'per step')

    # the step alone and the step with the stream's tower forward, in
    # turns; and the tower forward alone, by CUDA events
    step_fn = make_train_step(cfg)
    batch = trainer._device_batch(next(iter(trainer.data_loader)))
    scorer, _ = _captured(trainer._make_is_scorer)
    seed = [4000]

    def five(with_is):
        for _ in range(5):
            seed[0] += 1
            _, fakes = step_fn(state, batch, seed[0])
            if with_is:
                scorer.add(fakes)

    # GATE_PAIRS pairs of 5-step turns, in the order (off, on), (on, off),
    # ...: the gate's cost is read from the differences within pairs, so
    # that a drift of the host's speed across the phase cancels
    for with_is in (False, True):
        five(with_is)  # warm up
    torch.cuda.synchronize()
    times = {False: [], True: []}
    for pair in range(GATE_PAIRS):
        for with_is in ((False, True) if pair % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            five(with_is)
            torch.cuda.synchronize()
            times[with_is].append((time.perf_counter() - t0) / 5 * 1e3)
    fakes = step_fn(state, batch, 5000)[1]
    add = _best_ms({'add': lambda: scorer.add(fakes)}, 10)['add']
    # what the stream asks of the host: the add's dispatch, no synchronize
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        scorer.add(fakes)
    dispatch = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    diffs = sorted(b - a for a, b in zip(times[False], times[True]))
    off, on = float(np.median(times[False])), float(np.median(times[True]))
    cost = float(np.median(diffs))
    print('phase 16b train step on %s, %s compute, batch %d, %d pairs of '
          '5-step turns (off, on; on, off; ...; host clock with '
          'synchronize): without the stream median %.2f ms (all %s), with '
          'it median %.2f ms (all %s); the gate costs a median %.2f ms a '
          'step at TPU_IS_EVERY 1 over the pairs (each pair: %s; %d of %d '
          'positive), %.2f at the flagship\'s 2; the bf16 tower forward '
          'alone %.3f ms (CUDA events, best of 2 x 10; all %s), its '
          'dispatch on the host %.3f ms (10 calls, no synchronize)'
          % (card, cfg.TPU_COMPUTE_DTYPE, cfg.TRAIN.BATCH_SIZE, GATE_PAIRS,
             off, ['%.2f' % t for t in times[False]], on,
             ['%.2f' % t for t in times[True]], cost,
             ['%.2f' % d for d in diffs], sum(d > 0 for d in diffs),
             len(diffs), cost / 2, add[0], ['%.3f' % t for t in add[1]],
             dispatch))
    return {'off_ms': off, 'on_ms': on, 'cost_ms': cost, 'add_ms': add[0],
            'dispatch_ms': dispatch}


def _direct_eval_phase(ecfg, png_dir, reset_launches, launches, card):
    """16c. Direct evaluation against the PNG route of phase 3, with the
    same random towers; the CLIs score phase 3's directory."""
    import numpy as np
    import torch
    import fid_torch
    import is_of_dir_torch
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    _, out = _captured(is_of_dir_torch.main, ['--dir', png_dir, '--splits',
                                              '1'])
    png_is = _printed(out, 'IS: ')[0]
    stats = os.path.join(WORK, 'png_dir_stats.npz')
    _captured(fid_torch.main, [png_dir, png_dir, '--save_stats', stats])
    with np.load(stats) as f:
        trace = float(np.trace(f['sigma']))
    cfg = copy.deepcopy(ecfg)
    cfg.TPU_EVAL_DIRECT = True
    cfg.TPU_EVAL_FID_STATS = stats
    trainer = CondGANTrainer(cfg, os.path.join(WORK, 'direct_eval'),
                             device='cuda')
    # the directory's IS takes one split, where direct eval's JSON takes
    # ten (its 640 images): the 10-split IS depends on the images' order,
    # which a directory sorts by name; keep the direct tower's one-split
    # score too
    one_split = []
    make = trainer._make_is_scorer

    def keep(dtype=None):
        s = make(dtype)
        score = s.score

        def both(num_splits=1, reset=True):
            one_split.append(score(1, reset=False)[0])
            return score(num_splits, reset)
        s.score = both
        return s

    trainer._make_is_scorer = keep
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    save_dir, out = _captured(trainer.evaluate, max_batches=BATCHES)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    got = launches()
    with open(os.path.join(save_dir, 'direct_scores.json')) as f:
        scores = json.load(f)
    pngs = [f for _, _, files in os.walk(save_dir) for f in files
            if f.endswith('.png')]
    want_images = BATCHES * cfg.TRAIN.BATCH_SIZE * 10
    print('phase 16c evaluate with TPU_EVAL_DIRECT on %s: %.2f s for %d '
          'images (%d PNGs written), launches %s; direct_scores.json %s; '
          'one-split IS %.6f vs is_of_dir_torch on phase 3\'s PNGs %.4f '
          '(bar %.0e relative); FID against fid_torch --save_stats of that '
          'directory %.4e, trace(sigma) %.4e (bar %.0e x trace)'
          % (card, direct_s, scores.get('images', 0), len(pngs), got, scores,
             one_split[0] if one_split else float('nan'), png_is,
             DIRECT_IS_RTOL, scores.get('fid', float('nan')), trace,
             DIRECT_FID_TRACE))
    if got != dict(PER_RUN, **{'K1-G': BATCHES}):
        raise AssertionError('direct eval did not launch K1-G once per '
                             'sampler call')
    if pngs or scores.get('images') != want_images or \
            scores.get('is_splits') != 10 or scores.get('real_is_weights'):
        raise AssertionError('direct eval wrote %s' % scores)
    if abs(one_split[0] - png_is) > DIRECT_IS_RTOL * png_is:
        raise AssertionError('direct IS disagrees with the PNG route')
    if not abs(scores['fid']) < DIRECT_FID_TRACE * trace:
        raise AssertionError('direct FID against the PNG route\'s own '
                             'statistics is not ~0')
    return {'seconds': direct_s, 'is': scores['is_mean'],
            'fid': scores['fid']}


# phase 17: the native host paths. A half is skipped only where the probe
# finds no g++, or no header or library that its source needs; a source
# that does not build or load where they exist fails the phase. The
# writer's PNGs must hold the sampler's uint8 pixels exactly, and the two
# routes' directories the same names and pixels.
NATIVE_HALVES = (('decoder', 'dataloader'), ('writer', 'imagewriter'))
CAPTIONS = 10
DECODER_JPEGS = 96   # three batches of 32: one epoch of train(max_steps=3)
LOADER_BENCH = ['--n', '256', '--bs', '32']


def _native_build_phase():
    """17a. Build both host libraries; print what the probe found."""
    from text2img_ekl_tpu_torch.ops import _build
    probe = _build.host_probe()
    print('phase 17a host probe: g++ %s; headers %s; libraries %s'
          % (probe['g++'] or 'not found', probe['headers'],
             probe['libraries']))
    available = {}
    for half, stem in NATIVE_HALVES:
        header, lib = _build.HOST_DEPS[stem]
        missing = ([] if probe['g++'] else ['g++']) + [
            what for what, ok in (
                (header, probe['headers'].get(header)),
                ('lib' + lib, probe['libraries'].get('lib' + lib)))
            if not ok]
        available[half] = not missing
        if missing:
            print('phase 17 %s SKIPPED: %s missing' % (half,
                                                        ', '.join(missing)))
            continue
        t0 = time.perf_counter()
        built = _build.host_library(stem)
        print('phase 17a %s: csrc/%s.cpp built and loaded in %.2f s -> %s'
              % (half, stem, time.perf_counter() - t0,
                 os.path.relpath(built._name, ROOT)))
    return available


def _writer_phase(ecfg, phase3, native_ok, card):
    """17b. The PNG writer: its batches in phase 3's evaluate; then evaluate
    with T2I_NATIVE_WRITE 1 and 0 in turns (1, 0, 0, 1) on phase 3's
    weights and draws: the sampler's uint8 stacks recorded, one batch's
    files held to its stack, the two routes' directories to each other."""
    import numpy as np
    import torch
    from PIL import Image
    import text2img_ekl_tpu_torch.train.trainer as trainer_mod
    from text2img_ekl_tpu_torch.io_utils import native_writer
    from text2img_ekl_tpu_torch.io_utils.images import flush_writes
    images = phase3['images']
    ok_line = 'Save images ok; Number of images: %d' % images
    fallback = 'native PNG writer unavailable'
    want_batches = BATCHES * CAPTIONS if native_ok else 0
    print('phase 17b phase 3\'s evaluate: %d batches to the native writer '
          '(want %d), "%s" printed %s, PIL fallback printed %s'
          % (phase3['writer_batches'], want_batches, ok_line,
             ok_line in phase3['printed'], fallback in phase3['printed']))
    if phase3['writer_batches'] != want_batches or \
            ok_line not in phase3['printed'] or \
            (fallback in phase3['printed']) == native_ok:
        raise AssertionError('phase 3\'s evaluate did not write as expected')
    if flush_writes() != 0 or not all(os.path.exists(p)
                                      for p in phase3['pngs']):
        raise AssertionError('the writer lost a file of phase 3')

    stacks, calls = [], []
    real_sample = trainer_mod.caption_sample
    real_save = trainer_mod.save_single_images

    def sample(*a, **kw):
        out = real_sample(*a, **kw)
        stacks[-1].append(out.cpu())
        return out

    def save(images_, names, save_dir, si, classes, imsize, nid):
        calls[-1].append((save_dir, list(names), si,
                          [int(c) for c in classes], imsize, nid))
        return real_save(images_, names, save_dir, si, classes, imsize, nid)

    trainers = {route: trainer_mod.CondGANTrainer(
        ecfg, os.path.join(WORK, 'writer_' + route), device='cuda')
        for route in ('1', '0')}
    seconds = {'1': [], '0': []}
    dirs = {}
    env = os.environ.get('T2I_NATIVE_WRITE')
    trainer_mod.caption_sample = sample
    trainer_mod.save_single_images = save
    try:
        for route in ('1', '0', '0', '1'):
            os.environ['T2I_NATIVE_WRITE'] = route
            shutil.rmtree(trainers[route].output_dir, ignore_errors=True)
            stacks.append([])
            calls.append([])
            before = native_writer.batches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dirs[route], out = _captured(trainers[route].evaluate,
                                         max_batches=BATCHES)
            seconds[route].append(time.perf_counter() - t0)
            got = native_writer.batches - before
            if got != (want_batches if route == '1' else 0) or \
                    ok_line not in out:
                raise AssertionError('evaluate with T2I_NATIVE_WRITE=%s: %d '
                                     'batches to the native writer'
                                     % (route, got))
    finally:
        trainer_mod.caption_sample = real_sample
        trainer_mod.save_single_images = real_save
        if env is None:
            os.environ.pop('T2I_NATIVE_WRITE', None)
        else:
            os.environ['T2I_NATIVE_WRITE'] = env
    same_draws = all(len(t) == BATCHES and all(
        torch.equal(a, b) for a, b in zip(t, stacks[0])) for t in stacks)
    # batch 0's files of the native route against the sampler's stack: its
    # CAPTIONS writes come first
    mismatched = checked = 0
    for (save_dir, names, si, classes, imsize, nid) in calls[0][:CAPTIONS]:
        for i, (name, c) in enumerate(zip(names, classes)):
            path = '%s/single_samples/%s_%d_class%d_sid%d_nid%d.png' % (
                save_dir, name, imsize, c, si, nid)
            checked += 1
            mismatched += not np.array_equal(np.asarray(Image.open(path)),
                                             stacks[0][0][si, i].numpy())

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    names = {r: listing(d) for r, d in dirs.items()}
    differ = sum(not np.array_equal(
        np.asarray(Image.open(os.path.join(dirs['1'], f))),
        np.asarray(Image.open(os.path.join(dirs['0'], f))))
        for f in names['1']) if names['1'] == names['0'] else -1
    rate = {r: ['%.1f' % (images / t) for t in ts]
            for r, ts in seconds.items()}
    print('phase 17b evaluate on %s, %d host cores, %d images a turn, in '
          'turns (1, 0, 0, 1): T2I_NATIVE_WRITE=1 (%s) %s images/s, '
          'T2I_NATIVE_WRITE=0 (PIL) %s images/s; seconds %s'
          % (card, os.cpu_count(), images,
             'native writer' if native_ok else 'PIL: no native writer here',
             rate['1'], rate['0'],
             {r: ['%.3f' % t for t in ts] for r, ts in seconds.items()}))
    print('phase 17b same sampler stacks in every turn %s; batch 0\'s %d '
          'PNGs vs the sampler\'s uint8 stack: %d differ; the two routes\' '
          'directories: %d and %d files, same names %s, %d differ in pixels'
          % (same_draws, checked, mismatched, len(names['1']),
             len(names['0']), names['1'] == names['0'], differ))
    if not same_draws or checked != ecfg.TRAIN.BATCH_SIZE * CAPTIONS or \
            mismatched or differ != 0 or len(names['1']) != images:
        raise AssertionError('the writer\'s PNGs disagree')


def _decoder_phase(tcfg, native_ok, reset_launches, launches, card):
    """17c. train(max_steps=3) at full width on fabricated CUB JPEGs with
    TPU_NATIVE_DECODE, then on synthetic data; the loader's bench."""
    import re
    import numpy as np
    import torch
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    from tools import bench_loader_torch
    root = os.path.join(WORK, 'data', 'birds')
    t0 = time.perf_counter()
    bench_loader_torch.fabricate_cub(root, DECODER_JPEGS)
    fabricate_s = time.perf_counter() - t0
    jcfg = copy.deepcopy(tcfg)
    jcfg.TPU_SYNTHETIC_DATA = False
    jcfg.DATA_DIR = root
    jcfg.TPU_NATIVE_DECODE = True
    want = {k: TRAIN_STEPS * PER_STEP[k] + PER_RUN[k] for k in PER_STEP}
    fallback = '!! native decode unavailable, using PIL'
    result = {}
    for source, c in (('jpeg', jcfg), ('synthetic', tcfg)):
        trainer = CondGANTrainer(c, os.path.join(WORK, 'decoder_' + source),
                                 device='cuda')
        reset_launches()
        t0 = time.perf_counter()
        _, out = _captured(trainer.train, max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launches()
        metrics = trainer.last_metrics
        ds = trainer.data_loader.dataset
        result[source] = {
            'wall_s': wall, 'epoch_s': float(re.findall(
                r'Time: ([0-9.]+)s', out)[-1]),
            'native_batches': getattr(ds, 'native_batches', None),
            'batches': len(trainer.data_loader),
            'fallback_printed': out.count(fallback),
            'finite': all(np.isfinite(v) for v in metrics.values()),
            'launches_ok': got == want}
        del trainer
    jr = result['jpeg']
    print('phase 17c train(max_steps=%d) on %d fabricated 500x375 JPEGs '
          '(CUB layout, bboxes; fabricated in %.2f s) with TPU_NATIVE_DECODE '
          '%s: %d of %d batches decoded natively, PIL fallback printed %d '
          'time(s), finite losses %s, launches per step as phase 8 %s'
          % (TRAIN_STEPS, DECODER_JPEGS, fabricate_s,
             'on the native decoder' if native_ok else
             '(no native decoder here: PIL)', jr['native_batches'],
             jr['batches'], jr['fallback_printed'], jr['finite'],
             jr['launches_ok']))
    print('phase 17c on %s, %d host cores: the epoch of %d steps took %.2f s '
          'on JPEGs (%s) and %.2f s on synthetic data; train() %.2f s and '
          '%.2f s'
          % (card, os.cpu_count(), TRAIN_STEPS, jr['epoch_s'],
             'native' if native_ok else 'PIL', result['synthetic']['epoch_s'],
             jr['wall_s'], result['synthetic']['wall_s']))
    want_native = TRAIN_STEPS if native_ok else 0
    if jr['batches'] != TRAIN_STEPS or jr['native_batches'] != want_native \
            or jr['fallback_printed'] != (0 if native_ok else 1):
        raise AssertionError('the JPEG loader did not decode as expected')
    if not all(r['finite'] and r['launches_ok'] for r in result.values()):
        raise AssertionError('train() on JPEGs or synthetic data: %s'
                             % result)
    print('phase 17c tools/bench_loader_torch.py %s:' % ' '.join(LOADER_BENCH))
    lines = bench_loader_torch.main(LOADER_BENCH)
    if any(ln['value'] is None for ln in lines if ln['path'].startswith(
            'pil') or native_ok):
        raise AssertionError('the loader bench lacks a path')


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
    from tools.bench_eval_torch import seeded_generator
    from text2img_ekl_tpu_torch.io_utils import native_writer

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
    state = seeded_generator(cfg, dev)
    torch.save(state, net_g)
    cfg.TRAIN.NET_G = net_g
    trainer = CondGANTrainer(cfg, os.path.join(WORK, 'eval_run'),
                             device='cuda')
    writer_batches = native_writer.batches
    reset_launches()
    t0 = time.perf_counter()
    save_dir, eval_out = _captured(trainer.evaluate, max_batches=BATCHES)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = launches()
    writer_batches = native_writer.batches - writer_batches
    pngs = []
    for d, _, files in os.walk(save_dir):
        pngs += [os.path.join(d, f) for f in files if f.endswith('.png')]
    want = BATCHES * cfg.TRAIN.BATCH_SIZE * 10
    from PIL import Image
    shapes = {np.asarray(Image.open(p)).shape for p in pngs}
    print('phase 3 evaluate: launches %s for %d sampler calls, %d PNGs '
          '(want %d) of shape %s in %.2f s (%.1f images/s; %d batches to the '
          'native writer)'
          % (eval_launches, BATCHES, len(pngs), want, sorted(shapes), eval_s,
             want / eval_s, writer_batches))
    if eval_launches != dict(PER_RUN, **{'K1-G': BATCHES}):
        raise AssertionError('K1-G did not run once per sampler call')
    if len(pngs) != want or shapes != {(cfg.imsize, cfg.imsize, 3)}:
        raise AssertionError('evaluate wrote the wrong PNGs')
    # phase 16 scores these PNGs against direct eval on the same weights;
    # phase 17 checks the writer's part in this run
    png_dir, eval_cfg = save_dir, copy.deepcopy(cfg)
    phase3 = {'writer_batches': writer_batches, 'printed': eval_out,
              'pngs': sorted(pngs), 'images': want}

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

    # 16. the Inception towers: on the card against the CPU, the IS stream
    #     at full width, direct eval against phase 3's PNGs, images/s
    _tower_phase(card)
    _is_stream_phase(tcfg, reset_launches, launches, card)
    _direct_eval_phase(eval_cfg, png_dir, reset_launches, launches, card)
    _tower_rate_phase(card)

    # 17. the native host paths: the PNG writer on phase 3's evaluate and
    #     against PIL; the JPEG decoder under the flagship's train()
    available = _native_build_phase()
    _writer_phase(eval_cfg, phase3, available['writer'], card)
    _decoder_phase(tcfg, available['decoder'], reset_launches, launches,
                   card)

    # 18. K5's calls in a step and a sampler call; K5 against the eager
    #     chain and its bound at the benchmark's shapes
    k5_record = _bn_act_phase(tcfg, eval_cfg, card)

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
    record.append(k5_record)
    print(card)
    print(json.dumps({'kernels': record}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
