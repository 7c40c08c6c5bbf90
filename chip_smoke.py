#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (built for
an H100: the kernels compile for sm_90a). Phases, each printing what it
found; any failure raises and exits non-zero:

  1. build the CUDA kernels from text2img_ekl_tpu_torch/csrc with nvcc, one
     process per source, all at once;
  2. hold the factored capsule-routing forward (K1-G) to the plain PyTorch
     routing on the card, float32 with TF32 off, at the flagship generator
     shape and a ragged one;
  3. drive the serving path: the port's CondGANTrainer.evaluate on
     cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml (synthetic data, full
     width GF_DIM 64, 32 images x 10 captions, 2 batches) with a seeded
     random generator (BatchNorm statistics set from one random batch)
     saved to a .pth; check that K1-G ran once per sampler call and that
     the expected PNGs were written;
  4. the same weights and draws at B=4: the generator on the card (K1)
     against the generator on the CPU (plain routing), float32;
  5. time K1-G against the plain routing at the flagship shape, and the
     caption sampler's images/s at the config's compute dtype;
  6. hold K1-D (the votes form, the discriminator class head) to the plain
     routing at B=32 and at a ragged shape;
  7. hold K2-G and K2-D (the backward kernels) to autograd through the
     plain routing at B=32, and time kernels and plain versions;
  8. drive the training path: CondGANTrainer.train(max_steps=3) on
     cfg/birds_2stg_splitz_cap_ca.realcls.yml at full width (GF_DIM and
     DF_DIM 64, batch 32, 64 and 128 px, bf16 compute) on synthetic data;
     check finite losses, that G and D parameters moved, and the kernel
     launches per step; time the step;
  9. one step on the card against one on the CPU at GF/DF_DIM 16, batch 4,
     float32 (TF32 off for matmuls and cuDNN), same weights and draws.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, where
torch finds no CUDA device or the package is not beside this file.
"""

from __future__ import annotations

import copy
import json
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
PER_STEP = {'K1-G': 1, 'K1-D': 8, 'K2-G': 1, 'K2-D': 6}
PER_RUN = {'K1-G': 1, 'K1-D': 0, 'K2-G': 0, 'K2-D': 0}
# CUDA vs CPU step (float32): metrics |d| <= 1e-3 |ref| + 1e-5; first
# moments per tensor ||d|| <= 1e-2 ||ref|| + 1e-5 max|ref over the net|
# (cuDNN and oneDNN sum convolutions in other orders; a LeakyReLU input
# within rounding of zero takes the other slope; biases that feed a
# BatchNorm have zero gradient in exact arithmetic)
STEP_RTOL, STEP_ATOL = 1e-3, 1e-5
MOMENT_RTOL, MOMENT_ATOL = 1e-2, 1e-5
# the card's peaks (H100 SXM data sheet): float32 outside the tensor cores
# and device-memory bandwidth
F32_FLOPS, HBM_BYTES = 67e12, 3.35e12


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


def _bound(flops, nbytes):
    """(least ms, what bounds it) from operations and bytes."""
    t_ops, t_bytes = flops / F32_FLOPS, nbytes / HBM_BYTES
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
    """(flops, bytes) of one routing backward: the forward recomputed, the
    reverse passes (about 2.5x a forward pass: squash, softmax and
    agreement pullbacks) and the weight gradient (the sum over the batch:
    factored 2 (2R-1) B J O L for the outer products; votes form two more
    products of the vote size). Bytes: x, W and dv read, dx and dW
    written."""
    b, i, l, j, o = shape
    fwd, _ = _k1_work(shape, factored)
    nbytes = 4 * (2 * b * i * l + 2 * j * o * l + b * j * o)
    if factored:
        rev = ITERS * b * ((10 * l + 6) * i * j + 8 * o * l * j) \
            + 2 * (2 * ITERS - 1) * b * j * o * l
    else:
        rev = ITERS * b * (6 * i * j * o + 6 * i * j + 6 * j * o) \
            + 4 * b * i * l * j * o
    return fwd + rev, nbytes


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch finds no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from text2img_ekl_tpu_torch.config import cfg_from_file
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.ops import _build
    from text2img_ekl_tpu_torch.ops import capsule_cuda as cc
    from text2img_ekl_tpu_torch.ops.capsule import capsule_linear
    from text2img_ekl_tpu_torch.ops.capsule_cuda import capsule_routing
    from text2img_ekl_tpu_torch.train.sample import (caption_sample,
                                                     sample_images)
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.step import make_train_step
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer

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

    err = {name: 0.0 for name in cc.KERNELS}
    with torch.no_grad():
        for shape, weights in ((FLAGSHIP, 'N(0,1)'), (FLAGSHIP, 'init'),
                               (RAGGED, 'N(0,1)')):
            x, w = k1_inputs(shape, weights)
            out = capsule_routing(x, w, ITERS)
            ref = capsule_linear(x, w, ITERS, 'dynamic')
            torch.cuda.synchronize()
            max_abs, max_rel, scale, ok = _errors(out, ref, K1_RTOL, K1_ATOL)
            print('phase 2 K1-G %s weights %s: max|ref| %.3e, max_abs_err '
                  '%.3e, max_rel_err %.3e (where |ref| > 1e-3 max|ref|); '
                  'bound |d| <= %.0e |ref| + %.0e max|ref|: %s'
                  % (shape, weights, scale, max_abs, max_rel, K1_RTOL,
                     K1_ATOL, 'ok' if ok else 'FAIL'))
            if not ok:
                raise AssertionError('K1-G disagrees with the plain routing')
            err['K1-G'] = max(err['K1-G'], max_abs)
        flagship_x, flagship_w = k1_inputs(FLAGSHIP, 'N(0,1)')

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
    cc.reset_launches()
    t0 = time.perf_counter()
    save_dir = trainer.evaluate(max_batches=BATCHES)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = cc.launches()
    pngs = []
    for d, _, files in os.walk(save_dir):
        pngs += [os.path.join(d, f) for f in files if f.endswith('.png')]
    want = BATCHES * cfg.TRAIN.BATCH_SIZE * 10
    from PIL import Image
    shapes = {np.asarray(Image.open(p)).shape for p in pngs}
    print('phase 3 evaluate: launches %s for %d sampler calls, %d PNGs '
          '(want %d) of shape %s in %.2f s'
          % (eval_launches, BATCHES, len(pngs), want, sorted(shapes), eval_s))
    if eval_launches != {'K1-G': BATCHES, 'K1-D': 0, 'K2-G': 0, 'K2-D': 0}:
        raise AssertionError('K1-G did not run once per sampler call')
    if len(pngs) != want or shapes != {(cfg.imsize, cfg.imsize, 3)}:
        raise AssertionError('evaluate wrote the wrong PNGs')

    # 4. CUDA generator (K1) against CPU generator (plain), float32; and
    #    the config's compute dtype on the card against the same reference
    f32 = copy.deepcopy(cfg)
    f32.TPU_COMPUTE_DTYPE = 'float32'
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
    print('phase 4 CUDA %s vs CPU float32: mean image diff %.3e (bound '
          '1e-2), max %.3e (bound 1e-1)'
          % (cfg.TPU_COMPUTE_DTYPE, low_mean, low_max))
    if not (low_mean <= 1e-2 and low_max <= 0.1):
        raise AssertionError('the %s generator drifts from float32'
                             % cfg.TPU_COMPUTE_DTYPE)

    # 5. timings of K1-G and the sampler
    timing = {}
    with torch.no_grad():
        best = _best_ms({
            'kernel': lambda: capsule_routing(flagship_x, flagship_w, ITERS),
            'plain': lambda: capsule_linear(flagship_x, flagship_w, ITERS,
                                            'dynamic')})
    print('phase 5 K1-G at %s on %s: kernel %.4f ms, plain %.4f ms (best of '
          '2 x 20; all: kernel %s plain %s)'
          % (FLAGSHIP, card, best['kernel'][0], best['plain'][0],
             ['%.4f' % t for t in best['kernel'][1]],
             ['%.4f' % t for t in best['plain'][1]]))
    b_, i_, j_, o_ = FLAGSHIP
    bound_ms, bound_by = _bound(*_k1_work((b_, i_, 8, j_, o_), True))
    print('phase 5 K1-G at %s: bound %.4f ms (%s; H100 SXM peaks at 700 W)'
          % (FLAGSHIP, bound_ms, bound_by))

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
    with torch.no_grad():
        x, w = _capsule_inputs(rng, G_HEAD, dev)
        best = _best_ms({
            'kernel': lambda: capsule_routing(x, w, ITERS),
            'plain': lambda: capsule_linear(x, w, ITERS, 'dynamic')})
    timing['K1-G'] = (best['kernel'][0], best['plain'][0],
                      _k1_work(G_HEAD, True), G_HEAD)
    print('phase 6 K1-G at %s on %s: kernel %.4f ms, plain %.4f ms (best of '
          '2 x 20)' % (G_HEAD, card, best['kernel'][0], best['plain'][0]))
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
    print('phase 6 K1-D at %s on %s: kernel %.4f ms, plain %.4f ms (best of '
          '2 x 20)' % (D_HEAD, card, best['kernel'][0], best['plain'][0]))

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
        best = _best_ms({
            'kernel': lambda: kernel(x, w, dv, ITERS, True, True),
            'plain': plain}, iters=10)
        timing[name] = (best['kernel'][0], best['plain'][0],
                        _k2_work(shape, name == 'K2-G'), shape)
        print('phase 7 %s at %s on %s: kernel %.4f ms, plain autograd '
              '(forward + backward) %.4f ms (best of 2 x 10)'
              % (name, shape, card, best['kernel'][0], best['plain'][0]))

    # 8. the training path
    tcfg = cfg_from_file(TRAIN_CFG)
    tcfg.TPU_SYNTHETIC_DATA = True
    assert (tcfg.GAN.GF_DIM, tcfg.GAN.DF_DIM, tcfg.TRAIN.BATCH_SIZE,
            tcfg.branch_sizes()) == (64, 64, 32, [64, 128])
    trainer = CondGANTrainer(tcfg, os.path.join(WORK, 'train_run'),
                             device='cuda')
    initial = create_train_state(tcfg, 'cpu', seed=0)
    cc.reset_launches()
    t0 = time.perf_counter()
    tstate = trainer.train(max_steps=TRAIN_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = cc.launches()
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

    # 9. one step on the card against one on the CPU, float32
    scfg = copy.deepcopy(tcfg)
    scfg.GAN.GF_DIM = scfg.GAN.DF_DIM = 16
    scfg.TRAIN.BATCH_SIZE = 4
    scfg.TPU_COMPUTE_DTYPE = 'float32'
    results = {}
    for device in ('cuda', 'cpu'):
        st = create_train_state(scfg, device, seed=0)
        batch, draws = _step_batch(np.random.default_rng(5), scfg, device)
        m, _ = make_train_step(scfg)(st, batch, 0, draws)
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
    print('phase 9 CUDA vs CPU step (GF/DF 16, batch 4, float32): metrics '
          'errD %.6f vs %.6f, errG %.6f vs %.6f; worst metric at %.3f of '
          'its bound (|d| <= %.0e |ref| + %.0e), worst Adam first moment at '
          '%.3f of its bound (||d|| <= %.0e ||ref|| + %.0e max|ref|)'
          % (cm['errD'], pm['errD'], cm['errG'], pm['errG'], worst_metric,
             STEP_RTOL, STEP_ATOL, worst_moment, MOMENT_RTOL, MOMENT_ATOL))
    if worst_metric > 1 or worst_moment > 1:
        raise AssertionError('the CUDA step disagrees with the CPU step')

    shutil.rmtree(WORK, ignore_errors=True)
    bad = sorted(m for m in sys.modules
                 if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',
                                        'text2img_ekl_tpu'))
    print('imported JAX or JAX-package modules: %s' % (bad or 'none'))
    if bad:
        raise AssertionError('the port imported %s' % bad)
    sources = {'K1-G': ('capsule_routing.cu', 'capsule_pallas.py:32'),
               'K1-D': ('capsule_routing.cu', 'capsule_pallas.py:32'),
               'K2-G': ('capsule_routing_bwd.cu', 'capsule_pallas.py:114'),
               'K2-D': ('capsule_routing_bwd.cu', 'capsule_pallas.py:114')}
    record = []
    for name, fn in cc.KERNELS.items():
        ms, plain_ms, (flops, nbytes), shape = timing[name]
        bound_ms, bound_by = _bound(flops, nbytes)
        record.append({
            'name': '%s %s' % (name, fn.__name__), 'route': 'cuda',
            'source': 'text2img_ekl_tpu_torch/csrc/%s' % sources[name][0],
            'replaces': 'text2img_ekl_tpu/ops/%s' % sources[name][1],
            'launches': train_launches[name], 'max_abs_err': err[name],
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': None,
            'shape': list(shape)})
    print(card)
    print(json.dumps({'kernels': record}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
