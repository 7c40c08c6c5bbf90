#!/usr/bin/env python3
"""Microbenchmark of K4, the port's 3x3 conv weight-gradient kernel, against
cuDNN's weight gradient and the plain version, at the flagship shapes.

    python3 tools/bench_conv_dw_torch.py [--shape B,C,H,F] [--device cuda]
        [--dtype bfloat16|float32] [--profile]

Without ``--shape`` it runs the three shapes the flagship training step
gives K4 with ``TPU_PALLAS_DW`` (chip_smoke.py's K4_SHAPES, 5 launches a
step) and prints the per-step totals; ``--shape`` is one square map of B
images, C input and F output channels, H x H pixels. Inputs, from numpy
seed 0: x [B, C, H, H] and dy [B, F, H, H] ~ N(0, 1) in ``--dtype``:
bfloat16, the flagship's compute type (the bf16 body), or float32 (the
float32 body, 3xTF32 on the tensor cores, which a run with
TPU_COMPUTE_DTYPE float32 and TPU_PALLAS_DW launches).

Parity comes first: K4 (``dw3x3_kernel``) against ``dw3x3_reference`` at
|d| <= 1e-3 |ref| + 1e-4 max|ref|, and two calls on the same inputs
bit-identical; a miss raises. In float32 each line also gives the max
error of K4 and of the float32 plain version against the same contraction
in float64 (the float32 body's faithfulness) and, on the card, their max
distance from ``dw3x3_tf32x3_reference`` (the body's arithmetic emulated
with the card's plan) in float32 ulps of max|dW|. Then the times, CUDA events,
best of two runs of each function in turns (kernel, cuDNN, plain, plain,
cuDNN, kernel): K4, cuDNN's weight gradient (``aten.convolution_backward``;
the yardstick, never called by the port; in float32 with TF32 off, set
explicitly) and the plain version. Each line gives the bound,
max(operations / peak, bytes / 3.35 TB/s) with x and dy read once and dW
written once, the peak 989 TFLOP/s for bf16 and, for float32, 495 TFLOP/s
of TF32 with each product done three times (3xTF32; H100 SXM peaks at 700
W), and the kernel's time over the bound and over cuDNN's.

With ``--profile`` it also records 20 calls of K4 and of cuDNN's weight
gradient under torch.profiler at each shape and prints their device time
per call by kernel: the kernels' own time, without the host's launch
overhead, which CUDA events include once the host is the slower side.

It needs a CUDA card, and refuses to run without one, unless ``--device
cpu`` is given: then the same runs on the CPU, where ``dw3x3`` takes the
plain version and the library call is PyTorch's CPU convolution backward,
and the times are the CPU's host clock. Prints the card's name and power
limit (nvidia-smi) first.
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from text2img_ekl_tpu_torch.ops import conv_dw  # noqa: E402

# (B, C, H, F) and launches per flagship step (chip_smoke.py K4_SHAPES)
FLAGSHIP = (((32, 64, 64, 128), 2), ((32, 64, 64, 64), 2),
            ((32, 64, 128, 64), 1))
RTOL, ATOL = 1e-3, 1e-4
BF16_FLOPS, TF32_FLOPS, HBM_BYTES = 989e12, 495e12, 3.35e12
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
WARM, TIMED = 3, 10  # calls before a timed run, calls per timed run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--shape', type=str, default=None, help='B,C,H,F')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    ap.add_argument('--dtype', choices=tuple(DTYPES), default='bfloat16',
                    help='the inputs\' type: which body of K4 runs')
    ap.add_argument('--profile', action='store_true',
                    help='device time per call by kernel (torch.profiler)')
    args = ap.parse_args(argv)
    if args.profile and args.device != 'cuda':
        ap.error('--profile reads device time: it needs --device cuda')
    return args


def bound(shape, dtype=torch.bfloat16):
    """(least ms, 'operations' or 'bytes') of one weight gradient: bf16 on
    the tensor cores, float32 as three tf32 products (3xTF32)."""
    b, c, h, f = shape
    k = b * h * h
    flops = 2 * f * 9 * c * k
    size = torch.finfo(dtype).bits // 8
    nbytes = size * k * (c + f) + 4 * f * c * 9
    t_ops = (flops / BF16_FLOPS if dtype == torch.bfloat16
             else 3 * flops / TF32_FLOPS)
    t_bytes = nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def _run_ms(fn, calls, device):
    if device.type == 'cuda':
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e3


def best_ms(fns, device, calls=TIMED):
    """Best of two runs of each function, in turns (a, b, c, c, b, a), after
    a warm-up; returns name -> (best ms, [ms of each run])."""
    times = {name: [] for name in fns}
    names = list(fns)
    for name in names + names[::-1]:
        _run_ms(fns[name], WARM, device)
        times[name].append(_run_ms(fns[name], calls, device))
    return {name: (min(t), t) for name, t in times.items()}


def card_name(device):
    if device.type != 'cuda':
        return 'cpu (host clock)'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_us(fn, calls=20):
    """Device time per call of ``fn`` by kernel name, in microseconds, from
    torch.profiler over ``calls`` calls after a warm-up; empty where the
    profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, 'device_time_total', None)
        if t is None:
            t = e.cuda_time_total
        if t > 0:
            out[e.key] = t / calls
    return out


def measure(shape, device, profile=False, dtype=torch.bfloat16):
    """Check and time K4 at one shape; returns a dict of max_abs_err, scale
    (max|ref|), kernel_ms, library_ms, plain_ms, bound_ms, bound_by,
    float32: f64_err (K4, plain) against the float64 contraction and, on
    the card, emu_ulps (K4, plain) from the emulation, and with ``profile``
    kernel_us and library_us (``device_us``)."""
    b, c, h, f = shape
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, c, h, h), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, f, h, h),
                                              dtype=np.float32))
    x, dy = x.to(device).to(dtype), dy.to(device).to(dtype)
    wgt = torch.zeros((f, c, 3, 3), device=device, dtype=dtype)

    def kernel():
        return conv_dw.dw3x3(x, dy)

    def library():
        return torch.ops.aten.convolution_backward(
            dy, x, wgt, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [False, True, False])[1]

    def plain():
        return conv_dw.dw3x3_reference(x, dy)

    ref = plain()
    out, again = kernel(), kernel()
    diff = (out - ref).abs()
    scale = float(ref.abs().max())
    ok = bool((diff <= RTOL * ref.abs() + ATOL * scale).all())
    if not ok:
        raise AssertionError('K4 at %s disagrees with dw3x3_reference: '
                             'max_abs_err %.3e, max|ref| %.3e'
                             % (list(shape), float(diff.max()), scale))
    if not torch.equal(out, again):
        raise AssertionError('K4 at %s: two calls on the same inputs differ'
                             % list(shape))
    r = {}
    if dtype == torch.float32:
        exact = conv_dw.dw3x3_reference(x, dy, torch.float64)
        r['f64_err'] = tuple(float((v.double() - exact).abs().max())
                             for v in (out, ref))
        del exact
        if device.type == 'cuda':
            p = conv_dw.plan(b, c, h, h, f, False, torch.cuda
                             .get_device_properties(device)
                             .multi_processor_count)
            emu = conv_dw.dw3x3_tf32x3_reference(x, dy, p.chunk)
            ulp = 2.0 ** (math.floor(math.log2(float(emu.abs().max()))) - 23)
            r['emu_ulps'] = tuple(float((v - emu).abs().max()) / ulp
                                  for v in (out, ref))
            del emu
    best = best_ms({'kernel': kernel, 'library': library, 'plain': plain},
                   device)
    bound_ms, bound_by = bound(shape, dtype)
    r.update({'max_abs_err': float(diff.max()), 'scale': scale,
              'kernel_ms': best['kernel'][0],
              'library_ms': best['library'][0],
              'plain_ms': best['plain'][0], 'all_ms': best,
              'bound_ms': bound_ms, 'bound_by': bound_by})
    if profile:
        r['kernel_us'] = device_us(kernel)
        r['library_us'] = device_us(library)
    return r


def run(args):
    """Check, time and print every shape; returns [(shape, launches, the
    dict of ``measure``)]."""
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    print('card: %s; K4 %s' % (card_name(device), args.dtype))
    shapes = FLAGSHIP if args.shape is None else (
        (tuple(int(v) for v in args.shape.split(',')), 1),)
    rows = []
    lib = 'cuDNN wgrad' if device.type == 'cuda' else 'library (CPU)'
    for shape, n in shapes:
        r = measure(shape, device, args.profile, dtype)
        rows.append((shape, n, r))
        b, c, h, f = shape
        line = ('K4 x [%d,%d,%d,%d] dy F=%d: max_abs_err %.3e (max|ref| '
                '%.3e), bit-identical over two calls; kernel %.4f ms, %s %.4f '
                'ms, plain %.4f ms (best of 2 x %d, in turns)'
                % (b, c, h, h, f, r['max_abs_err'], r['scale'],
                   r['kernel_ms'], lib, r['library_ms'], r['plain_ms'],
                   TIMED))
        if 'f64_err' in r:
            line += ('; max_abs_err vs float64: kernel %.3e, plain float32 '
                     '%.3e (ratio %.2f)' % (*r['f64_err'], r['f64_err'][0]
                                            / r['f64_err'][1]))
        if 'emu_ulps' in r:
            line += ('; vs its emulation: kernel %.2f, plain float32 %.2f '
                     'float32 ulps of max|dW|' % r['emu_ulps'])
        if device.type == 'cuda':
            line += ('; bound %.4f ms (%s); kernel / bound %.2f, kernel / '
                     'cuDNN %.3f' % (r['bound_ms'], r['bound_by'],
                                     r['kernel_ms'] / r['bound_ms'],
                                     r['kernel_ms'] / r['library_ms']))
        print(line)
        if args.profile:
            for what, key in (('K4', 'kernel_us'), ('cuDNN', 'library_us')):
                if not r[key]:
                    print('  device time per call, %s: not recorded (the '
                          'profiler saw no device activity)' % what)
                    continue
                print('  device time per call, %s: %.1f us (%s)' % (
                    what, sum(r[key].values()), '; '.join(
                        '%s %.1f' % (k[:50], v) for k, v in r[key].items())))
    if args.shape is None:
        tot = {k: sum(n * r[k] for _, n, r in rows)
               for k in ('kernel_ms', 'library_ms', 'plain_ms', 'bound_ms')}
        print('K4 per step (%d launches): kernel %.4f ms, %s %.4f ms, plain '
              '%.4f ms%s' % (sum(n for _, n, _ in rows), tot['kernel_ms'],
                             lib, tot['library_ms'], tot['plain_ms'],
                             '' if device.type != 'cuda' else
                             ', bound %.4f ms; kernel / bound %.2f, kernel / '
                             'cuDNN %.3f' % (
                                 tot['bound_ms'],
                                 tot['kernel_ms'] / tot['bound_ms'],
                                 tot['kernel_ms'] / tot['library_ms'])))
    return rows


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            print('bench_conv_dw_torch: torch finds no CUDA device (pass '
                  '--device cpu to run the plain version on the CPU)',
                  file=sys.stderr)
            return 1
        # float32 references, and cuDNN's float32 wgrad, without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    run(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
