#!/usr/bin/env python3
"""Microbenchmark of the port's capsule-routing kernels at the flagship
shapes.

    python3 tools/bench_capsule_torch.py [--bwd | --variants] [--batch 128]
        [--shape 48,8,1024,32] [--device cuda]

The port of tools/bench_capsule.py, with no JAX. ``--shape`` is
in_capsules,in_length,out_capsules,out_length: the generator head by
default, 16,512,201,16 for a discriminator class head. Inputs, from numpy
seed 0: x ~ N(0, 1) [B, in, in_length] and a unit-variance weight [out,
out_length, in_length] scaled by 1/sqrt(in_length / 8), as chip_smoke.py
draws them (the JAX tool scales the weight by 0.1, which leaves the
routing nearly uniform); 3 routing iterations.

Parity comes first: K1 (``capsule_routing``) against the plain routing,
and with ``--variants`` each variant at each NB against the plain routing,
all at K1's bar |d| <= 1e-4 |ref| + 1e-5 max|ref|; with ``--bwd`` the
gradients of sum(v**2) through K1 + K2 against plain autograd at K2's bar
|d| <= 1e-3 |ref| + 1e-4 max|ref|. A miss raises. Then the times, CUDA
events, best of two runs of each function in turns (a, b, b, a):

- default: the plain routing and K1;
- ``--bwd``: forward + backward through plain autograd and through
  ``CapsuleRoutingFunction`` (K1 + K2);
- ``--variants``: the plain routing and K1, then every variant at every NB
  of ``SWEEP`` in turns with K1.

It needs a CUDA card, and refuses to run without one, unless ``--device
cpu`` is given: then the same runs on the CPU, where every wrapper takes
the plain routing, and the times are the CPU's host clock. A kernel that
fails to build or launch fails the run. Prints the card's name and power
limit (nvidia-smi) first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from text2img_ekl_tpu_torch.ops import capsule_variants as cv  # noqa: E402
from text2img_ekl_tpu_torch.ops.capsule import capsule_linear  # noqa: E402
from text2img_ekl_tpu_torch.ops.capsule_cuda import \
    capsule_routing  # noqa: E402

ITERS = 3
# the NB values tools/bench_capsule.py sweeps, each with NB=1 beside it
SWEEP = (('V-stored', (8, 1)), ('V-seq', (2, 4, 1)),
         ('V-recompute', (8, 16, 32, 1)))
K1_RTOL, K1_ATOL = 1e-4, 1e-5
K2_RTOL, K2_ATOL = 1e-3, 1e-4
WARM, TIMED = 2, 10  # calls before a timed run, calls per timed run


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--bwd', action='store_true',
                      help='time forward + backward (K1 + K2)')
    mode.add_argument('--variants', action='store_true',
                      help='check and time the batch-blocked variants (V)')
    ap.add_argument('--batch', type=int, default=128)
    ap.add_argument('--shape', type=str, default='48,8,1024,32',
                    help='in_caps,in_length,out_caps,out_length')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    return ap.parse_args(argv)


def _inputs(batch, shape, device):
    in_caps, in_len, out_caps, out_len = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((batch, in_caps, in_len), dtype=np.float32)
    w = rng.standard_normal((out_caps, out_len, in_len), dtype=np.float32) \
        / np.float32(np.sqrt(in_len / 8))
    return torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)


def _check(what, out, ref, rtol, atol):
    """Print and return max|out - ref|; raise where an element misses
    |d| <= rtol |ref| + atol max|ref|."""
    diff = (out - ref).abs()
    scale = float(ref.abs().max())
    ok = bool((diff <= rtol * ref.abs() + atol * scale).all())
    err = float(diff.max())
    print('%s: max|ref| %.3e, max_abs_err %.3e; bound |d| <= %.0e |ref| + '
          '%.0e max|ref|: %s' % (what, scale, err, rtol, atol,
                                 'ok' if ok else 'FAIL'))
    if not ok:
        raise AssertionError('%s disagrees with the plain routing' % what)
    return err


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
    """Best of two runs of each function, in turns (a, b, b, a), after a
    warm-up; returns name -> (best ms, [ms of each run])."""
    times = {name: [] for name in fns}
    names = list(fns)
    for name in names + names[::-1]:
        _run_ms(fns[name], WARM, device)
        times[name].append(_run_ms(fns[name], calls, device))
    return {name: (min(t), t) for name, t in times.items()}


def _card(device):
    if device.type != 'cuda':
        return 'cpu (host clock)'
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _grads(fn, x, w):
    xd = x.detach().requires_grad_(True)
    wd = w.detach().requires_grad_(True)
    return torch.autograd.grad((fn(xd, wd, ITERS) ** 2).sum(), (xd, wd))


def run(args):
    """Check, time and print; returns {'shape': (B, in, in_length, out,
    out_length), 'rows'}, one row per function timed: name, nb, ms,
    all_ms, max_abs_err, k1_ms (the yardstick timed in turns with it)."""
    device = torch.device(args.device)
    shape = tuple(int(v) for v in args.shape.split(','))
    bsz = args.batch
    card = _card(device)
    print('card: %s; x [%d, %d, %d], W [%d, %d, %d], %d iterations'
          % (card, bsz, shape[0], shape[1], shape[2], shape[3], shape[1],
             ITERS))
    x, w = _inputs(bsz, shape, device)
    tag = 'B=%d %s' % (bsz, args.shape)
    rows = []

    def row(name, nb, t, err, k1_ms=None):
        rows.append({'name': name, 'nb': nb, 'ms': t[0], 'all_ms': t[1],
                     'max_abs_err': err, 'k1_ms': k1_ms})
        print('%s%s %s: %.4f ms (best of 2 x %d; all %s)%s'
              % (name, '' if nb is None else ' NB=%d' % nb, tag, t[0], TIMED,
                 ['%.4f' % v for v in t[1]],
                 '' if k1_ms is None else ', K1 %.4f ms in turns' % k1_ms))

    with torch.no_grad():
        ref = capsule_linear(x, w, ITERS, 'dynamic')
        k1_err = _check('K1 %s' % tag, capsule_routing(x, w, ITERS), ref,
                        K1_RTOL, K1_ATOL)

        def plain():
            return capsule_linear(x, w, ITERS, 'dynamic')

        def k1():
            return capsule_routing(x, w, ITERS)

    if args.bwd:
        ref_g = _grads(capsule_linear, x, w)
        got_g = _grads(capsule_routing, x, w)
        err = max(_check('K1+K2 %s d%s' % (tag, what), got, want, K2_RTOL,
                         K2_ATOL)
                  for what, got, want in zip(('x', 'W'), got_g, ref_g))
        best = best_ms({'plain': lambda: _grads(capsule_linear, x, w),
                        'kernel': lambda: _grads(capsule_routing, x, w)},
                       device)
        row('plain forward+backward', None, best['plain'], 0.0)
        row('K1+K2 forward+backward', None, best['kernel'], err)
        return {'shape': (bsz,) + shape, 'rows': rows}

    with torch.no_grad():
        best = best_ms({'plain': plain, 'K1': k1}, device)
        row('plain', None, best['plain'], 0.0)
        row('K1', None, best['K1'], k1_err)
        if args.variants:
            for name, nbs in SWEEP:
                fn = cv.KERNELS[name]
                for nb in nbs:
                    err = _check('%s NB=%d %s' % (name, nb, tag),
                                 fn(x, w, ITERS, nb=nb), ref, K1_RTOL,
                                 K1_ATOL)
                    best = best_ms({'V': lambda: fn(x, w, ITERS, nb=nb),
                                    'K1': k1}, device)
                    row(name, nb, best['V'], err, best['K1'][0])
    return {'shape': (bsz,) + shape, 'rows': rows}


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == 'cuda':
        if not torch.cuda.is_available():
            print('bench_capsule_torch: torch finds no CUDA device (pass '
                  '--device cpu to run the plain routing on the CPU)',
                  file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
    run(args)
    return 0


if __name__ == '__main__':
    sys.exit(main())
