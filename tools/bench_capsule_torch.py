#!/usr/bin/env python3
"""Microbenchmark of the port's capsule-routing kernels at the flagship
shapes.

    python3 tools/bench_capsule_torch.py [--bwd] [--profile] [--variants]
        [--batch 128] [--shape 48,8,1024,32] [--device cuda]

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

``--profile`` adds the kernels' device time under torch.profiler (20
calls after a warm-up, each kernel inside the call in launch order) and,
where the routing runs on a cluster of blocks per sample, a sweep over
every cluster size of ``CLUSTER_SIZES`` forced through the plan (CUDA
events in turns, and the routing kernel's device time):

- forward at a votes-form shape (in_length > 8, the discriminator class
  head: ``--shape 16,512,201,16 --batch 32``): K1-D (``routing_fwd_votes``),
  its 3xTF32 vote product and its routing, and the cluster sweep;
- forward at in_length 8 (the generator head: ``--shape 48,8,1024,32
  --batch 32`` or ``320``): K1-G (``routing_fwd_factored``), its W planes
  and its routing, its plan, the clusters the card holds at once, and the
  cluster sweep;
- ``--bwd`` at in_length 8 (the generator head: ``--shape 48,8,1024,32
  --batch 32``): K2-G (``routing_bwd_factored``) with dx and dW and with dx
  only (``need_dw=False``), its routing kernel and its dW sum, and the
  cluster sweep;
- ``--bwd`` at a votes-form shape: K2-D (``routing_bwd_votes``) with dx
  and dW and with dx only, its kernels (product u, routing, product dx,
  product dW). Beside it, the yardstick: the same three products as
  ``torch.matmul`` calls on inputs of the same shapes, in float32 with TF32
  off and again with TF32 on, each timed (CUDA events, in turns with K2-D)
  and profiled; the port never calls them. Then the cluster sweep.

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

from text2img_ekl_tpu_torch.ops import capsule_cuda as cc  # noqa: E402
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
    ap.add_argument('--profile', action='store_true',
                    help='device time of each kernel inside K1 (or with '
                    '--bwd, K2), and the cluster sweep')
    args = ap.parse_args(argv)
    if args.profile and (args.device != 'cuda' or args.variants):
        ap.error('--profile reads device time of the kernels: it needs '
                 '--device cuda, and not --variants')
    return args


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


def kernel_trace(fn, calls=20):
    """The device kernels of one call of ``fn`` in launch order, [(name,
    us per call)], from torch.profiler over ``calls`` calls after a
    warm-up; empty where the profiler recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARM):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if str(e.device_type).endswith('CUDA')),
                 key=lambda e: e.time_range.start)
    if not evs or len(evs) % calls:
        return []
    per = len(evs) // calls
    return [(evs[k].name, sum(evs[c * per + k].time_range.elapsed_us()
                              for c in range(calls)) / calls)
            for k in range(per)]


def _short(name):
    """A kernel's name without its return type, namespaces and arguments."""
    name = name.replace('(anonymous namespace)::', '')
    if name.startswith('void '):
        name = name[5:]
    return name.split('(')[0].split('<')[0].split('::')[-1]


def _label(trace, products=()):
    """Name the kernels of a trace: the 3xTF32 products in launch order take
    the names in ``products``, a routing kernel is 'routing', the rest keep
    their own."""
    names = iter(products)
    out = []
    for n, us in trace:
        short = _short(n)
        if short == 'gemm_kernel':
            out.append(('product %s' % next(names, '?'), us))
        else:
            out.append(('routing' if 'routing' in short else short, us))
    return out


def _print_trace(what, trace):
    print('%s device time per call: %s' % (
        what, '%.1f us (%s)' % (sum(us for _, us in trace), '; '.join(
            '%s %.1f' % kv for kv in trace)) if trace else
        'not recorded (the profiler saw no device activity)'))


def cluster_sweep(who, plans, call, device, products=()):
    """Each plan of ``plans`` {cluster: plan} timed with CUDA events in
    turns through ``call(plan)``, and its routing kernel's device time;
    prints and returns {cluster: (events ms, routing us)}."""
    fns = {c: (lambda p=p: call(p)) for c, p in plans.items()}
    best = best_ms(fns, device)
    out = {}
    for c, p in plans.items():
        trace = _label(kernel_trace(fns[c]), products)
        routing = sum(us for n, us in trace if n == 'routing')
        out[c] = (best[c][0], routing)
        print('%s cluster sweep C=%d (%d blocks, %d B of shared memory a '
              'block): %.4f ms (best of 2 x %d, in turns; all %s), routing %s '
              'device' % (who, c, p.blocks, p.smem_bytes, best[c][0], TIMED,
                          ['%.4f' % v for v in best[c][1]],
                          '%.1f us' % routing if trace else 'not recorded'))
    return out


def sweep_plans(plan_fn, sizes=cc.CLUSTER_SIZES):
    """{cluster: plan_fn(cluster)} over ``sizes``, each size the plan clamps
    to once."""
    plans = {}
    for c in sizes:
        p = plan_fn(c)
        plans.setdefault(p.cluster, p)
    return plans


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def fwd_sweep_plans(bsz, in_caps, out_caps, sms):
    """K1-G's plans {cluster: plan} at every cluster size the plan
    clamps to."""
    return sweep_plans(lambda c: cc.factored_fwd_plan(
        bsz, in_caps, out_caps, ITERS, sms, cluster=c),
        cc.FACTORED_CLUSTER_SIZES)


def profile_factored_fwd(x, w):
    """K1-G's plan, the clusters the card holds at once and its cluster
    sweep; prints and returns {'plan': plan, 'held': {cluster: clusters},
    'sweep': {cluster: (events ms, routing us)}}."""
    bsz, in_caps = x.shape[:2]
    out_caps, out_len = w.shape[:2]
    sms = _sms(x.device)
    held = cc.fwd_card_clusters(x.device, in_caps, out_caps, out_len)
    plan = cc.factored_fwd_plan(bsz, in_caps, out_caps, ITERS, sms,
                                max_clusters=held)
    plans = fwd_sweep_plans(bsz, in_caps, out_caps, sms)
    counts = {c: held(p.cluster, p.in_smem) for c, p in plans.items()}
    print('K1-G plan on %d SMs: clusters of %d, %d blocks, %d B of shared '
          'memory a block, couplings in shared memory %s; clusters the card '
          'holds at once: %s' % (
              sms, plan.cluster, plan.blocks, plan.smem_bytes, plan.in_smem,
              ', '.join('%d of C=%d' % (n, c) for c, n in counts.items())))
    sweep = cluster_sweep('K1-G', plans, lambda p: cc.routing_fwd_factored(
        x, w, ITERS, plan=p), x.device)
    return {'plan': plan, 'held': counts, 'sweep': sweep}


def profile_fwd(x, w):
    """K1's device time by kernel (K1-D: the vote product u and the
    routing; K1-G: W's planes and the routing), its plan and its cluster
    sweep. Prints and returns {'k1': trace, 'sweep': {cluster: (events ms,
    routing us)}} (and for K1-G its 'plan' and 'held')."""
    out = {'k1': _label(kernel_trace(lambda: capsule_routing(x, w, ITERS)),
                        ('u',))}
    votes = x.shape[2] != cc.FACTORED_IN_LENGTH
    _print_trace('K1-D' if votes else 'K1-G', out['k1'])
    if not votes:
        out.update(profile_factored_fwd(x, w))
    else:
        shape = x.shape + w.shape[:2]
        plan = cc.votes_fwd_plan(*shape, _sms(x.device))
        print('K1-D plan on %d SMs: clusters of %d, %d blocks, %d B of shared '
              'memory a block, votes in shared memory %s'
              % (_sms(x.device), plan.cluster, plan.blocks, plan.smem_bytes,
                 plan.votes_in_smem))
        out['sweep'] = cluster_sweep(
            'K1-D', sweep_plans(lambda c: cc.votes_fwd_plan(
                *shape, _sms(x.device), cluster=c)),
            lambda p: cc.routing_fwd_votes(x, w, ITERS, plan=p), x.device,
            ('u',))
    return out


def _dv(x, w):
    rng = np.random.default_rng(1)
    return torch.from_numpy(rng.standard_normal(
        (x.shape[0],) + w.shape[:2], dtype=np.float32)).to(x.device)


def profile_factored_bwd(x, w):
    """K2-G's device time by kernel (its routing, then the dW sum), with dx
    and dW and with dx only, its plan and its cluster sweep; prints and
    returns {'k2g': {need_dw: trace}, 'sweep': {cluster: (events ms,
    routing us)}}."""
    dv = _dv(x, w)
    out = {'k2g': {}}
    for need_dw in (True, False):
        trace = _label(kernel_trace(lambda: cc.routing_bwd_factored(
            x, w, dv, ITERS, True, need_dw)))
        out['k2g'][need_dw] = trace
        _print_trace('K2-G %s' % ('dx and dW' if need_dw else 'dx only'),
                     trace)
    bsz, in_caps = x.shape[:2]
    out_caps, out_len = w.shape[:2]
    held = cc.card_clusters(x.device, in_caps, out_caps, out_len, ITERS)
    plan = cc.factored_bwd_plan(bsz, in_caps, out_caps, ITERS,
                                _sms(x.device), max_clusters=held)
    print('K2-G plan on %d SMs: clusters of %d, %d blocks, %d B of shared '
          'memory a block, stashes in shared memory %s; clusters the card '
          'holds at once: %s' % (
              _sms(x.device), plan.cluster, plan.blocks, plan.smem_bytes,
              plan.in_smem, ', '.join('%d of %d' % (held(
                  p.cluster, p.in_smem), c) for c, p in sweep_plans(
                      lambda c: cc.factored_bwd_plan(
                          bsz, in_caps, out_caps, ITERS, _sms(x.device),
                          cluster=c), cc.FACTORED_CLUSTER_SIZES).items())))
    out['sweep'] = cluster_sweep(
        'K2-G', sweep_plans(lambda c: cc.factored_bwd_plan(
            bsz, in_caps, out_caps, ITERS, _sms(x.device), cluster=c),
            cc.FACTORED_CLUSTER_SIZES),
        lambda p: cc.routing_bwd_factored(x, w, dv, ITERS, True, True,
                                          plan=p), x.device)
    return out


def profile_votes_bwd(x, w, card):
    """K2-D's device time by kernel, with dx and dW and with dx only, and
    the torch.matmul yardstick of its three products, in float32 and in
    TF32, and the cluster sweep; prints and returns {'k2d': {need_dw:
    trace}, 'matmul': {tf32: (events ms, trace)}, 'k2d_ms': {need_dw:
    [events ms]}, 'sweep': {cluster: (events ms, routing us)}}."""
    bsz, in_caps, in_len = x.shape
    out_caps, out_len = w.shape[:2]
    dv = _dv(x, w)
    rng = np.random.default_rng(2)
    x2, w2 = x.reshape(bsz * in_caps, in_len), w.reshape(-1, in_len)
    du = torch.from_numpy(rng.standard_normal(
        (bsz * in_caps, out_caps * out_len), dtype=np.float32)).to(x.device)

    def products():
        return x2 @ w2.t(), du @ w2, du.t() @ x2

    out = {'k2d': {}, 'matmul': {}, 'k2d_ms': {}}
    for need_dw in (True, False):
        def k2d():
            return cc.routing_bwd_votes(x, w, dv, ITERS, True, need_dw)
        trace = _label(kernel_trace(k2d),
                       ('u', 'dx', 'dW') if need_dw else ('u', 'dx'))
        out['k2d'][need_dw] = trace
        _print_trace('K2-D %s' % ('dx and dW' if need_dw else 'dx only'),
                     trace)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            best = best_ms({'matmul': products,
                            'dx_dw': lambda: cc.routing_bwd_votes(
                                x, w, dv, ITERS, True, True),
                            'dx': lambda: cc.routing_bwd_votes(
                                x, w, dv, ITERS, True, False)}, x.device)
            trace = kernel_trace(products)
            out['matmul'][tf32] = (best['matmul'][0], trace)
            out['k2d_ms'].setdefault(True, []).append(best['dx_dw'][0])
            out['k2d_ms'].setdefault(False, []).append(best['dx'][0])
            print('torch.matmul x3 (u, dx, dW; %s): %.4f ms (best of 2 x %d, '
                  'in turns with K2-D: dx and dW %.4f ms, dx only %.4f ms); '
                  'device %s on %s' % (
                      'TF32' if tf32 else 'float32, TF32 off',
                      best['matmul'][0], TIMED, best['dx_dw'][0],
                      best['dx'][0], '%.1f us (%s)' % (
                          sum(us for _, us in trace), '; '.join(
                              '%.1f' % us for _, us in trace))
                      if trace else 'not recorded', card))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    sms = _sms(x.device)
    shape = (bsz, in_caps, in_len, out_caps, out_len)
    plan = cc.votes_bwd_plan(*shape, ITERS, sms)
    print('K2-D plan on %d SMs: clusters of %d, %d blocks, %d B of shared '
          'memory a block, votes in shared memory %s, dx split %d ways'
          % (sms, plan.cluster, plan.blocks, plan.smem_bytes,
             plan.votes_in_smem, plan.dx_splits))
    out['sweep'] = cluster_sweep(
        'K2-D', sweep_plans(lambda c: cc.votes_bwd_plan(
            *shape, ITERS, sms, cluster=c)),
        lambda p: cc.routing_bwd_votes(x, w, dv, ITERS, True, True, plan=p),
        x.device, ('u', 'dx', 'dW'))
    return out


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
        res = {'shape': (bsz,) + shape, 'rows': rows}
        if args.profile:
            res['profile'] = (profile_factored_bwd(x, w) if shape[1] ==
                              cc.FACTORED_IN_LENGTH else
                              profile_votes_bwd(x, w, card))
        return res

    res = {'shape': (bsz,) + shape, 'rows': rows}
    with torch.no_grad():
        best = best_ms({'plain': plain, 'K1': k1}, device)
        row('plain', None, best['plain'], 0.0)
        row('K1', None, best['K1'], k1_err)
        if args.profile:
            res['profile'] = profile_fwd(x, w)
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
    return res


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
