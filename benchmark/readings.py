#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell,
in one process (PERF.md gives the readings each limit was set from):

    python3 benchmark/readings.py --workload <name> --seeds 1,2,...
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--seconds 7]

  program  the numbers a run compares, on each seed: the first steps (or
           a window of ``--seconds`` of sampler calls) of the port against
           the reference;
  control  the reference computed with fp8 products (the precision below
           the configuration's bfloat16) in the port's place, against the
           float32 reference;
  half     (training) the port stepping half of each batch, its losses the
           mean over the rest, against the reference on the whole batch.

Prints one JSON line per reading. Needs a CUDA card; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import compare  # noqa: E402
import loops  # noqa: E402
import program  # noqa: E402
import run  # noqa: E402


def halve(tree):
    """Every tensor of a batch or its draws cut to its first half of
    rows."""
    if isinstance(tree, dict):
        return {k: halve(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(halve(v) for v in tree)
    return tree[:tree.shape[0] // 2]


def half_batch_step(make):
    """A ``make_train_step`` whose step sees half of each batch."""
    def make_half(cfg):
        step = make(cfg)

        def half(state, batch, seed, draws=None):
            return step(state, halve(batch), seed, halve(draws))
        return half
    return make_half


def program_reading(cell, seconds: float) -> dict:
    kind = loops.KINDS[cell.traffic['kind']](cell)
    kind.setup()
    if cell.traffic['kind'] == 'sample':
        kind.window(seconds)
    kind.release()
    f32 = cell.reference.Precision('float32')
    if cell.traffic['kind'] == 'train':
        ref = kind.reference(f32)
        return dict(compare.train_numbers(kind.prog, ref),
                    details=compare.train_details(kind.prog, ref))
    return kind.check(f32)


def control_reading(cell) -> dict:
    kind = loops.KINDS[cell.traffic['kind']](cell)
    kind.make_pool()
    fp8 = cell.reference.Precision('fp8')
    f32 = cell.reference.Precision('float32')
    if cell.traffic['kind'] == 'train':
        low, ref = kind.reference(fp8), kind.reference(f32)
        return dict(compare.train_numbers(low, ref),
                    details=compare.train_details(low, ref))
    gap = 0.0
    with cell.reference.reference_mode():
        for slot in range(len(kind.pool)):
            gap = max(gap, compare.image_gap(kind.reference_images(slot, fp8),
                                             kind.reference_images(slot, f32)))
    return {'image_gap': gap}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--fault-seeds', default='')
    ap.add_argument('--seconds', type=float, default=7.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('readings: no CUDA card', file=sys.stderr)
        return 2
    run._cache_dirs()
    bench = run._read_json(run.ROOT, 'BENCHMARK.json')
    seeds = lambda s: [int(x) for x in s.split(',') if x]  # noqa: E731

    def emit(what, seed, numbers):
        print(json.dumps({'workload': args.workload, 'reading': what,
                          'seed': seed, 'numbers': numbers}), flush=True)

    for seed in seeds(args.seeds):
        cell = run.Cell(bench, args.workload, seed)
        cell.device = torch.device('cuda', 0)
        emit('program', seed, program_reading(cell, args.seconds))
    for seed in seeds(args.control_seeds):
        cell = run.Cell(bench, args.workload, seed)
        cell.device = torch.device('cuda', 0)
        emit('control', seed, control_reading(cell))
    make = program.make_train_step
    program.make_train_step = half_batch_step(make)
    try:
        for seed in seeds(args.fault_seeds):
            cell = run.Cell(bench, args.workload, seed)
            cell.device = torch.device('cuda', 0)
            emit('half', seed, program_reading(cell, args.seconds))
    finally:
        program.make_train_step = make
    return 0


if __name__ == '__main__':
    sys.exit(main())
