"""Small cells for the benchmark's CPU tests: a workload of BENCHMARK.json
at GF_DIM and DF_DIM 8, a batch of 8 and a handful of sampler images, run
on the CPU by the harness's own ``run_cell``, which skips the look for a
card and drives everything else of a run."""

from __future__ import annotations

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import run  # noqa: E402

WORKLOADS = ('cub-splitz-cap-ca.train-b512', 'cub-splitz-cap-ca.sample-320',
             'cub-splitz-cap-lin.train-b512')
TRAIN = ('cub-splitz-cap-ca.train-b512', 'cub-splitz-cap-lin.train-b512')


def benchmark_json() -> dict:
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def small_cell(workload: str, seed: int = 2 ** 31 + 7, policy: str = None,
               width: int = 8, batch: int = 8) -> 'run.Cell':
    """The workload at a small width on the CPU. ``policy`` 'float32' runs
    the port's float32 compute and BatchNorm: at a width of 8 on the CPU
    the bfloat16 policy's gaps are not those of the full width on the
    card, which the limits were set from."""
    import torch
    cell = run.Cell(benchmark_json(), workload, seed)
    cell.config = copy.deepcopy(cell.config)
    cell.config['GAN']['GF_DIM'] = width
    cell.config['GAN']['DF_DIM'] = width
    cell.config['TRAIN']['BATCH_SIZE'] = batch
    if policy:
        cell.config['TPU_COMPUTE_DTYPE'] = policy
        cell.config['TPU_BN_DTYPE'] = policy
    cell.traffic = dict(cell.traffic, batch=batch, images=4, captions=2,
                        checked_from=6, checked_calls=3)
    cell.device = torch.device('cpu')
    return cell


def run_small(cell, seconds: float = 0.5):
    """``run_cell`` on the CPU: (result dict, lines of the checks)."""
    return run.run_cell(cell, seconds, False, 'cpu')
