#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json`` at the checkout's
root; its configuration (``benchmark/configs/<config>.json``, with the
plain reference module it names beside it), its traffic
(``benchmark/traffic/<traffic>.json``, whose ``kind`` picks a loop of
``loops.py``), its limits (``benchmark/limits/<workload>.json``) and its
per-layer readers (``benchmark/metrics/<metric>.py``) are found by name,
so a cell, a configuration, a traffic mix or a metric is added as files
and entries with no edit here.

One run: set-up (the port's kernels load or build into the checkout's
``build/``, the weights and inputs are made on the card from the seed, the
first units run), then the window of ``--seconds``; with ``--trace 1`` a
few more units under ``torch.profiler``; then the port's state is freed and
what the timed path produced is held to the reference. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error. Needs as many CUDA cards as
the cell asks for; without them it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# what nothing the benchmark runs may load, by whole top-level name
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'text2img_ekl_tpu')
TRACED_UNITS = {'train': 4, 'sample': 20}


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its files, the run's seed and
    its device."""

    def __init__(self, bench: dict, name: str, seed: int, root: str = ROOT):
        work = {w['name']: w for w in bench['workloads']}
        if name not in work:
            raise SystemExit('no workload %r in BENCHMARK.json' % name)
        here = os.path.join(root, os.path.relpath(HERE, ROOT))
        self.here = here
        self.workload = work[name]
        self.name = name
        self.seed = seed
        self.chips = int(self.workload['chips'])
        configs = {c['name']: c for c in bench['configs']}
        entry = configs[self.workload['config']]
        self.config_file = _read_json(root, entry['file'])
        self.config = self.config_file['config']
        self.reference = _load_module(
            os.path.join(os.path.dirname(os.path.join(root, entry['file'])),
                         self.config_file['reference'] + '.py'),
            'reference_' + self.config_file['reference'])
        self.traffic_name = self.workload['traffic']
        self.traffic = _read_json(here, 'traffic', self.traffic_name + '.json')
        limits = os.path.join(here, 'limits', name + '.json')
        self.limits = _read_json(limits)['limits'] \
            if os.path.exists(limits) else {}
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        self.per_layer = [m for m in bench['per_layer']
                          if name in m.get('workloads', [name])]
        self.device = None

    def readers(self) -> dict:
        return {m['name']: (_load_module(
            os.path.join(self.here, 'metrics', m['name'] + '.py'),
            'metric_' + m['name'].replace('.', '_')).read, m['unit'])
            for m in self.per_layer}


def forbidden_modules() -> list:
    loaded = {m.split('.')[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def _card(torch) -> dict:
    out = {'name': torch.cuda.get_device_name(0)}
    try:
        q = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                            '--format=csv,noheader,nounits', '-i', '0'],
                           capture_output=True, text=True, timeout=30)
        out['power_limit_w'] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out['power_limit_w'] = None
    return out


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the port builds
    its own libraries into ``build/`` there)."""
    build = os.path.join(ROOT, 'build')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build,
                                                      'torch_extensions')
    os.environ.setdefault('USE_FLAX', '0')


def run_cell(cell: Cell, seconds: float, trace: bool, device,
             start: float = T_START):
    """Set-up, window, optional trace and check of one cell on ``device``;
    -> (the result's dict, the lines of the numbers compared)."""
    import torch
    import compare
    import devtrace
    import loops

    cell.device = torch.device(device)
    if cell.device.type == 'cuda':
        torch.cuda.init()
    kind = cell.traffic['kind']
    traffic = loops.KINDS[kind](cell)
    ready = time.perf_counter() - start
    traffic.setup()
    loops.sync(cell.device)
    setup_s = time.perf_counter() - start
    print('setup %.3f s: imports and device %.3f, %s' % (
        setup_s, ready, ', '.join('%s %.3f' % kv
                                 for kv in traffic.setup_phases.items())),
        file=sys.stderr)
    result = traffic.window(seconds)
    recorded = gaps = None
    if trace:
        recorded = devtrace.record(traffic.run, TRACED_UNITS[kind])
        gaps = devtrace.record(traffic.run, TRACED_UNITS[kind],
                               host=True).idle_gaps()
    on_card = cell.device.type == 'cuda'
    memory_peak = torch.cuda.max_memory_allocated(cell.device) \
        if on_card else 0
    card = _card(torch) if on_card else {'name': str(device),
                                         'power_limit_w': None}
    attempted = result['units']
    traffic.release()

    numbers = traffic.check(cell.reference.Precision('float32'))
    correct, lines = compare.judge(numbers, cell.limits)
    metrics = {}
    if trace:
        run = {'kind': kind, 'units_per_s': result['units_per_s'],
               'flops_per_unit': traffic.flops_per_unit,
               'capsule_least_s': traffic.capsule_least_s}
        metrics = devtrace.read_metrics(recorded, run, cell.readers())
    else:
        values = dict(result, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': values[m['name']],
                                  'unit': m['unit']}
    device_out = {'platform': 'gpu' if on_card else cell.device.type,
                  'kind': card['name'], 'count': cell.chips,
                  'memory_peak_bytes': int(memory_peak)}
    out = {'correct': bool(correct), 'attempted': attempted,
           'failed': 0 if correct else attempted,
           'metrics': metrics, 'device': device_out}
    if recorded is not None:
        device_out['busy_s'] = recorded.busy_s
        device_out['window_s'] = recorded.window_s
        out['breakdown'] = {'device_ops': recorded.top_kernels(),
                            'idle_gaps': gaps}
    out['card'] = {'power_limit_w': card['power_limit_w'],
                   'setup_s': setup_s, 'window_units': attempted}
    # a number that is not finite (an output of the wrong shape) prints as
    # null: the line stays strict JSON
    out['checks'] = {k: {'value': _finite(numbers.get(k, math.inf)),
                         'limit': v} for k, v in cell.limits.items()}
    return out, lines


def _finite(x):
    return x if math.isfinite(x) else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    bench = _read_json(ROOT, 'BENCHMARK.json')
    cell = Cell(bench, args.workload, args.seed)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('benchmark: the cell needs %d CUDA card(s); torch finds %d'
              % (cell.chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out, lines = run_cell(cell, args.seconds, bool(args.trace), 'cuda:0')
    found = forbidden_modules()
    if found:
        print('benchmark: the run loaded %s' % ', '.join(found),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    return 0


if __name__ == '__main__':
    sys.exit(main())
