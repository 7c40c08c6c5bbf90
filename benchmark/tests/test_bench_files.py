"""The harness finds a configuration, a traffic mix, a limit file and a
per-layer metric by name: a copy of the benchmark with one more cell,
added as new files and BENCHMARK.json entries only, runs that cell and
reads its new metric, with no edit to any file that was there."""

import json
import os
import shutil

from bench_small import BENCH, ROOT  # noqa: I100 (first)
import devtrace
import run

READER = '''"""A test metric: device seconds a unit in kernels named 'k1'."""


def read(trace, run):
    if trace is None:
        return None
    return trace.seconds(('k1',)) / trace.units
'''


def _copy(tmp):
    root = os.path.join(tmp, 'checkout')
    shutil.copytree(BENCH, os.path.join(root, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), root)
    return root


def test_new_files_make_a_new_cell(tmp_path):
    root = _copy(str(tmp_path))
    before = {os.path.join(d, n): open(os.path.join(d, n), 'rb').read()
              for d, _, ns in os.walk(root) for n in ns}
    bench_dir = os.path.join(root, 'benchmark')
    # a configuration: the flagship at another batch, in a file of its own
    cfg = json.load(open(os.path.join(bench_dir, 'configs',
                                      'cub-splitz-cap-ca.json')))
    cfg['config']['TRAIN']['BATCH_SIZE'] = 8
    cfg['config']['GAN']['GF_DIM'] = cfg['config']['GAN']['DF_DIM'] = 8
    json.dump(cfg, open(os.path.join(bench_dir, 'configs', 'tiny.json'),
                        'w'))
    # a traffic mix: data only
    json.dump({'kind': 'train', 'batch': 8, 'batches': 3},
              open(os.path.join(bench_dir, 'traffic', 'train-b8.json'), 'w'))
    json.dump({'limits': {'grad_gap_d': 1.0, 'grad_gap_g': 1.0,
                          'change_gap': 1.0}},
              open(os.path.join(bench_dir, 'limits', 'tiny.train-b8.json'),
                   'w'))
    # a per-layer metric: a reader of its own
    open(os.path.join(bench_dir, 'metrics', 'k1_s.train.py'),
         'w').write(READER)
    bench = json.load(open(os.path.join(root, 'BENCHMARK.json')))
    bench['configs'].append({'name': 'tiny', 'source': 'a test',
                             'file': 'benchmark/configs/tiny.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'].append({'name': 'tiny.train-b8', 'config': 'tiny',
                               'traffic': 'train-b8', 'chips': 1,
                               'why': 'a test'})
    for e in bench['end_to_end']:
        if e['name'] == 'train_img_s':
            e['workloads'].append('tiny.train-b8')
    bench['per_layer'].append({'name': 'k1_s.train', 'unit': 's',
                               'better': 'lower', 'source': 'device_trace',
                               'layer': 'a test', 'moves': 'train_img_s',
                               'workloads': ['tiny.train-b8']})
    json.dump(bench, open(os.path.join(root, 'BENCHMARK.json'), 'w'))

    cell = run.Cell(bench, 'tiny.train-b8', 11, root=root)
    assert cell.traffic['batch'] == 8 and cell.limits['change_gap'] == 1.0
    out, lines = run.run_cell(cell, 0.3, False, 'cpu')
    assert out['correct'], lines
    assert set(out['metrics']) == {'train_img_s', 'setup_s'}
    readers = cell.readers()
    assert set(readers) == {'k1_s.train'}
    trace = devtrace.Trace([('k1', 0.0, 5.0), ('k2', 5.0, 7.0),
                            ('k1', 9.0, 10.0)], [], 20e-6, 2)
    got = devtrace.read_metrics(trace, {'kind': 'train'}, readers)
    assert got == {'k1_s.train': {'value': 3e-6, 'unit': 's'}}
    for path, data in before.items():
        if os.path.basename(path) != 'BENCHMARK.json':
            assert open(path, 'rb').read() == data, path


def test_a_reader_that_finds_nothing_is_left_out():
    trace = devtrace.Trace([('other', 0.0, 1.0)], [], 1e-6, 1)
    readers = run.Cell(json.load(open(os.path.join(ROOT, 'BENCHMARK.json'))),
                       'cub-splitz-cap-ca.train-b512', 1).readers()
    got = devtrace.read_metrics(trace, {'kind': 'train',
                                        'capsule_least_s': 1e-3,
                                        'units_per_s': 4.0,
                                        'flops_per_unit': 1e12}, readers)
    assert 'capsule_roofline_pct.train' not in got
    assert got['mfu_pct.train']['value'] == 100 * 4e12 / 989e12
    assert got['idle_pct.train']['value'] == 0.0
