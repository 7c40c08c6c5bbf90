"""The eight readers of the port's spans (``spanread.py`` and their files
under ``metrics/``), run on fabricated units: the numbers they give, and
None where the program recorded no spans or has no recorder; and the
program's functions that a cell calls load the recorder."""

import json
import os
import subprocess
import sys
import types

import pytest

from bench_small import ROOT  # noqa: I100 (first)
import devtrace
import run
import spanread

TRAIN_CELLS = ('cub-splitz-cap-ca.train-b512', 'cub-splitz-cap-lin.train-b512')
SAMPLE_CELL = 'cub-splitz-cap-ca.sample-320'
TRAIN_METRICS = {'g_forward_ms.train', 'd_update_ms.train',
                 'g_update_ms.train', 'adam_ms.train', 'capsule_ms.train'}
SAMPLE_METRICS = {'dispatch_ms.sample', 'caller_gap_ms.sample',
                  'call_idle_ms.sample'}


def _span(name, ms, parent=None, **extra):
    return dict({'name': name, 'attrs': {}, 'id': None, 'parent': parent,
                 'device_ms': ms}, **extra)


def _step(scale):
    """One step unit: each phase's device ms times ``scale``."""
    phases = [('step.g_forward', 10.0), ('step.d_passes', 20.0),
              ('step.d_backward', 30.0), ('step.d_adam', 1.0),
              ('step.d_passes', 22.0), ('step.d_backward', 32.0),
              ('step.d_adam', 1.5), ('step.g_loss', 40.0),
              ('step.g_backward', 50.0), ('step.g_adam', 2.0)]
    spans = [_span('step', 210.0 * scale)]
    spans += [_span(n, ms * scale, 'step') for n, ms in phases]
    spans += [_span('capsule.fwd', 3.0 * scale, 'step.d_passes'),
              _span('capsule.bwd', 4.0 * scale, 'step.g_backward')]
    return {'unit': scale, 'spans': spans}


def _call(k):
    """Sampler call ``k``: 30 ms on the card from 40 k ms, 2 ms on the
    host from 1 s + 40 k ms."""
    return {'unit': k, 'spans': [
        _span('sample.call', 30.0, device_start_ms=40.0 * k,
              device_end_ms=40.0 * k + 30.0,
              host_start_ns=int(1e9 + 40e6 * k),
              host_end_ns=int(1e9 + 40e6 * k + 2e6)),
        _span('capsule.fwd', 0.3, 'sample.call')]}


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in for the port's recorder in sys.modules, holding
    ``units`` by root name."""
    held = {}
    rec = types.SimpleNamespace(
        units=lambda name, n=None: held.get(name, [])[:n])
    monkeypatch.setitem(sys.modules, spanread.RECORDER, rec)
    return held


def _readers(cell):
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    return run.Cell(bench, cell, 1).readers()


def _read(cell, trace, kind):
    return {k: v['value'] for k, v in devtrace.read_metrics(
        trace, {'kind': kind, 'capsule_least_s': None}, _readers(cell)
    ).items()}


def _trace(units, busy_s=0.0):
    tr = devtrace.Trace([('k', 0.0, 1.0)], [], 1.0, units)
    tr.busy_s = busy_s
    return tr


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_train_readers(recorder, cell):
    # two units in the device-only trace, then the host trace's
    recorder['step'] = [_step(1.0), _step(2.0), _step(100.0)]
    got = _read(cell, _trace(2), 'train')
    assert TRAIN_METRICS <= set(got)
    assert not SAMPLE_METRICS & set(got)
    assert got['g_forward_ms.train'] == pytest.approx(15.0)
    assert got['d_update_ms.train'] == pytest.approx(1.5 * 104.0)
    assert got['g_update_ms.train'] == pytest.approx(1.5 * 90.0)
    assert got['adam_ms.train'] == pytest.approx(1.5 * 4.5)
    assert got['capsule_ms.train'] == pytest.approx(1.5 * 7.0)


def test_sample_readers(recorder):
    recorder['sample.call'] = [_call(k) for k in range(4)]
    got = _read(SAMPLE_CELL, _trace(3, busy_s=0.081), 'sample')
    assert SAMPLE_METRICS <= set(got)
    assert not TRAIN_METRICS & set(got)
    assert got['dispatch_ms.sample'] == pytest.approx(2.0)
    # calls 0-2: each opens 10 ms after the last one closed
    assert got['caller_gap_ms.sample'] == pytest.approx(10.0)
    assert got['call_idle_ms.sample'] == pytest.approx(30.0 - 27.0)


@pytest.mark.parametrize('cell', TRAIN_CELLS + (SAMPLE_CELL,))
def test_no_spans_read_none(monkeypatch, recorder, cell):
    kind = 'sample' if cell == SAMPLE_CELL else 'train'
    new = SAMPLE_METRICS if kind == 'sample' else TRAIN_METRICS
    # a recorder that holds nothing, or too few units for the trace
    assert not new & set(_read(cell, _trace(2), kind))
    recorder['step'] = [_step(1.0)]
    recorder['sample.call'] = [_call(0)]
    assert not new & set(_read(cell, _trace(2), kind))
    # spans without device times (a run off the card)
    recorder['step'] = [_step(1.0)]
    for s in recorder['step'][0]['spans']:
        s['device_ms'] = None
    assert not TRAIN_METRICS & set(_read(cell, _trace(1), kind))
    # a program without the recorder, as the parent of the spans has
    monkeypatch.delitem(sys.modules, spanread.RECORDER)
    recorder['step'] = [_step(1.0), _step(2.0)]
    recorder['sample.call'] = [_call(0), _call(1)]
    assert not new & set(_read(cell, _trace(2), kind))
    assert spanread.units(None, 'step') is None


@pytest.mark.parametrize('kind', ('train', 'sample'))
def test_the_program_loads_the_recorder(kind):
    """``spanread`` reads the recorder from sys.modules: the functions of
    ``program.py`` that a cell of each kind calls have to load it (a fresh
    interpreter, nothing run)."""
    call = {'train': 'program.make_train_step(program.port_config('
                     'run.Cell(bench_small.benchmark_json(), %r, 1).config))'
                     % TRAIN_CELLS[0],
            'sample': 'program.caption_sample()'}[kind]
    code = ('import sys\n'
            'sys.path.insert(0, %r)\n'
            'import bench_small, program, run, spanread\n'
            'before = spanread.RECORDER in sys.modules\n'
            '%s\n'
            'print(before, spanread.RECORDER in sys.modules)\n'
            % (os.path.dirname(os.path.abspath(__file__)), call))
    env = dict(os.environ, PYTHONPATH='')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == 'False True'
