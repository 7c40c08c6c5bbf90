"""BENCHMARK.json against the rules it is checked by: names, units, sizes
and keys, the cells each metric is reported in, and the files each entry
names."""

import os
import re

import pytest

from bench_small import BENCH, ROOT, benchmark_json

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./\-]{1,200}$')
TOP = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
       'end_to_end', 'per_layer'}
KEYS = {
    'configs': ({'name', 'source', 'file', 'reduced', 'why'}, set()),
    'workloads': ({'name', 'config', 'traffic', 'chips', 'why'}, set()),
    'end_to_end': ({'name', 'unit', 'better', 'bound', 'source'},
                   {'workloads'}),
    'per_layer': ({'name', 'unit', 'better', 'source', 'layer', 'moves'},
                  {'workloads'})}


def _line(text):
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


@pytest.fixture(scope='module')
def bench():
    return benchmark_json()


def test_top_level_and_entry_keys(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    for section, (required, optional) in KEYS.items():
        assert bench[section]
        for entry in bench[section]:
            assert required <= set(entry) <= required | optional, entry


def test_names_units_and_text(bench):
    for section in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [e['name'] for e in bench[section]]
        assert len(names) == len(set(names)), section
        for e in bench[section]:
            assert NAME.match(e['name']), e['name']
    for e in bench['end_to_end'] + bench['per_layer']:
        assert UNIT.match(e['unit']), e['unit']
        assert e['better'] in ('lower', 'higher')
    for e in bench['configs']:
        assert _line(e['source']) and _line(e['why'])
        assert len(e['reduced']) <= 16
        assert all(NAME.match(k) for k in e['reduced'])
    for e in bench['workloads']:
        assert NAME.match(e['config']) and NAME.match(e['traffic'])
        assert _line(e['why'])
    for e in bench['per_layer']:
        assert _line(e['layer'])


def test_command_paths_and_budget(bench):
    assert 1 <= len(bench['paths']) <= 16
    for p in bench['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch') and os.path.isdir(
            os.path.join(ROOT, p))
    cmd = bench['command']
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for word in cmd:
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word.startswith(p + '/') for p in bench['paths'])
    rs = bench['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_cells_and_bounds(bench):
    configs = {c['name']: c for c in bench['configs']}
    used = {w['config'] for w in bench['workloads']}
    assert used == set(configs)
    files = [c['file'] for c in bench['configs']]
    assert len(files) == len(set(files))
    for c in bench['configs']:
        assert any(c['file'].startswith(p + '/') for p in bench['paths'])
        assert os.path.exists(os.path.join(ROOT, c['file']))
    pairs = [(w['config'], w['traffic']) for w in bench['workloads']]
    assert len(pairs) == len(set(pairs))
    assert all(w['chips'] in (1, 4) for w in bench['workloads'])
    for e in bench['end_to_end']:
        assert e['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= e['bound'] <= 0.25
    setup = [e for e in bench['end_to_end'] if e['name'] == 'setup_s']
    assert len(setup) == 1 and 'workloads' not in setup[0]
    for e in bench['per_layer']:
        assert e['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')


def _reports(entry, cell):
    return cell in entry.get('workloads', [cell])


def test_every_cell_reports_enough_and_moves_are_reported(bench):
    e2e = {e['name']: e for e in bench['end_to_end']}
    cells = [w['name'] for w in bench['workloads']]
    layers = {}
    for e in bench['per_layer']:
        assert e['moves'] in e2e
        for cell in cells:
            if _reports(e, cell):
                assert _reports(e2e[e['moves']], cell), (e['name'], cell)
        layers.setdefault(e['layer'].lower(), set()).add(e['layer'])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [n for n, e in e2e.items() if _reports(e, cell)]
        assert 'setup_s' in reported and len(reported) >= 2, cell
        assert any(_reports(e, cell) for e in bench['per_layer']), cell


def test_every_named_file_exists(bench):
    for w in bench['workloads']:
        assert os.path.exists(os.path.join(BENCH, 'traffic',
                                           w['traffic'] + '.json'))
        assert os.path.exists(os.path.join(BENCH, 'limits',
                                           w['name'] + '.json'))
    for e in bench['per_layer']:
        assert os.path.exists(os.path.join(BENCH, 'metrics',
                                           e['name'] + '.py'))
    for root, _, names in os.walk(BENCH):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), BENCH)
            if '__pycache__' not in rel:
                assert re.match(r'^[A-Za-z0-9_.\-/]+$', rel), rel


def test_every_cell_has_limits_set_from_readings(bench):
    import json
    for w in bench['workloads']:
        data = json.load(open(os.path.join(BENCH, 'limits',
                                           w['name'] + '.json')))
        assert data['limits']
        for name, limit in data['limits'].items():
            seen = data['set_from'][name]
            # above the lower reading, below the upper, nearer the upper
            assert seen['lower'] < limit < seen['upper'], (w['name'], name)
            assert limit - seen['lower'] > seen['upper'] - limit
