"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the port: top-level module names are
compared whole (the port's name begins with the JAX package's)."""

import ast
import json
import os
import subprocess
import sys

from bench_small import BENCH, ROOT  # noqa: I100 (first)

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'text2img_ekl_tpu'}
PORT = 'text2img_ekl_tpu_torch'


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _sources():
    for root, _, names in os.walk(BENCH):
        for n in names:
            if n.endswith('.py'):
                yield os.path.join(root, n)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        found = set(_imports(path)) & FORBIDDEN
        assert not found, (path, found)


def test_the_reference_and_the_yardstick_import_nothing_of_the_port():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    refs = {json.load(open(os.path.join(ROOT, c['file'])))['reference']
            for c in bench['configs']}
    yardstick = [os.path.join(BENCH, 'configs', r + '.py') for r in refs]
    yardstick += [os.path.join(BENCH, n) for n in
                  ('compare.py', 'work.py', 'inputs.py', 'devtrace.py')]
    for path in yardstick:
        assert PORT not in set(_imports(path)), path
    # and no other file than program.py names the port
    for path in _sources():
        if os.path.basename(path) != 'program.py':
            assert PORT not in set(_imports(path)), path


def test_a_run_loads_none_of_them():
    """A small cell run end to end in a fresh interpreter: afterwards its
    sys.modules holds none of the forbidden top-level names."""
    code = (
        'import sys\n'
        'sys.path.insert(0, %r)\n'
        'from bench_small import small_cell, run_small\n'
        'import run\n'
        'out, _ = run_small(small_cell("cub-splitz-cap-ca.sample-320"), 0.2)\n'
        'print(sorted(run.forbidden_modules()), out["attempted"] > 0)\n'
        % os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH='')
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == '[] True'
