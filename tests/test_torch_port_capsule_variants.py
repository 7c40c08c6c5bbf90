"""The batch-blocked capsule-routing variants (V) of the PyTorch port
against the JAX package's, on the CPU, and the port's capsule
microbenchmark.

The JAX variants (``tools/capsule_variants.py``) are Pallas kernels for the
TPU. Here they run in Pallas interpret mode: the file is loaded by path and
its module-level ``pl`` is replaced by a shim whose ``pallas_call`` adds
``interpret=True`` and drops ``compiler_params`` (a TPU VMEM limit, which
only ``vmem_mb`` sets); neither file is edited. Each JAX variant is first
held to the JAX package's plain routing, to show that the interpreted
kernel computes routing, then the port's wrapper (on CPU tensors: the plain
routing over the padded batch) is held to the JAX variant.

Inputs come from a numpy seed: x ~ N(0, 1) and weights ~ N(0, 1 /
in_length), so that the votes are unit-scale at every in_length and the
routing is neither uniform nor saturated (outputs reach ~0.6). Tolerance
|d| <= 1e-5 |ref| + 1e-6 max|ref|, as the K1 parity test
(tests/test_torch_port_capsule.py): both sides compute in float32 on the
CPU, and the Pallas kernels sum in other orders (block-ones products).
With votes sqrt(8) times larger (weights ~ N(0, 8 / in_length)) the
routing is steeper, and at in_length 16 two float32 orders of the plain
routing itself, JAX's and the port's, already differ by up to 0.8 of this
bar.
"""

import importlib.util
import inspect
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from text2img_ekl_tpu.ops import capsule as jcap
from text2img_ekl_tpu_torch.ops import capsule_variants as cv
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, 'tools', 'bench_capsule_torch.py')

# (x shape, W shape): in_length 8 (the generator head's, narrow) and 16;
# both batches are ragged for every NB below but 3 at the first shape
SHAPES = {'L8': ((5, 6, 8), (16, 16, 8)), 'L16': ((3, 4, 16), (12, 32, 16))}
# two NB values per variant
NBS = {'forward_stored': (2, 4), 'forward_seq': (2, 4),
       'forward_recompute': (3, 8)}


@pytest.fixture(scope='module')
def jax_variants():
    """tools/capsule_variants.py with its Pallas calls interpreted."""
    spec = importlib.util.spec_from_file_location(
        'capsule_variants_interpret',
        os.path.join(REPO, 'tools', 'capsule_variants.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def pallas_call(*args, **kwargs):
        kwargs.pop('compiler_params', None)
        return pl.pallas_call(*args, interpret=True, **kwargs)

    shim = types.SimpleNamespace(**{n: getattr(pl, n) for n in dir(pl)
                                    if not n.startswith('_')})
    shim.pallas_call = pallas_call
    mod.pl = shim
    return mod


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(0)
    out = {}
    for key, (sx, sw) in SHAPES.items():
        x = rng.standard_normal(sx, dtype=np.float32)
        w = rng.standard_normal(sw, dtype=np.float32) \
            / np.float32(np.sqrt(sx[2]))
        ref = np.asarray(jcap.dynamic_routing(
            jcap.compute_votes(jnp.asarray(x), jnp.asarray(w)), 3))
        out[key] = (x, w, ref)
    return out


def assert_close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('shape', sorted(SHAPES))
@pytest.mark.parametrize('name,nb', [(n, nb) for n, nbs in NBS.items()
                                     for nb in nbs])
def test_variant_matches_jax(jax_variants, inputs, shape, name, nb):
    x, w, ref = inputs[shape]
    want = np.asarray(getattr(jax_variants, name)(
        jnp.asarray(x), jnp.asarray(w), 3, nb=nb))
    assert want.shape == ref.shape
    assert_close(want, ref)
    wrapper = getattr(cv, name)
    before = wrapper.launches
    with torch.no_grad():
        got = wrapper(torch.from_numpy(x), torch.from_numpy(w), 3, nb=nb)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert wrapper.launches == before  # the CPU takes the plain routing
    assert_close(got, want)


def test_signatures_match_jax(jax_variants):
    """Same names, defaults and order; the TPU's vmem_mb is not taken."""
    for name in NBS:
        want = inspect.signature(getattr(jax_variants, name)).parameters
        got = inspect.signature(getattr(cv, name)).parameters
        assert list(got) == [p for p in want if p != 'vmem_mb']
        assert [p.default for p in got.values()] == \
            [want[p].default for p in got]


def test_variants_refuse_what_they_do_not_take():
    x = torch.zeros((2, 3, 8))
    w = torch.zeros((4, 16, 8))
    for name in NBS:
        fn = getattr(cv, name)
        with pytest.raises(RuntimeError, match='no backward'):
            fn(x.clone().requires_grad_(True), w)
        with pytest.raises(RuntimeError, match='no backward'):
            fn(x, w.clone().requires_grad_(True))
        with pytest.raises(ValueError, match='nb >= 1'):
            fn(x, w, nb=0)
        with torch.no_grad():  # no gradient needed: the plain routing
            assert fn(x.clone().requires_grad_(True), w).shape == (2, 4, 16)


def _bench(*args):
    env = {k: v for k, v in os.environ.items() if k != 'T2I_JAX_CACHE'}
    env['OMP_NUM_THREADS'] = '1'
    return subprocess.run([sys.executable, BENCH, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_variants_runs_on_the_cpu():
    proc = _bench('--device', 'cpu', '--variants', '--batch', '5',
                  '--shape', '6,8,16,16')
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith('card: cpu (host clock)')
    for name, nbs in (('V-stored', (8, 1)), ('V-seq', (2, 4, 1)),
                      ('V-recompute', (8, 16, 32, 1))):
        for nb in nbs:
            tag = '%s NB=%d B=5 6,8,16,16' % (name, nb)
            assert any(line.startswith(tag + ': max|ref|')
                       and line.endswith(': ok') for line in lines), tag
            assert any(line.startswith(tag + ': ') and 'in turns' in line
                       for line in lines), tag


def test_bench_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    proc = _bench('--variants', '--batch', '2', '--shape', '4,8,8,16')
    assert proc.returncode != 0
    assert 'no CUDA device' in proc.stderr
    assert 'ms' not in proc.stdout
