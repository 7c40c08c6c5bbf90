"""The PyTorch port's IS and FID scorers and its three scoring CLIs, held
to the JAX package's on the CPU.

Both packages' scorers run the same weights (the port's seeded random
tower, moved into the JAX layout with ``inception_to_flax``). The score
math runs on the same predictions and activations. A 2048-wide matrix
square root takes tens of seconds on one CPU thread, so where a test runs
FID over pool_3 statistics it stands a recording ``scipy.linalg.sqrtm`` in
for scipy's, the same for the port and for JAX; the FID formula itself is
held to JAX's on 64-wide statistics.
"""

import os

import numpy as np
import pytest
import scipy.linalg
import torch
from PIL import Image

import jax.numpy as jnp

from text2img_ekl_tpu.eval import fid as jfid
from text2img_ekl_tpu.eval import inception_score as jis
from text2img_ekl_tpu_torch.eval import fid as tfid
from text2img_ekl_tpu_torch.eval import inception_score as tis
from text2img_ekl_tpu_torch.io_utils.weights import (RANDOM_INCEPTION_SEED,
                                                     inception_to_flax,
                                                     random_inception)
from torch_port_threads import one_torch_thread  # noqa: F401

# probabilities |d| <= 1e-5; activations |d| <= 1e-4 max|ref| (float32
# towers, convolutions summed in another order); IS, NLPP and FID on the
# same predictions or statistics: 1e-6 relative
PROB_TOL = 1e-5
ACT_TOL = 1e-4
SCORE_RTOL = 1e-6
# the CLIs print IS and FID with 4 decimals: within half a unit of the
# last digit of the value JAX's scorer gives on the same images
PRINT_TOL = 5e-5 + 1e-6


@pytest.fixture(scope='module')
def towers():
    """{name: (port state_dict, JAX variables, classes, flavor)}: the
    random towers the trainer and the CLIs fall back to."""
    out = {}
    for name, n, flavor in (('slim', 51, 'slim'), ('fid', 1008, 'fid')):
        sd = random_inception(RANDOM_INCEPTION_SEED, n, flavor)
        out[name] = (sd, inception_to_flax(sd), n, flavor)
    return out


def _scorers(towers, name, **kw):
    sd, variables, n, flavor = towers[name]
    finetuned = name == 'slim'
    return (tis.InceptionScorer(sd, n, finetuned=finetuned, flavor=flavor,
                                device='cpu', **kw),
            jis.InceptionScorer(variables, n, finetuned=finetuned,
                                flavor=flavor, **kw))


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize('name', ['slim', 'fid'])
def test_inception_scorer_matches_jax(towers, name):
    """Generator output (NCHW here, NHWC in JAX) and uint8 images through
    both flavors' input chains: the same probabilities; queued and scored,
    the same IS."""
    port, jax_s = _scorers(towers, name, batch_size=2)
    gan = np.random.default_rng(0).uniform(
        -1, 1, (2, 128, 128, 3)).astype(np.float32)
    got = port.predict_batch(torch.from_numpy(gan).permute(0, 3, 1, 2))
    want = np.asarray(jax_s.predict_batch(jnp.asarray(gan)))
    assert got.shape == want.shape == (2, 50 if name == 'slim' else 1008)
    assert np.abs(got.numpy() - want).max() <= PROB_TOL
    u8 = _u8(1, (4, 64, 64, 3))
    got = port.predict_uint8(u8[:2]).numpy()
    assert np.abs(got - np.asarray(jax_s.predict_uint8(u8[:2]))).max() \
        <= PROB_TOL
    for s, x in ((port, torch.from_numpy(gan).permute(0, 3, 1, 2)),
                 (jax_s, jnp.asarray(gan))):
        s.add(x)
        s.add(x.flip(0) if isinstance(x, torch.Tensor) else x[::-1])
    assert port.count == jax_s.count == 4
    _same_score(port.score(), jax_s.score())
    assert port.count == 0
    _same_score(port.score_images(u8, 2), jax_s.score_images(u8, 2))


def _same_score(got, want):
    """(mean, std) of a split score: the mean within SCORE_RTOL, the std
    (over near-equal splits: float noise) within SCORE_RTOL of the mean."""
    assert got[0] == pytest.approx(want[0], rel=SCORE_RTOL)
    assert got[1] == pytest.approx(want[1], abs=SCORE_RTOL * want[0])


def test_add_keeps_rows_on_the_device_until_score(towers, monkeypatch):
    """add / add_uint8_row queue tensors and never fetch to the host (the
    host helper would raise); SPILL_AFTER rows move them all at once."""
    port, _ = _scorers(towers, 'slim')
    fetches = []

    def to_host(p):
        if isinstance(p, torch.Tensor):
            fetches.append(p.shape[0])
            return p.numpy()
        return p

    monkeypatch.setattr(tis.InceptionScorer, '_to_host',
                        staticmethod(to_host))
    monkeypatch.setattr(tis.InceptionScorer, 'SPILL_AFTER', 7)
    x = torch.rand(3, 3, 64, 64) * 2 - 1
    port.add(x)
    stack = torch.from_numpy(_u8(2, (2, 3, 64, 64, 3)))
    port.add_uint8_row(stack, 1)
    assert fetches == [] and port.count == 6
    assert all(isinstance(p, torch.Tensor) for p in port.predictions)
    port.add(x)     # 9 rows >= 7: everything spills
    assert fetches == [3, 3, 3] and port.count == 9
    assert all(isinstance(p, np.ndarray) for p in port.predictions)
    spilled = port.score(reset=False)
    monkeypatch.setattr(tis.InceptionScorer, 'SPILL_AFTER', 25000)
    again, _ = _scorers(towers, 'slim')
    again.add(x)
    again.add_uint8_row(stack, 1)
    again.add(x)
    assert again.score() == pytest.approx(spilled, rel=1e-12)


def test_fid_scorer_spills_after_its_bound(towers, monkeypatch):
    sd, _, n, flavor = towers['fid']
    fs = tfid.FIDScorer(sd, n, flavor=flavor, device='cpu')
    monkeypatch.setattr(tfid.FIDScorer, 'SPILL_AFTER', 5)
    stack = torch.from_numpy(_u8(3, (3, 2, 64, 64, 3)))
    fs.add_uint8_row(stack, 0)
    fs.add_uint8_row(stack, 1)
    assert all(isinstance(a, torch.Tensor) for a in fs._act_rows)
    fs.add_uint8_row(stack, 2)
    assert all(isinstance(a, np.ndarray) for a in fs._act_rows)
    mu, sigma = fs.accumulated_statistics()
    flat = fs.activations_uint8(stack.numpy().reshape(6, 64, 64, 3))
    np.testing.assert_allclose(mu, flat.mean(0), rtol=1e-5, atol=1e-6)
    assert fs._act_rows == []


@pytest.mark.parametrize('name', ['slim', 'fid'])
def test_fid_scorer_matches_jax(towers, name):
    """pool_3 of uint8 images through both input chains; for the frozen
    graph's flavor (the one FID runs), also of generator output and of the
    caption rows of a uint8 stack, accumulated to mu and sigma."""
    sd, variables, n, flavor = towers[name]
    port = tfid.FIDScorer(sd, n, batch_size=4, flavor=flavor, device='cpu')
    jax_s = jfid.FIDScorer(variables, n, batch_size=4, flavor=flavor)
    u8 = _u8(4, (4, 64, 64, 3))
    want = jax_s.activations_uint8(u8)
    got = port.activations_uint8(u8)
    assert got.shape == want.shape == (4, 2048)
    assert np.abs(got - want).max() <= ACT_TOL * np.abs(want).max()
    if name == 'slim':
        return
    gan = np.random.default_rng(5).uniform(
        -1, 1, (4, 96, 96, 3)).astype(np.float32)
    want = jax_s.activations_gan(gan)
    got = port.activations_gan(gan.transpose(0, 3, 1, 2))
    assert np.abs(got - want).max() <= ACT_TOL * np.abs(want).max()
    stack = _u8(6, (2, 4, 64, 64, 3))
    for si in range(2):
        port.add_uint8_row(torch.from_numpy(stack), si)
        jax_s.add_uint8_row(jnp.asarray(stack), si)
    for g, w in zip(port.accumulated_statistics(),
                    jax_s.accumulated_statistics()):
        assert np.abs(g - w).max() <= ACT_TOL * np.abs(w).max()


def test_score_math_matches_jax():
    """IS and NLPP over the same predictions, FID over the same 64-wide
    statistics (full rank, and singular enough to take the eps jitter)."""
    rng = np.random.default_rng(7)
    preds = rng.dirichlet(np.full(50, 0.3), size=120).astype(np.float32)
    for splits in (1, 3, 10):
        for fn in ('compute_inception_score',
                   'negative_log_posterior_probability'):
            assert getattr(tis, fn)(preds, splits) == pytest.approx(
                getattr(jis, fn)(preds, splits), rel=SCORE_RTOL)
    for rows in (400, 20):
        a = rng.normal(size=(rows, 64))
        b = rng.normal(0.3, 1.2, size=(rows, 64))
        sa, sb = (tfid.calculate_activation_statistics(x) for x in (a, b))
        for g, w in zip(sa, jfid.calculate_activation_statistics(a)):
            np.testing.assert_array_equal(g, w)
        got = tfid.calculate_frechet_distance(*sa, *sb)
        assert got == pytest.approx(jfid.calculate_frechet_distance(
            *sa, *sb), rel=SCORE_RTOL)
        assert tfid.calculate_frechet_distance(*sa, *sa) == pytest.approx(
            0, abs=1e-6 * np.trace(sa[1]))


def test_load_statistics_refuses_bad_files(tmp_path):
    good = tmp_path / 'good.npz'
    np.savez(good, mu=np.zeros(2048), sigma=np.eye(2048))
    mu, sigma = tfid.load_statistics(str(good))
    assert mu.shape == (2048,) and sigma.shape == (2048, 2048)
    for name, kw, match in (
            ('nosigma', dict(mu=np.zeros(2048)), 'lacks'),
            ('small', dict(mu=np.zeros(64), sigma=np.eye(64)), 'want'),
            ('nan', dict(mu=np.full(2048, np.nan), sigma=np.eye(2048)),
             'non-finite')):
        np.savez(tmp_path / name, **kw)
        with pytest.raises(ValueError, match=match):
            tfid.load_statistics(str(tmp_path / ('%s.npz' % name)))
    with pytest.raises(FileNotFoundError):
        tfid.load_statistics(str(tmp_path / 'absent.npz'))


class _RecordingSqrtm:
    """Stands in for scipy.linalg.sqrtm in the port and in JAX: records
    each product and returns a cheap, deterministic "root" of it."""

    def __init__(self):
        self.calls = []

    def __call__(self, m, disp=True):
        self.calls.append(np.array(m))
        root = (m + m.T) / 2
        return (root, 0.0) if not disp else root


@pytest.fixture
def fake_sqrtm(monkeypatch):
    rec = _RecordingSqrtm()
    monkeypatch.setattr(scipy.linalg, 'sqrtm', rec)
    return rec


def _png_dir(path, images):
    os.makedirs(path, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(path, '%02d.png' % i))
    return str(path)


def _printed(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag)][-1]
    return [float(v) for v in line[len(tag):].split(' +- ')]


def test_clis_match_jax_scorers(towers, tmp_path, capsys, fake_sqrtm):
    """The three CLIs with --device cpu on fabricated PNGs print what the
    JAX package's scorers give on the same weights and images."""
    import fid_torch
    import inception_score_torch
    import is_of_dir_torch
    a, b = _u8(8, (3, 64, 64, 3)), _u8(9, (2, 64, 64, 3))
    dir_a, dir_b = _png_dir(tmp_path / 'a', a), _png_dir(tmp_path / 'b', b)
    _, jslim = _scorers(towers, 'slim')
    _, jgeneral = _scorers(towers, 'fid')

    inception_score_torch.main(['--image_folder', dir_a, '--splits', '2',
                                '--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'random inception weights' in out and 'images: 3' in out
    assert _printed(out, 'IS: ') == pytest.approx(
        jslim.score_images(a, 2), abs=PRINT_TOL)
    inception_score_torch.main(['--image_folder', dir_b, '--general',
                                '--pb', '', '--splits', '1', '--device',
                                'cpu'])
    assert _printed(capsys.readouterr().out, 'IS: ') == pytest.approx(
        jgeneral.score_images(b, 1), abs=PRINT_TOL)

    _, jvars, n, _ = towers['fid']
    jfs = jfid.FIDScorer(jvars, n, flavor='fid')
    stats = str(tmp_path / 'b.npz')
    fid_torch.main([dir_b, 'unused', '--save_stats', stats, '--pb', '',
                    '--device', 'cpu'])
    assert 'RANDOM' in capsys.readouterr().out
    with np.load(stats) as f:
        mu_b, sigma_b = f['mu'], f['sigma']
    want_b = jfs.statistics(b)
    assert np.abs(mu_b - want_b[0]).max() <= ACT_TOL * np.abs(
        want_b[0]).max()
    fid_torch.main([dir_a, stats, '--pb', '', '--device', 'cpu'])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('FID: ')][-1]
    want = jfid.calculate_frechet_distance(*jfs.statistics(a), *want_b)
    assert float(line[5:]) == pytest.approx(want, rel=1e-4)

    is_of_dir_torch.main(['--dir', dir_a, '--fid_stats', stats, '--pb', '',
                          '--splits', '1', '--device', 'cpu'])
    out = capsys.readouterr().out
    assert _printed(out, 'IS: ') == pytest.approx(
        jslim.score_images(a, 1), abs=PRINT_TOL)
    assert _printed(out, 'FID: ')[0] == pytest.approx(want, abs=5e-5,
                                                      rel=1e-4)
    with pytest.raises(SystemExit):
        is_of_dir_torch.main(['--dir', dir_a, '--general',
                              '--checkpoint_dir', 'x'])
