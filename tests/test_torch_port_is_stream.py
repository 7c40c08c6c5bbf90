"""The PyTorch port's in-training IS stream, its gated save, BIG_EVAL and
direct on-device evaluation, on the CPU at GF/DF_DIM 8, batch 4 (F9), as
tests/test_is_gate.py and tests/test_eval_direct.py check the JAX
package's.

A stub scorer patched over ``CondGANTrainer._make_is_scorer`` stands for
the tower where a test is about the trainer's wiring: the protected save
with real weights and none with random ones, the stream's cadence (which
step's fakes ``add`` receives), and BIG_EVAL. The real (random-weight)
tower runs an unbounded run that the trainer used to refuse, an epoch-end
score, and direct evaluation against the PNG route.
"""

import copy
import glob
import json
import os

import numpy as np
import pytest
import scipy.linalg
import torch

from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.data import DataLoader, SyntheticTextDataset
from text2img_ekl_tpu_torch.eval import inception_score as tis
from text2img_ekl_tpu_torch.io_utils.weights import (RANDOM_INCEPTION_SEED,
                                                     random_inception)
from text2img_ekl_tpu_torch.train import trainer as trainer_mod
from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
EVAL_CFG = os.path.join(REPO, 'cfg',
                        'birds_2stg_splitz_cap_ca_eval.realcls.yml')
B = 4
# direct IS against the PNG directory's, the same float32 tower on the
# same uint8 images: 1e-6 relative
SCORE_RTOL = 1e-6


class _StubScorer:
    """Records what it is given; scores ``value``."""

    def __init__(self, real_weights, count=0, value=9.9):
        self.real_weights = real_weights
        self._count = count
        self.value = value
        self.added = []

    def add(self, fakes):
        self.added.append(fakes)
        self._count += fakes.shape[0]

    @property
    def count(self):
        return self._count

    def score(self, num_splits=1):
        return self.value, 0.1


def _cfg(**kw):
    cfg = cfg_from_file(TRAIN_CFG)
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TRAIN.MAX_EPOCH = 1
    cfg.TRAIN.SNAPSHOT_INTERVAL = 100   # no interval snapshot: gate only
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _trainer(cfg, out, batches=2):
    ds = SyntheticTextDataset(num_items=B * batches, base_size=64,
                              branch_num=2, entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=True,
                              uint8_output=True)
    return CondGANTrainer(cfg, str(out), device='cpu', data_loader=DataLoader(
        ds, B, shuffle=False, num_workers=1))


def _metrics(trainer):
    with open(os.path.join(trainer.log_dir, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize('real_weights', [False, True])
def test_is_gate_protect_save_requires_real_weights(tmp_path, monkeypatch,
                                                    capsys, real_weights):
    """3,000 pooled fakes and a score above every threshold: a protected
    snapshot with real Inception weights, none with random ones; the score
    is printed and logged either way."""
    stub = _StubScorer(real_weights, count=3000)
    monkeypatch.setattr(CondGANTrainer, '_make_is_scorer',
                        lambda self, dtype=None: stub)
    trainer = _trainer(_cfg(TPU_IS_EVERY=1000000), tmp_path)
    state = trainer.train(max_steps=2)
    assert state.step == 2 and stub.added == []
    out = capsys.readouterr().out
    assert 'Epoch0 IS: 9.900 +- 0.100' in out
    model = os.listdir(trainer.model_dir)
    if real_weights:
        assert 'Saved good model' in out
        assert sorted(model) == ['.protect_epoch0', 'state_epoch0']
    else:
        assert 'Saved good model' not in out
        assert 'weights are random' in out and model == []
    assert [m['inception_score'] for m in _metrics(trainer)] == [9.9]


def test_stream_adds_every_nth_steps_own_fakes(tmp_path, monkeypatch):
    """TPU_IS_EVERY 2 over two epochs of 3 batches: the fakes the step
    returned at the 2nd step of each epoch (the count restarts at an
    epoch), untouched; none with TPU_IS_EVERY 0, where no tower is
    built."""
    stub = _StubScorer(False)
    monkeypatch.setattr(CondGANTrainer, '_make_is_scorer',
                        lambda self, dtype=None: stub)
    returned = []
    real = trainer_mod.make_train_step

    def recording(cfg):
        step = real(cfg)

        def fn(*a):
            metrics, fakes = step(*a)
            returned.append(fakes)
            return metrics, fakes
        return fn

    monkeypatch.setattr(trainer_mod, 'make_train_step', recording)
    cfg = _cfg(TPU_IS_EVERY=2)
    cfg.TRAIN.MAX_EPOCH = 2
    _trainer(cfg, tmp_path / 'every2', batches=3).train()
    assert len(returned) == 6
    assert [next(i for i, r in enumerate(returned) if r is a)
            for a in stub.added] == [1, 4]
    assert stub.added[0].shape == (B, 3, 128, 128)

    def refuse(self, dtype=None):
        raise AssertionError('no tower where TPU_IS_EVERY is 0')

    monkeypatch.setattr(CondGANTrainer, '_make_is_scorer', refuse)
    _trainer(_cfg(TPU_IS_EVERY=0), tmp_path / 'off').train(max_steps=2)


def test_big_eval_scores_fresh_samples_and_gates_at_5_4(tmp_path,
                                                        monkeypatch, capsys):
    """BIG_EVAL builds no stream scorer; after the epoch it samples fresh
    top-stage fakes over the loader until more than BIG_EVAL_IMAGES are
    pooled, and saves a protected snapshot above 5.4 with real weights."""
    made = []

    def make(self, dtype=torch.bfloat16):
        made.append(_StubScorer(True, value=5.5))
        return made[-1]

    monkeypatch.setattr(CondGANTrainer, '_make_is_scorer', make)
    monkeypatch.setattr(trainer_mod, 'BIG_EVAL_IMAGES', 5)
    cfg = _cfg()
    cfg.TRAIN.BIG_EVAL = True
    trainer = _trainer(cfg, tmp_path, batches=3)
    trainer.train(max_steps=1)
    out = capsys.readouterr().out
    assert len(made) == 1   # the BIG_EVAL scorer; no stream
    assert [a.shape for a in made[0].added] == [(B, 3, 128, 128)] * 2
    assert 'Epoch0 IS: 5.500' in out and 'Saved good model' in out
    assert '.protect_epoch0' in os.listdir(trainer.model_dir)


def test_train_runs_what_it_used_to_refuse(tmp_path, capsys, monkeypatch):
    """No max_steps, TPU_IS_EVERY 2 and a loader that claims enough
    batches to pool 3,000 fakes: train() runs (the trainer refused this
    before the tower was ported) with the real, random-weight bf16 tower,
    and scores at the end of an epoch once the pool is large enough (here
    8 fakes)."""
    monkeypatch.setattr(trainer_mod, 'IS_MIN_IMAGES', 8)
    cfg = _cfg(TPU_IS_EVERY=1)
    cfg.TRAIN.MAX_EPOCH = 2
    trainer = _trainer(cfg, tmp_path)
    trainer.num_batches = 10000
    state = trainer.train()
    assert state.step == 4
    out = capsys.readouterr().out
    assert 'Inception weights are random' in out
    assert out.count('IS: ') == 2 and 'Saved good model' not in out
    scores = [m['inception_score'] for m in _metrics(trainer)]
    assert len(scores) == 2 and all(np.isfinite(s) and s >= 1
                                    for s in scores)
    assert os.listdir(trainer.model_dir) == []


def test_make_is_scorer_falls_back_to_the_seeded_random_tower(
        tmp_path, monkeypatch):
    """Without T2I_INCEPTION_CKPT: the random 51-class slim tower of
    RANDOM_INCEPTION_SEED, bf16 for the gate, float32 offline, flagged
    as not real; GENERAL_IS takes the torch flavor with 1,000 classes."""
    monkeypatch.delenv('T2I_INCEPTION_CKPT', raising=False)
    trainer = _trainer(_cfg(), tmp_path)
    gate = trainer._make_is_scorer()
    assert gate.real_weights is False
    assert gate.model.conv0.conv.weight.dtype == torch.bfloat16
    offline = trainer._make_is_scorer(dtype=None)
    want = random_inception(RANDOM_INCEPTION_SEED, 51, 'slim')
    for k, v in offline.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert offline.finetuned
    trainer.cfg.TRAIN.GENERAL_IS = True
    general = trainer._make_is_scorer(dtype=None)
    assert not general.finetuned
    assert general.model.logits.out_features == 1000
    assert general.model.mixed_35x35x256a.torch_pool


# --------------------------------------------------------------------------
# direct on-device evaluation (TPU_EVAL_DIRECT)

class _RecordingSqrtm:
    """Stands in for scipy.linalg.sqrtm (a 2048-wide root takes tens of
    seconds on one CPU thread): records each product, returns a cheap
    deterministic "root"; eval/test_torch_port_eval.py holds the FID
    formula to JAX's."""

    def __init__(self):
        self.calls = []

    def __call__(self, m, disp=True):
        self.calls.append(np.array(m))
        root = (m + m.T) / 2
        return (root, 0.0) if not disp else root


def _eval_cfg(tmp_path, direct, fid_stats=''):
    from text2img_ekl_tpu_torch.models.generator import build_generator
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 2
    net_g = tmp_path / 'run7' / 'Model' / 'netG_epoch_12.pth'
    if not net_g.exists():
        torch.manual_seed(0)
        net_g.parent.mkdir(parents=True)
        torch.save(build_generator(cfg, train_flag=False).state_dict(),
                   net_g)
    cfg.TRAIN.NET_G = str(net_g)
    cfg.TPU_EVAL_DIRECT = direct
    cfg.TPU_EVAL_FID_STATS = fid_stats
    return cfg


def _eval_trainer(cfg, out):
    ds = SyntheticTextDataset(num_items=4, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=False)
    return CondGANTrainer(cfg, str(out), device='cpu', data_loader=DataLoader(
        ds, 2, shuffle=False, drop_last=True, num_workers=1))


def test_direct_eval_matches_the_png_route(tmp_path, capsys, monkeypatch):
    """evaluate with TPU_EVAL_DIRECT scores the sampler's uint8 stacks in
    place: no PNG, direct_scores.json with the IS that the PNG route's
    directory gives on the same tower (10 splits from 100 images, here 1),
    and the FID statistics of the same images as fid_torch --save_stats of
    that directory."""
    import fid_torch
    from inception_score_torch import load_images
    fake_sqrtm = _RecordingSqrtm()
    monkeypatch.setattr(scipy.linalg, 'sqrtm', fake_sqrtm)
    png_dir = _eval_trainer(_eval_cfg(tmp_path, False), tmp_path / 'png') \
        .evaluate(max_batches=1)
    pngs = glob.glob(os.path.join(png_dir, '**', '*.png'), recursive=True)
    assert len(pngs) == 2 * 10
    stats = str(tmp_path / 'png.npz')
    fid_torch.main([png_dir, 'unused', '--save_stats', stats, '--pb', '',
                    '--device', 'cpu'])
    sd = random_inception(RANDOM_INCEPTION_SEED, 51)
    png_is = tis.InceptionScorer(sd, 51, device='cpu').score_images(
        np.stack(load_images(png_dir)), 1)
    capsys.readouterr()

    direct = _eval_trainer(_eval_cfg(tmp_path, True, stats),
                           tmp_path / 'direct')
    save_dir = direct.evaluate(max_batches=1)
    out = capsys.readouterr().out
    assert 'Direct eval (no PNG round trip): IS' in out and ' FID ' in out
    assert not glob.glob(os.path.join(save_dir, '**', '*.png'),
                         recursive=True)
    with open(os.path.join(save_dir, 'direct_scores.json')) as f:
        scores = json.load(f)
    assert set(scores) == {'images', 'is_mean', 'is_std', 'is_splits',
                           'real_is_weights', 'fid'}
    assert scores['images'] == len(pngs) and scores['is_splits'] == 1
    assert scores['real_is_weights'] is False
    assert scores['is_mean'] == pytest.approx(png_is[0], rel=SCORE_RTOL)
    # the direct path's sigma times the PNG directory's: the same matrix
    # squared, within float32 order
    prod = fake_sqrtm.calls[-1]
    with np.load(stats) as f:
        sigma = f['sigma']
    assert np.abs(prod - sigma @ sigma).max() <= 1e-4 * np.abs(
        sigma @ sigma).max()

    empty = _eval_trainer(_eval_cfg(tmp_path, True), tmp_path / 'empty')
    with open(os.path.join(empty.evaluate(max_batches=0),
                           'direct_scores.json')) as f:
        assert json.load(f) == {'images': 0}


def test_direct_eval_refuses_bad_fid_stats_before_sampling(tmp_path,
                                                           monkeypatch):
    """A TPU_EVAL_FID_STATS file that is missing, or holds no sigma, or
    the wrong width, raises before the first sampler call."""
    calls = []
    monkeypatch.setattr(trainer_mod, 'caption_sample',
                        lambda *a, **k: calls.append(1))
    np.savez(tmp_path / 'mu_only.npz', mu=np.zeros(2048))
    np.savez(tmp_path / 'narrow.npz', mu=np.zeros(8), sigma=np.eye(8))
    for stats, err in ((tmp_path / 'absent.npz', FileNotFoundError),
                       (tmp_path / 'mu_only.npz', ValueError),
                       (tmp_path / 'narrow.npz', ValueError)):
        cfg = _eval_cfg(tmp_path, True, str(stats))
        with pytest.raises(err):
            _eval_trainer(copy.deepcopy(cfg), tmp_path / 'out').evaluate(
                max_batches=1)
    assert calls == []
