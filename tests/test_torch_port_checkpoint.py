"""Checkpoints, resume and metrics logging of the PyTorch port on the CPU,
held to the JAX package where that is cheap.

The port's ``CheckpointManager``, ``parse_epoch_from_path`` and EMA-slot
rules against the JAX package's on the same tables (JAX's side saves tiny
trees through orbax); a save killed before its rename; the refusals of a
mismatched architecture and of an orbax directory; and the trainer at
GF/DF_DIM 8, batch 4: a SIGTERM mid-epoch, auto-resume, NET_G / NET_D
resume, the metrics stream, and ``evaluate`` from a checkpoint directory.
"""

import json
import os
import signal
import sys
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2img_ekl_tpu.io_utils import checkpoint as jckpt
from text2img_ekl_tpu.train import state as jstate
from text2img_ekl_tpu_torch.config import cfg_from_file
from text2img_ekl_tpu_torch.data import DataLoader, SyntheticTextDataset
from text2img_ekl_tpu_torch.io_utils import checkpoint as ckpt
from text2img_ekl_tpu_torch.train import state as tstate
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = os.path.join(REPO, 'cfg', 'birds_2stg_splitz_cap_ca.realcls.yml')
EVAL_CFG = os.path.join(REPO, 'cfg',
                        'birds_2stg_splitz_cap_ca_eval.realcls.yml')
B = 4


def small_cfg(df_dim=8, ema_decay=0.0):
    cfg = cfg_from_file(TRAIN_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.GAN.DF_DIM = df_dim
    cfg.TRAIN.BATCH_SIZE = B
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    cfg.TPU_EMA_DECAY = ema_decay
    return cfg


@pytest.fixture(scope='module')
def port_state():
    return tstate.create_train_state(small_cfg(), 'cpu', seed=0)


@pytest.mark.parametrize('path', [
    'Model/state_epoch7', 'Model/netG_123.pth', 'out/Model/state_epoch12/',
    'netG_epoch_600.pth', 'Model/netG.pth', 'state_epoch', 'state_epoch0'])
def test_parse_epoch_from_path_matches_jax(path):
    assert ckpt.parse_epoch_from_path(path) == \
        jckpt.parse_epoch_from_path(path)


# (epoch, protect) saves: a protected epoch stays whatever ``keep`` says,
# and epoch 3 is saved twice (the second save replaces the first)
SAVES = ((0, False), (1, True), (2, False), (3, False), (3, False),
         (4, True), (5, False), (6, False))


@pytest.mark.parametrize('keep', [0, 2])
def test_manager_keeps_what_jax_keeps(tmp_path, port_state, keep):
    tree = {'w': np.arange(3, dtype=np.float32)}
    jm = jckpt.CheckpointManager(str(tmp_path / 'jax'), keep=keep)
    pm = ckpt.CheckpointManager(str(tmp_path / 'port'), keep=keep)
    for epoch, protect in SAVES:
        jm.save(tree, epoch, protect=protect)
        pm.save(port_state, epoch, protect=protect)
        assert sorted(os.listdir(pm.model_dir)) == \
            sorted(os.listdir(jm.model_dir))
        assert os.path.basename(pm.latest()) == \
            os.path.basename(jm.latest())
    kept = sorted(n for n in os.listdir(pm.model_dir)
                  if n.startswith('state_epoch'))
    assert kept == (['state_epoch%d' % e for e in range(7)] if keep == 0
                    else ['state_epoch1', 'state_epoch4', 'state_epoch5',
                          'state_epoch6'])


def _jax_state(ema):
    def tree(v, n):
        return {'w': jnp.full((n,), v, jnp.float32)}
    return jstate.TrainState(
        step=jnp.asarray(6, jnp.int32), g_params=tree(2.0, 3),
        g_batch_stats=tree(0.5, 3), g_opt_state=tree(0.1, 3),
        d_params=(tree(1.0, 2),), d_batch_stats=(tree(0.0, 2),),
        d_opt_states=(tree(0.2, 2),), g_ema_params=ema)


def _jax_ema_outcome(tmp_path, in_ckpt, decay):
    path = str(tmp_path / ('jax_%d' % in_ckpt))
    if not os.path.exists(path):
        jckpt.save_train_state(path, _jax_state(
            {'w': jnp.full((3,), 5.0)} if in_ckpt else None))
    target = _jax_state(None).replace(g_params={'w': jnp.zeros(3)})
    if decay > 0:  # create_train_state's slot: a copy of the fresh init
        target = target.replace(g_ema_params={'w': jnp.zeros(3)})
    out = jstate.resolve_restored_ema(
        jckpt.restore_train_state(path, target), decay)
    if out.g_ema_params is None:
        return None
    ema = np.asarray(out.g_ema_params['w'])
    return {5.0: 'averages', 2.0: 'restored weights'}[float(ema[0])]


def _port_ema_outcome(tmp_path, port_state, in_ckpt, decay):
    path = str(tmp_path / ('port_%d' % in_ckpt))
    port_state.g_ema = ({n: p.detach() + 1.0
                         for n, p in port_state.G.named_parameters()}
                        if in_ckpt else None)
    ckpt.save_train_state(path, port_state)
    port_state.g_ema = None
    target = tstate.create_train_state(small_cfg(ema_decay=decay), 'cpu',
                                       seed=1)
    assert (target.g_ema is not None) == (decay > 0)
    out = tstate.resolve_restored_ema(ckpt.restore_train_state(path, target),
                                      decay)
    if out.g_ema is None:
        return None
    params = dict(port_state.G.named_parameters())
    if all(torch.equal(out.g_ema[n], p + 1.0) for n, p in params.items()):
        return 'averages'
    assert all(torch.equal(out.g_ema[n], p) for n, p in params.items())
    return 'restored weights'


@pytest.mark.parametrize('in_ckpt,decay', [(True, 0.0), (True, 0.999),
                                           (False, 0.0), (False, 0.999)])
def test_ema_rules_match_jax(tmp_path, port_state, in_ckpt, decay):
    want = {(True, 0.0): None, (True, 0.999): 'averages',
            (False, 0.0): None, (False, 0.999): 'restored weights'}
    got = _port_ema_outcome(tmp_path, port_state, in_ckpt, decay)
    assert got == _jax_ema_outcome(tmp_path, in_ckpt, decay) == \
        want[(in_ckpt, decay)]


def test_killed_save_is_not_taken(tmp_path, port_state, monkeypatch):
    """A save that dies before its rename leaves only its temporary name,
    which latest() and pruning ignore and the next manager deletes; the
    next save to that epoch succeeds."""
    m = ckpt.CheckpointManager(str(tmp_path), keep=1)
    m.save(port_state, 0)

    def dies(obj, f):
        f.write(b'PK\x03\x04 half a file')
        raise KeyboardInterrupt

    monkeypatch.setattr(ckpt.torch, 'save', dies)
    with pytest.raises(KeyboardInterrupt):
        m.save(port_state, 1)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == [
        'state_epoch0', 'state_epoch1.tmp-%d' % os.getpid()]
    assert m.latest() == m.path(0)
    restored = m.restore(tstate.create_train_state(small_cfg(), 'cpu',
                                                   seed=1))
    assert restored.step == port_state.step
    m = ckpt.CheckpointManager(str(tmp_path), keep=1)
    assert os.listdir(tmp_path) == ['state_epoch0']
    m.save(port_state, 1)
    assert sorted(os.listdir(tmp_path)) == ['state_epoch1']


@pytest.mark.parametrize('replaced', [True, False])
def test_killed_replacement_keeps_the_epoch(tmp_path, port_state, replaced):
    """A save to an existing epoch that dies after moving the old snapshot
    aside: the next manager puts it back where the new one never arrived,
    and deletes it where the new one did."""
    m = ckpt.CheckpointManager(str(tmp_path))
    port_state.step = 5
    try:
        m.save(port_state, 0)
    finally:
        port_state.step = 0
    aside = m.path(0) + '.old-1'
    os.rename(m.path(0), aside)
    if replaced:
        m.save(port_state, 0)
    m = ckpt.CheckpointManager(str(tmp_path))
    assert os.listdir(tmp_path) == ['state_epoch0']
    restored = m.restore(tstate.create_train_state(small_cfg(), 'cpu',
                                                   seed=1))
    assert restored.step == (0 if replaced else 5)


def test_mismatch_and_orbax_directories_raise(tmp_path, port_state):
    path = str(tmp_path / 'state_epoch0')
    ckpt.save_train_state(path, port_state)
    wide = tstate.create_train_state(small_cfg(df_dim=16), 'cpu', seed=0)
    with pytest.raises(ValueError, match=r'D0 tensor .* has shape \(8, '
                       r'3, 4, 4\) but this config expects \(16, 3, 4, 4\)'):
        ckpt.restore_train_state(path, wide)
    orbax_dir = str(tmp_path / 'jax_state_epoch0')
    jckpt.save_train_state(orbax_dir, _jax_state(None))
    with pytest.raises(NotImplementedError, match='orbax.*F7'):
        ckpt.restore_train_state(orbax_dir, port_state)
    with pytest.raises(NotImplementedError, match='orbax.*F7'):
        ckpt.restore_generator_state(orbax_dir, port_state.G)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_train_state(str(tmp_path / 'nothing'), port_state)


def _loader(cfg, items=2 * B):
    ds = SyntheticTextDataset(num_items=items, base_size=64, branch_num=2,
                              entity_dim=cfg.GAN.ENTITY_DIM,
                              text_dim=cfg.TEXT.DIMENSION, train_pairs=True,
                              uint8_output=True)
    return DataLoader(ds, B, shuffle=True, num_workers=1)


class _SignalAt:
    """The loader's batches; SIGTERM is raised just before batch ``at``
    (counted over epochs) is handed out."""

    def __init__(self, loader, at):
        self.loader, self.at, self.n = loader, at, 0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            if self.n == self.at:
                signal.raise_signal(signal.SIGTERM)
            self.n += 1
            yield batch


def test_sigterm_mid_epoch_saves_and_resumes_that_epoch(tmp_path, capsys):
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    assert threading.current_thread() is threading.main_thread()
    cfg = small_cfg()
    before = signal.getsignal(signal.SIGTERM)
    trainer = CondGANTrainer(cfg, str(tmp_path),
                             data_loader=_SignalAt(_loader(cfg), 2),
                             device='cpu')
    state = trainer.train(max_steps=10)
    assert state.step == 3      # epoch 0, then one step of epoch 1
    assert signal.getsignal(signal.SIGTERM) is before
    assert 'checkpointed on signal' in capsys.readouterr().out
    assert os.listdir(trainer.model_dir) == ['state_epoch1']
    saved = dict(state.G.state_dict())

    again = CondGANTrainer(cfg, str(tmp_path), data_loader=_loader(cfg),
                           device='cpu')
    restored = {}

    def fake_step(cfg_):
        def step(st, batch, seed):
            if not restored:
                restored.update(st.G.state_dict(), step=st.step, seed=seed)
            st.step += 1
            # the step's top-stage fakes, which the IS stream takes
            return {}, torch.zeros(B, 3, 128, 128)
        return step

    import text2img_ekl_tpu_torch.train.trainer as trainer_mod
    real = trainer_mod.make_train_step
    trainer_mod.make_train_step = fake_step
    try:
        state = again.train(max_steps=2)
    finally:
        trainer_mod.make_train_step = real
    out = capsys.readouterr().out
    assert 'Resumed from %s (epoch 1)' % again.ckpt.path(1) in out
    assert '[1/300][BN=2]' in out and '[0/300]' not in out
    assert restored.pop('step') == 3
    assert restored.pop('seed') == trainer_mod._seed(
        trainer_mod.STEP_SEED_STREAM, 3)
    assert all(torch.equal(restored[k], v) for k, v in saved.items())
    assert state.step == 5


class _Writer:
    """A stand-in for tensorboardX's SummaryWriter that records its
    calls."""
    made = []

    def __init__(self, log_dir):
        self.scalars, self.closed = [], False
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def close(self):
        self.closed = True


def test_metrics_stream_records_the_epoch_keys(tmp_path, monkeypatch):
    """The JSONL record at the logging step, mirrored to TensorBoard, whose
    writer train() closes."""
    from text2img_ekl_tpu_torch.train import trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, 'LOG_EVERY', 2)
    monkeypatch.setitem(sys.modules, 'tensorboardX',
                        types.SimpleNamespace(SummaryWriter=_Writer))
    _Writer.made.clear()
    cfg = small_cfg()
    trainer = trainer_mod.CondGANTrainer(cfg, str(tmp_path),
                                         data_loader=_loader(cfg),
                                         device='cpu')
    trainer.train(max_steps=3)
    assert sorted(os.listdir(tmp_path)) == ['Image', 'Log', 'Model']
    with open(os.path.join(trainer.log_dir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['step'] for r in recs] == [2]
    rec = recs[0]
    assert list(rec)[:2] == ['step', 'time']
    # step 2 ends epoch 0, whose line prints these metrics
    assert set(rec) - {'step', 'time'} == set(trainer.last_metrics) and \
        len(trainer.last_metrics) == 14
    [writer] = _Writer.made
    assert sorted(writer.scalars) == sorted((k, 2) for k in
                                            trainer.last_metrics)
    assert writer.closed and trainer.logger.tb is None


def test_net_g_and_net_d_resume(tmp_path, port_state, monkeypatch, capsys):
    """NET_G .pth loads G (the EMA re-seeded from it), NET_D each D, and
    training resumes at the epoch after the file's; NET_G naming a
    checkpoint directory restores the full state."""
    from text2img_ekl_tpu_torch.train import trainer as trainer_mod
    seen = []

    def fake_step(cfg_):
        def step(st, batch, seed):
            if len(seen) < 1 or seen[-1][0] is not st:
                seen.append((st, {k: v.clone() for k, v in
                                  tstate.train_state_dict(st)['G'].items()},
                                 [dict(D.state_dict()) for D in st.Ds],
                                 st.step, st.g_ema))
            st.step += 1
            # the step's top-stage fakes, which the IS stream takes
            return {}, torch.zeros(B, 3, 128, 128)
        return step

    monkeypatch.setattr(trainer_mod, 'make_train_step', fake_step)
    model = tmp_path / 'ref' / 'Model'
    model.mkdir(parents=True)
    torch.save(port_state.G.state_dict(), model / 'netG_epoch_4.pth')
    for i, D in enumerate(port_state.Ds):
        torch.save(D.state_dict(), model / ('netD%d.pth' % i))
    cfg = small_cfg(ema_decay=0.5)
    cfg.TRAIN.NET_G = str(model / 'netG_epoch_4.pth')
    cfg.TRAIN.NET_D = str(model / 'netD')
    trainer = trainer_mod.CondGANTrainer(cfg, str(tmp_path / 'a'),
                                         data_loader=_loader(cfg),
                                         device='cpu')
    trainer.train(max_steps=1)
    out = capsys.readouterr().out
    assert '(resuming at epoch 5)' in out and '[5/300]' in out
    assert out.count('Load D from') == 2
    _, g, ds, step, ema = seen[-1]
    assert step == 0
    for k, v in port_state.G.state_dict().items():
        assert torch.equal(g[k], v)
    for got, D in zip(ds, port_state.Ds):
        assert all(torch.equal(got[k], v) for k, v in D.state_dict().items())
    assert all(torch.equal(ema[n], p)
               for n, p in port_state.G.named_parameters())

    port_state.step = 7
    ckpt.save_train_state(str(model / 'state_epoch2'), port_state)
    cfg.TRAIN.NET_G = str(model / 'state_epoch2')
    cfg.TRAIN.NET_D = ''
    trainer.train(max_steps=1)
    assert '(resuming at epoch 3)' in capsys.readouterr().out
    assert seen[-1][3] == 7
    port_state.step = 0


@pytest.mark.parametrize('use_ema', [True, False])
def test_evaluate_from_a_checkpoint_matches_its_pth(tmp_path, port_state,
                                                    use_ema):
    """A checkpoint directory samples the same PNG bytes as the .pth of the
    generator it holds: the EMA with TPU_EMA_EVAL, else the live
    weights."""
    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    cfg = cfg_from_file(EVAL_CFG)
    cfg.GAN.GF_DIM = 8
    cfg.TRAIN.BATCH_SIZE = 2
    cfg.TPU_EMA_EVAL = use_ema
    model = tmp_path / 'run7' / 'Model'
    model.mkdir(parents=True)
    port_state.g_ema = {n: p.detach() * 0.5
                        for n, p in port_state.G.named_parameters()}
    try:
        ckpt.save_train_state(str(model / 'state_epoch12'), port_state)
        torch.save(tstate.eval_g_state_dict(port_state, use_ema=use_ema),
                   model / 'netG_epoch_12.pth')
    finally:
        port_state.g_ema = None
    files = []
    for name in ('state_epoch12', 'netG_epoch_12.pth'):
        cfg.TRAIN.NET_G = str(model / name)
        ds = SyntheticTextDataset(num_items=2, base_size=64, branch_num=2,
                                  entity_dim=cfg.GAN.ENTITY_DIM,
                                  text_dim=cfg.TEXT.DIMENSION,
                                  train_pairs=False)
        trainer = CondGANTrainer(cfg, str(tmp_path / name),
                                 data_loader=DataLoader(ds, 2, shuffle=False,
                                                        num_workers=1),
                                 device='cpu')
        save_dir = trainer.evaluate(max_batches=1)
        assert save_dir.endswith('_12_run7')
        root = os.path.join(save_dir, 'single_samples', 'synthetic')
        files.append({f: open(os.path.join(root, f), 'rb').read()
                      for f in sorted(os.listdir(root))})
    assert len(files[0]) == 2 * 10 and files[0] == files[1]
