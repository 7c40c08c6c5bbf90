"""Training and offline evaluation loops, PyTorch.

Counterpart of ``CondGANTrainer`` in ``text2img_ekl_tpu/train/trainer.py``
(the reference's cub_trainer_splitz_cap_ca.py:268-911) for the split-z
strategy:

- ``train(max_steps)`` runs the G+D step (``train/step.py``)
  over the train split to ``TRAIN.MAX_EPOCH`` (or fewer steps), prints the
  JAX epoch line, writes the epoch image grids (train-mode samples that
  leave the BatchNorm buffers alone), logs the scalars every 100 steps to
  ``Log/metrics.jsonl`` and writes full-state snapshots to
  ``Model/state_epoch<N>`` at the snapshot epochs. It resumes from
  ``TRAIN.NET_G`` (a reference netG ``.pth``, or a checkpoint directory of
  this package), loads ``TRAIN.NET_D``, or else resumes from the newest
  snapshot under ``output_dir``; SIGTERM and SIGINT save a snapshot at the
  next step boundary and return. The in-training IS stream and
  ``BIG_EVAL`` wait for ROADMAP.md M11: ``train`` raises at start where
  the run would score IS. Single process only (M13).
- ``evaluate`` samples the test split to PNGs for the 'cls' and
  'cls_share' patterns with the generator of ``TRAIN.NET_G`` (a ``.pth`` or
  a checkpoint directory, whose EMA it samples with ``TPU_EMA_EVAL``):
  each test batch samples its 10 captions in one forward, quantises on the
  device, and writes one PNG per image under the reference's directory and
  file names. Host noise comes from ``np.random.default_rng(100)`` exactly
  as in the JAX package; device draws (CA eps, class priors) come from a
  ``torch.Generator`` seeded per sampler call. Super-grid sampling
  (``TEST.B_EXAMPLE``), direct on-device scoring (``TPU_EVAL_DIRECT``),
  two-path eval and multi-host eval are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import os
import re
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data import DataLoader, SyntheticTextDataset, TextDataset
from ..data.transforms import build_eval_transform, build_train_transform
from ..io_utils.checkpoint import (CheckpointManager, parse_epoch_from_path,
                                   restore_generator_state,
                                   restore_train_state)
from ..io_utils.images import save_image_grid, save_single_images
from ..io_utils.logging import MetricsLogger
from ..io_utils.weights import load_pth_discriminator, load_pth_generator
from ..models.generator import build_generator
from ..nn.blocks import frozen_running_stats
from .sample import caption_sample
from .state import (TrainState, create_train_state, ema_copy,
                    resolve_restored_ema)
from .step import check_step_config, make_train_step

# captions sampled per test image (cub_trainer_splitz_cap_ca.py:826)
CAPTIONS_PER_IMAGE = 10
# seed streams of the device generators (the JAX package's host key
# streams: 1 the train step, 2 the epoch grids, 100 the sampler)
STEP_SEED_STREAM = 1
GRID_SEED_STREAM = 2
SAMPLER_SEED_STREAM = 100
# the JAX trainer scores IS once this many fakes are pooled
# (text2img_ekl_tpu/train/trainer.py:404)
IS_MIN_IMAGES = 3000
# steps between two records of the scalars (cub_trainer_splitz_cap_ca.py:
# 458-460)
LOG_EVERY = 100


def _seed(stream: int, n: int) -> int:
    return (stream << 32) + n


class CondGANTrainer:
    def __init__(self, cfg: Config, output_dir: str, data_loader=None,
                 device: str = 'cuda'):
        self.cfg = cfg
        self.output_dir = output_dir
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('device %s requested but torch finds no CUDA '
                               'device' % device)
        self.batch_size = cfg.TRAIN.BATCH_SIZE
        self.data_loader = data_loader or self._build_loader()
        self.num_batches = len(self.data_loader)
        self.state: Optional[TrainState] = None
        # the last epoch's metrics of train(), as floats
        self.last_metrics: Dict[str, float] = {}
        if cfg.TRAIN.FLAG:
            check_step_config(cfg)
            self.model_dir = os.path.join(output_dir, 'Model')
            self.image_dir = os.path.join(output_dir, 'Image')
            self.log_dir = os.path.join(output_dir, 'Log')
            for d in (self.model_dir, self.image_dir, self.log_dir):
                os.makedirs(d, exist_ok=True)
            self.logger = MetricsLogger(self.log_dir)
            self.ckpt = CheckpointManager(self.model_dir,
                                          keep=cfg.TPU_KEEP_CHECKPOINTS)
        else:
            self.G = build_generator(cfg, train_flag=False).to(self.device)

    def _build_loader(self):
        cfg = self.cfg
        train = bool(cfg.TRAIN.FLAG)
        split = 'train' if train else 'test'
        if cfg.DATASET_NAME == 'coco':
            raise NotImplementedError('the COCO strategy is not ported yet: '
                                      'ROADMAP.md M12')
        if 'lsun' in cfg.DATA_DIR or 'imagenet' in cfg.DATA_DIR:
            raise NotImplementedError('the LSUN and ImageFolder datasets are '
                                      'not ported yet: ROADMAP.md M12')
        kw = dict(base_size=cfg.TREE.BASE_SIZE,
                  branch_num=cfg.TREE.BRANCH_NUM,
                  entity_dim=cfg.GAN.ENTITY_DIM, train_pairs=train,
                  uint8_output=bool(cfg.TPU_UINT8_INPUT))
        has_data = cfg.DATA_DIR and os.path.isdir(
            os.path.join(cfg.DATA_DIR, split))
        if cfg.TPU_SYNTHETIC_DATA or not has_data:
            if not cfg.TPU_SYNTHETIC_DATA:
                print('!! DATA_DIR %r has no %s split - using synthetic data'
                      % (cfg.DATA_DIR, split))
            ds = SyntheticTextDataset(
                num_items=max(512, self.batch_size * 4),
                text_dim=cfg.TEXT.DIMENSION, **kw)
        else:
            if cfg.TPU_NATIVE_DECODE:
                print('TPU_NATIVE_DECODE: the port decodes images with PIL '
                      '(the native C++ decoder is ROADMAP.md M9)')
            transform = (build_train_transform(cfg.imsize) if train
                         else build_eval_transform(cfg.imsize))
            ds = TextDataset(cfg.DATA_DIR, split, cfg.EMBEDDING_TYPE,
                             transform=transform, **kw)
        return DataLoader(ds, self.batch_size, shuffle=train, drop_last=True,
                          num_workers=int(cfg.WORKERS))

    # ------------------------------------------------------------------
    def _device_batch(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """Host batch -> the step's inputs on the device: NHWC pyramids
        (uint8 stays uint8, normalised by the step) as NCHW, 1-based labels
        as one-hot ``cls_onehot`` and ``real_cp``; copied from pinned
        memory."""
        cfg = self.cfg
        dev = self.device
        pin = dev.type == 'cuda'

        def put(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if pin:
                t = t.pin_memory()
            return t.to(dev, non_blocking=pin)

        labels = np.asarray(host_batch['cls'], np.int64) - 1
        return {
            'real': tuple(put(x).permute(0, 3, 1, 2).contiguous()
                          for x in host_batch['imgs']),
            'wrong': tuple(put(x).permute(0, 3, 1, 2).contiguous()
                           for x in host_batch['wrong_imgs']),
            'txt': put(np.asarray(host_batch['embedding'], np.float32)),
            'cls_onehot': put(np.eye(cfg.GAN.ENTITY_DIM,
                                     dtype=np.float32)[labels]),
            'real_cp': put(np.eye(cfg.GAN.ENTITY_DIM + 1,
                                  dtype=np.float32)[labels]),
        }

    def _check_bounded_run(self, max_steps: Optional[int],
                           start_epoch: int) -> None:
        """Raise, before any step, where the JAX trainer would score IS in
        this run from ``start_epoch``
        (text2img_ekl_tpu/train/trainer.py:334-339, 404-419): the
        Inception tower waits for ROADMAP.md M11."""
        cfg = self.cfg
        if self.num_batches < 1:
            raise ValueError('the train loader yields no batch of %d'
                             % self.batch_size)
        every = int(cfg.TPU_IS_EVERY)
        if every <= 0:
            return
        pooled, taken = 0, 0
        for epoch in range(start_epoch, cfg.TRAIN.MAX_EPOCH):
            steps = self.num_batches
            # the loop takes a step before it tests its bound
            if max_steps is not None:
                steps = max(1, min(steps, max_steps - taken))
            pooled += (steps // every) * self.batch_size
            if pooled >= IS_MIN_IMAGES:
                raise NotImplementedError(
                    'this run reaches the in-training IS score (%d fakes '
                    'pooled by epoch %d, TPU_IS_EVERY %d): ROADMAP.md M11; '
                    'set TPU_IS_EVERY 0 or bound the run'
                    % (pooled, epoch, every))
            taken += steps
            if max_steps is not None and taken >= max_steps:
                break

    def _load_pth_generator(self, path: str, state: TrainState) -> None:
        """A reference netG .pth into G (the Ds and the Adams keep their
        fresh init: all that a reference snapshot carries); a live EMA slot
        is re-seeded from the loaded weights, not left at the fresh
        init."""
        state.G.load_state_dict(load_pth_generator(path), strict=True)
        if state.g_ema is not None:
            state.g_ema = ema_copy(state.G)

    def _load_pth_discriminators(self, prefix: str,
                                 state: TrainState) -> None:
        """Reference netD<i>.pth files, '%s%d.pth' % (NET_D, i), into the
        Ds (cub_trainer_splitz_cap_ca.py:179-184)."""
        for i, D in enumerate(state.Ds):
            path = '%s%d.pth' % (prefix, i)
            D.load_state_dict(load_pth_discriminator(path), strict=True)
            print('Load D from: %s' % path)

    def train(self, max_steps: Optional[int] = None) -> TrainState:
        """Train to ``TRAIN.MAX_EPOCH``, or for ``max_steps`` steps of this
        call."""
        cfg = self.cfg
        if not cfg.TRAIN.FLAG:
            raise ValueError('train() needs TRAIN.FLAG True')
        if cfg.TRAIN.BIG_EVAL:
            raise NotImplementedError('TRAIN.BIG_EVAL needs the Inception '
                                      'tower: ROADMAP.md M11')
        state = self.state = create_train_state(cfg, self.device, seed=0)
        start_epoch = 0
        if cfg.TRAIN.NET_G:
            # the reference parses the epoch from the file name and
            # continues (cub_trainer_splitz_cap_ca.py:170-184); a checkpoint
            # of this package restores the full state
            if cfg.TRAIN.NET_G.endswith('.pth'):
                self._load_pth_generator(cfg.TRAIN.NET_G, state)
            else:
                restore_train_state(cfg.TRAIN.NET_G, state)
            start_epoch = parse_epoch_from_path(cfg.TRAIN.NET_G)
            print('Load %s (resuming at epoch %d)'
                  % (cfg.TRAIN.NET_G, start_epoch))
        else:
            latest = self.ckpt.latest()
            if latest is not None:
                self.ckpt.restore(state, latest)
                start_epoch = state.step // max(1, self.num_batches)
                print('Resumed from %s (epoch %d)' % (latest, start_epoch))
        if cfg.TRAIN.NET_D:
            self._load_pth_discriminators(cfg.TRAIN.NET_D, state)
        resolve_restored_ema(state, cfg.TPU_EMA_DECAY)
        self._check_bounded_run(max_steps, start_epoch)
        step_fn = make_train_step(cfg)

        # a SIGTERM / SIGINT asks for a snapshot at the next step boundary
        # and a clean return (the reference loses everything since its last
        # snapshot)
        stop = {'flag': False}

        def request_stop(signum, frame):
            print('signal %d: checkpointing at next step boundary' % signum)
            stop['flag'] = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, request_stop)
            except (ValueError, OSError):
                pass  # not the main thread
        try:
            self._train_epochs(state, step_fn, start_epoch, stop, max_steps)
        finally:
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.logger.close()
        return state

    def _train_epochs(self, state: TrainState, step_fn, start_epoch: int,
                      stop: Dict[str, bool],
                      max_steps: Optional[int]) -> None:
        cfg = self.cfg
        count = state.step
        taken = 0
        for epoch in range(start_epoch, cfg.TRAIN.MAX_EPOCH):
            start_t = time.time()
            metrics: Dict[str, torch.Tensor] = {}
            last_batch = None
            for host_batch in self.data_loader:
                last_batch = self._device_batch(host_batch)
                # the draws are keyed on the step count, so a resumed run
                # draws what the uninterrupted run draws
                metrics, _ = step_fn(state, last_batch,
                                     _seed(STEP_SEED_STREAM, count))
                count += 1
                taken += 1
                if count % LOG_EVERY == 0:
                    self.logger.log_scalars(
                        count, {k: float(v) for k, v in metrics.items()})
                if stop['flag']:
                    # resumes at the start of this epoch
                    self.ckpt.save(state, epoch)
                    print('checkpointed on signal; exiting train loop')
                    return
                if max_steps is not None and taken >= max_steps:
                    break
            m = self.last_metrics = {k: float(v) for k, v in metrics.items()}
            print('[%d/%d][BN=%d][%d stages]\n'
                  '  Loss_D_all: %.2f match: %.2f uncond: %.2f cls: %.2f\n'
                  '  Loss_G_all: %.2f match: %.2f uncond: %.2f cls: %.2f\n'
                  '  KL_sen: %.2f KL_cls: %.2f  Time: %.2fs'
                  % (epoch, cfg.TRAIN.MAX_EPOCH, self.num_batches,
                     len(state.Ds), m.get('errD', 0), m.get('errD_match', 0),
                     m.get('errD_uncond', 0), m.get('errD_cls', 0),
                     m.get('errG', 0), m.get('errG_match', 0),
                     m.get('errG_uncond', 0), m.get('errG_cls', 0),
                     m.get('kl_sen', 0), m.get('kl_cls', 0),
                     time.time() - start_t))
            if m:
                print('  Sentence mu/std (mean): %.4f / %.4f  Class mu/std '
                      '(mean): %.4f / %.4f'
                      % (m['mu_sen_mean'], m['std_sen_mean'],
                         m['mu_cls_mean'], m['std_cls_mean']))
            if last_batch is not None:
                self._save_epoch_images(state, last_batch,
                                        _seed(GRID_SEED_STREAM, epoch), epoch)
            interval = cfg.TRAIN.SNAPSHOT_INTERVAL
            if epoch % interval == interval - 1 or epoch > 199:
                self.ckpt.save(state, epoch)
                print('Snapshot: save model ok')
            if max_steps is not None and taken >= max_steps:
                break

    def _sample_like(self, state: TrainState, batch: Dict[str, Any],
                     seed: int):
        """All-stage train-mode samples with the current G for the epoch
        grids; BatchNorm normalises with the batch's statistics and the
        running statistics stay as they were (the JAX sampler throws its
        ``batch_stats`` update away)."""
        G = state.G.train()
        bsz = batch['txt'].shape[0]
        noise = np.random.default_rng(seed).standard_normal(
            (bsz, self.cfg.GAN.Z_DIM), dtype=np.float32)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.no_grad(), frozen_running_stats(G):
            h_codes = G(torch.from_numpy(noise).to(self.device),
                        batch['txt'], batch['cls_onehot'], generator=gen)[0]
            return G.image(h_codes)

    def _save_epoch_images(self, state: TrainState, batch: Dict[str, Any],
                           seed: int, epoch: int) -> None:
        fakes = self._sample_like(state, batch, seed)

        def host(x):  # NCHW on the device -> NHWC numpy
            return x.permute(0, 2, 3, 1).cpu().numpy()

        real = host(batch['real'][-1])
        num = min(self.cfg.TRAIN.VIS_COUNT, real.shape[0])
        save_image_grid(real[:num], '%s/real_samples.png' % self.image_dir)
        for i, f in enumerate(fakes):
            save_image_grid(host(f)[:num], '%s/epoch_%03d_fake_samples%d.png'
                            % (self.image_dir, epoch, i))

    # ------------------------------------------------------------------
    def evaluate(self, max_batches: Optional[int] = None) -> Optional[str]:
        """Sample the test split to PNGs; returns the eval directory."""
        cfg = self.cfg
        for flag, what in ((cfg.TRAIN.ENTITY_NET_G, 'two-path eval '
                            '(TRAIN.ENTITY_NET_G)'),
                           (cfg.TEST.B_EXAMPLE, 'super-grid sampling '
                            '(TEST.B_EXAMPLE)'),
                           (cfg.TPU_EVAL_DIRECT, 'direct on-device scoring '
                            '(TPU_EVAL_DIRECT)'),
                           (not cfg.TEST.EVAL_MODE, 'train-mode sampling '
                            '(TEST.EVAL_MODE False)')):
            if flag:
                raise NotImplementedError('%s is not ported yet: see '
                                          'ROADMAP.md' % what)
        if cfg.TRAIN.FLAG:
            raise ValueError('evaluate() needs TRAIN.FLAG False')
        if not cfg.TRAIN.NET_G:
            print('Error: the path for models is not found!')
            return None
        if os.path.isdir(cfg.TRAIN.NET_G):
            # G side only: an eval config need not describe the Ds that the
            # checkpoint was trained with
            ema = restore_generator_state(cfg.TRAIN.NET_G, self.G)
            if cfg.TPU_EMA_EVAL and ema is not None:
                # the averages, the live BatchNorm buffers (as
                # train/state.py::eval_g_state_dict)
                self.G.load_state_dict(dict(self.G.state_dict(), **ema),
                                       strict=True)
        else:
            self.G.load_state_dict(load_pth_generator(cfg.TRAIN.NET_G),
                                   strict=True)
        G = self.G.eval()

        save_dir = os.path.join(self.output_dir,
                                self._eval_save_dir('evalmode'))
        print('Save to %s' % save_dir)
        np_rng = np.random.default_rng(100)
        calls = itertools.count()
        cls_share = cfg.TEST.CLS_PRIOR and cfg.TEST.CLS_SHARE
        target = None if max_batches is not None else int(
            cfg.TEST.SAMPLE_NUM)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        count = 0
        # One batch in flight: batch b samples on the device while batch
        # b-1's pixels are written. (host tensor, event, names, cls,
        # noise id, captions to keep)
        pending = []

        def drain(limit):
            while len(pending) > limit:
                host, event, names, pcls, nid, keep = pending.pop(0)
                if event is not None:
                    event.synchronize()
                arr = host.numpy()
                for si in range(keep):
                    save_single_images(arr[si], names, save_dir, si, pcls,
                                       cfg.imsize, nid)

        # a pass over the test split per noise id, until SAMPLE_NUM images
        # (one pass when max_batches is given)
        for nid in itertools.count():
            pass_start = count
            for step, data in enumerate(self.data_loader):
                if max_batches is not None and step >= max_batches:
                    break
                embeddings = np.asarray(data['embeddings'], np.float32)
                cls0 = np.asarray(data['cls']) - 1  # 0-based, as filenames
                bsz = embeddings.shape[0]
                noise = np_rng.standard_normal((bsz, cfg.GAN.Z_DIM),
                                               dtype=np.float32)
                shared_prior = (np_rng.standard_normal(
                    (bsz, cfg.GAN.MANIFD_DIM), dtype=np.float32)
                    if cls_share else None)
                n_cap = min(CAPTIONS_PER_IMAGE, embeddings.shape[1])
                emb = embeddings[:, :n_cap].transpose(1, 0, 2)
                gen = torch.Generator(device=dev)
                gen.manual_seed(_seed(SAMPLER_SEED_STREAM, next(calls)))
                out = caption_sample(
                    G, put(noise), put(emb),
                    cls=(None if cls_share else put(np.eye(
                        cfg.GAN.ENTITY_DIM, dtype=np.float32)[cls0])),
                    cls_prior=None if shared_prior is None
                    else put(shared_prior),
                    generator=gen)
                keep = n_cap if target is None else min(
                    n_cap, max(0, -(-(target - count) // bsz)))
                if keep:
                    event = None
                    if dev.type == 'cuda':
                        host = out.to('cpu', non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                    else:
                        host = out
                    pending.append((host, event, data['key'], cls0, nid,
                                    keep))
                    count += bsz * keep
                drain(1)
                print('[%d/%d]' % (step, self.num_batches))
                if target is not None and count >= target:
                    break
            if target is None or count >= target:
                break
            if count == pass_start:
                print('!! eval loader yielded no batches - stopping at %d '
                      'images (target %d)' % (count, target))
                break
        drain(0)
        print('Save images ok; Number of images: %d' % count)
        return save_dir

    def _eval_save_dir(self, mode: str) -> str:
        """eval/Testset_<mode>_fixednoise[_clsprior-{share,random}]_<epoch>
        _<run>: <epoch> from the NET_G file name, <run> from its
        grandparent directory (cub_trainer_splitz_cap_ca.py:829-845)."""
        cfg = self.cfg
        net_g = (cfg.TRAIN.NET_G or '').rstrip('/')
        base = os.path.basename(net_g)
        stem = base[:-4] if base.endswith('.pth') else base
        m = re.search(r'(\d+)$', stem)
        epoch_tok = m.group(1) if m else (stem.split('_')[-1] or '0')
        parts = net_g.split('/')
        run_tok = parts[-3] if len(parts) >= 3 else (
            os.path.basename(os.path.abspath(self.output_dir)) or 'run')
        if cfg.TEST.CLS_PRIOR:
            prior_tok = ('clsprior-share' if cfg.TEST.CLS_SHARE
                         else 'clsprior-random')
            name = 'Testset_%s_fixednoise_%s_%s_%s' % (
                mode, prior_tok, epoch_tok, run_tok)
        else:
            name = 'Testset_%s_fixednoise_%s_%s' % (mode, epoch_tok, run_tok)
        return os.path.join('eval', name)
