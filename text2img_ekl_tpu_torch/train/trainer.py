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
  next step boundary and return. Every ``TPU_IS_EVERY`` steps the step's
  own fakes go through the Inception tower on the device (a bf16 tower;
  ``eval/inception_score.py``); at the end of an epoch with 3,000 or more
  pooled the IS is printed and logged as ``inception_score``, and a score
  above the reference's threshold (3.4 fine-tuned, 5.5 general, 6.0 COCO)
  writes a protected snapshot, with real Inception weights
  (``T2I_INCEPTION_CKPT``) only. ``TRAIN.BIG_EVAL`` scores 1,000 fresh
  samples an epoch instead, with its save gate at 5.4. Single process only
  (M13).
- ``evaluate`` samples the test split to PNGs for the 'cls' and
  'cls_share' patterns with the generator of ``TRAIN.NET_G`` (a ``.pth`` or
  a checkpoint directory, whose EMA it samples with ``TPU_EMA_EVAL``):
  each test batch samples its 10 captions in one forward, quantises on the
  device, and writes one PNG per image under the reference's directory and
  file names, on the native writer's threads while the next batch samples
  (joined before ``evaluate`` returns; ``T2I_NATIVE_WRITE=0`` writes with
  PIL). Host noise comes from ``np.random.default_rng(100)`` exactly
  as in the JAX package; device draws (CA eps, class priors) come from a
  ``torch.Generator`` seeded per sampler call. With ``TPU_EVAL_DIRECT``
  the sampler's uint8 stacks go straight from the device into the IS
  tower (and the FID tower, against ``TPU_EVAL_FID_STATS``): no PNG is
  written, and ``direct_scores.json`` holds the scores. Super-grid
  sampling (``TEST.B_EXAMPLE``), two-path eval and multi-host eval are not
  ported yet (ROADMAP.md).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import spans
from ..config import Config
from ..data import DataLoader, SyntheticTextDataset, TextDataset
from ..data.transforms import build_eval_transform, build_train_transform
from ..io_utils.checkpoint import (CheckpointManager, parse_epoch_from_path,
                                   restore_generator_state,
                                   restore_train_state)
from ..io_utils.images import (flush_writes, save_image_grid,
                               save_single_images)
from ..io_utils.logging import MetricsLogger
from ..io_utils.weights import (RANDOM_INCEPTION_SEED,
                                load_pth_discriminator, load_pth_generator,
                                random_inception)
from ..models.generator import build_generator
from ..nn.blocks import frozen_running_stats
from .sample import caption_sample
from .state import (TrainState, create_train_state, ema_copy,
                    resolve_restored_ema)
from .step import check_step_config, make_train_step

# captions sampled per test image (cub_trainer_splitz_cap_ca.py:826)
CAPTIONS_PER_IMAGE = 10
# seed streams of the device generators (the JAX package's host key
# streams: 1 the train step, 2 the epoch grids, 4 BIG_EVAL's batches, 100
# the sampler)
STEP_SEED_STREAM = 1
GRID_SEED_STREAM = 2
BIG_EVAL_SEED_STREAM = 4
SAMPLER_SEED_STREAM = 100
# IS is scored once this many fakes are pooled
# (cub_trainer_splitz_cap_ca.py:658)
IS_MIN_IMAGES = 3000
# BIG_EVAL scores once more than this many fresh samples are pooled, and
# saves above BIG_EVAL_THRESHOLD (cub_trainer_splitz_cap_ca.py:698-730)
BIG_EVAL_IMAGES = 1000
BIG_EVAL_THRESHOLD = 5.4
# IS save gates (cub_trainer_splitz_cap_ca.py:670-674)
IS_THRESHOLD_COCO = 6.0
IS_THRESHOLD_CUB_GENERAL = 5.5
IS_THRESHOLD_CUB_FINETUNED = 3.4
# steps between two records of the scalars (cub_trainer_splitz_cap_ca.py:
# 458-460)
LOG_EVERY = 100
# TPU_PROFILE records these steps [first, end) of the first epoch, as the
# JAX trainer does
PROFILE_STEPS = (3, 8)


def _seed(stream: int, n: int) -> int:
    return (stream << 32) + n


class _StepProfile:
    """``TPU_PROFILE``: a ``torch.profiler`` session over ``PROFILE_STEPS``
    of ``epoch`` (CPU and CUDA activities on the card, the CPU elsewhere),
    which turns the spans on (``spans.py``) and writes its Chrome trace
    under ``<log_dir>/profile/`` when it stops."""

    def __init__(self, device: torch.device, log_dir: str, epoch: int):
        self.device = device
        self.path = os.path.join(log_dir, 'profile', 'epoch%d_steps%d-%d.json'
                                 % (epoch, PROFILE_STEPS[0],
                                    PROFILE_STEPS[1] - 1))
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self) -> None:
        """Stop and write the trace; nothing if not recording."""
        if self.prof is None:
            return
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        prof, self.prof = self.prof, None
        prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        print('profile of steps %d-%d: %s' % (PROFILE_STEPS[0],
                                              PROFILE_STEPS[1] - 1, self.path))


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
            transform = (build_train_transform(cfg.imsize) if train
                         else build_eval_transform(cfg.imsize))
            ds = TextDataset(cfg.DATA_DIR, split, cfg.EMBEDDING_TYPE,
                             transform=transform,
                             native_decode=bool(cfg.TPU_NATIVE_DECODE), **kw)
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
        if self.num_batches < 1:
            raise ValueError('the train loader yields no batch of %d'
                             % self.batch_size)
        step_fn = make_train_step(cfg)
        # no tower where the stream is off (TPU_IS_EVERY <= 0): building it
        # costs start-up time, and its random-weights warning would mislead
        scorer = (self._make_is_scorer()
                  if not cfg.TRAIN.BIG_EVAL and cfg.TPU_IS_EVERY > 0
                  else None)

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
        profile = (_StepProfile(self.device, self.log_dir, start_epoch)
                   if cfg.TPU_PROFILE else None)
        try:
            self._train_epochs(state, step_fn, scorer, start_epoch, stop,
                               max_steps, profile)
        finally:
            if profile is not None:
                profile.stop()
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
            self.logger.close()
        return state

    def _train_epochs(self, state: TrainState, step_fn, scorer,
                      start_epoch: int, stop: Dict[str, bool],
                      max_steps: Optional[int],
                      profile: Optional[_StepProfile]) -> None:
        """The epochs. Each iteration of the step loop is a ``train.iter``
        span (``spans.py``); ``profile`` records steps ``PROFILE_STEPS`` of
        the first epoch."""
        cfg = self.cfg
        count = state.step
        taken = 0
        every = int(cfg.TPU_IS_EVERY)
        threshold = (IS_THRESHOLD_COCO if cfg.DATASET_NAME == 'coco' else
                     IS_THRESHOLD_CUB_GENERAL if cfg.TRAIN.GENERAL_IS
                     else IS_THRESHOLD_CUB_FINETUNED)
        for epoch in range(start_epoch, cfg.TRAIN.MAX_EPOCH):
            start_t = time.time()
            metrics: Dict[str, torch.Tensor] = {}
            last_batch = None
            batches = iter(self.data_loader)
            profiled = profile is not None and epoch == start_epoch
            for step_i in itertools.count():
                if profiled and step_i == PROFILE_STEPS[0]:
                    profile.start()
                with spans.span('train.iter'):
                    # the loader's wait and the copy to the device; the
                    # epoch's last iteration holds only the loader's end
                    with spans.span('train.batch'):
                        host_batch = next(batches, None)
                        if host_batch is not None:
                            last_batch = self._device_batch(host_batch)
                    if host_batch is None:
                        break
                    # the draws are keyed on the step count, so a resumed
                    # run draws what the uninterrupted run draws
                    metrics, fakes = step_fn(state, last_batch,
                                             _seed(STEP_SEED_STREAM, count))
                    count += 1
                    taken += 1
                    # after every N steps of an epoch (N = 2: steps 1, 3,
                    # 5.., the reference's every other step, cub_trainer:
                    # 613), the step's own fakes, on the device: one tower
                    # forward is the stream's whole cost
                    if scorer is not None and (step_i + 1) % every == 0:
                        with spans.span('train.is_stream'):
                            scorer.add(fakes)
                    if count % LOG_EVERY == 0:
                        self.logger.log_scalars(
                            count, {k: float(v) for k, v in metrics.items()})
                if profiled and step_i == PROFILE_STEPS[1] - 1:
                    profile.stop()
                if stop['flag']:
                    # resumes at the start of this epoch
                    self.ckpt.save(state, epoch)
                    print('checkpointed on signal; exiting train loop')
                    return
                if max_steps is not None and taken >= max_steps:
                    break
            if profiled:
                profile.stop()  # an epoch shorter than PROFILE_STEPS
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
            if scorer is not None and scorer.count >= IS_MIN_IMAGES:
                mean, std = scorer.score(num_splits=1)
                print('Epoch%d IS: %.3f +- %.3f' % (epoch, mean, std))
                self.logger.log_scalars(count, {'inception_score': mean})
                self._is_gated_save(state, epoch, mean, threshold, scorer)
            elif cfg.TRAIN.BIG_EVAL:
                mean = self._big_eval(state, epoch)
                print('Epoch%d IS: %.3f' % (epoch, mean))
                self._is_gated_save(state, epoch, mean, BIG_EVAL_THRESHOLD,
                                    self._big_scorer)
            if max_steps is not None and taken >= max_steps:
                break

    def _is_gated_save(self, state: TrainState, epoch: int, mean: float,
                       threshold: float, scorer) -> None:
        """The reference's threshold-gated "good model" save
        (cub_trainer_splitz_cap_ca.py:670-696), as a protected snapshot,
        refused on random Inception weights: an IS above 3.4 from a tower
        that was never trained is noise."""
        if mean <= threshold:
            return
        if getattr(scorer, 'real_weights', False):
            self.ckpt.save(state, epoch, protect=True)
            print('Saved good model')
        else:
            print('IS %.3f above threshold but inception weights are '
                  'random - skipping good-model save '
                  '(set T2I_INCEPTION_CKPT)' % mean)

    def _make_is_scorer(self, dtype: Optional[torch.dtype] = torch.bfloat16):
        """The IS tower on the trainer's device: the converted TF-slim
        checkpoint of ``T2I_INCEPTION_CKPT``, or seeded random weights
        (scores then are relative only; ``real_weights`` says which). The
        default bf16 tower serves the in-training relative gate; ``dtype``
        None builds the float32 one of offline scoring. ``GENERAL_IS``
        takes the torchvision flavor with 1,000 classes (reference
        model.py:18-47)."""
        from ..eval.inception_score import InceptionScorer
        general = self.cfg.TRAIN.GENERAL_IS
        num_classes = 1000 if general else 51
        flavor = 'torch' if general else 'slim'
        ckpt = os.environ.get('T2I_INCEPTION_CKPT', '')
        real_weights = bool(ckpt and (os.path.exists(ckpt) or
                                      os.path.exists(ckpt + '.index')))
        if real_weights:
            from ..eval.convert_tf import (flax_template,
                                           load_slim_checkpoint,
                                           slim_vars_to_flax)
            from ..io_utils.weights import inception_from_flax
            variables = inception_from_flax(slim_vars_to_flax(
                load_slim_checkpoint(ckpt, num_classes),
                flax_template(num_classes, flavor)), flavor)
        else:
            variables = random_inception(RANDOM_INCEPTION_SEED, num_classes,
                                         flavor)
            print('!! Inception weights are random (no checkpoint found): '
                  'in-training IS is a relative signal only')
        scorer = InceptionScorer(variables, num_classes,
                                 finetuned=not general, flavor=flavor,
                                 dtype=dtype, device=self.device)
        # the absolute save thresholds mean something only with the
        # reference's trained weights: the protected save checks this
        scorer.real_weights = real_weights
        return scorer

    def _big_eval(self, state: TrainState, epoch: int) -> float:
        """Sample more than BIG_EVAL_IMAGES fresh fakes over loader batches
        with the current G and score IS (the reference's per-epoch eval,
        cub_trainer_splitz_cap_ca.py:698-730)."""
        if not hasattr(self, '_big_scorer'):
            self._big_scorer = self._make_is_scorer()
        scorer = self._big_scorer
        for bi, host_batch in enumerate(self.data_loader):
            if scorer.count > BIG_EVAL_IMAGES:
                break
            batch = self._device_batch(host_batch)
            fakes = self._sample_like(
                state, batch, _seed(BIG_EVAL_SEED_STREAM, epoch * 4096 + bi))
            scorer.add(fakes[-1])
        mean, _ = scorer.score(num_splits=1)
        return mean

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
        """Sample the test split to PNGs, or score it on the device with
        ``TPU_EVAL_DIRECT``; returns the eval directory."""
        cfg = self.cfg
        for flag, what in ((cfg.TRAIN.ENTITY_NET_G, 'two-path eval '
                            '(TRAIN.ENTITY_NET_G)'),
                           (cfg.TEST.B_EXAMPLE, 'super-grid sampling '
                            '(TEST.B_EXAMPLE)'),
                           (not cfg.TEST.EVAL_MODE, 'train-mode sampling '
                            '(TEST.EVAL_MODE False)')):
            if flag:
                raise NotImplementedError('%s is not ported yet: see '
                                          'ROADMAP.md' % what)
        direct = bool(cfg.TPU_EVAL_DIRECT)
        if direct and cfg.TPU_EVAL_FID_STATS:
            # before any sampling: a bad file must not cost a sampling run
            from ..eval.fid import load_statistics
            load_statistics(cfg.TPU_EVAL_FID_STATS)
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

        is_scorer = fid_scorer = None
        if direct:
            is_scorer = self._make_is_scorer(dtype=None)  # float32 offline
            if cfg.TPU_EVAL_FID_STATS:
                fid_scorer = self._make_fid_scorer()

        count = 0
        # One batch in flight: batch b samples on the device while batch
        # b-1's pixels are written or scored. (pixels: a host copy, or the
        # device stack when scoring directly; event, names, cls, noise id,
        # captions to keep)
        pending = []

        def drain(limit):
            while len(pending) > limit:
                pixels, event, names, pcls, nid, keep = pending.pop(0)
                if direct:
                    # the towers take the device stack; nothing reaches
                    # the host until the scores
                    for si in range(keep):
                        is_scorer.add_uint8_row(pixels, si)
                        if fid_scorer is not None:
                            fid_scorer.add_uint8_row(pixels, si)
                    continue
                if event is not None:
                    event.synchronize()
                # the native writer copies at enqueue: the pinned host copy
                # is free once save_single_images returns
                arr = pixels.numpy()
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
                    pixels, event = out, None
                    if dev.type == 'cuda' and not direct:
                        pixels = out.to('cpu', non_blocking=True)
                        event = torch.cuda.Event()
                        event.record()
                    pending.append((pixels, event, data['key'], cls0, nid,
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
        if direct:
            return self._write_direct_scores(save_dir, count, is_scorer,
                                             fid_scorer)
        write_errors = flush_writes()  # join the async native PNG writer
        if write_errors:
            # the images on disk, not the attempts: each sampled image is
            # one PNG write
            print('!! %d image writes failed' % write_errors)
            print('Save images DONE WITH ERRORS; Number of images '
                  'written: %d (of %d sampled)'
                  % (count - write_errors, count))
        else:
            print('Save images ok; Number of images: %d' % count)
        return save_dir

    def _make_fid_scorer(self):
        """The FID tower on the trainer's device: the frozen 2015 graph of
        ``T2I_FID_PB``, or seeded random weights in its flavor (1,008
        classes; FID is then relative only)."""
        from ..eval.fid import FIDScorer
        pb = os.environ.get('T2I_FID_PB', '')
        if pb and os.path.exists(pb):
            return FIDScorer.from_frozen_pb(pb, device=self.device)
        print('!! random FID tower (no $T2I_FID_PB): FID is relative-only')
        return FIDScorer(random_inception(RANDOM_INCEPTION_SEED, 1008, 'fid'),
                         1008, flavor='fid', device=self.device)

    def _write_direct_scores(self, save_dir: str, count: int, is_scorer,
                             fid_scorer) -> str:
        """<save_dir>/direct_scores.json: images, IS (10 splits from 100
        images on, as is_of_dir scores a directory), whether the IS tower
        has real weights, and FID where TPU_EVAL_FID_STATS is set."""
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, 'direct_scores.json')
        if count == 0:
            with open(path, 'w') as f:
                json.dump({'images': 0}, f, indent=1)
            print('Direct eval: 0 images sampled - no scores')
            return save_dir
        splits = 10 if count >= 100 else 1
        mean, std = is_scorer.score(num_splits=splits)
        result = {'images': count, 'is_mean': mean, 'is_std': std,
                  'is_splits': splits,
                  'real_is_weights': bool(is_scorer.real_weights)}
        if fid_scorer is not None:
            result['fid'] = fid_scorer.accumulated_fid_against_stats(
                self.cfg.TPU_EVAL_FID_STATS)
        with open(path, 'w') as f:
            json.dump(result, f, indent=1)
        print('Direct eval (no PNG round trip): IS %.4f +- %.4f over %d '
              'images%s' % (mean, std, count,
                            (' FID %.4f' % result['fid'])
                            if 'fid' in result else ''))
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
