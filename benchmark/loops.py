"""The traffic generators. A traffic file names its ``kind`` and gives its
parameters; each kind is one general loop that reads them:

  train   a closed loop of the port's training step, back to back, on
          ``batches`` distinct synthetic batches of the configuration's
          ``TRAIN.BATCH_SIZE`` rows used in turn (the file's ``batch``
          states it, and a mismatch is refused);
  sample  a closed loop with one caller of the port's caption sampler,
          ``images`` test images x ``captions`` captions a call, on
          ``calls`` distinct sets of inputs used in turn, each call timed
          from its start to its result being ready.

Each kind has three parts: ``setup`` builds the program's objects from the
seed and drives the first units (training: the three steps the reference
follows), ``window`` runs for the given seconds, and ``check`` frees the
program's state and holds what the timed path produced to the reference.
"""

from __future__ import annotations

import gc
import itertools
import math
import random
import statistics
import time
from typing import Dict, List

import torch

import compare
import inputs
import program
import work

FIRST_STEPS = 3


def sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


class _CallTimer:
    """A call's time from its start to its result being ready: CUDA events
    on the card (the device's clock), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == 'cuda'
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def begin(self) -> None:
        if self.cuda:
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def finish(self) -> float:
        """Wait for the work enqueued since ``begin``; its milliseconds."""
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


class _Stamps:
    """Seconds of each set-up phase, each ending on a synchronize."""

    def __init__(self, device):
        self.device = device
        self.phases: Dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now


def _step_seed(seed: int, k: int) -> int:
    return (int(seed) * 1000003 + k) % (1 << 63)


# ------------------------------------------------------------------ train

class Train:
    def __init__(self, cell):
        self.cell = cell
        self.R = cell.reference
        self.d = self.R.dims(cell.config)
        self.b = int(cell.traffic['batch'])
        if int(cell.config['TRAIN']['BATCH_SIZE']) != self.b:
            raise ValueError('traffic %s steps batches of %d but the '
                             'configuration states TRAIN.BATCH_SIZE %d'
                             % (cell.traffic_name, self.b,
                                cell.config['TRAIN']['BATCH_SIZE']))
        self.flops_per_unit = work.train_step_flops(self.d, self.b)
        self.capsule_least_s = work.capsule_least_s(
            self.d, self.b, True, self.d['g_cap'])

    def setup(self) -> None:
        cell, dev = self.cell, self.cell.device
        stamp = _Stamps(dev)
        cfg = program.port_config(cell.config)
        self.make_pool()
        weights = self.R.make_weights(
            cell.config, inputs.generator(cell.seed, 'weights', dev), dev)
        stamp('inputs and weights')
        self.state = program.build_train_state(cfg, weights, dev)
        del weights
        self.step_fn = program.make_train_step(cfg)
        stamp('program built')
        self.k = itertools.count()
        self.prog = self.first_steps()
        stamp('first steps')
        self.setup_phases = stamp.phases

    def make_pool(self) -> None:
        dev = self.cell.device
        self.pool = inputs.train_batches(
            self.d, self.b, int(self.cell.traffic['batches']),
            inputs.generator(self.cell.seed, 'train_batches', dev), dev)

    def run(self, n: int):
        out = None
        for _ in range(n):
            k = next(self.k)
            slot = self.pool[k % len(self.pool)]
            out = self.step_fn(self.state, slot['batch'],
                               _step_seed(self.cell.seed, k),
                               draws=slot['draws'])
        return out

    def _params(self) -> Dict[str, torch.Tensor]:
        nets = [('G', self.state.G)] + [('D%d' % i, D)
                                        for i, D in enumerate(self.state.Ds)]
        return {'%s/%s' % (n, k): p for n, m in nets
                for k, p in m.named_parameters()}

    def first_steps(self) -> dict:
        """The first steps through the window's own call, with what the
        reference follows: each step's losses, the first gradient (from
        the Adams' first moments) and each leaf's change."""
        start = {k: p.detach().clone() for k, p in self._params().items()}
        losses, grads = [], None
        for step in range(FIRST_STEPS):
            metrics, _ = self.run(1)
            losses.append({k: metrics[k] for k in ('errD', 'errG')})
            if step == 0:
                st = self.state
                g = compare.adam_first_grads(st.G, st.g_opt, 'G/')
                for i, (D, o) in enumerate(zip(st.Ds, st.d_opts)):
                    g.update(compare.adam_first_grads(D, o, 'D%d/' % i))
                grads = compare.leaf_norms(g)
                del g
        change = compare.leaf_norms({k: p.detach() - start[k]
                                     for k, p in self._params().items()})
        del start
        losses = [{k: float(v) for k, v in m.items()} for m in losses]
        return {'losses': losses, 'grads': grads, 'change': change}

    def window(self, seconds: float) -> dict:
        sync(self.cell.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.run(1)
            n += 1
        sync(self.cell.device)
        elapsed = time.perf_counter() - t0
        return {'train_img_s': n * self.b / elapsed, 'units': n,
                'units_per_s': n / elapsed}

    def release(self) -> None:
        del self.state, self.step_fn
        _free(self.cell.device)

    def reference(self, prec) -> dict:
        """The reference's readings over the same first batches, from the
        same weights, made again from the seed."""
        cell, R, dev = self.cell, self.R, self.cell.device
        with R.reference_mode():
            weights = R.make_weights(
                cell.config, inputs.generator(cell.seed, 'weights', dev), dev)
            step = R.TrainStep(cell.config, weights, prec)
            losses, grads = [], None
            for k in range(FIRST_STEPS):
                slot = self.pool[k % len(self.pool)]
                losses.append(step(slot['batch'], slot['draws']))
                if k == 0:
                    grads = compare.leaf_norms({
                        '%s/%s' % (n, leaf): g for n, gs in step.grads.items()
                        for leaf, g in gs.items()})
            change = compare.leaf_norms({
                '%s/%s' % (n, leaf): step.P[n][leaf] - weights[n][leaf]
                for n in step.P for leaf in R.trainable(step.P[n])})
            del step, weights
            _free(dev)
        return {'losses': losses, 'grads': grads, 'change': change}

    def check(self, prec) -> Dict[str, float]:
        return compare.train_numbers(self.prog, self.reference(prec))


# ----------------------------------------------------------------- sample

class Sample:
    def __init__(self, cell):
        self.cell = cell
        self.R = cell.reference
        self.d = self.R.dims(cell.config)
        t = cell.traffic
        self.images, self.captions = int(t['images']), int(t['captions'])
        self.b = self.images * self.captions
        self.cap = bool(cell.config.get('TEST', {}).get('G_CAPSULE', False))
        self.flops_per_unit = work.sample_call_flops(self.d, self.b, self.cap)
        self.capsule_least_s = work.capsule_least_s(self.d, self.b, False,
                                                    self.cap)
        rng = random.Random(_step_seed(cell.seed, 7))
        self.checked = set(rng.sample(range(int(t['checked_from'])),
                                      int(t['checked_calls'])))
        self.kept: Dict[int, torch.Tensor] = {}

    def setup(self) -> None:
        cell, dev = self.cell, self.cell.device
        stamp = _Stamps(dev)
        cfg = program.port_config(cell.config)
        self.make_pool()
        weights = self.R.make_weights(
            cell.config, inputs.generator(cell.seed, 'weights', dev), dev,
            eval_build=True)['G']
        stamp('inputs and weights')
        self.G = program.build_sampler(cfg, weights, dev)
        del weights
        self.sample = program.caption_sample()
        stamp('program built')
        self.k = itertools.count()
        self.run(len(self.pool))  # every input set once: the shapes warm
        self.k = itertools.count()
        stamp('first calls')
        self.setup_phases = stamp.phases

    def make_pool(self) -> None:
        dev = self.cell.device
        self.pool = inputs.sample_inputs(
            self.d, self.images, self.captions,
            int(self.cell.traffic['calls']),
            inputs.generator(self.cell.seed, 'sample_inputs', dev), dev)

    def reference_images(self, slot: int, prec) -> torch.Tensor:
        """The reference's images for input set ``slot``."""
        cell, R, dev = self.cell, self.R, self.cell.device
        P = R.make_weights(cell.config,
                           inputs.generator(cell.seed, 'weights', dev), dev,
                           eval_build=True)['G']
        x = self.pool[slot]
        return R.sample(cell.config, P, x['noise'], x['emb'], x['cls_prior'],
                        x['eps'], prec)

    def call(self, k: int) -> torch.Tensor:
        x = self.pool[k % len(self.pool)]
        return self.sample(self.G, x['noise'], x['emb'], cls=x['cls'],
                           cls_prior=x['cls_prior'], eps=x['eps'])

    def run(self, n: int) -> None:
        """``n`` calls, each waited for, as the window's caller waits."""
        timer = _CallTimer(self.cell.device)
        for _ in range(n):
            timer.begin()
            self.call(next(self.k))
            timer.finish()

    def window(self, seconds: float) -> dict:
        timer = _CallTimer(self.cell.device)
        lat: List[float] = []
        last = None
        sync(self.cell.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            k = next(self.k)
            timer.begin()
            out = self.call(k)
            lat.append(timer.finish())
            if k in self.checked:
                self.kept[k] = out
            last = (k, out)
        elapsed = time.perf_counter() - t0
        self.kept[last[0]] = last[1]
        n = len(lat)
        return {'sample_img_s': n * self.b / elapsed,
                'sample_p95_ms': statistics.quantiles(lat, n=100)[94],
                'units': n, 'units_per_s': n / elapsed}

    def release(self) -> None:
        del self.G
        _free(self.cell.device)

    def check(self, prec) -> Dict[str, float]:
        """Every kept output against the reference on its inputs (the
        reference computed once per input set)."""
        gap = 0.0
        with self.R.reference_mode():
            for s in sorted({k % len(self.pool) for k in self.kept}):
                ref = self.reference_images(s, prec)
                for k, out in self.kept.items():
                    if k % len(self.pool) == s:
                        gap = max(gap, compare.image_gap(out, ref))
                del ref
        if not self.kept:
            gap = math.inf
        return {'image_gap': gap}


KINDS = {'train': Train, 'sample': Sample}
