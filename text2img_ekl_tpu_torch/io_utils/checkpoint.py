"""Checkpoints of the full training state, PyTorch.

Counterpart of ``text2img_ekl_tpu/io_utils/checkpoint.py``. The reference
saves only ``netG.state_dict()`` and drops the optimiser state on resume
(cub_trainer_splitz_cap_ca.py:662-667); here the whole ``TrainState``
round-trips: G's and each D's parameters and BatchNorm buffers, both
Adams (moments and per-parameter steps, on which bias correction
depends), the step count and the generator EMA.

Layout, as the JAX package's: one directory ``<model_dir>/state_epoch<N>``
per snapshot, holding one file, ``train_state.pt`` (``torch.save`` of
``train/state.py::train_state_dict``). A save writes the directory under a
temporary name and renames it into place, so that a process killed in
mid-save leaves nothing that ``CheckpointManager.latest`` takes; a save to
an epoch that exists replaces it. A new ``CheckpointManager`` clears what a
killed save left behind (see ``_recover``).

Not ported: the ZeRO-1 topology migration (ROADMAP.md M13) and reading
the JAX package's orbax directories (F7), which raise.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

from ..train.state import (TrainState, load_generator, load_train_state_dict,
                           train_state_dict)

STATE_FILE = 'train_state.pt'
_SNAPSHOT = re.compile(r'state_epoch(\d+)$')
# what a save leaves behind when it is killed: its temporary directory, or
# the snapshot it was replacing, moved aside
_LEFTOVER = re.compile(r'(state_epoch\d+)\.(tmp|old)-\d+$')


def _abspath(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def _state_device(state: TrainState) -> torch.device:
    return next(state.G.parameters()).device


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` to the directory ``path``: under a temporary name
    first, renamed into place when the file is whole and on disk
    (replacing ``path`` if it exists); the rename is made durable by
    syncing the parent directory."""
    path = _abspath(path).rstrip(os.sep)
    tmp = '%s.tmp-%d' % (path, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, STATE_FILE), 'wb') as f:
        torch.save(train_state_dict(state), f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    old = None
    if os.path.exists(path):
        old = '%s.old-%d' % (path, os.getpid())
        os.rename(path, old)
    os.rename(tmp, path)
    _fsync_dir(os.path.dirname(path))
    if old is not None:
        shutil.rmtree(old)


def _recover(model_dir: str) -> None:
    """Clear what killed saves left in ``model_dir``: a temporary directory
    is deleted; a snapshot moved aside is put back where its replacement
    never arrived, else deleted."""
    for name in sorted(os.listdir(model_dir)):
        m = _LEFTOVER.match(name)
        if m is None:
            continue
        p = os.path.join(model_dir, name)
        target = os.path.join(model_dir, m.group(1))
        if m.group(2) == 'old' and not os.path.exists(target):
            os.rename(p, target)
            _fsync_dir(model_dir)
        else:
            shutil.rmtree(p)


def _read(path: str, device) -> Dict[str, Any]:
    """The checkpoint dict in the directory ``path``, its tensors on
    ``device``. A directory without the port's file (an orbax checkpoint of
    the JAX package) raises, as ``io_utils/weights.py`` does for NET_G."""
    p = _abspath(path)
    if not os.path.isdir(p):
        raise FileNotFoundError('no checkpoint directory %r' % path)
    f = os.path.join(p, STATE_FILE)
    if not os.path.isfile(f):
        raise NotImplementedError(
            'checkpoint %r holds no %s (an orbax checkpoint of the JAX '
            'package?); the port restores its own checkpoints and loads '
            '.pth state_dicts only. Export the generator with '
            'text2img_ekl_tpu.io_utils.torch_export.save_torch_generator, '
            'or see ROADMAP.md (orbax NET_G load, F7).' % (path, STATE_FILE))
    return torch.load(f, map_location=device, weights_only=True)


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Restore the checkpoint at ``path`` into ``state`` in place, on the
    state's device; returns ``state``. The generator-EMA slot follows the
    checkpoint (``train/state.py::load_train_state_dict``): averages
    are restored whether or not ``state`` has a slot, and a slot that the
    checkpoint lacks is seeded from the restored weights. A state whose
    architecture differs raises, naming the tensor and both shapes; a
    dtype difference is cast."""
    return load_train_state_dict(state, _read(path, _state_device(state)))


def restore_generator_state(
        path: str, G: torch.nn.Module) -> Optional[Dict[str, torch.Tensor]]:
    """G-side restore for ``evaluate``: G's parameters and BatchNorm
    buffers into ``G``; returns the checkpoint's EMA of G's parameters, or
    None where it has none. An eval config need not describe the
    discriminators the checkpoint was trained with (the reference's eval
    path loads netG only, cub_trainer_splitz_cap_ca.py:784-800)."""
    return load_generator(G, _read(path, 'cpu'))


def parse_epoch_from_path(path: str) -> int:
    """'netG_epoch123' / 'netG_123.pth'-style suffix -> 124 (next count),
    mirroring cub_trainer_splitz_cap_ca.py:175-178."""
    m = re.search(r'(\d+)(?:\.[a-z]+)?$', path.rstrip('/'))
    return int(m.group(1)) + 1 if m else 0


class CheckpointManager:
    """Epoch-indexed checkpoint directory: <model_dir>/state_epoch<N>
    (the reference's netG_epoch%d convention, holding the full state).

    ``keep`` bounds disk: after each save the oldest unprotected snapshots
    beyond the newest ``keep`` are deleted (0 = keep all, the reference's
    never-delete behaviour). ``save(..., protect=True)`` (the IS-gated
    "good model" saves) writes a sidecar ``.protect_epoch<N>`` that exempts
    that epoch for good. A new manager clears what killed saves left
    behind (``_recover``)."""

    def __init__(self, model_dir: str, keep: int = 0):
        self.model_dir = _abspath(model_dir)
        self.keep = keep
        os.makedirs(self.model_dir, exist_ok=True)
        _recover(self.model_dir)

    def path(self, epoch: int) -> str:
        return os.path.join(self.model_dir, 'state_epoch%d' % epoch)

    def save(self, state: TrainState, epoch: int,
             protect: bool = False) -> str:
        p = self.path(epoch)
        save_train_state(p, state)
        if protect:
            with open(os.path.join(self.model_dir,
                                   '.protect_epoch%d' % epoch), 'w'):
                pass
        self._prune()
        return p

    def _epochs(self):
        return sorted(int(m.group(1)) for m in map(
            _SNAPSHOT.match, os.listdir(self.model_dir)) if m)

    def _prune(self) -> None:
        if self.keep <= 0:
            return
        epochs = self._epochs()
        protected = {e for e in epochs if os.path.exists(
            os.path.join(self.model_dir, '.protect_epoch%d' % e))}
        unprotected = [e for e in epochs if e not in protected]
        for e in unprotected[:-self.keep]:
            shutil.rmtree(self.path(e), ignore_errors=True)

    def latest(self) -> Optional[str]:
        if not os.path.isdir(self.model_dir):
            return None
        epochs = self._epochs()
        return self.path(epochs[-1]) if epochs else None

    def restore(self, state: TrainState,
                path: Optional[str] = None) -> Optional[TrainState]:
        p = path or self.latest()
        if p is None:
            return None
        return restore_train_state(p, state)
