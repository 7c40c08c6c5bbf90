"""Batched, prefetching data loader of the PyTorch port.

The port's own copy of ``text2img_ekl_tpu/data/loader.py`` without the
native C++ decode path (ROADMAP.md M9): a thread-pool PIL decode + a
double-buffered prefetch queue in place of torch's DataLoader worker
processes (main.py:133-135). PIL/numpy release the GIL during
decode/resize, and the next batch is assembled while the device steps.

Semantics kept from the reference: drop_last batching, reshuffle each epoch,
one epoch == one pass over the dataset.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np


def _stack_items(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Collate per-item dicts into a batch dict of stacked arrays."""
    out: Dict[str, Any] = {}
    first = items[0]
    for k, v in first.items():
        if isinstance(v, list):  # image pyramids
            out[k] = tuple(
                np.stack([it[k][i] for it in items]) for i in range(len(v)))
        elif isinstance(v, np.ndarray) or np.isscalar(v) or isinstance(
                v, (np.integer, np.floating)):
            out[k] = np.stack([np.asarray(it[k]) for it in items])
        else:  # strings/keys
            out[k] = [it[k] for it in items]
    return out


def _put_resilient(q: 'queue.Queue', item, stop: threading.Event) -> None:
    """Put that cannot hang a producer whose consumer is gone: retry on
    a full queue only until ``stop`` is set."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            if stop.is_set():
                return


class DataLoader:
    """``batch_size`` is the PER-PROCESS batch. In a multi-process run
    (``num_shards`` processes) every process shuffles the full
    index set with the same epoch seed and takes a disjoint stride
    (``shard_id::num_shards``), so hosts decode only their share and the
    union is one reference epoch up to ``len(dataset) % num_shards``
    leftover items (every shard is truncated to the minimum shard size so
    all processes step in lockstep — see ``_epoch_indices``); the
    per-process batches form the global batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0,
                 collate_fn: Optional[Callable] = None,
                 shard_id: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.collate = collate_fn or _stack_items
        self._epoch = 0
        self._seed = seed
        if not (0 <= shard_id < num_shards):
            raise ValueError('shard_id %d not in [0, %d)'
                             % (shard_id, num_shards))
        self.shard_id = shard_id
        self.num_shards = num_shards

    def _shard_len(self) -> int:
        n = len(self.dataset)
        if self.num_shards == 1:
            return n
        # MINIMUM stride-shard size, not this shard's own: every process
        # must report the SAME length — the trainer drives collective
        # steps off this loop, and when len(dataset) % num_shards != 0 a
        # host whose stride got one extra item would run one extra
        # psum step per epoch and wedge the job on mismatched
        # collectives.
        return n // self.num_shards

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # identical permutation on every process (seed is shared), then
            # a disjoint stride per process
            np.random.default_rng(self._seed + self._epoch).shuffle(idx)
        if self.num_shards > 1:
            # Truncate every stride shard to the MINIMUM shard size so all
            # processes see identical batch shapes even with
            # drop_last=False: when len(dataset) % num_shards != 0, a
            # larger shard's final batch would otherwise differ in SIZE
            # from the minimum shard's, wedging the job on mismatched
            # collectives exactly like a mismatched step COUNT would.
            idx = idx[self.shard_id::self.num_shards][:self._shard_len()]
        return idx

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._epoch_indices()
        epoch = self._epoch
        self._epoch += 1
        n_batches = len(self)
        bs = self.batch_size

        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        batch_idx = indices[b * bs:(b + 1) * bs]
                        fetch = getattr(self.dataset, 'item', None)
                        if fetch is not None:
                            # one deterministic Generator PER ITEM: the
                            # datasets' shared self.rng is not
                            # thread-safe under the pool (concurrent
                            # draws corrupt PCG64 state -> correlated
                            # crops, nondeterministic epochs), and
                            # per-(seed, epoch, index) seeding makes the
                            # pipeline reproducible independent of
                            # worker scheduling.
                            seed = self._seed

                            def get_one(i):
                                return fetch(int(i), np.random.default_rng(
                                    (seed, epoch, int(i))))

                            items = list(pool.map(get_one, batch_idx))
                        else:
                            items = list(pool.map(self.dataset.__getitem__,
                                                  batch_idx))
                        q.put(self.collate(items))
            except Exception as e:  # surface worker errors to the consumer
                _put_resilient(q, e, stop)
            finally:
                # End-of-stream sentinel. Both this and the error put are
                # best-effort: if the consumer abandoned mid-epoch
                # (max_steps) with a full queue, a blocking put would
                # leak this thread (plus a decoded batch) forever; the
                # consumer's finally-drain runs AFTER stop.set(), so on
                # the live path the slot frees and the put lands.
                _put_resilient(q, None, stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
