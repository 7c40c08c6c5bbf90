#!/usr/bin/env python3
"""Loader throughput of the PyTorch port: native C++ batch decode vs PIL.

    python3 tools/bench_loader_torch.py [--n 256] [--bs 32] [--branch 2]
                                        [--workers 4]

Fabricates CUB-sized JPEGs (500x375, random pixels, seed 0) with the
bounding boxes and the pickles of a CUB layout, then times one epoch of
training pairs of the port's ``TextDataset`` through its ``DataLoader``:
the native decoder (``native_decode``, ``csrc/dataloader.cpp``, 4 C++
threads) against the PIL pool (``--workers`` threads), each in float32
and uint8 output, in turns (PIL, native, native, PIL per output type)
after one warm-up epoch of each. Prints one JSON line per path: items/s
(each training item decodes two JPEGs, its real and its wrong image) of
its two epochs, JPEGs/s of the better one, and the host's
``os.cpu_count()``. Where the native library cannot be built here, its
lines carry ``"value": null`` and the reason. Host work only: no device
is touched. The counterpart of the JAX package's ``tools/bench_loader.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from text2img_ekl_tpu_torch.data import DataLoader, TextDataset  # noqa: E402
from text2img_ekl_tpu_torch.ops._build import (  # noqa: E402
    NativeUnavailable, host_library)


def fabricate_cub(root: str, n: int, text_dim: int = 1024) -> None:
    """A CUB layout under ``root`` (whose name must hold 'birds'): ``n``
    500x375 JPEGs in 20 class folders, images.txt, bounding_boxes.txt, and
    the train split's filenames, 10 x ``text_dim`` embeddings and class
    ids."""
    cub = os.path.join(root, 'CUB_200_2011')
    names = ['%03d.cls/img_%04d' % (i % 20, i) for i in range(n)]
    os.makedirs(cub, exist_ok=True)
    rng = np.random.default_rng(0)
    with open(os.path.join(cub, 'images.txt'), 'w') as f:
        for i, nm in enumerate(names):
            f.write('%d %s.jpg\n' % (i + 1, nm))
    with open(os.path.join(cub, 'bounding_boxes.txt'), 'w') as f:
        for i in range(n):
            f.write('%d 60 40 300 280\n' % (i + 1))
    for nm in names:
        p = os.path.join(cub, 'images', nm + '.jpg')
        os.makedirs(os.path.dirname(p), exist_ok=True)
        arr = rng.integers(0, 255, (375, 500, 3), dtype=np.uint8)
        Image.fromarray(arr).save(p, quality=90)
    split = os.path.join(root, 'train')
    os.makedirs(split, exist_ok=True)
    with open(os.path.join(split, 'filenames.pickle'), 'wb') as f:
        pickle.dump(names, f, protocol=2)
    emb = rng.standard_normal((n, 10, text_dim)).astype(np.float32)
    with open(os.path.join(split, 'char-CNN-RNN-embeddings.pickle'),
              'wb') as f:
        pickle.dump(emb, f, protocol=2)
    with open(os.path.join(split, 'class_info.pickle'), 'wb') as f:
        pickle.dump([i % 20 + 1 for i in range(n)], f, protocol=2)


def run(root: str, bs: int, branch: int, native: bool, workers: int,
        uint8: bool) -> float:
    """Items per second of one epoch of training pairs."""
    ds = TextDataset(root, 'train', base_size=64, branch_num=branch,
                     entity_dim=200, native_decode=native,
                     uint8_output=uint8)
    dl = DataLoader(ds, bs, shuffle=True, num_workers=workers)
    count = 0
    t0 = time.perf_counter()
    for batch in dl:
        count += batch['imgs'][0].shape[0]
    dt = time.perf_counter() - t0
    if native and ds.native_batches != len(dl):
        raise RuntimeError('the native decoder produced %d of %d batches'
                           % (ds.native_batches, len(dl)))
    return count / dt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=256, help='JPEGs fabricated')
    ap.add_argument('--bs', type=int, default=32)
    ap.add_argument('--branch', type=int, default=2)
    ap.add_argument('--workers', type=int, default=4,
                    help='threads of the PIL pool')
    return ap.parse_args(argv)


def main(argv=None) -> list:
    args = parse_args(argv)
    try:
        host_library('dataloader')
        unavailable = None
    except NativeUnavailable as e:
        unavailable = str(e)
    paths = [False] + ([True] if unavailable is None else [])
    rates = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, 'birds')
        fabricate_cub(root, args.n)
        for uint8 in (False, True):
            for native in paths:  # warm-up: page cache, decoder tables
                run(root, args.bs, args.branch, native, args.workers, uint8)
            for native in paths + paths[::-1]:
                rates.setdefault((native, uint8), []).append(
                    run(root, args.bs, args.branch, native, args.workers,
                        uint8))
    lines = []
    for uint8 in (False, True):
        for native in (False, True):
            got = rates.get((native, uint8))
            line = {'metric': 'loader_items_per_sec',
                    'path': ('native' if native else 'pil')
                    + ('+uint8' if uint8 else ''),
                    'value': max(got) if got else None,
                    'runs': got, 'jpegs_per_sec': 2 * max(got) if got
                    else None, 'bs': args.bs, 'branch_num': args.branch,
                    'threads': 4 if native else args.workers,
                    'cpu_count': os.cpu_count()}
            if native and unavailable is not None:
                line['unavailable'] = unavailable
            print(json.dumps(line))
            lines.append(line)
    return lines


if __name__ == '__main__':
    main()
