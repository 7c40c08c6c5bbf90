#!/usr/bin/env python3
"""Throughput of the PyTorch port's offline sampling path (the
TEST.SAMPLE_NUM protocol, reference cub_trainer_splitz_cap_ca.py:776-911):
images/s through ``CondGANTrainer.evaluate`` on synthetic data, split into
device sampling and host PNG writing.

    python3 tools/bench_eval_torch.py [--cfg cfg/..._eval.realcls.yml]
                                      [--batches 4] [--device cuda]

The config's full width (the flagship eval config: GF_DIM 64, 32 images x
10 captions a sampler call) with a seeded random generator whose every
layer carries signal (``seeded_generator``), so that the PNGs compress as
varied images do. In turns after one warm-up pass (none, native, pil, pil,
native, none), each over ``--batches`` test batches:

- sampling only: ``save_single_images`` replaced by a no-op;
- the native writer (``T2I_NATIVE_WRITE=1``, ``csrc/imagewriter.cpp``),
  joined by ``evaluate`` before it returns;
- the PIL writer (``T2I_NATIVE_WRITE=0``);

then direct scoring (``TPU_EVAL_DIRECT``: the uint8 stacks into the IS
tower on the device, no PNG) at 1 and ``--batches`` batches, reported as
its marginal rate (t(N) - t(1) over the extra images: each ``evaluate``
builds its tower anew, a fixed cost the 30k protocol amortises). The host
write tax of a writer is its best time less the best sampling-only time.
Prints a line per figure and one JSON object with the card's name and
power limit and the host's ``os.cpu_count()``. The counterpart of the JAX
package's ``tools/bench_eval.py``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from text2img_ekl_tpu_torch.ops._build import (  # noqa: E402
    NativeUnavailable, host_library)

CFG = os.path.join(ROOT, 'cfg', 'birds_2stg_splitz_cap_ca_eval.realcls.yml')
WORK = os.path.join(ROOT, 'output', 'bench_eval_torch')
CAPTIONS = 10


def seeded_generator(cfg, dev):
    """A random generator whose every layer carries signal: a fresh init
    routes to outputs near 1e-7, which BatchNorm's fresh 0/1 statistics
    pass on as near-zeros, so the images would hardly depend on the
    capsule stage. Capsule weights are drawn unit-variance and every
    BatchNorm's running statistics are set from one random batch. Returns
    the state dict on the CPU."""
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.nn import blocks
    torch.manual_seed(0)
    G = build_generator(cfg, train_flag=False).to(dev)
    momentum = blocks.BN_MOMENTUM
    with torch.no_grad():
        cap = G.h_net1.fc_cap[1].weight
        cap.copy_(torch.randn(cap.shape, device=dev))
        blocks.BN_MOMENTUM = 0.0  # running statistics := this batch's
        try:
            b = 64
            G.train()(torch.randn((b, cfg.GAN.Z_DIM), device=dev),
                      torch.randn((b, cfg.TEXT.DIMENSION), device=dev) * 0.03,
                      torch.eye(cfg.GAN.ENTITY_DIM, device=dev)[
                          torch.randint(0, cfg.GAN.ENTITY_DIM, (b,))])
        finally:
            blocks.BN_MOMENTUM = momentum
    return {k: v.cpu() for k, v in G.state_dict().items()}


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize()


def measure(cfg, batches: int, device: str = 'cuda', direct: bool = True,
            work: str = WORK) -> dict:
    """Seconds and images/s of ``evaluate`` over ``batches`` batches of the
    config's test batch for each route (see the module docstring). ``cfg``
    is an eval config; its synthetic data and a seeded random generator
    are used."""
    import text2img_ekl_tpu_torch.train.trainer as trainer_mod
    dev = torch.device(device)
    cfg = copy.deepcopy(cfg)
    cfg.TPU_SYNTHETIC_DATA = True
    cfg.TPU_EVAL_DIRECT = False
    shutil.rmtree(work, ignore_errors=True)
    net_g = os.path.join(work, 'run0', 'Model', 'netG_epoch_0.pth')
    os.makedirs(os.path.dirname(net_g))
    torch.save(seeded_generator(cfg, dev), net_g)
    cfg.TRAIN.NET_G = net_g
    trainer = trainer_mod.CondGANTrainer(cfg, os.path.join(work, 'out'),
                                         device=device)
    images = batches * cfg.TRAIN.BATCH_SIZE * CAPTIONS
    try:
        host_library('imagewriter')
        unavailable = None
    except NativeUnavailable as e:
        unavailable = str(e)
    real_save = trainer_mod.save_single_images

    def run(route, n):
        shutil.rmtree(trainer.output_dir, ignore_errors=True)
        if route == 'none':
            trainer_mod.save_single_images = lambda *a, **kw: None
        os.environ['T2I_NATIVE_WRITE'] = '0' if route == 'pil' else '1'
        try:
            _sync(dev)
            t0 = time.perf_counter()
            trainer.evaluate(max_batches=n)
            _sync(dev)
            return time.perf_counter() - t0
        finally:
            trainer_mod.save_single_images = real_save

    saved_env = os.environ.get('T2I_NATIVE_WRITE')
    try:
        routes = ['none'] + (['native'] if unavailable is None else []) + \
            ['pil']
        run('none', 1)  # warm-up: kernels built, cuDNN plans chosen
        seconds = {r: [] for r in routes}
        for r in routes + routes[::-1]:
            seconds[r].append(run(r, batches))
        out = {'images': images, 'batches': batches,
               'batch': cfg.TRAIN.BATCH_SIZE, 'gf_dim': cfg.GAN.GF_DIM,
               'imsize': cfg.imsize, 'cpu_count': os.cpu_count(),
               'native_unavailable': unavailable, 'seconds': seconds}
        for r in routes:
            out['%s_images_per_s' % r] = images / min(seconds[r])
            if r != 'none':
                out['%s_write_tax_s' % r] = (min(seconds[r])
                                             - min(seconds['none']))
        if direct:
            cfg_d = trainer.cfg
            cfg_d.TPU_EVAL_DIRECT = True
            try:
                run('direct', 1)  # warm-up: the tower's first forward
                t1 = run('direct', 1)
                tn = run('direct', batches)
            finally:
                cfg_d.TPU_EVAL_DIRECT = False
            out['direct_seconds'] = [t1, tn]
            out['direct_images_per_s'] = (
                (images - cfg.TRAIN.BATCH_SIZE * CAPTIONS) / (tn - t1)
                if batches > 1 else images / tn)
            out['direct_rate_kind'] = ('marginal' if batches > 1
                                       else 'total with the tower set-up')
    finally:
        if saved_env is None:
            os.environ.pop('T2I_NATIVE_WRITE', None)
        else:
            os.environ['T2I_NATIVE_WRITE'] = saved_env
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cfg', default=CFG)
    ap.add_argument('--batches', type=int, default=4)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    from text2img_ekl_tpu_torch.config import cfg_from_file
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('bench_eval_torch: torch finds no CUDA device', file=sys.stderr)
        return 1
    card = 'cpu'
    if args.device == 'cuda':
        card = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    res = measure(cfg_from_file(args.cfg), args.batches, args.device)
    n = res['images']
    for r, what in (('none', 'sampling only'), ('native', 'native writer'),
                    ('pil', 'PIL writer')):
        if r in res['seconds']:
            print('%-15s: best %6.2f s of %s  %8.1f images/s%s'
                  % (what, min(res['seconds'][r]),
                     ['%.2f' % t for t in res['seconds'][r]],
                     res['%s_images_per_s' % r],
                     '' if r == 'none' else '  host write tax %.2f s'
                     % res['%s_write_tax_s' % r]))
        else:
            print('%-15s: not measured (%s)' % (what,
                                                res['native_unavailable']))
    print('direct scoring : %6.2f s  %8.1f images/s %s (sample -> IS, no '
          'disk)' % (res['direct_seconds'][1], res['direct_images_per_s'],
                     res['direct_rate_kind']))
    print('%d images a route on %s, %d host cores' % (n, card,
                                                      res['cpu_count']))
    print(json.dumps(dict(res, card=card)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
