#!/usr/bin/env python3
"""Where the PyTorch port's caption sampler, or its training step, spends
device time.

    python3 tools/profile_torch_sampler.py [--calls 5] [--train]

Needs a CUDA card. Without ``--train``: builds the flagship eval generator
(cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml, full width, the config's
compute dtype) with the same seeded random weights as chip_smoke.py,
warms up, then records ``--calls`` caption-sampler calls (32 images x 10
captions each) under torch.profiler. With ``--train``: records
``--calls`` training steps of the flagship training config
(cfg/birds_2stg_splitz_cap_ca.realcls.yml, full width, batch 32) on one
synthetic batch, after two warm-up steps. Prints the device time by
kernel group and the top kernels, the device's busy share of the window,
and writes a Chrome trace to chiprun_out/{sampler,train}_trace.json.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (('K1-G capsule routing', ('routing_fwd_kernel',)),
          ('K1-D capsule routing', ('routing_votes_fwd_kernel',)),
          ('K2-G routing backward', ('routing_bwd_factored_kernel',
                                     'dw_factored_kernel')),
          ('K2-D routing backward', ('routing_bwd_votes_kernel',)),
          ('K1-D/K2-D vote products', ('gemm_f32_kernel',)),
          ('optimizer', ('adam', 'multi_tensor')),
          ('convolution', ('conv', 'gemm', 'xmma', 'cutlass', 'sm90_')),
          ('batch norm', ('batch_norm', 'bn_')),
          ('upsample', ('upsample',)),
          ('copy / cast', ('copy', 'cast')))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other elementwise'


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--calls', type=int, default=5)
    ap.add_argument('--train', action='store_true',
                    help='profile training steps instead of sampler calls')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('profile_torch_sampler: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import CFG, _seeded_generator
    from text2img_ekl_tpu_torch.config import cfg_from_file
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.train.sample import caption_sample
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device('cuda')
    if args.train:
        import itertools
        from chip_smoke import TRAIN_CFG
        from text2img_ekl_tpu_torch.train.state import create_train_state
        from text2img_ekl_tpu_torch.train.step import make_train_step
        from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
        cfg = cfg_from_file(TRAIN_CFG)
        cfg.TPU_SYNTHETIC_DATA = True
        trainer = CondGANTrainer(cfg, os.path.join(ROOT, 'output',
                                                   'profile_train'),
                                 device='cuda')
        state = create_train_state(cfg, dev, seed=0)
        batch = trainer._device_batch(next(iter(trainer.data_loader)))
        step_fn = make_train_step(cfg)
        seeds = itertools.count()

        def work():
            step_fn(state, batch, next(seeds))

        what, per_call = 'steps', cfg.TRAIN.BATCH_SIZE
    else:
        cfg = cfg_from_file(CFG)
        G = build_generator(cfg, train_flag=False).to(dev)
        G.load_state_dict(_seeded_generator(cfg, build_generator, dev))
        G.eval()
        b, c = cfg.TRAIN.BATCH_SIZE, 10
        noise = torch.randn((c, b, cfg.GAN.Z_DIM), device=dev)
        emb = torch.randn((c, b, cfg.TEXT.DIMENSION), device=dev) * 0.03
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        def work():
            caption_sample(G, noise, emb, generator=gen)

        what, per_call = 'calls', b * c
    for _ in range(3):
        work()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the optimizer's step annotation spans its own
    # kernels on the device timeline and would count them twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)
              and not e.key.startswith('Optimizer.')]
    attr = 'device_time_total' if hasattr(events[0], 'device_time_total') \
        else 'cuda_time_total'
    total = sum(getattr(e, attr) for e in events) / 1e3
    print('%d %s (%d images each, %s): wall %.2f ms, device kernels '
          '%.2f ms (busy %.1f%% of the window)'
          % (args.calls, what, per_call, cfg.TPU_COMPUTE_DTYPE, wall_ms,
             total, 100 * total / wall_ms))
    groups = {}
    for e in events:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + getattr(e, attr) / 1e3
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print('  %-24s %9.3f ms per %s  %5.1f%%'
              % (g, ms / args.calls, what[:-1], 100 * ms / total))
    print('top kernels (ms per %s, launches per %s):' % (what[:-1],
                                                        what[:-1]))
    for e in sorted(events, key=lambda e: -getattr(e, attr))[:15]:
        print('  %9.3f  %4d  %s' % (getattr(e, attr) / 1e3 / args.calls,
                                    e.count // args.calls, e.key[:110]))
    out = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out, '%s_trace.json' % ('train' if args.train else 'sampler')))
    if args.train:
        return 0

    # the host side of evaluate: one batch's D2H copy and PNG writes
    import shutil
    from text2img_ekl_tpu_torch.io_utils.images import save_single_images
    imgs = caption_sample(G, noise, emb, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = imgs.cpu().numpy()
    d2h_s = time.perf_counter() - t0
    tmp = os.path.join(ROOT, 'output', 'profile_png')
    names = ['item%03d' % i for i in range(b)]
    t0 = time.perf_counter()
    for si in range(c):
        save_single_images(host[si], names, tmp, si, [0] * b, cfg.imsize, 0)
    png_s = time.perf_counter() - t0
    shutil.rmtree(tmp, ignore_errors=True)
    print('host per batch of %d images: D2H %.1f ms, PNG writes %.1f ms '
          '(%.1f images/s)' % (b * c, d2h_s * 1e3, png_s * 1e3,
                               b * c / png_s))
    return 0


if __name__ == '__main__':
    sys.exit(main())
