#!/usr/bin/env python3
"""How far two float32 runs of one training step drift apart through the
discriminators' LeakyReLU kinks (ROADMAP F10), on the CPU.

    python3 tools/step_kink_check.py [--threads 1 4] [--switches]

Runs one step of the flagship training config at GF/DF_DIM 16, batch 4,
float32, from the same seeded weights, batch and draws, under two torch
thread counts (two summation orders of the same code). Prints how many
D LeakyReLU inputs took the other slope in the second run, and the worst
Adam first moment's distance, as a fraction of the bound that
``chip_smoke.py`` phase 9 applies (||d|| <= 1e-2 ||ref|| + 1e-5
max|ref over the net|): once with each run free, once with the second run
replaying the first run's branches, as phase 9 does across devices.
``--switches`` sets TPU_FUSED_BN_GLU and TPU_PALLAS_DW.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _moments(state):
    nets = [(state.G, state.g_opt)] + list(zip(state.Ds, state.d_opts))
    out = []
    for net, opt in nets:
        names = {p: n for n, p in net.named_parameters()}
        out.append({names[p]: s['exp_avg'] for p, s in opt.state.items()})
    return out


def _worst(got, want, rtol, atol):
    import torch
    worst = 0.0
    for g, w in zip(got, want):
        net_max = max(float(v.abs().max()) for v in w.values())
        for k, v in w.items():
            worst = max(worst, float(torch.linalg.vector_norm(g[k] - v)) / (
                rtol * float(torch.linalg.vector_norm(v)) + atol * net_max))
    return worst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--threads', type=int, nargs=2, default=[1, 4])
    ap.add_argument('--switches', action='store_true')
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import chip_smoke as cs
    from text2img_ekl_tpu_torch.config import cfg_from_file
    from text2img_ekl_tpu_torch.nn.blocks import LeakyReLU
    from text2img_ekl_tpu_torch.train.state import create_train_state
    from text2img_ekl_tpu_torch.train.step import make_train_step

    cfg = copy.deepcopy(cfg_from_file(cs.TRAIN_CFG))
    cfg.GAN.GF_DIM = cfg.GAN.DF_DIM = 16
    cfg.TRAIN.BATCH_SIZE = 4
    cfg.TPU_COMPUTE_DTYPE = 'float32'
    if args.switches:
        for k, v in cs.SWITCHES.items():
            setattr(cfg, k, v)

    def step(threads, masks, replay):
        torch.set_num_threads(threads)
        st = create_train_state(cfg, 'cpu', seed=0)
        batch, draws = cs._step_batch(np.random.default_rng(5), cfg, 'cpu')
        hooks, flips = cs._pinned_kinks(st.Ds, LeakyReLU, masks, replay)
        make_train_step(cfg)(st, batch, 0, draws)
        for h in hooks:
            h.remove()
        return _moments(st), flips[0]

    first, second = args.threads
    masks = []
    ref, _ = step(first, masks, replay=False)
    free, _ = step(second, [], replay=False)
    pinned, flips = step(second, masks, replay=True)
    print('switches %s, threads %d vs %d: %d LeakyReLU inputs of %d calls '
          'took the other slope; worst Adam first moment at %.3f of the '
          'bound with free branches, %.3f with the first run\'s branches'
          % (args.switches, first, second, flips, len(masks),
             _worst(free, ref, cs.MOMENT_RTOL, cs.MOMENT_ATOL),
             _worst(pinned, ref, cs.MOMENT_RTOL, cs.MOMENT_ATOL)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
