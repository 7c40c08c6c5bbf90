#!/usr/bin/env python
"""CLI of the PyTorch port: main.py's interface, plus --device and --net_g.

    python main_torch.py --cfg cfg/birds_2stg_splitz_cap_ca.realcls.yml \
        --synthetic --max_steps 3
    python main_torch.py --cfg cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml \
        --net_g path/to/netG.pth --synthetic --max_steps 2

TRAIN.FLAG True trains to TRAIN.MAX_EPOCH (or for --max_steps G+D steps)
from a seeded state, under ./output/<dataset>_<config>_<timestamp>/: the
epoch line, the epoch image grids in Image/, the scalars every 100 steps in
Log/metrics.jsonl, and full-state snapshots in Model/state_epoch<N> at
every TRAIN.SNAPSHOT_INTERVAL-th epoch and every epoch past 199. SIGTERM or
SIGINT saves a snapshot at the next step and stops. --net_g (TRAIN.NET_G)
Model/state_epoch<N> resumes that run's full state at epoch N + 1; a
reference netG .pth loads the generator only (TRAIN.NET_D the
discriminators, from <NET_D>0.pth, <NET_D>1.pth). Until the IS tower
(ROADMAP M11) is ported, a run that would score IS raises at start: set
TPU_IS_EVERY 0 for a long run. TRAIN.FLAG False samples the test split
with the generator named by --net_g or TRAIN.NET_G (a reference netG .pth,
a state_dict saved by this package, or a snapshot directory, whose EMA is
sampled with TPU_EMA_EVAL) and writes PNGs under
./output/<dataset>_<config>_<timestamp>/eval/.
"""

from __future__ import annotations

import argparse
import datetime
import os
import pprint
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from text2img_ekl_tpu_torch.config import cfg_from_file  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train or sample a text-to-image GAN (PyTorch port)')
    parser.add_argument(
        '--cfg', dest='cfg_file', type=str,
        default='cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml')
    parser.add_argument('--gpu', dest='gpu_id', type=str, default='-1',
                        help='compat only; use --device')
    parser.add_argument('--device', type=str, default='cuda',
                        help="torch device, e.g. 'cuda', 'cuda:1' or 'cpu'")
    parser.add_argument('--data_dir', dest='data_dir', type=str, default='')
    parser.add_argument('--net_g', type=str, default='',
                        help='TRAIN.NET_G: a generator .pth or a snapshot '
                             'directory (Model/state_epoch<N>) to sample, '
                             'or to resume training from')
    parser.add_argument('--manualSeed', type=int, help='manual seed')
    parser.add_argument('--max_steps', type=int, default=None,
                        help='training: the G+D steps to take (default: '
                             'to TRAIN.MAX_EPOCH); sampling: the data '
                             'batches to sample')
    parser.add_argument('--synthetic', action='store_true',
                        help='force the synthetic dataset')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = cfg_from_file(args.cfg_file)
    if args.gpu_id != '-1':
        cfg.GPU_ID = args.gpu_id
    if args.data_dir:
        cfg.DATA_DIR = args.data_dir
    if args.net_g:
        cfg.TRAIN.NET_G = args.net_g
    if args.synthetic:
        cfg.TPU_SYNTHETIC_DATA = True
    print('Using config:')
    pprint.pprint(cfg.to_dict())

    if not cfg.TRAIN.FLAG:
        args.manualSeed = 100  # the eval seed (main.py:87-94)
    elif args.manualSeed is None:
        args.manualSeed = random.randint(1, 10000)
    random.seed(args.manualSeed)
    import numpy as np
    import torch
    np.random.seed(args.manualSeed)
    torch.manual_seed(args.manualSeed)
    print('Top-stack images size: %dx%d' % (cfg.imsize, cfg.imsize))

    timestamp = datetime.datetime.now().strftime('%Y_%m_%d_%H_%M_%S')
    output_dir = './output/%s_%s_%s' % (
        cfg.DATASET_NAME, cfg.CONFIG_NAME, timestamp)

    from text2img_ekl_tpu_torch.train.trainer import CondGANTrainer
    algo = CondGANTrainer(cfg, output_dir, device=args.device)
    start_t = time.time()
    if cfg.TRAIN.FLAG:
        algo.train(max_steps=args.max_steps)
        print('Total time for training:', time.time() - start_t)
    else:
        algo.evaluate(max_batches=args.max_steps)
        print('Total time for sampling:', time.time() - start_t)


if __name__ == '__main__':
    main()
