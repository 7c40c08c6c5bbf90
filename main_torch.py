#!/usr/bin/env python
"""CLI of the PyTorch port: main.py's interface, plus --device and --net_g.

    python main_torch.py --cfg cfg/birds_2stg_splitz_cap_ca.realcls.yml \
        --synthetic --max_steps 3
    python main_torch.py --cfg cfg/birds_2stg_splitz_cap_ca_eval.realcls.yml \
        --net_g path/to/netG.pth --synthetic --max_steps 2

TRAIN.FLAG True trains: ``--max_steps`` G+D steps from a seeded state,
with the epoch line and the epoch image grids under
./output/<dataset>_<config>_<timestamp>/Image/. Until checkpoints (ROADMAP
M10) and the IS tower (M11) are ported, a run must be bounded by
--max_steps and reach no snapshot epoch and no IS score. TRAIN.FLAG False
samples the test split with the generator named by --net_g or TRAIN.NET_G
(a reference netG .pth, or a state_dict saved by this package) and writes
PNGs under ./output/<dataset>_<config>_<timestamp>/eval/.
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
                        help='generator .pth to sample (overrides '
                             'TRAIN.NET_G)')
    parser.add_argument('--manualSeed', type=int, help='manual seed')
    parser.add_argument('--max_steps', type=int, default=None,
                        help='training: the G+D steps to take (required '
                             'until ROADMAP M10/M11); sampling: the data '
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
