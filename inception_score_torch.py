#!/usr/bin/env python
"""Inception Score over an image directory, PyTorch port.

Counterpart of inception_score.py (reference inception_score.py:256-295):
loads a directory of images, runs the port's InceptionV3 (the fine-tuned
50+1-class TF-slim checkpoint when given, else ImageNet general mode with
--general) and prints the 10-split IS.

    python inception_score_torch.py --image_folder DIR \
        [--checkpoint_dir CKPT] [--num_classes 51] [--splits 10] \
        [--device cuda]

--checkpoint_dir is a TF-slim checkpoint prefix (model.ckpt for
model.ckpt.index and model.ckpt.data-*); --general takes --pb or
$T2I_FID_PB, the frozen 2015 graph. Neither file is in the repository:
without one the tower has seeded random weights and the score is relative
only (it says so). Neither TensorFlow nor protobuf is needed.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def load_images(folder: str, limit: int = 0) -> list:
    """Every .png / .jpg / .jpeg / .bmp under ``folder`` (walked in sorted
    order) as uint8 HWC RGB, at most ``limit`` of them (0: all)."""
    from PIL import Image
    out = []
    for root, _, files in sorted(os.walk(folder)):
        for name in sorted(files):
            if name.lower().endswith(('.png', '.jpg', '.jpeg', '.bmp')):
                img = Image.open(os.path.join(root, name)).convert('RGB')
                out.append(np.asarray(img, np.uint8))
                if limit and len(out) >= limit:
                    return out
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--image_folder', required=True)
    ap.add_argument('--checkpoint_dir', default='',
                    help='TF-slim checkpoint to convert (EMA variables)')
    ap.add_argument('--num_classes', type=int, default=51)
    ap.add_argument('--splits', type=int, default=10)
    ap.add_argument('--batch_size', type=int, default=64)
    ap.add_argument('--limit', type=int, default=0)
    ap.add_argument('--general', action='store_true',
                    help='ImageNet general-IS mode (no background slice; '
                         'weights from --pb, the frozen 2015 graph)')
    ap.add_argument('--pb', default=os.environ.get('T2I_FID_PB', ''),
                    help='classify_image_graph_def.pb for --general')
    ap.add_argument('--device', default='cuda',
                    help="torch device, e.g. 'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    from text2img_ekl_tpu_torch.eval.inception_score import InceptionScorer
    from text2img_ekl_tpu_torch.io_utils.weights import (
        RANDOM_INCEPTION_SEED, inception_from_flax, random_inception)

    if args.general:
        if args.pb and os.path.exists(args.pb):
            scorer = InceptionScorer.from_frozen_pb(
                args.pb, batch_size=args.batch_size, device=args.device)
        else:
            print('!! no --pb: random inception weights, general IS is NOT '
                  'comparable to the reference')
            scorer = InceptionScorer(
                random_inception(RANDOM_INCEPTION_SEED, 1008, 'fid'), 1008,
                finetuned=False, flavor='fid', batch_size=args.batch_size,
                device=args.device)
    else:
        num_classes = args.num_classes
        if args.checkpoint_dir:
            from text2img_ekl_tpu_torch.eval.convert_tf import (
                flax_template, load_slim_checkpoint, slim_vars_to_flax)
            tf_vars = load_slim_checkpoint(args.checkpoint_dir, num_classes)
            variables = inception_from_flax(slim_vars_to_flax(
                tf_vars, flax_template(num_classes, 'slim')))
        else:
            print('!! no checkpoint: random inception weights, scores are '
                  'NOT comparable to the reference')
            variables = random_inception(RANDOM_INCEPTION_SEED, num_classes)
        scorer = InceptionScorer(variables, num_classes, finetuned=True,
                                 batch_size=args.batch_size,
                                 device=args.device)

    images = load_images(args.image_folder, args.limit)
    print('images:', len(images))
    mean, std = scorer.score_images(images, args.splits)
    print('IS: %.4f +- %.4f' % (mean, std))


if __name__ == '__main__':
    main()
