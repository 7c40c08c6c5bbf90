#!/usr/bin/env python
"""IS (and FID against precomputed statistics) over a sample directory,
PyTorch port.

Counterpart of is_of_dir.py (reference is.py:11-89, is_of_dir.py):

    python is_of_dir_torch.py --dir eval/Testset_... [--checkpoint_dir CKPT]
        [--general --pb classify_image_graph_def.pb] [--fid_stats stats.npz]
        [--device cuda]

Weight sources (scores comparable with the reference's need one; neither
is in the repository, and without them the towers have seeded random
weights and say so):
  * fine-tuned IS (default): --checkpoint_dir, the TF-slim 50+1-class
    checkpoint prefix (reference inception_score.py:43-45);
  * general IS (--general): --pb, the frozen 2015 ImageNet graph
    (reference inception_score_general.py:56-99), 1008-way softmax and the
    frozen graph's preprocessing;
  * FID (--fid_stats) always takes the frozen graph (--pb or
    $T2I_FID_PB), as reference fid.py does.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--dir', required=True)
    ap.add_argument('--checkpoint_dir', default='',
                    help='TF-slim fine-tuned checkpoint (51-class IS)')
    ap.add_argument('--pb', default=os.environ.get('T2I_FID_PB', ''),
                    help='frozen 2015 graph for --general IS and the FID '
                         'branch; defaults to $T2I_FID_PB')
    ap.add_argument('--fid_stats', default='',
                    help='precomputed .npz real-set statistics')
    ap.add_argument('--splits', type=int, default=10)
    ap.add_argument('--limit', type=int, default=0)
    ap.add_argument('--general', action='store_true')
    ap.add_argument('--device', default='cuda',
                    help="torch device, e.g. 'cuda' or 'cpu'")
    args = ap.parse_args(argv)
    if args.general and args.checkpoint_dir:
        ap.error('--general uses the frozen pb (--pb), not a slim '
                 'checkpoint; drop --checkpoint_dir')

    from inception_score_torch import load_images
    from text2img_ekl_tpu_torch.eval.convert_tf import (
        flax_template, load_slim_checkpoint, slim_vars_to_flax)
    from text2img_ekl_tpu_torch.eval.inception_score import InceptionScorer
    from text2img_ekl_tpu_torch.io_utils.weights import (
        RANDOM_INCEPTION_SEED, inception_from_flax, random_inception)

    have_pb = args.pb and os.path.exists(args.pb)
    if args.general:
        if have_pb:
            scorer = InceptionScorer.from_frozen_pb(args.pb,
                                                    device=args.device)
        else:
            # the random fallback in the flavor the real path uses
            scorer = InceptionScorer(
                random_inception(RANDOM_INCEPTION_SEED, 1008, 'fid'), 1008,
                finetuned=False, flavor='fid', device=args.device)
            print('!! random inception weights (no --pb): general IS is '
                  'relative-only')
    else:
        if args.checkpoint_dir:
            variables = inception_from_flax(slim_vars_to_flax(
                load_slim_checkpoint(args.checkpoint_dir, 51),
                flax_template(51, 'slim')))
        else:
            variables = random_inception(RANDOM_INCEPTION_SEED, 51)
            print('!! random inception weights: scores are relative-only')
        scorer = InceptionScorer(variables, 51, finetuned=True,
                                 device=args.device)

    images = load_images(args.dir, args.limit)
    print('images:', len(images))
    mean, std = scorer.score_images(images, args.splits)
    print('IS: %.4f +- %.4f' % (mean, std))

    if args.fid_stats:
        from fid_torch import make_scorer
        fs = make_scorer(args.pb, device=args.device)
        print('FID: %.4f' % fs.fid_against_stats(np.stack(images),
                                                 args.fid_stats))


if __name__ == '__main__':
    main()
