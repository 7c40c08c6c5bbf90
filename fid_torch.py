#!/usr/bin/env python
"""FID between two paths (image directories or .npz statistics), PyTorch
port.

Counterpart of fid.py (reference fid.py:238-250):

    python fid_torch.py path_generated path_real_or_npz \
        [--pb classify_image_graph_def.pb] [--device cuda]

Each path is an image directory or a precomputed .npz with mu / sigma
(reference fid.py:208-219). Activations run on the device through the
port's InceptionV3; the matrix square root runs on the host with scipy, as
the reference computes it. --save_stats writes the first path's statistics
to an .npz and exits.

Numbers comparable with the reference's REQUIRE the frozen 2015 graph
(--pb or $T2I_FID_PB), which is not in the repository: the scorer then
takes its converted weights and its exact semantics (mixed_10 max pool,
legacy bilinear resize, (x-128)/128). Without it the tower has seeded
random weights in that same flavor (1,008 classes), the tower direct
evaluation falls back to, and FID is relative only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _handle_path(path: str, scorer):
    from text2img_ekl_tpu_torch.eval.fid import load_statistics
    if path.endswith('.npz'):
        return load_statistics(path)
    from inception_score_torch import load_images
    images = load_images(path)
    if not images:
        raise RuntimeError('no images under %s' % path)
    return scorer.statistics(np.stack(images), uint8=True)


def make_scorer(pb_path: str, batch_size: int = 50, device='cuda'):
    """FIDScorer from the frozen graph when there is one, else random
    weights with a loud warning and where to get the graph (the reference
    downloads the tarball, fid.py:190-206; this package never does)."""
    from text2img_ekl_tpu_torch.eval.convert_tf import (FROZEN_PB_NAME,
                                                        FROZEN_PB_URL)
    from text2img_ekl_tpu_torch.eval.fid import FIDScorer
    from text2img_ekl_tpu_torch.io_utils.weights import (
        RANDOM_INCEPTION_SEED, random_inception)

    if pb_path and (os.path.exists(pb_path) or
                    os.path.exists(os.path.join(pb_path, FROZEN_PB_NAME))):
        if os.path.isdir(pb_path):
            pb_path = os.path.join(pb_path, FROZEN_PB_NAME)
        print('FID inception weights: %s' % pb_path)
        return FIDScorer.from_frozen_pb(pb_path, batch_size, device=device)
    print('!! inception weights are RANDOM - FID is relative-only.\n'
          '   For reference-comparable FID download %s\n'
          '   and pass --pb path/to/%s (or set $T2I_FID_PB).'
          % (FROZEN_PB_URL, FROZEN_PB_NAME))
    return FIDScorer(random_inception(RANDOM_INCEPTION_SEED, 1008, 'fid'),
                     1008, batch_size=batch_size, flavor='fid',
                     device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('path', nargs=2,
                    help='image dirs or .npz statistics files')
    ap.add_argument('--pb', default=os.environ.get('T2I_FID_PB', ''),
                    help='classify_image_graph_def.pb (file or its dir); '
                         'defaults to $T2I_FID_PB')
    ap.add_argument('--batch', type=int, default=50)
    ap.add_argument('--save_stats', default='',
                    help='save first path stats to this .npz and exit')
    ap.add_argument('--device', default='cuda',
                    help="torch device, e.g. 'cuda' or 'cpu'")
    args = ap.parse_args(argv)

    from text2img_ekl_tpu_torch.eval.fid import calculate_frechet_distance

    scorer = make_scorer(args.pb, args.batch, args.device)
    mu1, s1 = _handle_path(args.path[0], scorer)
    if args.save_stats:
        np.savez(args.save_stats, mu=mu1, sigma=s1)
        print('saved stats to', args.save_stats)
        return
    mu2, s2 = _handle_path(args.path[1], scorer)
    print('FID:', calculate_frechet_distance(mu1, s1, mu2, s2))


if __name__ == '__main__':
    main()
