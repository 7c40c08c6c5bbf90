"""Sample quantisation, image grids and PNG writing.

Counterpart of ``text2img_ekl_tpu/io_utils/images.py``: ``pm1_to_uint8``
(the host twin of ``train.sample.pm1_to_uint8_dev``), the epoch grids of
training (numpy equivalents of torchvision's ``make_grid``/``save_image``,
cub_trainer_splitz_cap_ca.py:231-264) and ``save_single_images`` with the
reference's filename scheme (cub_trainer_splitz_cap_ca.py:758-774). Images
are NHWC here, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image


def pm1_to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8 pixels, truncating as the JAX package
    does. Change together with ``train.sample.pm1_to_uint8_dev``."""
    return np.clip((np.asarray(x, np.float32) + 1.0) * 127.5,
                   0, 255).astype(np.uint8)


def _to_uint8(img: np.ndarray, normalize: bool = True) -> np.ndarray:
    if img.dtype == np.uint8:  # already-quantised pixels (uint8 batches)
        return img
    if normalize:  # min-max over the whole grid, as vutils normalize=True
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    else:
        img = (img + 1.0) / 2.0
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8,
              padding: int = 2) -> np.ndarray:
    """[N, H, W, C] -> one [gh, gw, C] grid, vutils-style."""
    n, h, w, c = images.shape
    ncols = min(nrow, n)
    nrows = (n + ncols - 1) // ncols
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncols * (w + padding) + padding, c), dtype=images.dtype)
    for idx in range(n):
        r, col = divmod(idx, ncols)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = images[idx]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8,
                    normalize: bool = True) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    grid = make_grid(np.asarray(images), nrow)
    Image.fromarray(_to_uint8(grid, normalize)).save(path)


def save_single_images(images: np.ndarray, filenames: Sequence[str],
                       save_dir: str, sentence_id: int,
                       classes: Sequence[int], imsize: int,
                       noise_id: int) -> None:
    """One PNG per image of ``images`` ([N, H, W, 3] uint8, or floats in
    [-1, 1]) at <save_dir>/single_samples/<key>_<imsize>_class<c>_
    sid<s>_nid<n>.png."""
    batch = np.asarray(images)
    if batch.dtype != np.uint8:
        batch = pm1_to_uint8(batch)
    for img, name, c in zip(batch, filenames, classes):
        path = '%s/single_samples/%s_%d_class%d_sid%d_nid%d.png' % (
            save_dir, name, imsize, int(c), sentence_id, noise_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(img).save(path)
