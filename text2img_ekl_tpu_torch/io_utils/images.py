"""Sample quantisation, image grids and PNG writing.

Counterpart of ``text2img_ekl_tpu/io_utils/images.py``: ``pm1_to_uint8``
(the host twin of ``train.sample.pm1_to_uint8_dev``), the epoch grids of
training (numpy equivalents of torchvision's ``make_grid``/``save_image``,
cub_trainer_splitz_cap_ca.py:231-264) and ``save_single_images`` with the
reference's filename scheme (cub_trainer_splitz_cap_ca.py:758-774), through
the native async PNG writer (``io_utils/native_writer.py``) unless
``T2I_NATIVE_WRITE`` is '0'. Images are NHWC here, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
from PIL import Image

from . import native_writer


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


# why this process writes with PIL although T2I_NATIVE_WRITE is '1'
# (printed once): the native writer could not be built or loaded here
_native_unavailable = None


def save_single_images(images: np.ndarray, filenames: Sequence[str],
                       save_dir: str, sentence_id: int,
                       classes: Sequence[int], imsize: int,
                       noise_id: int) -> None:
    """One PNG per image of ``images`` ([N, H, W, 3] uint8, or floats in
    [-1, 1]) at <save_dir>/single_samples/<key>_<imsize>_class<c>_
    sid<s>_nid<n>.png.

    The encode goes through the native async PNG writer unless
    ``T2I_NATIVE_WRITE`` is '0': callers that read the files back call
    ``flush_writes()`` first. Where the writer cannot be built or loaded
    (``NativeUnavailable``), this says so once and writes with PIL,
    synchronously; any other error of the writer raises.
    """
    global _native_unavailable
    batch = np.asarray(images)
    if batch.dtype != np.uint8:
        batch = pm1_to_uint8(batch)
    paths = []
    for name, c in zip(filenames, classes):
        path = '%s/single_samples/%s_%d_class%d_sid%d_nid%d.png' % (
            save_dir, name, imsize, int(c), sentence_id, noise_id)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        paths.append(path)
    if (os.environ.get('T2I_NATIVE_WRITE', '1') == '1'
            and _native_unavailable is None):
        try:
            native_writer.write_png_batch(batch[:len(paths)], paths)
            return
        except native_writer.NativeUnavailable as e:
            _native_unavailable = e
            print('!! native PNG writer unavailable, writing with PIL: %s'
                  % e)
    for img, path in zip(batch, paths):
        Image.fromarray(img).save(path)


def flush_writes() -> int:
    """Join the async PNG writer; returns the number of failed writes since
    the last flush (0 when the native writer was never used)."""
    return native_writer.flush()
