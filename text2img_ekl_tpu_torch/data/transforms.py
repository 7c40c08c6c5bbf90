"""Host-side image transforms of the PyTorch port.

The port's own copy of ``text2img_ekl_tpu/data/transforms.py``: numpy/PIL
equivalents of the reference's torchvision pipeline.

  * ``bbox_crop``   — CUB square crop: 0.75*max-side box around the bbox
                      center, clamped to the image (datasets.py:47-55).
  * train transform — Scale(imsize*76/64) + RandomCrop(imsize) +
                      RandomHorizontalFlip (main.py:111-114).
  * pyramid         — per-branch Scale(imsize[i]) + ToTensor +
                      Normalize(0.5, 0.5): [-1, 1] float (datasets.py:61-67,
                      190-192), or raw uint8 that the train step normalises
                      on the device.

All randomness is explicit through a ``numpy.random.Generator`` so the input
pipeline is reproducible.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
from PIL import Image


def bbox_crop(img: Image.Image, bbox: Sequence[float]) -> Image.Image:
    """Square crop around the bbox center (reference: datasets.py:47-55).

    bbox = [x_left, y_top, width, height].
    """
    width, height = img.size
    r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
    center_x = int((2 * bbox[0] + bbox[2]) / 2)
    center_y = int((2 * bbox[1] + bbox[3]) / 2)
    y1 = int(np.maximum(0, center_y - r))
    y2 = int(np.minimum(height, center_y + r))
    x1 = int(np.maximum(0, center_x - r))
    x2 = int(np.minimum(width, center_x + r))
    return img.crop([x1, y1, x2, y2])


def scale_shorter_side(img: Image.Image, size: int) -> Image.Image:
    """torchvision.transforms.Scale: resize shorter side to ``size``
    keeping aspect ratio (no-op semantics preserved: the longer side
    scales proportionally)."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        return img.resize((size, int(size * h / w)), Image.BILINEAR)
    return img.resize((int(size * w / h), size), Image.BILINEAR)


def random_crop(img: Image.Image, size: int,
                rng: np.random.Generator) -> Image.Image:
    w, h = img.size
    if w == size and h == size:
        return img
    if w < size or h < size:  # pad-free fallback: upscale then crop
        img = img.resize((max(w, size), max(h, size)), Image.BILINEAR)
        w, h = img.size
    x = int(rng.integers(0, w - size + 1))
    y = int(rng.integers(0, h - size + 1))
    return img.crop((x, y, x + size, y + size))


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    x = max(0, (w - size) // 2)
    y = max(0, (h - size) // 2)
    return img.crop((x, y, x + size, y + size))


def build_train_transform(imsize: int):
    """Scale(76/64 oversize) + RandomCrop + RandomHorizontalFlip
    (main.py:111-114)."""
    oversize = int(imsize * 76 / 64)

    def transform(img: Image.Image, rng: np.random.Generator) -> Image.Image:
        img = scale_shorter_side(img, oversize)
        img = random_crop(img, imsize, rng)
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return img

    return transform


def build_eval_transform(imsize: int):
    """Deterministic Scale + center crop for sampling/eval."""
    oversize = int(imsize * 76 / 64)

    def transform(img: Image.Image, rng=None) -> Image.Image:
        img = scale_shorter_side(img, oversize)
        return center_crop(img, imsize)

    return transform


def normalize_to_pm1(img: Image.Image) -> np.ndarray:
    """HWC uint8 -> float32 in [-1, 1] (Normalize((0.5,)*3, (0.5,)*3))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def multiscale_pyramid(img: Image.Image, sizes: Sequence[int],
                       as_uint8: bool = False) -> List[np.ndarray]:
    """Per-branch resize + normalize (datasets.py:61-67): branches below the
    top are Scale'd down; the top branch is the transformed image itself.

    ``as_uint8`` keeps raw HWC uint8 pixels — the train step normalizes
    on-device (x/127.5-1, bit-identical to ``normalize_to_pm1`` since
    2/255 == 1/127.5), at 4x less host memory/H2D traffic."""
    out = []
    for i, s in enumerate(sizes):
        if i < len(sizes) - 1:
            re_img = scale_shorter_side(img, s)
        else:
            re_img = img
        out.append(np.asarray(re_img, dtype=np.uint8) if as_uint8
                   else normalize_to_pm1(re_img))
    return out
