"""Datasets of the PyTorch port: CUB/flowers text-to-image pairs.

The port's own copy of ``text2img_ekl_tpu/data/datasets.py``
(reference datasets.py:186-373):

  * pickle loaders for filenames / char-CNN-RNN embeddings (N x 10 x 1024) /
    class ids (datasets.py:261-292),
  * CUB bounding-box square crops (datasets.py:219-241, 47-55),
  * training pairs: multi-scale real pyramid, a "wrong" image from a random
    other index, one random caption embedding of the 10, the class label
    (datasets.py:294-346); COCO labels become (ENTITY_DIM+1) multi-hots,
  * test pairs: pyramid + all 10 embeddings + class id + key
    (datasets.py:349-366).

Items are numpy NHWC float32 in [-1, 1], or uint8 pixels with
``uint8_output`` (quantised by ``io_utils.images.pm1_to_uint8``). A
``SyntheticTextDataset`` with the same item contract is a deterministic
stand-in when no dataset exists on disk. Images decode with PIL; the
JAX package's native C++ decoder and its LSUN and ImageFolder datasets are
not ported (ROADMAP.md M9, M12).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List

import numpy as np
from PIL import Image, ImageFile

from ..io_utils.images import pm1_to_uint8
from . import transforms as T

# tolerate truncated files like the reference (datasets.py:32-33)
ImageFile.LOAD_TRUNCATED_IMAGES = True


def _load_pickle(path: str):
    with open(path, 'rb') as f:
        return pickle.load(f, encoding='latin1')


class TextDataset:
    """CUB / Oxford-102 / COCO dataset of (image pyramid, caption embedding,
    class) tuples."""

    def __init__(self, data_dir: str, split: str = 'train',
                 embedding_type: str = 'cnn-rnn', base_size: int = 64,
                 branch_num: int = 2, entity_dim: int = 200,
                 train_pairs: bool = True, transform=None, seed: int = 0,
                 uint8_output: bool = False):
        self.data_dir = data_dir
        self.branch_num = branch_num
        self.entity_dim = entity_dim
        self.train_pairs = train_pairs
        self.imsize = [base_size * (2 ** i) for i in range(branch_num)]
        self.transform = transform or T.build_train_transform(self.imsize[-1])
        self.is_coco = data_dir.rstrip('/').endswith('coco')
        self.rng = np.random.default_rng(seed)
        # raw uint8 pyramids; the train step normalizes on the device
        # (cfg.TPU_UINT8_INPUT: 4x less host bandwidth and H2D transfer)
        self.uint8_output = uint8_output

        self.bbox = self._load_bbox() if 'birds' in data_dir else None
        split_dir = os.path.join(data_dir, split)
        self.filenames = self._load_filenames(split_dir)
        self.embeddings = self._load_embedding(split_dir, embedding_type)
        self.class_id = self._load_class_id(split_dir, len(self.filenames))

    # -- loaders (datasets.py:219-292) ---------------------------------
    def _load_bbox(self) -> Dict[str, List[float]]:
        bbox_path = os.path.join(self.data_dir,
                                 'CUB_200_2011/bounding_boxes.txt')
        images_path = os.path.join(self.data_dir, 'CUB_200_2011/images.txt')
        filename_bbox = {}
        with open(images_path) as f:
            names = [line.split()[1] for line in f if line.strip()]
        with open(bbox_path) as f:
            for i, line in enumerate(f):
                parts = line.split()
                if not parts:
                    continue
                bbox = [int(float(v)) for v in parts[1:5]]
                filename_bbox[names[i][:-4]] = bbox
        return filename_bbox

    def _load_filenames(self, split_dir: str) -> List[str]:
        return list(_load_pickle(os.path.join(split_dir, 'filenames.pickle')))

    def _load_embedding(self, split_dir: str, embedding_type: str) -> np.ndarray:
        names = {
            'cnn-rnn': 'char-CNN-RNN-embeddings.pickle',
            'cnn-gru': 'char-CNN-GRU-embeddings.pickle',
            'skip-thought': 'skip-thought-embeddings.pickle',
        }
        emb = _load_pickle(os.path.join(split_dir, names[embedding_type]))
        return np.asarray(emb, dtype=np.float32)

    def _load_class_id(self, split_dir: str, total: int):
        path = os.path.join(split_dir, 'class_info.pickle')
        if os.path.isfile(path):
            return _load_pickle(path)
        return np.arange(total)

    # -- image IO -------------------------------------------------------
    def _image_path(self, key: str) -> str:
        if self.bbox is not None:
            return '%s/CUB_200_2011/images/%s.jpg' % (self.data_dir, key)
        if self.is_coco and self.train_pairs:
            # COCO train pairs load from DATA_DIR/train2014
            # (reference datasets.py:299-303); TEST pairs load from the
            # DATA_DIR root — prepair_test_pairs has no coco branch
            # (datasets.py:349-360) — so eval images must be placed/linked
            # there, exactly as the reference requires.
            return '%s/train2014/%s.jpg' % (self.data_dir, key)
        return '%s/%s.jpg' % (self.data_dir, key)

    def _get_pyramid(self, key: str, rng) -> List[np.ndarray]:
        img = Image.open(self._image_path(key)).convert('RGB')
        if self.bbox is not None:
            img = T.bbox_crop(img, self.bbox[key])
        img = self.transform(img, rng)
        return T.multiscale_pyramid(img, self.imsize,
                                    as_uint8=self.uint8_output)

    # -- item assembly (datasets.py:294-366) ---------------------------
    def _class_vector(self, index: int):
        """CUB/flowers: scalar id; COCO: (entity_dim+1) multi-hot."""
        if self.is_coco:
            key = self.filenames[index]
            img_id = int(key.split('_')[-1])
            clses = np.zeros(self.entity_dim + 1, np.float32)
            ids = self.class_id[img_id]
            if not ids:
                clses[-1] = 1
            else:
                for c in ids:
                    clses[c - 1] = 1
            return clses
        return np.int64(self.class_id[index])

    def training_pair(self, index: int, rng=None) -> Dict[str, Any]:
        rng = rng or self.rng
        key = self.filenames[index]
        imgs = self._get_pyramid(key, rng)

        wrong_ix = int(rng.integers(0, len(self.filenames)))
        if wrong_ix == index:
            wrong_ix = int(rng.integers(0, len(self.filenames)))
        wrong_imgs = self._get_pyramid(self.filenames[wrong_ix], rng)

        cap_ix = int(rng.integers(0, self.embeddings.shape[1]))
        embedding = self.embeddings[index, cap_ix, :]
        return {
            'imgs': imgs, 'wrong_imgs': wrong_imgs, 'embedding': embedding,
            'cls': self._class_vector(index), 'key': key,
        }

    def test_pair(self, index: int, rng=None) -> Dict[str, Any]:
        rng = rng or self.rng
        key = self.filenames[index]
        imgs = self._get_pyramid(key, rng)
        return {
            'imgs': imgs, 'embeddings': self.embeddings[index],
            'cls': np.int64(self.class_id[index]) if not self.is_coco
            else self._class_vector(index),
            'key': key,
        }

    def item(self, index: int, rng) -> Dict[str, Any]:
        """Thread-safe fetch: all randomness comes from the CALLER's
        generator (the loader hands each item its own deterministic
        rng — the shared self.rng is not thread-safe under the decode
        pool and would yield correlated crops / nondeterministic
        epochs)."""
        if self.train_pairs:
            return self.training_pair(index, rng)
        return self.test_pair(index, rng)

    def __getitem__(self, index: int):
        if self.train_pairs:
            return self.training_pair(index)
        return self.test_pair(index)

    def __len__(self):
        return len(self.filenames)


class SyntheticTextDataset:
    """Deterministic synthetic stand-in with TextDataset's item contract.

    Images are class-conditioned colored gradients + noise so a GAN can
    actually learn structure from them; embeddings are fixed random unit
    vectors per (item, caption).
    """

    def __init__(self, num_items: int = 512, base_size: int = 64,
                 branch_num: int = 2, entity_dim: int = 200,
                 text_dim: int = 1024, num_captions: int = 10,
                 is_coco: bool = False, train_pairs: bool = True,
                 seed: int = 0, uint8_output: bool = False):
        self.uint8_output = uint8_output
        self.num_items = num_items
        self.imsize = [base_size * (2 ** i) for i in range(branch_num)]
        self.entity_dim = entity_dim
        self.is_coco = is_coco
        self.train_pairs = train_pairs
        rng = np.random.default_rng(seed)
        self.embeddings = rng.standard_normal(
            (num_items, num_captions, text_dim)).astype(np.float32)
        self.embeddings /= np.linalg.norm(self.embeddings, axis=-1,
                                          keepdims=True)
        self.class_id = (rng.integers(0, entity_dim, num_items) + 1)
        self.filenames = ['synthetic/%06d' % i for i in range(num_items)]
        self.rng = np.random.default_rng(seed + 1)

    def _image(self, index: int, size: int) -> np.ndarray:
        cls = int(self.class_id[index])
        rng = np.random.default_rng(index)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        base = np.stack([
            np.sin(2 * np.pi * (cls % 7 + 1) * xx),
            np.cos(2 * np.pi * (cls % 5 + 1) * yy),
            np.sin(2 * np.pi * (cls % 3 + 1) * (xx + yy)),
        ], axis=-1)
        noise = rng.standard_normal((size, size, 3)).astype(np.float32) * 0.1
        return np.clip(base * 0.8 + noise, -1, 1).astype(np.float32)

    def _pyramid(self, index: int) -> List[np.ndarray]:
        imgs = [self._image(index, s) for s in self.imsize]
        if self.uint8_output:
            imgs = [pm1_to_uint8(im) for im in imgs]
        return imgs

    def _class_vector(self, index: int):
        if self.is_coco:
            clses = np.zeros(self.entity_dim + 1, np.float32)
            clses[int(self.class_id[index]) - 1] = 1
            return clses
        return np.int64(self.class_id[index])

    def training_pair(self, index: int, rng=None):
        rng = rng or self.rng
        wrong_ix = int(rng.integers(0, self.num_items))
        cap_ix = int(rng.integers(0, self.embeddings.shape[1]))
        return {
            'imgs': self._pyramid(index),
            'wrong_imgs': self._pyramid(wrong_ix),
            'embedding': self.embeddings[index, cap_ix],
            'cls': self._class_vector(index),
            'key': self.filenames[index],
        }

    def test_pair(self, index: int, rng=None):
        return {
            'imgs': self._pyramid(index),
            'embeddings': self.embeddings[index],
            'cls': self._class_vector(index),
            'key': self.filenames[index],
        }

    def item(self, index: int, rng):
        if self.train_pairs:
            return self.training_pair(index, rng)
        return self.test_pair(index, rng)

    def __getitem__(self, index: int):
        if self.train_pairs:
            return self.training_pair(index)
        return self.test_pair(index)

    def __len__(self):
        return self.num_items
