"""Inception Score on the device that made the images.

Counterpart of ``text2img_ekl_tpu/eval/inception_score.py``: the
reference's TF1 session round trip (inception_score.py; the per-step hand
off at cub_trainer_splitz_cap_ca.py:613-623) becomes a forward of the
port's InceptionV3 on the generator's device, for both IS flavors:

- fine-tuned: the 50+1-class CUB / flowers checkpoint; the background
  logit is dropped before the softmax (inception_score.py:242);
- general: ImageNet classes, the frozen 2015 graph flavor
  (inception_score_general.py) with its input chain.

The split-KL score is cub_trainer_splitz_cap_ca.py:87-98 /
inception_score.py:117-160, in numpy.

Layouts: the generator's [-1, 1] images are NCHW (its output); uint8
images are NHWC (image files, the sampler's [C, B, H, W, 3] stacks).
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..models.inception_v3 import (make_inception, preprocess_frozen,
                                   preprocess_gan_output, preprocess_uint8)


def compute_inception_score(predictions: np.ndarray,
                            num_splits: int = 1) -> Tuple[float, float]:
    """exp of the mean split KL (cub_trainer_splitz_cap_ca.py:87-98)."""
    scores = []
    n = predictions.shape[0]
    for i in range(num_splits):
        part = predictions[i * n // num_splits:(i + 1) * n // num_splits, :]
        kl = part * (np.log(part) -
                     np.log(np.expand_dims(np.mean(part, 0), 0)))
        kl = np.mean(np.sum(kl, 1))
        scores.append(np.exp(kl))
    return float(np.mean(scores)), float(np.std(scores))


def negative_log_posterior_probability(predictions: np.ndarray,
                                       num_splits: int = 1):
    """-log max-prob diagnostic (cub_trainer_splitz_cap_ca.py:100-110)."""
    scores = []
    n = predictions.shape[0]
    for i in range(num_splits):
        part = predictions[i * n // num_splits:(i + 1) * n // num_splits, :]
        scores.append(float(np.mean(-1.0 * np.log(np.max(part, 1)))))
    return float(np.mean(scores)), float(np.std(scores))


def nhwc_uint8_to_nchw(images) -> torch.Tensor:
    """[N, H, W, 3] pixels (numpy or a tensor) -> an NCHW tensor."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    return images.permute(0, 3, 1, 2)


class InceptionScorer:
    """Accumulate prediction batches on the device, then score.

    ``variables`` is the tower's state_dict (``io_utils.weights.
    random_inception``, ``inception_from_flax`` or a converter).
    ``finetuned`` drops the background class before the softmax. ``dtype``
    torch.bfloat16 builds a bf16 tower, for the in-training relative gate;
    offline scoring stays float32.
    """

    #: prediction rows held on the device before they spill to the host
    #: (25k x 1008 float32 ~ 100 MB; the training gate scores at 3000 and
    #: never spills; this bounds device memory if score() waits long)
    SPILL_AFTER = 25000

    def __init__(self, variables, num_classes: int = 51,
                 finetuned: bool = True, batch_size: int = 64,
                 flavor: str = 'slim', dtype: Optional[torch.dtype] = None,
                 device='cuda'):
        self.device = torch.device(device)
        self.model = make_inception(num_classes, flavor,
                                    dtype=dtype or torch.float32)
        self.model.load_state_dict(variables, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.finetuned = finetuned
        self.batch_size = batch_size
        self.frozen_input = flavor == 'fid'
        self.predictions: List[Any] = []  # device tensors until score()
        self._rows = 0

    @staticmethod
    def _to_host(p) -> np.ndarray:
        """Host rows of a prediction tensor (or of rows already spilled):
        the one place where the scorers' rows leave the device. Single
        process; the JAX package's gathers a multi-host array's local
        shards here (ROADMAP M13)."""
        if isinstance(p, torch.Tensor):
            return p.detach().cpu().numpy()
        return np.asarray(p)

    @classmethod
    def from_frozen_pb(cls, pb_path: str, batch_size: int = 64,
                       dtype: Optional[torch.dtype] = None, device='cuda'):
        """General-IS scorer off classify_image_graph_def.pb: the weights
        AND input chain of inception_score_general.py (1008-way softmax, no
        background slice, no logits bias)."""
        from .convert_tf import frozen_pb_to_inception
        variables, n = frozen_pb_to_inception(pb_path)
        return cls(variables, n, finetuned=False, batch_size=batch_size,
                   flavor='fid', dtype=dtype, device=device)

    def _softmax(self, x: torch.Tensor) -> torch.Tensor:
        logits, _ = self.model(x)
        if self.finetuned:
            logits = logits[:, 1:]  # drop the background class
        return torch.softmax(logits, dim=-1)

    @torch.no_grad()
    def predict_batch(self, images: torch.Tensor) -> torch.Tensor:
        """images: NCHW in [-1, 1] (the generator's output), on the
        scorer's device."""
        if self.frozen_input:
            # the frozen graph's semantics: 0..255 input, legacy resize,
            # (x - 128) / 128 (inception_score_general.py:78-99)
            x = preprocess_frozen((images.float() + 1.0) * 127.5)
        else:
            x = preprocess_gan_output(images)
        return self._softmax(x)

    @torch.no_grad()
    def predict_uint8(self, images) -> torch.Tensor:
        """images: NHWC uint8 [0, 255] (the directory path), numpy or a
        tensor."""
        x = nhwc_uint8_to_nchw(images).to(self.device)
        x = (preprocess_frozen(x) if self.frozen_input
             else preprocess_uint8(x))
        return self._softmax(x)

    def add(self, images: torch.Tensor) -> None:
        """Queue one prediction batch of generator output WITHOUT a host
        sync: the [B, C] probabilities stay on the device until score(),
        so the gate never drains the training pipeline. Past SPILL_AFTER
        queued rows, every row moves to the host in one go."""
        self._queue(self.predict_batch(images))

    def add_uint8_row(self, images_cb: torch.Tensor, si: int) -> None:
        """Queue the predictions of caption row ``si`` of a device-resident
        [C, B, H, W, 3] uint8 stack, without a host fetch (TPU_EVAL_DIRECT:
        the sampler's stacks are scored in place, skipping the reference's
        PNG round trip, is_of_dir.py / cub_trainer_splitz_cap_ca.py:
        776-911)."""
        self._queue(self.predict_uint8(images_cb[si]))

    def _queue(self, p) -> None:
        self.predictions.append(p)
        self._rows += p.shape[0]
        n_dev = sum(q.shape[0] for q in self.predictions
                    if isinstance(q, torch.Tensor))
        if n_dev >= self.SPILL_AFTER:
            self.predictions = [self._to_host(q) for q in self.predictions]

    @property
    def count(self) -> int:
        """Rows accumulated since the last reset."""
        return self._rows

    def score(self, num_splits: int = 1,
              reset: bool = True) -> Tuple[float, float]:
        preds = np.concatenate(
            [self._to_host(p) for p in self.predictions], 0)
        if reset:
            self.predictions = []
            self._rows = 0
        return compute_inception_score(preds, num_splits)

    def score_images(self, images,
                     num_splits: int = 10) -> Tuple[float, float]:
        """Directory path: uint8 NHWC images -> IS
        (inception_score.py:117-160)."""
        preds = []
        for i in range(0, len(images), self.batch_size):
            batch = np.asarray(images[i:i + self.batch_size])
            preds.append(self._to_host(self.predict_uint8(batch)))
        return compute_inception_score(np.concatenate(preds, 0), num_splits)
