"""Frechet Inception Distance: pool_3 activations on the device, the
matrix square root on the host.

Counterpart of ``text2img_ekl_tpu/eval/fid.py`` and of the reference's
fid.py: the activations (fid.py:68-103) come from the port's InceptionV3 on
the images' device; mu and sigma, and the matrix square root, are computed
on the host with numpy and scipy as the reference computes them
(fid.py:105-187), with its eps jitter on singular covariances and its
guard on imaginary components.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np
import torch

from ..models.inception_v3 import (make_inception, preprocess_frozen,
                                   preprocess_uint8)
from .inception_score import InceptionScorer, nhwc_uint8_to_nchw

#: the activations FID statistics are taken over
POOL3_DIM = 2048


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy's ``linalg.sqrtm``, without its error estimate (its ``disp``
    argument is deprecated, and gone after scipy 1.17)."""
    from scipy import linalg
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        try:
            return linalg.sqrtm(m, disp=False)[0]
        except TypeError:
            return linalg.sqrtm(m)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) (fid.py:105-160)."""
    mu1 = np.atleast_1d(np.asarray(mu1))
    mu2 = np.atleast_1d(np.asarray(mu2))
    sigma1 = np.atleast_2d(np.asarray(sigma1))
    sigma2 = np.atleast_2d(np.asarray(sigma2))
    assert mu1.shape == mu2.shape
    assert sigma1.shape == sigma2.shape

    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError('Imaginary component {}'.format(m))
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_activation_statistics(
        activations: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """mu, sigma over pool_3 activations (fid.py:162-187)."""
    act = np.asarray(activations)
    mu = np.mean(act, axis=0)
    sigma = np.cov(act, rowvar=False)
    return mu, sigma


def load_statistics(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a statistics .npz (fid.py:208-219), checked: mu
    [2048] and sigma [2048, 2048], finite."""
    with np.load(path) as f:
        missing = {'mu', 'sigma'} - set(f.files)
        if missing:
            raise ValueError('%s lacks %s (it holds %s)'
                             % (path, sorted(missing), sorted(f.files)))
        mu, sigma = f['mu'][:], f['sigma'][:]
    if mu.shape != (POOL3_DIM,) or sigma.shape != (POOL3_DIM, POOL3_DIM):
        raise ValueError('%s: mu %s and sigma %s, want [%d] and [%d, %d]'
                         % (path, list(mu.shape), list(sigma.shape),
                            POOL3_DIM, POOL3_DIM, POOL3_DIM))
    if not (np.isfinite(mu).all() and np.isfinite(sigma).all()):
        raise ValueError('%s holds non-finite statistics' % path)
    return mu, sigma


class FIDScorer:
    """pool_3 activations and FID.

    ``flavor='fid'`` selects the frozen-2015-graph tower (the mixed_10 max
    pool quirk) AND its input chain, legacy TF1 bilinear resize then
    (x-128)/128, with which reference FID numbers are computed (fid.py:95
    feeds 0..255 at 'ExpandDims:0'). Build ``variables`` with
    ``convert_tf.frozen_pb_to_inception``, or use ``from_frozen_pb``.
    """

    #: activation rows held on the device before they spill to the host,
    #: the bound InceptionScorer.SPILL_AFTER gives (a 30k-image protocol
    #: would otherwise hold ~245 MB of activations)
    SPILL_AFTER = 25000

    def __init__(self, variables, num_classes: int = 1000,
                 batch_size: int = 50, flavor: str = 'slim', device='cuda'):
        self.device = torch.device(device)
        self.model = make_inception(num_classes, flavor)
        self.model.load_state_dict(variables, strict=True)
        self.model.to(self.device).eval().requires_grad_(False)
        self.batch_size = batch_size
        self.frozen_input = flavor == 'fid'
        self._act_rows: List[object] = []  # [B, 2048], device until spilled

    @torch.no_grad()
    def _pool3(self, images: torch.Tensor) -> torch.Tensor:
        """NCHW 0..255 images (any type) on the device -> [B, 2048]."""
        x = (preprocess_frozen(images) if self.frozen_input
             else preprocess_uint8(images))
        _, ep = self.model(x)
        return ep['pool_3']

    def add_uint8_row(self, images_cb: torch.Tensor, si: int) -> None:
        """Accumulate the activations of caption row ``si`` of a
        device-resident [C, B, H, W, 3] uint8 stack, without a host fetch
        (TPU_EVAL_DIRECT; the reference dumps PNGs and reloads them before
        FID, fid.py:208-219)."""
        self._act_rows.append(self._pool3(nhwc_uint8_to_nchw(
            images_cb[si])))
        n_dev = sum(a.shape[0] for a in self._act_rows
                    if isinstance(a, torch.Tensor))
        if n_dev >= self.SPILL_AFTER:
            self._act_rows = [InceptionScorer._to_host(a)
                              for a in self._act_rows]

    def accumulated_statistics(self, reset: bool = True):
        """(mu, sigma) over every row queued by ``add_uint8_row``."""
        acts = np.concatenate([InceptionScorer._to_host(a)
                               for a in self._act_rows], 0)
        if reset:
            self._act_rows = []
        return calculate_activation_statistics(acts)

    def accumulated_fid_against_stats(self, stats_npz_path: str,
                                      reset: bool = True) -> float:
        mu_ref, sigma_ref = load_statistics(stats_npz_path)
        mu, sigma = self.accumulated_statistics(reset)
        return calculate_frechet_distance(mu, sigma, mu_ref, sigma_ref)

    @classmethod
    def from_frozen_pb(cls, pb_path: str, batch_size: int = 50,
                       device='cuda'):
        """The reference's scorer: the weights and semantics of
        classify_image_graph_def.pb (fid.py:35-66)."""
        from .convert_tf import frozen_pb_to_inception
        variables, n = frozen_pb_to_inception(pb_path)
        return cls(variables, n, batch_size, flavor='fid', device=device)

    def activations_uint8(self, images) -> np.ndarray:
        """images: NHWC uint8 [0, 255] -> [N, 2048] activations."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            batch = nhwc_uint8_to_nchw(
                np.asarray(images[i:i + self.batch_size]))
            outs.append(InceptionScorer._to_host(
                self._pool3(batch.to(self.device))))
        return np.concatenate(outs, 0)

    def activations_gan(self, images) -> np.ndarray:
        """images: NCHW in [-1, 1] (the generator's output; a tensor or an
        array), mapped to the 0..255 domain the reference feeds FID with
        (its eval dumps PNGs and reloads them, fid.py:208-219; the
        quantisation is negligible)."""
        outs = []
        for i in range(0, len(images), self.batch_size):
            batch = torch.as_tensor(images[i:i + self.batch_size])
            batch = (batch.to(self.device).float() + 1.0) * 127.5
            outs.append(InceptionScorer._to_host(self._pool3(batch)))
        return np.concatenate(outs, 0)

    def statistics(self, images, uint8: bool = True):
        act = self.activations_uint8(images) if uint8 \
            else self.activations_gan(images)
        return calculate_activation_statistics(act)

    def fid_between(self, images1, images2, uint8: bool = True) -> float:
        mu1, s1 = self.statistics(images1, uint8)
        mu2, s2 = self.statistics(images2, uint8)
        return calculate_frechet_distance(mu1, s1, mu2, s2)

    def fid_against_stats(self, images, stats_npz_path: str,
                          uint8: bool = True) -> float:
        """Against precomputed .npz statistics (fid.py:208-219)."""
        mu_ref, sigma_ref = load_statistics(stats_npz_path)
        mu, sigma = self.statistics(images, uint8)
        return calculate_frechet_distance(mu, sigma, mu_ref, sigma_ref)
