"""GAN loss functions, PyTorch.

Counterpart of ``text2img_ekl_tpu/train/losses.py``:

  * ``bce``      — torch nn.BCELoss over probabilities (the D heads emit
                   sigmoids; criterion at cub_trainer_splitz_cap_ca.py:512),
                   mean reduction, with the JAX package's semantics: inputs
                   clamped to [0, 1], log clamped to -100 below 1.2e-38
                   with zero gradient there. ``nn.BCELoss`` is not used: it
                   raises or asserts on input outside [0, 1], which a
                   probability one ulp above 1 is.
  * ``ce_loss``  — soft-target cross entropy over log-probabilities,
                   normalized by batch only (cub_trainer_splitz_cap_ca.py:60-65).
  * ``kl_loss``  — -0.5 * mean(1 + logvar - mu^2 - exp(logvar)), mean over
                   *all* elements (cub_trainer_splitz_cap_ca.py:54-58).
  * ``color_consistency_loss`` — StackGAN++'s colour consistency between
                   consecutive stages (trainer.py:29-47).
  * ``nll_loss`` — torch nn.NLLLoss over log-probs + integer targets.

All computed in float32. Images are NCHW here.
"""

from __future__ import annotations

from typing import Sequence

import torch

_LOG_CLAMP = 100.0
# the smallest normal float32: below it the log clamps (see bce)
_TINY = 1.2e-38


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) clamped to >= -100 where x < 1.2e-38, with zero gradient
    there: the clamp region is selected before the log, so a saturated
    input (x == 0) stays finite in both passes."""
    clamped = x < _TINY
    return torch.where(clamped, torch.full_like(x, -_LOG_CLAMP),
                       torch.log(torch.where(clamped, torch.ones_like(x), x)))


def bce(p: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross entropy over probabilities, mean reduction, with the
    -100 log clamp: a fully saturated wrong-way sigmoid contributes exactly
    100 per element on either side."""
    # minimum(maximum(.)) rather than clamp: at exactly 0 or 1 the gradient
    # splits between the tied arguments (halves), as jnp.clip's does
    p = p.float()
    p = torch.minimum(torch.maximum(p, torch.zeros_like(p)),
                      torch.ones_like(p))
    target = target.float()
    return -torch.mean(target * _clamped_log(p)
                       + (1.0 - target) * _clamped_log(1.0 - p))


def ce_loss(logq: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Soft-target CE: -sum(p * logq) / batch."""
    return -torch.sum(p.float() * logq.float()) / p.shape[0]


def kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, sigma) || N(0, 1)) averaged over every element."""
    mu, logvar = mu.float(), logvar.float()
    return -0.5 * torch.mean(1.0 + logvar - mu * mu - torch.exp(logvar))


def compute_mean_covariance(img: torch.Tensor):
    """Per-image channel mean [B, C] and channel covariance [B, C, C] of an
    NCHW image, E[(x-mu)(x-mu)^T] over the H*W pixels (trainer.py:29-47)."""
    img = img.float()
    b, c, h, w = img.shape
    mu = img.mean(dim=(2, 3))
    hat = (img - mu[:, :, None, None]).reshape(b, c, h * w)
    return mu, torch.bmm(hat, hat.transpose(1, 2)) / (h * w)


def color_consistency_loss(imgs: Sequence[torch.Tensor],
                           coeff: float) -> torch.Tensor:
    """coeff * MSE(mu_hi, sg(mu_lo)) + coeff * 5 * MSE(cov_hi, sg(cov_lo))
    over consecutive stage outputs."""
    total = imgs[0].new_zeros((), dtype=torch.float32)
    for lo, hi in zip(imgs[:-1], imgs[1:]):
        mu_lo, cov_lo = compute_mean_covariance(lo.detach())
        mu_hi, cov_hi = compute_mean_covariance(hi)
        total = total + coeff * torch.mean((mu_hi - mu_lo) ** 2)
        total = total + coeff * 5.0 * torch.mean((cov_hi - cov_lo) ** 2)
    return total


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Negative log likelihood with integer class targets, mean reduction."""
    picked = torch.gather(log_probs.float(), 1, targets[:, None].long())[:, 0]
    return -torch.mean(picked)
