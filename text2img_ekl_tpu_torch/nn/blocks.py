"""Generator and discriminator building blocks, PyTorch, NCHW.

Counterpart of ``text2img_ekl_tpu/nn/blocks.py``. Submodules are
``nn.Sequential`` where the reference ``model.py`` has one, so that
``state_dict()`` keys are the reference's: an up block is
``(Upsample, conv, BN, GLU)`` -> ``.1.weight`` / ``.2.*``, a residual
block's ``block`` is ``(conv, BN, GLU, conv, BN)`` -> ``0, 1, 3, 4``, a
down block is ``(conv, BN, LeakyReLU)`` -> ``.0.weight`` / ``.1.*``.

Numerics follow the JAX package: bias-free 3x3 and 4x4 convs and linears
run in the compute ``dtype`` (float32 parameters cast at the call),
BatchNorm normalizes in float32 (eps 1e-5, scale init N(1, 0.02)) with
flax's statistics, GLU and LeakyReLU run on the float32 BN output and cast
back to ``dtype``. Orthogonal init as the reference's ``weights_init``.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


def glu(x: torch.Tensor) -> torch.Tensor:
    """Channel-halving gated linear unit over dim 1: a * sigmoid(b)."""
    nc = x.shape[1]
    if nc % 2:
        raise ValueError("channels dont divide 2!")
    nc //= 2
    return x[:, :nc] * torch.sigmoid(x[:, nc:])


class GLU(nn.Module):
    """``glu`` then a cast to the compute dtype (JAX's ``bn_glu`` tail)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu(x).to(self.dtype)


# Running averages: new = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * batch
# (flax's momentum 0.9, torch's 0.1).
BN_MOMENTUM = 0.9


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 of [B, C] or [B, C, H, W], computed in float32.

    Train mode normalizes with the batch's statistics as flax computes them
    (mean and E[x^2] - mean^2 over every axis but the channel, the biased
    variance, clipped at 0) and folds them into the running statistics as
    flax does: ``new = 0.9 * old + 0.1 * batch``, with the biased variance
    (``F.batch_norm`` would fold in the unbiased one). With
    ``update_running_stats`` False (see ``frozen_running_stats``) it
    normalizes with the batch's statistics and leaves the buffers alone.
    Eval mode normalizes with the running statistics. The module keeps no
    ``num_batches_tracked`` counter: the momentum is fixed, so the counter
    is never read (``io_utils.weights`` drops it from reference files).
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_running_stats = True
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer('running_mean', torch.zeros(num_features))
        self.register_buffer('running_var', torch.ones(num_features))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        nn.init.normal_(self.weight, 1.0, 0.02)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        if self.update_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.detach(), alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.detach(), alpha=1.0 - BN_MOMENTUM)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean.view(shape)) * scale.view(shape) + \
            self.bias.view(shape)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Train-mode forwards inside the block normalize with batch statistics
    but leave every BatchNorm's running statistics as they were (JAX's
    train-mode sampling, whose ``batch_stats`` update is thrown away)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_running_stats = False
    try:
        yield module
    finally:
        for m in bns:
            m.update_running_stats = True


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 pad-1 bias-free conv in the compute dtype."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_planes, out_planes, 3, 1, 1, bias=False)
        self.dtype = dtype
        nn.init.orthogonal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        None, 1, 1)


class Dense(nn.Linear):
    """Linear layer in the compute dtype, orthogonal weight, zero bias."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype
        nn.init.orthogonal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class UpBlock(nn.Sequential):
    """nearest-2x upsample -> conv3x3(2*out) -> BN -> GLU (model.py:87-94)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Upsample(scale_factor=2, mode='nearest'),
                         Conv3x3(in_planes, out_planes * 2, dtype),
                         BatchNorm(out_planes * 2), GLU(dtype))


class Block3x3Relu(nn.Sequential):
    """conv3x3(2*out) -> BN -> GLU, same spatial size (model.py:98-104)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(Conv3x3(in_planes, out_planes * 2, dtype),
                         BatchNorm(out_planes * 2), GLU(dtype))


class ResBlock(nn.Module):
    """conv-BN-GLU-conv-BN + skip (model.py:107-123)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(
            Conv3x3(channels, channels * 2, dtype), BatchNorm(channels * 2),
            GLU(dtype), Conv3x3(channels, channels, dtype),
            BatchNorm(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.block(x) + x.float()).to(self.dtype)


class LeakyReLU(nn.Module):
    """LeakyReLU(0.2), then a cast to the compute dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2).to(self.dtype)


class Conv4x4s2(nn.Conv2d):
    """4x4 stride-2 pad-1 bias-free conv in the compute dtype
    (model.py:822-828)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_planes, out_planes, 4, 2, 1, bias=False)
        self.dtype = dtype
        nn.init.orthogonal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        None, 2, 1)


class Conv4x4s4(nn.Conv2d):
    """4x4 stride-4 valid conv of the D logit heads (model.py:886-888): it
    collapses the 4x4 map to 1x1 and has a bias, with torch Conv2d's
    default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init (the reference's
    weights_init orthogonalizes conv weights only)."""

    def __init__(self, in_planes: int, out_planes: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_planes, out_planes, 4, 4, 0, bias=True)
        self.dtype = dtype
        nn.init.orthogonal_(self.weight)
        bound = 1.0 / math.sqrt(in_planes * 16)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype), 4, 0)


class Block3x3LeakyRelu(nn.Sequential):
    """conv3x3 -> BN -> LeakyReLU(0.2) (model.py:812-818)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(Conv3x3(in_planes, out_planes, dtype),
                         BatchNorm(out_planes), LeakyReLU(dtype))


class DownBlock(nn.Sequential):
    """4x4-s2 conv -> BN -> LeakyReLU(0.2), halves H and W
    (model.py:822-828)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(Conv4x4s2(in_planes, out_planes, dtype),
                         BatchNorm(out_planes), LeakyReLU(dtype))


class EncodeBy16(nn.Sequential):
    """Four stride-2 convs 3 -> ndf -> 2ndf -> 4ndf -> 8ndf, the first
    without BatchNorm (model.py:832-850). Flat like the reference's
    Sequential: convs at 0, 2, 5, 8 and BatchNorms at 3, 6, 9."""

    def __init__(self, ndf: int, dtype: torch.dtype = torch.float32):
        layers = [Conv4x4s2(3, ndf, dtype), LeakyReLU(dtype)]
        for k in (1, 2, 4):
            layers += [Conv4x4s2(ndf * k, ndf * k * 2, dtype),
                       BatchNorm(ndf * k * 2), LeakyReLU(dtype)]
        super().__init__(*layers)
