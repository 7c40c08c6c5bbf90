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
flax's statistics and casts its output to ``bn_dtype`` (the config's
``TPU_BN_DTYPE``, bfloat16 or float32), where flax's ``BatchNorm(dtype=)``
casts it. GLU, LeakyReLU and a residual block's sum then run in the BN
output's type, as JAX promotes them, and cast back to ``dtype``.
Orthogonal init as the reference's ``weights_init``.

Every BatchNorm of rank 4 and the activation after it are one
``BatchNormAct`` in the BN slot and an identity in the activation's slot
(same ``state_dict`` keys): kernel K5 on the card, the eager chain on the
CPU. The rank-2 BatchNorms (the generators' FC stage, the VC net) stay
``BatchNorm`` -> ``GLU``.

Two switches of the JAX package are constructor flags here:
``fused_bn_glu`` (``TPU_FUSED_BN_GLU``) makes every 4-D BN -> GLU tail one
``FusedBatchNormGLU`` (kernel K3), with the same ``state_dict`` keys (the
BN slot holds the fused module, the GLU slot an identity); ``kernel_dw``
(``TPU_PALLAS_DW``) routes a ``Conv3x3``'s weight gradient through kernel
K4 wherever ``dw_supported`` holds for the call's shapes.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import bn_act as bn_act_op
from ..ops import bn_glu as bn_glu_op
from ..ops import conv_dw


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
    """BatchNorm over dim 1 of [B, C] or [B, C, H, W], computed in float32,
    its output cast to ``bn_dtype`` (flax's ``_normalize`` casts its float32
    result last).

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

    def __init__(self, num_features: int, eps: float = 1e-5,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.bn_dtype = bn_dtype
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

    def batch_statistics(self, x: torch.Tensor):
        """flax's float32 mean and E[x^2] - mean^2 (biased, unclipped) over
        every axis but the channel."""
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        mean = xf.mean(dims)
        return mean, (xf * xf).mean(dims) - mean * mean

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold batch statistics into the running ones, unless frozen."""
        if self.update_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean.detach(), alpha=1.0 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var.detach(), alpha=1.0 - BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # ``ops.bn_act.bn_act.eager_calls`` counts the rank-4 BatchNorms on
        # the card that took this eager chain and not kernel K5
        # (``BatchNormAct``); it reads 0 on the default path
        if x.dim() == 4 and x.device.type == 'cuda':
            bn_act_op.bn_act.eager_calls += 1
        xf = x.float()
        if not self.training:
            return F.batch_norm(xf, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(self.bn_dtype)
        mean, var = self.batch_statistics(xf)
        var = torch.clamp(var, min=0.0)
        self.update_running(mean, var)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean.view(shape)) * scale.view(shape) +
                self.bias.view(shape)).to(self.bn_dtype)


class FusedBatchNormGLU(BatchNorm):
    """BatchNorm over dim 1 of [B, 2C, H, W] and the GLU after it as one
    fused pass (``fused_bn_glu``, kernel K3 on the card), the affine in
    ``bn_dtype`` as the JAX module passes its ``BN_DTYPE``, then a cast to
    the compute dtype. Counterpart of the JAX package's ``FusedBatchNormGLU``
    (``text2img_ekl_tpu/nn/blocks.py:143-170``), with ``BatchNorm``'s
    parameters and buffers. Train mode takes flax's float32 statistics,
    mean and E[x^2] - mean^2, unclipped as the JAX fused module takes them,
    and folds them into the running statistics as ``BatchNorm`` does; eval
    mode uses the running statistics."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, bn_dtype=bn_dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self.batch_statistics(x)
            self.update_running(mean, var)
        return bn_glu_op.fused_bn_glu(x.contiguous(), mean, var, self.weight,
                                      self.bias, self.bn_dtype).to(self.dtype)


def bn_glu_tail(planes: int, dtype: torch.dtype, fused: bool,
                bn_dtype: torch.dtype = torch.float32):
    """The (BN, GLU) slots of a block's tail: K3's fused module
    (``fused_bn_glu``) or ``BatchNormAct``, and an identity."""
    if fused:
        return [FusedBatchNormGLU(planes, dtype, bn_dtype), nn.Identity()]
    return bn_act_tail(planes, 'glu', dtype, bn_dtype)


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
    """3x3 stride-1 pad-1 bias-free conv in the compute dtype. With
    ``kernel_dw`` its weight gradient is kernel K4 wherever ``dw_supported``
    holds for the call's shapes, as the JAX package routes
    (``text2img_ekl_tpu/nn/blocks.py:351-354``)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32, kernel_dw: bool = False):
        super().__init__(in_planes, out_planes, 3, 1, 1, bias=False)
        self.dtype = dtype
        self.kernel_dw = kernel_dw
        nn.init.orthogonal_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.kernel_dw and conv_dw.dw_supported(
                x.shape[2], x.shape[3], x.shape[1], self.out_channels):
            return conv_dw.conv3x3_dw(x, self.weight)
        return F.conv2d(x, self.weight.to(self.dtype), None, 1, 1)


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
                 dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__(nn.Upsample(scale_factor=2, mode='nearest'),
                         Conv3x3(in_planes, out_planes * 2, dtype, kernel_dw),
                         *bn_glu_tail(out_planes * 2, dtype, fused_bn_glu,
                                      bn_dtype))


class Block3x3Relu(nn.Sequential):
    """conv3x3(2*out) -> BN -> GLU, same spatial size (model.py:98-104)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__(Conv3x3(in_planes, out_planes * 2, dtype, kernel_dw),
                         *bn_glu_tail(out_planes * 2, dtype, fused_bn_glu,
                                      bn_dtype))


class ResBlock(nn.Module):
    """conv-BN-GLU-conv-BN + skip (model.py:107-123); the skip is added in
    the BN output's type, as JAX adds it."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.block = nn.Sequential(
            Conv3x3(channels, channels * 2, dtype, kernel_dw),
            *bn_glu_tail(channels * 2, dtype, fused_bn_glu, bn_dtype),
            Conv3x3(channels, channels, dtype, kernel_dw),
            BatchNormAct(channels, None, dtype, bn_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.block(x)
        return (out + x.to(out.dtype)).to(self.dtype)


# 0.2 rounded to bfloat16, as JAX's ``0.2 * x`` rounds its weakly typed
# constant on a bfloat16 x
_BF16_SLOPE = float(torch.tensor(0.2, dtype=torch.bfloat16))


class LeakyReLU(nn.Module):
    """LeakyReLU(0.2) in its input's type, then a cast to the compute
    dtype."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x, self.dtype)


def leaky_relu(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """LeakyReLU(0.2) in x's type, then a cast to ``dtype``."""
    slope = _BF16_SLOPE if x.dtype == torch.bfloat16 else 0.2
    return F.leaky_relu(x, slope).to(dtype)


# BatchNormAct's epilogues: (BatchNorm output, compute dtype) -> output, as
# the GLU and LeakyReLU modules compute them
_EPILOGUES = {None: None, 'glu': lambda y, dtype: glu(y).to(dtype),
              'leaky': leaky_relu}


class BatchNormAct(BatchNorm):
    """BatchNorm and the activation after it (``act``: 'glu', 'leaky' or
    None), with ``BatchNorm``'s parameters, buffers and numerics. On a
    CUDA tensor of rank 4 it is kernel K5 (``ops.bn_act``), forward and
    backward, in train mode (``update_running_stats`` honoured) and eval
    mode; on anything else it is the eager chain ``BatchNorm`` -> ``GLU`` /
    ``LeakyReLU`` it replaces (``composition``), bit for bit. The output is
    of the compute ``dtype`` after an activation, of ``bn_dtype`` without
    one."""

    def __init__(self, num_features: int, act=None,
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        if act not in _EPILOGUES:
            raise ValueError('act must be glu, leaky or None, got %r'
                             % (act,))
        super().__init__(num_features, bn_dtype=bn_dtype)
        self.act = act
        self.dtype = dtype

    def composition(self, x: torch.Tensor,
                    epilogue: bool = True) -> torch.Tensor:
        """The eager chain: ``BatchNorm.forward``, then the activation as
        the GLU or LeakyReLU module computes it (cast to ``dtype``)."""
        y = super().forward(x)
        if self.act is None or not epilogue:
            return y
        return _EPILOGUES[self.act](y, self.dtype)

    def forward(self, x: torch.Tensor, epilogue: bool = True) -> torch.Tensor:
        """``epilogue=False`` runs the BatchNorm alone (its output in
        ``bn_dtype``), on the same path."""
        if x.device.type != 'cuda' or x.dim() != 4:
            return self.composition(x, epilogue)
        return bn_act_op.bn_act(x, self.weight, self.bias, self.running_mean,
                                self.running_var, self.training,
                                self.update_running_stats, self.eps,
                                self.act if epilogue else None,
                                self.bn_dtype)


def bn_act_tail(planes: int, act, dtype: torch.dtype,
                bn_dtype: torch.dtype = torch.float32):
    """The (BN, activation) slots of a tail: ``BatchNormAct`` and an
    identity, with the plain pair's ``state_dict`` keys."""
    return [BatchNormAct(planes, act, dtype, bn_dtype), nn.Identity()]


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
                 dtype: torch.dtype = torch.float32, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__(Conv3x3(in_planes, out_planes, dtype, kernel_dw),
                         *bn_act_tail(out_planes, 'leaky', dtype, bn_dtype))


class DownBlock(nn.Sequential):
    """4x4-s2 conv -> BN -> LeakyReLU(0.2), halves H and W
    (model.py:822-828)."""

    def __init__(self, in_planes: int, out_planes: int,
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__(Conv4x4s2(in_planes, out_planes, dtype),
                         *bn_act_tail(out_planes, 'leaky', dtype, bn_dtype))


class EncodeBy16(nn.Sequential):
    """Four stride-2 convs 3 -> ndf -> 2ndf -> 4ndf -> 8ndf, the first
    without BatchNorm (model.py:832-850). Flat like the reference's
    Sequential: convs at 0, 2, 5, 8 and BatchNorms at 3, 6, 9."""

    def __init__(self, ndf: int, dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        layers = [Conv4x4s2(3, ndf, dtype), LeakyReLU(dtype)]
        for k in (1, 2, 4):
            layers += [Conv4x4s2(ndf * k, ndf * k * 2, dtype),
                       *bn_act_tail(ndf * k * 2, 'leaky', dtype, bn_dtype)]
        super().__init__(*layers)
