"""Variational conditioning networks, PyTorch.

Counterpart of ``text2img_ekl_tpu/nn/conditioning.py``. ``CANet`` is the
reference CA_NET (model.py:126-157): FC -> GLU -> (mu, logvar) ->
mu + eps * std. ``VCNet`` is VC_NET (model.py:160-201): an MLP over
concat(noise, cond) with BatchNorm'd hidden layers.

The reparameterisation ``eps`` is an argument: a caller that must agree
with another framework passes the draws in; otherwise they come from the
given ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .blocks import BatchNorm, Dense, glu


def _normal_like(t: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(t.shape, generator=generator, device=t.device,
                       dtype=torch.float32)


class CANet(nn.Module):
    """Conditioning augmentation over the sentence embedding."""

    def __init__(self, text_dim: int = 1024, ef_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ef_dim = ef_dim
        self.fc = Dense(text_dim, ef_dim * 4, bias=True, dtype=dtype)

    def forward(self, text_embedding: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = glu(self.fc(text_embedding)).float()
        mu, logvar = x[:, :self.ef_dim], x[:, self.ef_dim:]
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = _normal_like(std, generator)
        return eps * std + mu, mu, logvar, std


class VCNet(nn.Module):
    """Variational conditional-manifold encoder over concat(noise, cond)."""

    def __init__(self, in_dim: int, manifd_dim: int = 128,
                 dtype: torch.dtype = torch.float32,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(in_dim, 512, dtype=dtype)
        self.bn_fc1 = BatchNorm(512, bn_dtype=bn_dtype)
        self.fc2 = Dense(512, 256, dtype=dtype)
        self.bn_fc2 = BatchNorm(256, bn_dtype=bn_dtype)
        self.fc31 = Dense(256, manifd_dim, dtype=dtype)
        self.fc32 = Dense(256, manifd_dim, dtype=dtype)

    def forward(self, noise: torch.Tensor, cond: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = torch.cat([noise.to(self.dtype), cond.to(self.dtype)], dim=1)
        h = torch.relu(self.bn_fc1(self.fc1(x))).to(self.dtype)
        h = torch.relu(self.bn_fc2(self.fc2(h))).to(self.dtype)
        mu = self.fc31(h).float()
        logvar = self.fc32(h).float()
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = _normal_like(std, generator)
        return eps * std + mu, mu, logvar, std
