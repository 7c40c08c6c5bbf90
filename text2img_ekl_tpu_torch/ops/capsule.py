"""Capsule linear layer with routing, plain PyTorch.

Counterpart of ``text2img_ekl_tpu/ops/capsule.py``. With a shared weight
``W [out_capsules, out_length, in_length]`` the votes are
``u[b, i, j, :] = W[j] @ x[b, i, :]``; dynamic routing (routing by
agreement) then iterates a softmax coupling over the *output* capsules,
the weighted vote sum, the squash and the agreement update.

This file is the plain twin of the hand-written routing kernel
(``capsule_cuda.py``): the CPU path and the kernel's parity reference.
"""

from __future__ import annotations

import torch
from torch import nn


def squash(s: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """v = (|s|^2 / (1 + |s|^2)) * s / |s| along ``dim``."""
    s2 = torch.sum(s * s, dim=dim, keepdim=True)
    return s * (s2 / (1.0 + s2) * torch.rsqrt(s2 + eps))


def compute_votes(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x [B, in, in_length], weight [out, out_length, in_length] (shared) or
    [out, in, out_length, in_length] (unshared) -> u [B, in, out, out_length].
    """
    if weight.dim() == 3:
        return torch.einsum('bil,jol->bijo', x, weight)
    return torch.einsum('bil,jiol->bijo', x, weight)


def dynamic_routing(u: torch.Tensor, num_iterations: int = 3) -> torch.Tensor:
    """Routing by agreement over votes u [B, in, out, out_length]."""
    b = u.new_zeros(u.shape[:3])
    v = None
    for r in range(num_iterations):
        c = torch.softmax(b, dim=2)
        s = torch.einsum('bij,bijo->bjo', c, u)
        v = squash(s)
        if r < num_iterations - 1:
            b = b + torch.einsum('bijo,bjo->bij', u, v)
    return v


def k_means_routing(u: torch.Tensor, num_iterations: int = 3,
                    eps: float = 1e-8) -> torch.Tensor:
    """Cosine-similarity routing: the first centroid is the mean vote, the
    couplings are softmaxed cosine similarities of votes and centroids."""
    v = u.mean(dim=1)
    u_n = u * torch.rsqrt(torch.sum(u * u, dim=-1, keepdim=True) + eps)
    for _ in range(num_iterations):
        v_n = v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps)
        sim = torch.einsum('bijo,bjo->bij', u_n, v_n)
        c = torch.softmax(sim, dim=2)
        v = torch.einsum('bij,bijo->bjo', c, u)
    return squash(v)


def capsule_linear(x: torch.Tensor, weight: torch.Tensor,
                   num_iterations: int = 3,
                   routing: str = 'dynamic') -> torch.Tensor:
    """Votes + routing in float32: x [B, in, in_length] -> [B, out,
    out_length]."""
    u = compute_votes(x.float(), weight.float())
    if routing == 'dynamic':
        return dynamic_routing(u, num_iterations)
    if routing == 'k_means':
        return k_means_routing(u, num_iterations)
    raise ValueError('unknown routing type: %s' % routing)


class CapsuleLinear(nn.Module):
    """Capsule layer with a weight [out_capsules, out_length, in_length]
    shared over the input capsules (the mode every reference call site
    uses).

    ``use_kernel`` routes the dynamic routing through the hand-written
    routing kernels and their backward (``capsule_cuda.capsule_routing``),
    as ``TPU_CAPSULE_PALLAS`` selects the Pallas kernels in the JAX
    package.
    """

    def __init__(self, out_capsules: int, in_length: int, out_length: int,
                 num_iterations: int = 3, routing: str = 'dynamic',
                 use_kernel: bool = False):
        super().__init__()
        self.in_length = in_length
        self.num_iterations = num_iterations
        self.routing = routing
        self.use_kernel = use_kernel
        self.weight = nn.Parameter(
            torch.empty((out_capsules, out_length, in_length)))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        # The reference's weights_init orthogonalizes every '*Linear*'
        # module, this one included, over [out_capsules, rest].
        with torch.no_grad():
            flat = self.weight.view(self.weight.shape[0], -1)
            nn.init.orthogonal_(flat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3 or x.shape[-1] != self.in_length:
            raise ValueError('capsule input must be [B, in, %d], got %s'
                             % (self.in_length, tuple(x.shape)))
        if self.use_kernel and self.routing == 'dynamic':
            from .capsule_cuda import capsule_routing
            # the kernels take contiguous rows; a capsule view of a
            # permuted feature map (the D class head) is strided
            return capsule_routing(x.float().contiguous(), self.weight,
                                   self.num_iterations)
        return capsule_linear(x, self.weight, self.num_iterations,
                              self.routing)
