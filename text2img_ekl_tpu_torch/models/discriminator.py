"""The joint discriminators, PyTorch, NCHW.

Counterpart of ``text2img_ekl_tpu/models/discriminator.py`` for
``JointDNet`` (the reference's JOINT_D_NET64/128, model.py:918-977,
1054-1121): a 16x image encoder (plus one down block and one squeeze block
at 128 px), then three heads: sentence match (conditional), reality
(unconditional) and an (ENTITY_DIM+1)-way class head, which is a capsule
classifier over the 4x4 map's 16 positions (capsules of length 8*ndf) or a
linear layer.

Submodule names give the reference netD ``state_dict`` keys
(``img_code_s16.0.weight``, ``img_code_s32.1.running_mean``,
``jointConv.0.weight``, ``logits.0.bias``, ``fc_ac_cap.0.weight``, ...),
the keys ``text2img_ekl_tpu.io_utils.torch_export.flax_joint_d_to_torch``
writes. The heads return probabilities and log-probabilities in float32,
as the reference does (sigmoid on the match and reality heads,
log_softmax on the class head).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..nn.blocks import (Block3x3LeakyRelu, Conv4x4s4, Dense, DownBlock,
                         EncodeBy16)
from ..ops.capsule import CapsuleLinear
from .generator import bn_dtype, compute_dtype


class _SigmoidF32(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(x.float())


def _logit_head(in_planes: int, dtype: torch.dtype) -> nn.Sequential:
    """conv 4x4 s4 (with bias) -> sigmoid (model.py:886-888)."""
    return nn.Sequential(Conv4x4s4(in_planes, 1, dtype), _SigmoidF32())


def concat_cond(x_code: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
    """Tile the condition code over the 4x4 map and put it FIRST on the
    channels (model.py:956-959)."""
    b, _, h, w = x_code.shape
    c = c_code.to(x_code.dtype)[:, :, None, None].expand(b, -1, h, w)
    return torch.cat([c, x_code], dim=1)


class JointDNet(nn.Module):
    """Three-headed joint discriminator at 64 or 128 px. ``kernel_dw``
    (TPU_PALLAS_DW) routes the weight gradient of its 3x3 convs through
    kernel K4 where ``dw_supported`` holds, as the JAX package's module
    switch reaches them; they run on the 4x4 code, outside the envelope."""

    def __init__(self, ndf: int = 64, ef_dim: int = 256,
                 entity_dim: int = 200, imsize: int = 64,
                 use_cap: bool = False, num_iterations: int = 3,
                 routing: str = 'dynamic', use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        if imsize not in (64, 128):
            raise NotImplementedError(
                'JointDNet at %d px is not ported yet: ROADMAP.md M12'
                % imsize)
        self.ndf = ndf
        self.ef_dim = ef_dim
        self.use_cap = use_cap
        self.img_code_s16 = EncodeBy16(ndf, dtype, bn_dtype)
        if imsize == 128:
            self.img_code_s32 = DownBlock(ndf * 8, ndf * 16, dtype, bn_dtype)
            self.img_code_s32_1 = Block3x3LeakyRelu(ndf * 16, ndf * 8, dtype,
                                                    kernel_dw, bn_dtype)
        self.jointConv = Block3x3LeakyRelu(ndf * 8 + ef_dim, ndf * 8, dtype,
                                           kernel_dw, bn_dtype)
        self.logits = _logit_head(ndf * 8, dtype)
        self.uncond_logits = _logit_head(ndf * 8, dtype)
        if use_cap:
            self.fc_ac_cap = nn.Sequential(CapsuleLinear(
                out_capsules=entity_dim + 1, in_length=ndf * 8,
                out_length=16, num_iterations=num_iterations,
                routing=routing, use_kernel=use_kernel))
        else:
            # over the NCHW flatten of the 4x4 code, as the reference's
            # Linear(8ndf*4*4) (model.py:972-973)
            self.fc_ac = Dense(ndf * 8 * 16, entity_dim + 1, dtype=dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, s, s] -> the 4x4 code [B, 8ndf, 4, 4]."""
        x = self.img_code_s16(x)
        if hasattr(self, 'img_code_s32'):
            x = self.img_code_s32_1(self.img_code_s32(x))
        return x

    def forward(self, x: torch.Tensor,
                c_code: torch.Tensor) -> List[torch.Tensor]:
        """-> [sentence match [B], reality [B], class log-probs [B, K+1]]."""
        if c_code.shape[-1] != self.ef_dim:
            raise ValueError('condition code width %d != ef_dim %d this '
                             'JointDNet was built for'
                             % (c_code.shape[-1], self.ef_dim))
        x_code = self.encode(x)
        h = self.jointConv(concat_cond(x_code, c_code))
        sen_match = self.logits(h).reshape(-1)
        real = self.uncond_logits(x_code).reshape(-1)
        b = x_code.shape[0]
        if self.use_cap:
            # the 16 spatial positions, in NHWC order, are the input
            # capsules of length 8ndf (model.py:967-968)
            caps = x_code.permute(0, 2, 3, 1).reshape(b, 16, self.ndf * 8)
            out = self.fc_ac_cap(caps)                  # [B, K+1, 16]
            norm = torch.sqrt(torch.sum(out * out, dim=-1) + 1e-12)
            cp = torch.log_softmax(norm.float(), dim=-1)
        else:
            cp = torch.log_softmax(self.fc_ac(x_code.reshape(b, -1)).float(),
                                   dim=-1)
        return [sen_match, real, cp]


def cond_code_width(cfg) -> int:
    """Width of the condition code the split-z step feeds the Ds."""
    if cfg.TRAIN.CAT_Z == 'concat':
        return cfg.GAN.EMBEDDING_DIM + cfg.GAN.MANIFD_DIM
    return cfg.GAN.EMBEDDING_DIM


def build_discriminators(cfg, cond_width: Optional[int] = None
                         ) -> List[JointDNet]:
    """One JointDNet per branch, as the split-z trainers build them
    (cub_trainer_splitz_cap_ca.py:142-158)."""
    if not cfg.GAN.B_CONDITION:
        raise NotImplementedError(
            'DNet (the legacy per-scale discriminator) is not ported yet: '
            'ROADMAP.md M12')
    if cfg.DATASET_NAME == 'coco':
        raise NotImplementedError(
            'the COCO single-cond discriminators are not ported yet: '
            'ROADMAP.md M12')
    if cond_width is None:
        cond_width = cfg.GAN.EMBEDDING_DIM * 2 \
            if cfg.TRAIN.CAT_Z == 'concat' else cfg.GAN.EMBEDDING_DIM
    return [JointDNet(
        ndf=cfg.GAN.DF_DIM, ef_dim=cond_width, entity_dim=cfg.GAN.ENTITY_DIM,
        imsize=size, use_cap=cfg.TRAIN.D_CAPSULE,
        num_iterations=cfg.TPU_CAPSULE_ITERATIONS,
        routing=cfg.TPU_CAPSULE_ROUTING, use_kernel=cfg.TPU_CAPSULE_PALLAS,
        dtype=compute_dtype(cfg), kernel_dw=bool(cfg.TPU_PALLAS_DW),
        bn_dtype=bn_dtype(cfg))
        for size in cfg.branch_sizes()]


class DNet(nn.Module):
    """The legacy per-scale discriminator (model.py:874-1373)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError('DNet is not ported yet: ROADMAP.md M12')


class EntityDNet(nn.Module):
    """The legacy entity discriminator (model.py:853-1150)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'EntityDNet is not ported yet: ROADMAP.md M12')
