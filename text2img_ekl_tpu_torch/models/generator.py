"""The split-z CA generator family, PyTorch, NCHW.

Counterpart of ``text2img_ekl_tpu/models/generator.py`` for the flagship
``CondGNetCatZCA`` (model.py:455-563): CA over the sentence embedding, VC
over the class (or a class prior at eval), a capsule (or FC) first stage
to 64 px, then ``NextStageG`` stages and shared toRGB heads.

Submodule names give the reference ``model.py`` netG ``state_dict`` keys
(``h_net1.fc_cap.1.weight``, ``h_net2.residual.0.block.0.weight``,
``img_net2.img.0.weight``, ...), so a reference ``.pth`` loads with a
plain ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.blocks import GLU, BatchNorm, Block3x3Relu, Conv3x3, Dense, \
    ResBlock, UpBlock
from ..nn.conditioning import CANet, VCNet
from ..ops.capsule import CapsuleLinear

_CAPSULE_LENGTH = 8


class _ToCapsules(nn.Module):
    """[B, D] -> [B, ceil(D/8), 8]. A width that does not divide into
    length-8 capsules is zero-padded: zero capsules cast zero votes."""

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        pad = (-z.shape[1]) % _CAPSULE_LENGTH
        if pad:
            z = F.pad(z, (0, pad))
        return z.reshape(z.shape[0], -1, _CAPSULE_LENGTH)


class _Flatten(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class _UpStack(nn.Module):
    """The four ngf -> ngf/16 up blocks of every init stage
    (model.py:217-220); mixed into the stage so the keys are
    ``h_net1.upsample1..4``."""

    def _make_up(self, ngf: int, dtype: torch.dtype, fused_bn_glu: bool,
                 kernel_dw: bool, bn_dtype: torch.dtype) -> None:
        for k in range(1, 5):
            setattr(self, 'upsample%d' % k, UpBlock(
                ngf // 2 ** (k - 1), ngf // 2 ** k, dtype, fused_bn_glu,
                kernel_dw, bn_dtype))

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        x = self.upsample1(x)
        x = self.upsample2(x)
        x = self.upsample3(x)
        return self.upsample4(x)


class CondInitStageG(_UpStack):
    """FC -> BN -> GLU -> 4x4 x ngf -> four up blocks (model.py:204-235)."""

    def __init__(self, ngf: int, in_dim: int,
                 dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ngf = ngf
        self.fc = nn.Sequential(Dense(in_dim, ngf * 4 * 4 * 2, bias=False,
                                      dtype=dtype),
                                BatchNorm(ngf * 4 * 4 * 2, bn_dtype=bn_dtype),
                                GLU(dtype))
        self._make_up(ngf, dtype, fused_bn_glu, kernel_dw, bn_dtype)

    def forward(self, c_code: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is not None:
            c_code = torch.cat([c_code, noise], dim=1)
        x = self.fc(c_code).view(c_code.shape[0], self.ngf, 4, 4)
        return self._up(x)


class CondInitStageGWithCap(_UpStack):
    """Capsule first stage (model.py:238-277): the latent as length-8
    capsules, routed to ngf capsules of length 32 (= 4*4*2), flattened
    channel-major, BN, GLU, 4x4 x ngf, four up blocks."""

    def __init__(self, ngf: int, num_iterations: int = 3,
                 routing: str = 'dynamic', use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ngf = ngf
        self.fc_cap = nn.Sequential(
            _ToCapsules(),
            CapsuleLinear(out_capsules=ngf, in_length=_CAPSULE_LENGTH,
                          out_length=4 * 4 * 2,
                          num_iterations=num_iterations, routing=routing,
                          use_kernel=use_kernel),
            _Flatten(), BatchNorm(ngf * 4 * 4 * 2, bn_dtype=bn_dtype),
            GLU(dtype))
        self._make_up(ngf, dtype, fused_bn_glu, kernel_dw, bn_dtype)

    def forward(self, c_code: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        if noise is not None:
            c_code = torch.cat([c_code, noise], dim=1)
        x = self.fc_cap(c_code.float()).view(c_code.shape[0], self.ngf, 4, 4)
        return self._up(x)


class NextStageG(nn.Module):
    """Tile the condition over HxW, joint conv, residual blocks, upsample
    (model.py:379-423). The joint conv is the plain conv over
    ``concat(tile(c), h)``; the JAX package's tile-free rewrite of it
    computes the same function with the same parameter. That rewrite never
    takes the Pallas dW; the concatenated conv here has ngf + ef_dim > 64
    input channels in every config (EMBEDDING_DIM 128), outside K4's
    envelope, so it never takes K4 either."""

    def __init__(self, ngf: int, ef_dim: int, num_residual: int = 2,
                 scale: int = 2, dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        flags = (dtype, fused_bn_glu, kernel_dw, bn_dtype)
        self.jointConv = Block3x3Relu(ngf + ef_dim, ngf, *flags)
        self.residual = nn.ModuleList(
            ResBlock(ngf, *flags) for _ in range(num_residual))
        self.upsample = UpBlock(ngf, ngf // 2, *flags)
        if scale == 4:
            self.upsample2 = UpBlock(ngf // 2, ngf // 4, *flags)

    def forward(self, h_code: torch.Tensor,
                c_code: torch.Tensor) -> torch.Tensor:
        b, _, h, w = h_code.shape
        c = c_code.to(h_code.dtype)[:, :, None, None].expand(b, -1, h, w)
        x = self.jointConv(torch.cat([c, h_code], dim=1))
        for block in self.residual:
            x = block(x)
        x = self.upsample(x)
        if hasattr(self, 'upsample2'):
            x = self.upsample2(x)
        return x


class ToRGB(nn.Module):
    """conv3x3 -> tanh decoder head (model.py:426-437), tanh in float32."""

    def __init__(self, ngf: int, dtype: torch.dtype = torch.float32,
                 kernel_dw: bool = False):
        super().__init__()
        self.img = nn.Sequential(Conv3x3(ngf, 3, dtype, kernel_dw))

    def forward(self, h_code: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.img(h_code).float())


def _fuse(c1: torch.Tensor, c2: torch.Tensor, cat: str) -> torch.Tensor:
    """Latent fusion (model.py:497-508)."""
    if cat == 'concat':
        return torch.cat([c1, c2], dim=1)
    if cat == 'product':
        return c1 * c2
    if cat == 'sum':
        return c1 + c2
    raise ValueError('unknown CAT_Z: %s' % cat)


class CondGNetCatZCA(nn.Module):
    """Flagship split-z generator: CA for the sentence path, VC for the
    class path (model.py:455-563).

    In eval mode with ``use_cls_prior`` (model.py:485-494) the class code
    is a supplied ``cls_prior`` or a standard normal draw from
    ``generator``; ``eps``/``eps_cls`` inject the CA/VC reparameterisation
    draws. ``fused_bn_glu``, ``kernel_dw`` and ``bn_dtype`` reach every
    block (see ``nn.blocks``).
    """

    def __init__(self, sen_dim: int = 1024, cls_dim: int = 200,
                 z_dim: int = 128, gf_dim: int = 64, ef_dim: int = 128,
                 manifd_dim: int = 128, branch_num: int = 2, r_num: int = 2,
                 scale: int = 2, use_cap: bool = False, cat: str = 'concat',
                 use_cls_prior: bool = False, num_iterations: int = 3,
                 routing: str = 'dynamic', use_kernel: bool = False,
                 dtype: torch.dtype = torch.float32,
                 fused_bn_glu: bool = False, kernel_dw: bool = False,
                 bn_dtype: torch.dtype = torch.float32):
        super().__init__()
        if not 1 <= branch_num <= 3:
            raise ValueError('BRANCH_NUM must be 1, 2 or 3')
        self.manifd_dim = manifd_dim
        self.branch_num = branch_num
        self.cat = cat
        self.use_cls_prior = use_cls_prior
        self.ca_net1 = CANet(sen_dim, ef_dim, dtype)
        self.vc_net2 = VCNet(z_dim + cls_dim, manifd_dim, dtype, bn_dtype)
        c_dim = ef_dim + manifd_dim if cat == 'concat' else ef_dim
        ngf = gf_dim * 16
        flags = dict(fused_bn_glu=fused_bn_glu, kernel_dw=kernel_dw,
                     bn_dtype=bn_dtype)
        if use_cap:
            self.h_net1 = CondInitStageGWithCap(
                ngf, num_iterations, routing, use_kernel, dtype, **flags)
        else:
            self.h_net1 = CondInitStageG(ngf, c_dim + z_dim, dtype, **flags)
        self.img_net1 = ToRGB(gf_dim, dtype, kernel_dw)
        if branch_num > 1:
            self.h_net2 = NextStageG(gf_dim, c_dim, r_num, scale, dtype,
                                     **flags)
            self.img_net2 = ToRGB(gf_dim // scale, dtype, kernel_dw)
        if branch_num > 2:
            self.h_net3 = NextStageG(gf_dim // scale, c_dim, r_num, scale,
                                     dtype, **flags)
            self.img_net3 = ToRGB(gf_dim // scale ** 2, dtype, kernel_dw)

    def forward(self, noise: torch.Tensor, sen: torch.Tensor,
                cls: Optional[torch.Tensor] = None,
                cls_prior: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                eps_cls: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (h_codes, mu1, mu2, logvar1, logvar2, std1, std2)."""
        c1, mu1, logvar1, std1 = self.ca_net1(sen, eps, generator)
        if self.training or not self.use_cls_prior:
            c2, mu2, logvar2, std2 = self.vc_net2(noise, cls, eps_cls,
                                                  generator)
        else:
            if cls_prior is None:
                cls_prior = torch.randn(
                    (noise.shape[0], self.manifd_dim), generator=generator,
                    device=noise.device, dtype=torch.float32)
            c2 = cls_prior.float()
            mu2 = logvar2 = std2 = torch.zeros_like(c2)
        c_code = _fuse(c1, c2, self.cat)
        h_codes = [self.h_net1(c_code, noise.float())]
        if self.branch_num > 1:
            h_codes.append(self.h_net2(h_codes[-1], c_code))
        if self.branch_num > 2:
            h_codes.append(self.h_net3(h_codes[-1], c_code))
        return h_codes, mu1, mu2, logvar1, logvar2, std1, std2

    def decode(self, h_code: torch.Tensor, stage: int) -> torch.Tensor:
        """One stage's hidden code -> NCHW image in [-1, 1], float32."""
        return getattr(self, 'img_net%d' % (stage + 1))(h_code)

    def image(self, h_codes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Decode every stage (model.py:547-563)."""
        return [self.decode(h, k) for k, h in enumerate(h_codes)]


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU_COMPUTE_DTYPE == 'bfloat16' \
        else torch.float32


def bn_dtype(cfg) -> torch.dtype:
    """BatchNorm's output type from TPU_BN_DTYPE, as the JAX package's
    ``_apply_bn_dtype_policy`` reads it for G and D alike."""
    return torch.bfloat16 if cfg.TPU_BN_DTYPE == 'bfloat16' \
        else torch.float32


def build_generator(cfg, train_flag: bool = True) -> CondGNetCatZCA:
    """The generator the split-z CA trainers build for ``cfg``
    (cub_trainer_splitz_cap_ca.py:113-135), in train and in eval builds
    alike with the config's kernel switches (TPU_FUSED_BN_GLU: K3,
    TPU_PALLAS_DW: K4) and BatchNorm dtype (TPU_BN_DTYPE). The other
    families are not ported yet."""
    if not cfg.GAN.B_CONDITION:
        raise NotImplementedError(
            'GNet (B_CONDITION False) is not ported yet: ROADMAP.md M12')
    if cfg.DATASET_NAME == 'coco':
        raise NotImplementedError(
            'CondGNet (the COCO single-cond generator) is not ported yet: '
            'ROADMAP.md M12')
    if cfg.TRAIN.EXCHANGE:
        raise NotImplementedError(
            'CondInitStageGExchangeCap (TRAIN.EXCHANGE) is not ported yet: '
            'ROADMAP.md M12')
    use_cap = cfg.TRAIN.G_CAPSULE if train_flag else cfg.TEST.G_CAPSULE
    return CondGNetCatZCA(
        sen_dim=cfg.TEXT.DIMENSION, cls_dim=cfg.GAN.ENTITY_DIM,
        z_dim=cfg.GAN.Z_DIM, gf_dim=cfg.GAN.GF_DIM,
        ef_dim=cfg.GAN.EMBEDDING_DIM, manifd_dim=cfg.GAN.MANIFD_DIM,
        branch_num=cfg.TREE.BRANCH_NUM, r_num=cfg.GAN.R_NUM,
        scale=cfg.TREE.SCALE, use_cap=use_cap, cat=cfg.TRAIN.CAT_Z,
        use_cls_prior=cfg.TEST.CLS_PRIOR,
        num_iterations=cfg.TPU_CAPSULE_ITERATIONS,
        routing=cfg.TPU_CAPSULE_ROUTING, use_kernel=cfg.TPU_CAPSULE_PALLAS,
        dtype=compute_dtype(cfg), fused_bn_glu=bool(cfg.TPU_FUSED_BN_GLU),
        kernel_dw=bool(cfg.TPU_PALLAS_DW), bn_dtype=bn_dtype(cfg))
