"""The G+D training step of the split-z strategy, PyTorch.

Counterpart of ``make_train_step`` in ``text2img_ekl_tpu/train/step.py``
(the reference's cub_trainer_splitz_cap_ca.py:544-625), in the JAX phase
order:

  1. one generator forward in train mode, whose graph is kept;
  2. per discriminator: three train-mode passes (real, wrong, detached
     fake) with the detached fused mu, so that its BatchNorm buffers
     thread real -> wrong -> fake; the errD composition; one backward and
     one Adam step;
  3. the generator loss through the UPDATED discriminators (match + uncond
     + cls + KL * coeff + colour), with the discriminators' parameters
     frozen so that the backward reaches only G (and the capsule head's
     backward computes no weight gradient); their BatchNorm buffers take a
     fourth update here, as the JAX step's ``final_d_bs``. Then one G Adam
     step and the optional EMA.

JAX runs this as one compiled function; here it runs eagerly, updating
the modules and optimisers of the ``TrainState`` in place. Random draws
come from a ``torch.Generator`` seeded per step; ``draws`` injects them
(the tests hand in JAX's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .losses import bce, ce_loss, color_consistency_loss, kl_loss
from .state import TrainState

# options of the JAX step that the port does not run, and where they wait
_NOT_PORTED = (
    ('TPU_GROUPED_D', 'grouped D passes (TPU_GROUPED_D)', 'M13'),
    ('TPU_REMAT_G', 'G rematerialisation (TPU_REMAT_G)', 'M14'),
    ('TPU_SUBPIXEL_UP', 'the subpixel upsample (TPU_SUBPIXEL_UP)', 'M14'),
    ('TPU_FUSED_BN_GLU', 'the fused BN+GLU kernel K3 (TPU_FUSED_BN_GLU)',
     'M14'),
    ('TPU_PALLAS_DW', 'the conv weight-gradient kernel K4 (TPU_PALLAS_DW)',
     'M14'),
)


def fuse_mu(mu1: torch.Tensor, mu2: torch.Tensor,
            cat_z: str) -> torch.Tensor:
    """Condition code for the Ds: cat/product/sum of the two mus
    (cub_trainer_splitz_cap_ca.py:577-582)."""
    if cat_z == 'concat':
        return torch.cat([mu1, mu2], dim=1)
    if cat_z == 'product':
        return mu1 * mu2
    if cat_z == 'sum':
        return mu1 + mu2
    raise ValueError(cat_z)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 pyramids -> [-1, 1] on the device, x/127.5 - 1 (bit-identical
    to ToTensor + Normalize(0.5, 0.5) since 2/255 == 1/127.5); float
    images pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 127.5 - 1.0
    return x


def check_step_config(cfg) -> None:
    """Raise on what the port's step does not run, naming its ROADMAP
    item."""
    if cfg.DATASET_NAME == 'coco':
        raise NotImplementedError(
            'the COCO single-cond step (CondGNet) is not ported yet: '
            'ROADMAP.md M12')
    for key, what, item in _NOT_PORTED:
        if getattr(cfg, key):
            raise NotImplementedError('%s is not ported yet: ROADMAP.md %s'
                                      % (what, item))
    if int(cfg.TPU_GRAD_ACCUM or 0) > 1:
        raise NotImplementedError('gradient accumulation (TPU_GRAD_ACCUM) '
                                  'is not ported yet: ROADMAP.md M13')


def make_train_step(cfg):
    """Build ``step_fn(state, batch, seed, draws=None) -> (metrics,
    fakes)``.

    ``batch`` holds tensors on the networks' device: ``real`` and
    ``wrong`` (one NCHW image batch per branch, uint8 or float in
    [-1, 1]), ``txt`` [B, TEXT.DIMENSION], ``cls_onehot`` [B, ENTITY_DIM]
    and ``real_cp`` [B, ENTITY_DIM + 1]. ``metrics`` maps the JAX step's
    names to 0-d float32 tensors on the device (read them once per epoch,
    not per step); ``fakes`` is the top-stage generated batch, NCHW.
    ``draws`` may hold ``noise`` [B, Z_DIM], ``eps`` (CA) and ``eps_cls``
    (VC) in place of the step's own.
    """
    check_step_config(cfg)
    uncond_coeff = float(cfg.TRAIN.COEFF.UNCOND_LOSS)
    kl_coeff = float(cfg.TRAIN.COEFF.KL)
    color_coeff = float(cfg.TRAIN.COEFF.COLOR_LOSS)
    ema_decay = float(cfg.TPU_EMA_DECAY)
    cat_z = cfg.TRAIN.CAT_Z
    z_dim = cfg.GAN.Z_DIM
    entity_p1 = cfg.GAN.ENTITY_DIM + 1

    def step_fn(state: TrainState, batch: Dict[str, Any], seed: int,
                draws: Optional[Dict[str, torch.Tensor]] = None):
        G, Ds = state.G, state.Ds
        num_ds = len(Ds)
        real = [normalize_images(x) for x in batch['real']]
        wrong = [normalize_images(x) for x in batch['wrong']]
        txt, real_cp = batch['txt'], batch['real_cp']
        bsz = txt.shape[0]
        dev = txt.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = dict(draws or {})
        noise = draws.get('noise')
        if noise is None:
            noise = torch.randn((bsz, z_dim), generator=gen, device=dev)
        ones = torch.ones(bsz, device=dev)
        zeros = torch.zeros(bsz, device=dev)
        fake_cp = torch.zeros((bsz, entity_p1), device=dev)
        fake_cp[:, -1] = 1.0
        G.train()
        for D in Ds:
            D.train()

        # ---- phase 1: one generator forward, graph kept
        h_codes, mu1, mu2, lv1, lv2, _, _ = G(
            noise, txt, batch['cls_onehot'], eps=draws.get('eps'),
            eps_cls=draws.get('eps_cls'), generator=gen)
        imgs = G.image(h_codes)
        mu_d = fuse_mu(mu1, mu2, cat_z)
        mu_sg = mu_d.detach()

        # ---- phase 2: D updates on real / wrong / detached fake
        errD_all = errD_match_all = errD_uncond_all = errD_cls_all = 0.0
        for i, D in enumerate(Ds):
            rl = D(real[i], mu_sg)
            wl = D(wrong[i], mu_sg)
            fl = D(imgs[i].detach(), mu_sg)
            errD_real = bce(rl[0], ones)
            errD_wrong = bce(wl[0], zeros)
            errD_fake = bce(fl[0], zeros)
            if uncond_coeff > 0:
                errD_match = errD_real + errD_wrong + errD_fake
                errD_uncond = uncond_coeff * (
                    bce(rl[1], ones) + bce(wl[1], ones) + bce(fl[1], zeros))
                errD_cls = ce_loss(rl[2], real_cp) + ce_loss(fl[2], fake_cp)
                errD = errD_match + errD_uncond + errD_cls
            else:
                errD_match = errD_real + 0.5 * (errD_wrong + errD_fake)
                errD_uncond = errD_cls = torch.zeros((), device=dev)
                errD = errD_match
            state.d_opts[i].zero_grad(set_to_none=True)
            errD.backward()
            state.d_opts[i].step()
            errD_all = errD_all + errD.detach()
            errD_match_all = errD_match_all + errD_match.detach()
            errD_uncond_all = errD_uncond_all + errD_uncond.detach()
            errD_cls_all = errD_cls_all + errD_cls.detach()

        # ---- phase 3: G loss through the updated Ds
        for D in Ds:
            D.requires_grad_(False)
        try:
            match = uncond = cls_ = torch.zeros((), device=dev)
            for i, D in enumerate(Ds):
                o = D(imgs[i], mu_d)
                match = match + bce(o[0], ones)
                if uncond_coeff > 0:
                    uncond = uncond + uncond_coeff * bce(o[1], ones)
                    cls_ = cls_ + ce_loss(o[2], real_cp)
            kl_sen, kl_cls = kl_loss(mu1, lv1), kl_loss(mu2, lv2)
            errG = match + uncond + cls_ + (kl_sen + kl_cls) * kl_coeff
            if color_coeff > 0 and num_ds > 1:
                errG = errG + color_consistency_loss(imgs[:num_ds],
                                                     color_coeff)
            state.g_opt.zero_grad(set_to_none=True)
            errG.backward()
        finally:
            for D in Ds:
                D.requires_grad_(True)
        state.g_opt.step()
        if ema_decay > 0 and state.g_ema is not None:
            with torch.no_grad():
                for n, p in G.named_parameters():
                    state.g_ema[n].mul_(ema_decay).add_(
                        p, alpha=1.0 - ema_decay)
        state.step += 1

        with torch.no_grad():
            metrics = {
                'errD': errD_all, 'errD_match': errD_match_all,
                'errD_uncond': errD_uncond_all, 'errD_cls': errD_cls_all,
                'errG': errG.detach(), 'errG_match': match.detach(),
                'errG_uncond': uncond.detach(), 'errG_cls': cls_.detach(),
                'kl_sen': kl_sen.detach(), 'kl_cls': kl_cls.detach(),
                'mu_sen_mean': mu1.mean(),
                'std_sen_mean': torch.exp(0.5 * lv1).mean(),
                'mu_cls_mean': mu2.mean(),
                'std_cls_mean': torch.exp(0.5 * lv2).mean(),
            }
        return metrics, imgs[-1].detach()

    return step_fn
