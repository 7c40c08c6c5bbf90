"""Eval-mode sampling.

Counterpart of ``_sample_core``, ``make_sample_fn``,
``make_caption_sample_fn`` and ``_pm1_to_uint8_dev`` in
``text2img_ekl_tpu/train/step.py``. Inputs and outputs keep the JAX
package's layouts (images NHWC); inside, the generator runs NCHW.

In eval mode BatchNorm normalizes with its running statistics, so the C
captions of a batch fold into one batch of C*B rows exactly. Train-mode
sampling (``TEST.EVAL_MODE: False``) needs statistics per caption and is
not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import spans


def pm1_to_uint8_dev(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 pixels on the tensor's device, truncating like
    the JAX package's ``astype(uint8)``. Host twin:
    ``io_utils.images.pm1_to_uint8``."""
    return torch.clamp((x.float() + 1.0) * 127.5, 0, 255).to(torch.uint8)


def _require_eval(G: torch.nn.Module) -> None:
    if G.training:
        raise NotImplementedError(
            'train-mode sampling (TEST.EVAL_MODE False) needs BatchNorm '
            'statistics per caption and is not ported yet (ROADMAP.md); '
            'call G.eval() first')


@torch.no_grad()
def sample_images(G, noise: torch.Tensor, sen: torch.Tensor,
                  cls: Optional[torch.Tensor] = None,
                  cls_prior: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None,
                  eps_cls: Optional[torch.Tensor] = None
                  ) -> List[torch.Tensor]:
    """One eval-mode forward: every stage's image, NHWC float32 in
    [-1, 1] (``make_sample_fn``)."""
    _require_eval(G)
    h_codes = G(noise, sen, cls, cls_prior, eps, eps_cls, generator)[0]
    return [img.permute(0, 2, 3, 1) for img in G.image(h_codes)]


@torch.no_grad()
def caption_sample(G, noise: torch.Tensor, emb: torch.Tensor,
                   cls: Optional[torch.Tensor] = None,
                   cls_prior: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   eps: Optional[torch.Tensor] = None,
                   eps_cls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every caption of an eval batch in one forward
    (``make_caption_sample_fn``): the top-stage image as uint8
    [C, B, H, W, 3], quantised on the device.

    emb [C, B, E] is per caption. A 2-D argument is shared by the C
    captions: noise [B, Z], ``cls`` [B, K] (the 'cls' pattern), a
    ``cls_prior`` [B, M] (the 'cls_share' pattern). A 3-D one is per
    caption: noise [C, B, Z], and a ``cls_prior`` [C, B, M] or ``eps``
    [C, B, ef] / ``eps_cls`` [C, B, M] that inject the draws which
    otherwise come from ``generator``.
    """
    _require_eval(G)
    n_cap, bsz = emb.shape[:2]

    def fold(t):
        if t is None:
            return None
        if t.dim() == 2:  # shared by the captions
            t = t.unsqueeze(0).expand(n_cap, *t.shape)
        return t.reshape(n_cap * bsz, *t.shape[2:])

    with spans.span('sample.call', rows=n_cap * bsz):
        h_codes = G(fold(noise), fold(emb), fold(cls), fold(cls_prior),
                    fold(eps), fold(eps_cls), generator)[0]
        img = G.decode(h_codes[-1], len(h_codes) - 1)
        img = pm1_to_uint8_dev(img).permute(0, 2, 3, 1)
        return img.reshape(n_cap, bsz, *img.shape[1:]).contiguous()
