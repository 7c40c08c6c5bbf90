"""Inputs made from the seed on the card: the weights (through the
configuration's reference module), synthetic training batches and the
sampler's captions and draws. The same seed gives the same tensors; each
kind of input draws from a generator of its own."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

STREAMS = {'weights': 1, 'train_batches': 2, 'sample_inputs': 3}


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for one kind of input of run ``seed``.
    Any whole number is a seed; it is folded into 63 bits with the
    stream."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream])
                  % (1 << 63))
    return g


def _unit_rows(gen, shape, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=device)
    return x / x.norm(dim=-1, keepdim=True)


def _pyramid(gen, b: int, sizes: List[int], device):
    """uint8 NCHW images at the top size and their 2x average-pooled
    copies, smallest first, as a loader's pyramid."""
    top = torch.randint(0, 256, (b, 3, sizes[-1], sizes[-1]), generator=gen,
                        device=device, dtype=torch.uint8)
    out = [top]
    for _ in sizes[:-1]:
        out.insert(0, F.avg_pool2d(out[0].float(), 2).round()
                   .to(torch.uint8))
    return tuple(out)


def train_batches(d: dict, b: int, count: int, gen, device
                  ) -> List[Dict[str, object]]:
    """``count`` distinct batches of ``b`` rows: uint8 real and wrong
    pyramids, unit-norm text embeddings, classes uniform over the
    entities (one-hot, and the (K+1)-way target), and the step's draws
    (noise, CA and VC reparameterisation)."""
    out = []
    for _ in range(count):
        cls = torch.randint(0, d['entity'], (b,), generator=gen, device=device)
        out.append({
            'batch': {
                'real': _pyramid(gen, b, d['sizes'], device),
                'wrong': _pyramid(gen, b, d['sizes'], device),
                'txt': _unit_rows(gen, (b, d['text']), device),
                'cls_onehot': F.one_hot(cls, d['entity']).float(),
                'real_cp': F.one_hot(cls, d['entity'] + 1).float()},
            'draws': {
                'noise': torch.randn((b, d['z']), generator=gen,
                                     device=device),
                'eps': torch.randn((b, d['ef']), generator=gen, device=device),
                'eps_cls': torch.randn((b, d['manifd']), generator=gen,
                                       device=device)}})
    return out


def sample_inputs(d: dict, images: int, captions: int, count: int, gen,
                  device) -> List[Dict[str, torch.Tensor]]:
    """``count`` distinct sampler calls: ``captions`` unit-norm caption
    embeddings for each of ``images`` test images, one noise row per
    image shared by its captions, and per caption the class prior and
    the CA draw."""
    out = []
    for _ in range(count):
        cls = torch.randint(0, d['entity'], (images,), generator=gen,
                            device=device)
        out.append({
            'emb': _unit_rows(gen, (captions, images, d['text']), device),
            'noise': torch.randn((images, d['z']), generator=gen,
                                 device=device),
            'cls_prior': torch.randn((captions, images, d['manifd']),
                                     generator=gen, device=device),
            'eps': torch.randn((captions, images, d['ef']), generator=gen,
                               device=device),
            'cls': F.one_hot(cls, d['entity']).float()})
    return out
