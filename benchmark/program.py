"""What the benchmark takes from the system under test, the PyTorch port
``text2img_ekl_tpu_torch``: its configuration type, its networks, its
optimiser, its training step and its caption sampler. Nothing else of the
port is imported anywhere in the benchmark.

The networks are allocated on the card with ``torch.nn.init``'s fills
skipped, so that no initialisation runs; the benchmark's own weights, made
on the card from the seed, are then loaded into them (every tensor, buffers
included, strictly by name and shape).
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


def port_config(config: dict):
    """The port's ``Config`` from a configuration file's dict."""
    from text2img_ekl_tpu_torch.config import cfg_from_dict
    return cfg_from_dict(config)


def _load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    module.load_state_dict(tensors, strict=True)


_INIT_FILLS = ('normal_', 'uniform_', 'kaiming_uniform_', 'orthogonal_',
               'zeros_', 'ones_')


@contextlib.contextmanager
def _unfilled(device):
    """Modules built here are allocated on ``device`` and
    ``torch.nn.init``'s fills do nothing: every value is loaded
    afterwards, so no initialisation runs on the host or the card."""
    saved = {k: getattr(torch.nn.init, k) for k in _INIT_FILLS}
    for k in _INIT_FILLS:
        setattr(torch.nn.init, k, lambda tensor, *a, **kw: tensor)
    try:
        with torch.device(device):
            yield
    finally:
        for k, f in saved.items():
            setattr(torch.nn.init, k, f)


def build_train_state(cfg, weights: Dict[str, Dict[str, torch.Tensor]],
                      device: torch.device):
    """The port's ``TrainState``: G and one joint D per branch with the
    given tensors, and their Adams, as ``create_train_state`` builds it."""
    from text2img_ekl_tpu_torch.models.discriminator import (
        build_discriminators, cond_code_width)
    from text2img_ekl_tpu_torch.models.generator import build_generator
    from text2img_ekl_tpu_torch.train.state import TrainState, make_optimizer
    with _unfilled(device):
        G = build_generator(cfg, train_flag=True)
        Ds = build_discriminators(cfg, cond_code_width(cfg))
    _load(G, weights['G'])
    for i, D in enumerate(Ds):
        _load(D, weights['D%d' % i])
    return TrainState(
        G=G, Ds=Ds,
        g_opt=make_optimizer(G.parameters(), cfg.TRAIN.GENERATOR_LR),
        d_opts=[make_optimizer(D.parameters(), cfg.TRAIN.DISCRIMINATOR_LR)
                for D in Ds])


def make_train_step(cfg):
    """The port's training step for ``cfg``."""
    from text2img_ekl_tpu_torch.train.step import make_train_step as make
    return make(cfg)


def build_sampler(cfg, weights: Dict[str, torch.Tensor],
                  device: torch.device) -> torch.nn.Module:
    """The eval-mode generator of the sampling build."""
    from text2img_ekl_tpu_torch.models.generator import build_generator
    with _unfilled(device):
        G = build_generator(cfg, train_flag=False)
    _load(G, weights)
    return G.eval()


def caption_sample():
    """The port's caption sampler (looked up at each set-up, so that a test
    can stand a broken one in its place)."""
    from text2img_ekl_tpu_torch.train.sample import caption_sample as fn
    return fn
