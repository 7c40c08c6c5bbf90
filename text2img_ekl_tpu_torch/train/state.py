"""Training state: the networks, their Adam optimisers, the step count and
the optional generator EMA.

Counterpart of ``text2img_ekl_tpu/train/state.py``. JAX carries the state
as one immutable pytree; here the modules and optimisers are updated in
place by the step, which saves a copy of every parameter and moment.
Weight-update sharding (ZeRO-1), optimiser-state migration across mesh
sizes and mesh placement are not ported (ROADMAP.md M13), nor are
checkpoints (M10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import torch

from ..models.discriminator import (JointDNet, build_discriminators,
                                    cond_code_width)
from ..models.generator import CondGNetCatZCA, build_generator


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Adam:
    """Adam(lr, betas=(0.5, 0.999), eps=1e-8) as the reference configures
    it (cub_trainer_splitz_cap_ca.py:199-215); the same update as optax's
    ``adam`` (bias-corrected moments, eps added to the root of the second
    moment)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    G: CondGNetCatZCA
    Ds: List[JointDNet]
    g_opt: torch.optim.Adam
    d_opts: List[torch.optim.Adam]
    step: int = 0
    # EMA of G's parameters by name (the reference's avg_param_G slot,
    # cub_trainer_splitz_cap_ca.py:80-85; its in-loop update is disabled
    # there, so TPU_EMA_DECAY 0, no EMA, is the faithful default)
    g_ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(cfg, device='cuda', seed: int = 0) -> TrainState:
    """G and one JointDNet per branch, initialised from ``seed`` (the
    global torch generator is left as it was), on ``device``, with their
    optimisers."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        G = build_generator(cfg, train_flag=True)
        Ds = build_discriminators(cfg, cond_code_width(cfg))
    G = G.to(device)
    Ds = [D.to(device) for D in Ds]
    ema = None
    if float(cfg.TPU_EMA_DECAY) > 0:
        ema = {n: p.detach().clone() for n, p in G.named_parameters()}
    return TrainState(
        G=G, Ds=Ds,
        g_opt=make_optimizer(G.parameters(), cfg.TRAIN.GENERATOR_LR),
        d_opts=[make_optimizer(D.parameters(), cfg.TRAIN.DISCRIMINATOR_LR)
                for D in Ds],
        g_ema=ema)


def eval_g_state_dict(state: TrainState,
                      use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The generator's state_dict for sampling and export: the EMA
    parameters when the state carries them (the reference's save_model
    writes avg_param_G into the netG .pth, cub_trainer_splitz_cap_ca.py:
    218-228), the live BatchNorm buffers always."""
    sd = dict(state.G.state_dict())
    if use_ema and state.g_ema is not None:
        sd.update(state.g_ema)
    return sd
