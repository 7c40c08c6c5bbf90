"""Training state: the networks, their Adam optimisers, the step count and
the optional generator EMA.

Counterpart of ``text2img_ekl_tpu/train/state.py``. JAX carries the state
as one immutable pytree; here the modules and optimisers are updated in
place by the step, which saves a copy of every parameter and moment.
Weight-update sharding (ZeRO-1), optimiser-state migration across mesh
sizes and mesh placement are not ported (ROADMAP.md M13).
``train_state_dict`` and ``load_train_state_dict`` turn the state into the
checkpoint's dict and back (``io_utils/checkpoint.py`` writes and reads
it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional

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
    ema = ema_copy(G) if float(cfg.TPU_EMA_DECAY) > 0 else None
    return TrainState(
        G=G, Ds=Ds,
        g_opt=make_optimizer(G.parameters(), cfg.TRAIN.GENERATOR_LR),
        d_opts=[make_optimizer(D.parameters(), cfg.TRAIN.DISCRIMINATOR_LR)
                for D in Ds],
        g_ema=ema)


def ema_copy(G: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh EMA slot: copies of G's parameters (the reference's
    copy_G_params, cub_trainer_splitz_cap_ca.py:83)."""
    return {n: p.detach().clone() for n, p in G.named_parameters()}


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


def resolve_restored_ema(state: TrainState, ema_decay: float) -> TrainState:
    """EMA-slot policy for a training run after a restore.

    A restored EMA slot with averaging off (TPU_EMA_DECAY 0) would stay
    frozen at its checkpointed values, the step only updating averages when
    decay > 0, while being saved into every snapshot; eval and export with
    the default TPU_EMA_EVAL would then prefer those stale weights over the
    trained model. Drop the slot loudly instead; ``evaluate`` of a finished
    averaged run still samples the averages (``eval_g_state_dict``)."""
    if state.g_ema is not None and float(ema_decay) <= 0:
        print('!! checkpoint carries generator EMA averages but '
              'TPU_EMA_DECAY=0: dropping them for this training run so '
              'snapshots hold live weights (set TPU_EMA_DECAY>0 to '
              'continue averaging)')
        state.g_ema = None
    return state


def train_state_dict(state: TrainState) -> Dict[str, Any]:
    """The checkpoint's dict of ``state``: the step, G's and each D's
    ``state_dict`` (parameters and BatchNorm buffers), the Adams'
    ``state_dict`` (moments and per-parameter steps) and the EMA (None
    without a slot). Its tensors are the state's own, not copies."""
    return {'step': int(state.step),
            'G': state.G.state_dict(),
            'Ds': [D.state_dict() for D in state.Ds],
            'g_opt': state.g_opt.state_dict(),
            'd_opts': [o.state_dict() for o in state.d_opts],
            'g_ema': None if state.g_ema is None else dict(state.g_ema)}


def _fit_tensors(target: Mapping[str, torch.Tensor],
                 saved: Mapping[str, torch.Tensor], what: str) -> None:
    """Raise unless ``saved`` has ``target``'s names and shapes: a
    checkpoint written under another architecture names the first tensor
    that differs and both shapes (dtypes may differ; loading casts)."""
    if set(saved) != set(target):
        raise ValueError(
            'checkpoint %s lacks %s and has %s that this config does not '
            'expect: it was written under a different architecture'
            % (what, sorted(set(target) - set(saved)) or 'nothing',
               sorted(set(saved) - set(target)) or 'nothing'))
    for k, t in target.items():
        if tuple(saved[k].shape) != tuple(t.shape):
            raise ValueError(
                'checkpoint %s tensor %s has shape %s but this config '
                'expects %s: it was written under a different architecture'
                % (what, k, tuple(saved[k].shape), tuple(t.shape)))


def _load_module(module: torch.nn.Module, saved: Mapping[str, torch.Tensor],
                 what: str) -> None:
    _fit_tensors(dict(module.state_dict()), saved, what)
    module.load_state_dict(saved, strict=True)


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module,
               saved: Mapping[str, Any], what: str) -> None:
    """The saved Adam state (moments and steps) into ``opt``, whose
    hyperparameters stay this config's, as optax's state holds none."""
    params = [p for g in opt.param_groups for p in g['params']]
    n_saved = sum(len(g['params']) for g in saved['param_groups'])
    if n_saved != len(params):
        raise ValueError('checkpoint %s covers %d tensors but this config '
                         'has %d: it was written under a different '
                         'architecture' % (what, n_saved, len(params)))
    names = {p: n for n, p in module.named_parameters()}
    state = {}
    for i, s in saved['state'].items():
        p = params[int(i)]
        _fit_tensors({k: p for k in s if k != 'step'},
                     {k: v for k, v in s.items() if k != 'step'},
                     '%s (%s)' % (what, names[p]))
        # steps stay on the host, as a fresh non-capturable Adam keeps them
        state[i] = {k: v.cpu() if k == 'step' else v for k, v in s.items()}
    current = opt.state_dict()
    current['state'] = state
    opt.load_state_dict(current)


def load_generator(G: torch.nn.Module, saved: Mapping[str, Any]
                   ) -> Optional[Dict[str, torch.Tensor]]:
    """G's parameters and BatchNorm buffers of ``train_state_dict``'s
    output into ``G``, in place on its device (values copied and cast to
    its dtypes); returns the checkpoint's EMA of G's parameters on G's
    device and dtypes, or None where it has none."""
    _load_module(G, saved['G'], 'G')
    ema = saved['g_ema']
    if ema is None:
        return None
    params = dict(G.named_parameters())
    _fit_tensors(params, ema, 'g_ema')
    return {n: ema[n].to(p.device, p.dtype, copy=True)
            for n, p in params.items()}


def load_train_state_dict(state: TrainState,
                          saved: Mapping[str, Any]) -> TrainState:
    """``train_state_dict``'s output into ``state``, in place on the
    state's device (values copied and cast to the state's dtypes): G, the
    step, each D, both Adams and the EMA. The EMA slot follows the
    checkpoint, as in the JAX package: its averages are loaded whether or
    not ``state`` has a slot (the reference's save_model bakes avg_param_G
    into the .pth, so an averaged run's eval weights ARE the averages); a
    slot that the checkpoint lacks is seeded from the loaded weights, as
    copy_G_params does at train start (cub_trainer_splitz_cap_ca.py:83,
    218-228), not left at a fresh init."""
    if len(saved['Ds']) != len(state.Ds):
        raise ValueError('checkpoint has %d discriminators but this config '
                         'builds %d' % (len(saved['Ds']), len(state.Ds)))
    ema = load_generator(state.G, saved)
    state.step = int(saved['step'])
    if ema is not None:
        state.g_ema = ema
    elif state.g_ema is not None:
        state.g_ema = ema_copy(state.G)
    for i, (D, sd) in enumerate(zip(state.Ds, saved['Ds'])):
        _load_module(D, sd, 'D%d' % i)
    _load_adam(state.g_opt, state.G, saved['g_opt'], 'G Adam')
    for i, (opt, D, sd) in enumerate(zip(state.d_opts, state.Ds,
                                         saved['d_opts'])):
        _load_adam(opt, D, sd, 'D%d Adam' % i)
    return state
