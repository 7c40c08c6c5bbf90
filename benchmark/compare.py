"""The numbers that decide ``correct``: what the timed path produced,
against the plain reference on the same inputs.

Training (the first three steps, which set-up drives through the window's
own call and feed). A leaf's gap is the gap between the program's and the
reference's norms of a tensor of that leaf, over the larger of the
reference's norm of that leaf and of the median leaf.
  grad_gap_d  the median gap of the Ds' leaves in the first gradient (the
              program's read from its Adam state after one step: the first
              moment over 1 - beta1). The Ds' first gradient comes before
              any update; G's comes through the Ds after their first Adam
              step, which moves every weight by +-lr by the sign of its
              gradient, so a gradient within rounding of zero flips a
              whole update and G's gradient, the later losses and the
              worst leaves inherit such flips (PERF.md gives the readings).
  grad_gap_g  the same median over G's leaves.
  change_gap  the worst leaf's gap in the norm of each leaf's change over
              the three steps, leaving out the leaves whose reference
              gradient is under a thousandth of the median leaf's (Adam
              moves them by round-off alone). A state left unchanged reads
              1.
Sampling (calls drawn from the seed in the window, and the last):
  image_gap   the worst image's mean absolute gap in uint8 levels.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

BETA1 = 0.5


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    if not tensors:
        return {}
    keys = list(tensors)
    norms = torch.stack([tensors[k].detach().float().norm() for k in keys])
    return dict(zip(keys, norms.tolist()))


def adam_first_grads(module: torch.nn.Module, opt, prefix: str
                     ) -> Dict[str, torch.Tensor]:
    """The gradient each leaf's Adam took at its first step, from its
    first moment: m1 = (1 - beta1) g."""
    return {prefix + n: opt.state[p]['exp_avg'] / (1.0 - BETA1)
            for n, p in module.named_parameters() if p in opt.state}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys
              ) -> List[float]:
    """|prog - ref| / max(ref, median ref over ``keys``) per leaf of
    ``keys``; a leaf the program lacks, or a non-finite one, reads as an
    infinite gap."""
    med = statistics.median(ref[k] for k in keys)
    out = []
    for k in keys:
        gap = abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], med, 1e-30)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def moved_leaves(ref_grads: Dict[str, float]) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v >= med / 1000}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {'losses': [{'errD', 'errG'} per step],
    'grads': leaf -> norm after step 1, 'change': leaf -> norm of the
    change after the last step}; leaves are 'G/<name>', 'D0/<name>', ..."""
    moved = [k for k in ref['change'] if k in moved_leaves(ref['grads'])]
    out = {}
    for net in ('D', 'G'):
        keys = [k for k in ref['grads'] if k.startswith(net)]
        out['grad_gap_%s' % net.lower()] = statistics.median(
            leaf_gaps(prog['grads'], ref['grads'], keys))
    out['change_gap'] = max(leaf_gaps(prog['change'], ref['change'], moved))
    return out


def image_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst image's mean absolute gap, in uint8 levels, of two stacks
    [..., H, W, 3]; stacks of other shapes read as infinite."""
    if prog.shape != ref.shape or prog.dtype != torch.uint8:
        return math.inf
    diff = (prog.int() - ref.int()).abs().float()
    return float(diff.reshape(-1, math.prod(diff.shape[-3:])).mean(1).max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> (bool, List[str]):
    """Every number the limits name at or under its limit (one missing
    reads as infinite); the lines that show each, and the numbers read but
    not compared."""
    ok, lines = bool(limits), []
    for name in sorted(set(numbers) - set(limits)):
        lines.append('read %s %.6g (not compared)' % (name, numbers[name]))
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        lines.append('check %s %.6g limit %.6g %s' % (
            name, value, limit, 'ok' if good else 'FAILED'))
    return ok, lines


def train_details(prog: dict, ref: dict) -> dict:
    """What is not compared, for the record: each step's loss gaps, and
    the worst leaf (with its name) and the median leaf of the first
    gradient and of the change, for G and for the Ds apart."""
    out = {}
    for i, (p, r) in enumerate(zip(prog['losses'], ref['losses'])):
        for k in ('errD', 'errG'):
            out['%s%d' % (k, i + 1)] = abs(p[k] - r[k]) / abs(r[k])
    moved = moved_leaves(ref['grads'])
    for what, keep in (('grads', None), ('change', moved)):
        for net in ('G', 'D'):
            keys = [k for k in ref[what] if k.startswith(net)
                    and (keep is None or k in keep)]
            gaps = leaf_gaps(prog[what], ref[what], keys)
            worst = max(range(len(keys)), key=gaps.__getitem__)
            out['%s_%s' % (what, net)] = [gaps[worst], keys[worst],
                                          statistics.median(gaps)]
    return out
