"""Generator and discriminator weights across frameworks.

``jax_generator_to_state_dict`` and ``jax_joint_d_to_state_dict`` move the
JAX package's variables (flax ``{'params', 'batch_stats'}`` as numpy
arrays, e.g. after ``jax.device_get``) into this package's ``state_dict``;
the keys are the reference ``model.py`` netG and netD keys, as
``text2img_ekl_tpu.io_utils.torch_export.flax_generator_to_torch`` and
``flax_joint_d_to_torch`` write them (without the ``num_batches_tracked``
counters, which the port's BatchNorm does not keep).
``load_pth_generator`` and ``load_pth_discriminator`` read a reference
``netG_*.pth`` / ``netD<i>.pth`` or a file this package wrote with
``torch.save(module.state_dict(), path)``.

The key mapping is written out here: the JAX package's own mapping lives
in a package whose import pulls in JAX.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_VC_DENSE = {'Dense_0': 'fc1', 'Dense_1': 'fc2',
             'Dense_2': 'fc31', 'Dense_3': 'fc32'}
_VC_BN = {'BatchNorm_0': 'bn_fc1', 'BatchNorm_1': 'bn_fc2'}
_BN_LEAF = {'scale': 'weight', 'bias': 'bias',
            'mean': 'running_mean', 'var': 'running_var'}
_RES = {'Conv3x3_0': 0, 'BatchNorm_0': 1, 'Conv3x3_1': 3, 'BatchNorm_1': 4}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _port_key(mods: Tuple[str, ...], leaf: str, capsule_init: bool) -> str:
    """Flax module path + leaf -> reference/port state_dict key. The
    JAX package's Dense/Conv3x3/BatchNorm each wrap one flax layer
    (``Dense_0/Dense_0``, ``Conv3x3_0/Conv_0``, ...): only the outer name
    is read."""
    top = mods[0]
    param = 'weight' if leaf == 'kernel' else _BN_LEAF.get(leaf, leaf)
    if top.startswith('ca_net'):
        return '%s.fc.%s' % (top, param)
    if top.startswith('vc_net'):
        name = _VC_DENSE.get(mods[1]) or _VC_BN[mods[1]]
        return '%s.%s.%s' % (top, name, param)
    if top.startswith('img_net'):
        return '%s.img.0.weight' % top
    if not top.startswith('h_net'):
        raise KeyError('no mapping for %s' % '/'.join(mods))
    sub, rest = mods[1], mods[2:]
    if sub == 'up':  # the init stage's up stack: h_net1.upsampleN
        sub, rest = rest[0], rest[1:]
    if sub.startswith('upsample'):
        return '%s.%s.%d.%s' % (top, sub, 1 if rest[0] == 'Conv3x3_0' else 2,
                                param)
    if sub == 'jointConv':
        return '%s.jointConv.%d.%s' % (top, 0 if rest[0] == 'Conv3x3_0'
                                       else 1, param)
    if sub.startswith('residual_'):
        return '%s.residual.%s.block.%d.%s' % (top, sub.split('_')[1],
                                               _RES[rest[0]], param)
    if sub == 'fc':
        return '%s.fc.0.%s' % (top, param)
    if sub == 'fc_cap':
        return '%s.fc_cap.1.%s' % (top, param)
    if sub == 'bn':
        return '%s.%s.%s' % (top, 'fc_cap.3' if capsule_init else 'fc.1',
                             param)
    raise KeyError('no mapping for %s' % '/'.join(mods))


def _port_value(leaf: str, value) -> torch.Tensor:
    a = np.asarray(value, np.float32)
    if leaf == 'kernel' and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    elif leaf == 'kernel' and a.ndim == 2:
        a = a.T                              # [in, out] -> [out, in]
    return torch.tensor(a)


def jax_generator_to_state_dict(
        variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax generator variables (nested dicts of arrays) -> state_dict."""
    flat = list(_flatten(variables))
    capsule_init = any('fc_cap' in path for path, _ in flat)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat:
        # path: (collection, module..., leaf)
        key = _port_key(path[1:-1], path[-1], capsule_init)
        if key in sd:
            raise ValueError('duplicate key %s from %s' % (key, path))
        sd[key] = _port_value(path[-1], value)
    return sd


# Reference JOINT_D_NET layout (model.py:918-977, 1054-1121): img_code_s16
# is Sequential(conv, lrelu, conv, BN, lrelu, conv, BN, lrelu, conv, BN,
# lrelu), so its convs sit at 0, 2, 5, 8 and its BNs at 3, 6, 9.
_ENC_CONV_IX = (0, 2, 5, 8)
_ENC_BN_IX = (None, 3, 6, 9)
_SQUEEZE = {64: (), 128: ('img_code_s32_1',)}


def _joint_d_key(mods: Tuple[str, ...], leaf: str, imsize: int) -> str:
    """Flax JointDNet module path + leaf -> reference netD key."""
    top = mods[0]
    param = 'weight' if leaf == 'kernel' else _BN_LEAF.get(leaf, leaf)
    if top == 'tower':
        sub, inner = mods[1], mods[2]
        if sub == 'encode16':
            if inner.startswith('Conv4x4s2'):
                return 'img_code_s16.0.weight'
            k = int(inner.split('_')[1]) + 1   # DownBlock_k: the k+1-th conv
            if mods[3].startswith('Conv'):
                return 'img_code_s16.%d.weight' % _ENC_CONV_IX[k]
            return 'img_code_s16.%d.%s' % (_ENC_BN_IX[k], param)
        if sub.startswith('downs_'):
            scope = 'img_code_s%d' % (32 << int(sub.split('_')[1]))
        elif sub.startswith('squeezes_'):
            scope = _SQUEEZE[imsize][int(sub.split('_')[1])]
        else:
            raise KeyError('no mapping for %s' % '/'.join(mods))
        return '%s.%d.%s' % (scope, 0 if inner.startswith('Conv') else 1,
                             param)
    if top == 'jointConv':
        return 'jointConv.%d.%s' % (
            0 if mods[1].startswith('Conv') else 1, param)
    if top in ('logits', 'uncond_logits'):
        return '%s.0.%s' % (top, param)
    if top == 'fc_ac':
        return 'fc_ac.%s' % param
    if top == 'fc_ac_cap':
        return 'fc_ac_cap.0.weight'
    raise KeyError('no mapping for %s' % '/'.join(mods))


def jax_joint_d_to_state_dict(variables: Mapping[str, Any],
                              imsize: int) -> Dict[str, torch.Tensor]:
    """Flax JointDNet variables -> state_dict. The linear class head's
    kernel is permuted from the NHWC flatten of the 4x4 code (s*C + c) to
    the NCHW one (c*16 + s) that the port and the reference use."""
    if imsize not in _SQUEEZE:
        raise NotImplementedError('JointDNet at %d px is not ported yet: '
                                  'ROADMAP.md M12' % imsize)
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables):
        mods, leaf = path[1:-1], path[-1]
        key = _joint_d_key(mods, leaf, imsize)
        if key in sd:
            raise ValueError('duplicate key %s from %s' % (key, path))
        if mods[0] == 'fc_ac' and leaf == 'kernel':
            a = np.asarray(value, np.float32)      # [16*C, out]
            cs, out = a.shape
            sd[key] = torch.tensor(a.reshape(16, cs // 16, out)
                                   .transpose(1, 0, 2).reshape(cs, out).T)
        else:
            sd[key] = _port_value(leaf, value)
    return sd


def _read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if not isinstance(sd, Mapping):
        raise ValueError('%s holds a %s, not a state_dict'
                         % (path, type(sd).__name__))
    out = {}
    for k, v in sd.items():
        if k.endswith('num_batches_tracked'):
            continue
        out[k[len('module.'):] if k.startswith('module.') else k] = v
    return out


def load_pth_discriminator(path: str) -> Dict[str, torch.Tensor]:
    """A reference netD<i> ``.pth`` (``module.`` prefixes and
    ``num_batches_tracked`` counters dropped) or a state_dict this package
    saved -> state_dict for ``load_state_dict(strict=True)``."""
    return _read_state_dict(path)


def load_pth_generator(path: str) -> Dict[str, torch.Tensor]:
    """A reference netG ``.pth`` (DataParallel ``module.`` prefixes and
    BatchNorm ``num_batches_tracked`` counters dropped) or a state_dict
    this package saved -> state_dict for ``load_state_dict(strict=True)``.
    """
    if os.path.isdir(path):
        raise NotImplementedError(
            'NET_G %r is a directory (an orbax checkpoint of the JAX '
            'package); the port loads .pth state_dicts only. Export it with '
            'text2img_ekl_tpu.io_utils.torch_export.save_torch_generator, or '
            'see ROADMAP.md (orbax NET_G load).' % path)
    return _read_state_dict(path)
