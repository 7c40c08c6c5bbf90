"""TF and torchvision InceptionV3 weights -> the port's tower.

Counterpart of ``text2img_ekl_tpu/eval/convert_tf.py``. The reference's
metric stack loads its weights three ways:

- a TF-slim checkpoint with EMA variables for the fine-tuned 50+1-class
  IS model (inception_score.py:247-251): ``load_slim_checkpoint`` +
  ``slim_vars_to_flax``;
- the frozen 2015 ImageNet ``classify_image_graph_def.pb`` of
  inception_score_general.py:56-81 and fid.py:190-206:
  ``load_frozen_graph_weights`` + ``frozen_graph_to_flax``, or
  ``frozen_pb_to_inception`` in one call;
- torchvision's inception_v3 state dict (model.py:18-31):
  ``torchvision_state_to_flax`` (a ``torch.load``-ed dict; no torchvision
  needed).

The name maps are the JAX package's and produce its variable layout (nested
``params`` / ``batch_stats`` dicts of numpy arrays, HWIO kernels), so that
they can be held to it key for key; ``io_utils/weights.py::
inception_from_flax`` turns that layout into the port's state_dict. A
template of the layout comes from ``flax_template``. Both TF formats are
read by this package's own decoder (``eval/tf_files.py``): neither
TensorFlow nor protobuf is needed.

``keras_inception_to_flax`` is not ported: it converts a live
``tf.keras`` model object, which exists only where TensorFlow does, and
serves only the JAX package's tests.

Checkpoint files are not bundled; the loaders raise a clear error when the
file is missing, so that callers can fall back to random weights (their
scores then are not comparable to the reference's, which they say).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..io_utils.weights import (_flatten, _inception_keys,
                                inception_flax_path, inception_from_flax)
from .tf_files import TensorBundle, read_frozen_graph_consts


def _flatten_dict(tree: Mapping[str, Any]) -> Dict[Tuple[str, ...], Any]:
    return dict(_flatten(tree))


def _unflatten_dict(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return tree


def _np(value) -> np.ndarray:
    """A torch tensor (CPU or not) or an array-like -> numpy."""
    if hasattr(value, 'detach'):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def flax_template(num_classes: int = 1000, flavor: str = 'slim'
                  ) -> Dict[str, Any]:
    """Zeros in the JAX tower's variable layout for ``make_inception(
    num_classes, flavor)``: the tree the name maps below walk."""
    flat = {}
    for key, shape in _inception_keys(num_classes, flavor).items():
        path = inception_flax_path(key)
        if path[-1] == 'kernel':
            shape = (shape[2], shape[3], shape[1], shape[0]) \
                if len(shape) == 4 else shape[::-1]
        flat[path] = np.zeros(shape, np.float32)
    return _unflatten_dict(flat)


def _require(path: str, what: str):
    # TF checkpoints are a PREFIX (model.ckpt.index + .data-*), so accept
    # either a real file or a prefix whose .index exists, as
    # tf.train.Saver.restore takes it (inception_score.py:287).
    if not path or not (os.path.exists(path)
                        or os.path.exists(path + '.index')):
        raise FileNotFoundError(
            '%s not found at %r: point the converter at the reference '
            'checkpoint; random weights are only valid for smoke tests.'
            % (what, path))


def load_slim_checkpoint(ckpt_path: str, num_classes: int = 51,
                         use_ema: bool = True) -> Dict[str, Any]:
    """A TF-slim InceptionV3 training checkpoint (V2 format, given by its
    prefix) -> a flat {tf_name: np.ndarray} dict, preferring the
    ExponentialMovingAverage variables as inception_score.py:247-251
    restores them."""
    _require(ckpt_path, 'TF-slim checkpoint')
    reader = TensorBundle(ckpt_path)
    out = {}
    for name in reader.names:
        if name.endswith('ExponentialMovingAverage') and use_ema:
            base = name.rsplit('/', 1)[0]
            out[base] = reader.get_tensor(name)
        elif name not in out:
            out.setdefault(name, reader.get_tensor(name))
    return out


def slim_vars_to_flax(tf_vars: Dict[str, np.ndarray],
                      flax_variables: Dict[str, Any]) -> Dict[str, Any]:
    """Map slim variable names onto the tower's variable tree.

    The vendored slim tower creates variables under the scopes of
    inception_model.py:87-330 with NO outer variable scope: 'conv0/weights',
    'mixed_35x35x256a/branch5x5/Conv_1/BatchNorm/beta',
    'logits/logits/weights'. The mapping walks the tree, derives each
    leaf's slim twin, and raises KeyError listing any miss.
    """
    flat = _flatten_dict(flax_variables)
    missing = []
    new = {}
    for path, val in flat.items():
        tf_name = _flax_path_to_slim(path)
        if tf_name in tf_vars:
            cand = [tf_name]
        else:  # tolerate an extra outer scope prefix
            cand = [k for k in tf_vars if k.endswith('/' + tf_name)]
        if not cand:
            missing.append('/'.join(str(p) for p in path))
            new[path] = val
            continue
        src = np.asarray(tf_vars[cand[0]])
        if src.shape != tuple(val.shape):
            src = src.reshape(val.shape)
        new[path] = src.astype(np.float32)
    if missing:
        raise KeyError('unmapped params: %s' % missing[:20])
    return _unflatten_dict(new)


# The tower's module name -> the slim scope where they differ: the 17->8
# grid reduction is scoped 'mixed_17x17x1280a' in the vendored tower
# (inception/slim/inception_model.py:266).
_SLIM_BLOCK_RENAME = {'mixed_8x8x1280a': 'mixed_17x17x1280a'}


def _split_branch(name: str):
    """'branch5x5_2' -> ('branch5x5', 1); 'branch3x3dbl_3a' -> (..., 2).

    Slim puts every conv of a branch in ONE variable_scope, so TF
    uniquifies the default 'Conv' scope: the k-th conv is Conv / Conv_1 /
    Conv_2 ... in creation order. The tower names them branch_1/_2/...
    (a/b for the parallel split pairs, which slim creates a, then b)."""
    m = re.match(r'^(branch\w*?)_(\d)([ab])?$', name)
    if not m:
        return name, 0
    idx = int(m.group(2)) - 1 + (1 if m.group(3) == 'b' else 0)
    return m.group(1), idx


def _flax_path_to_slim(path) -> str:
    """Tree path -> slim checkpoint variable name.

    ('params','mixed_35x35x256a','branch5x5_2','Conv_0','kernel')
        -> 'mixed_35x35x256a/branch5x5/Conv_1/weights'
    ('params','conv0','BatchNorm_0','bias') -> 'conv0/BatchNorm/beta'
        (stem convs pass their name as the conv2d scope itself,
        inception_model.py:87-102)
    ('params','logits','kernel') -> 'logits/logits/weights'
        (ops.fc scope 'logits' inside variable_scope('logits'),
        inception_model.py:318-326)
    """
    parts = [str(p) for p in path if str(p) not in ('params', 'batch_stats')]
    leaf = parts[-1]
    mods = parts[:-1]
    is_bn = bool(mods) and mods[-1].startswith('BatchNorm')
    mods = [m for m in mods if not m.startswith(('Conv', 'BatchNorm'))]
    if mods and mods[0] == 'logits':
        return 'logits/logits/%s' % {'kernel': 'weights',
                                     'bias': 'biases'}[leaf]
    if len(mods) == 1:
        scope = mods[0]  # stem conv: the module name IS the conv2d scope
    else:
        block = _SLIM_BLOCK_RENAME.get(mods[0], mods[0])
        branch, idx = _split_branch(mods[1])
        conv = 'Conv' if idx == 0 else 'Conv_%d' % idx
        scope = '%s/%s/%s' % (block, branch, conv)
    if is_bn:
        leaf_name = {'bias': 'beta', 'scale': 'gamma',
                     'mean': 'moving_mean', 'var': 'moving_variance'}[leaf]
        return '%s/BatchNorm/%s' % (scope, leaf_name)
    return '%s/%s' % (scope, {'kernel': 'weights', 'bias': 'biases'}[leaf])


def load_frozen_graph_weights(pb_path: str) -> Dict[str, np.ndarray]:
    """The Const tensors of the frozen 2015 ImageNet graph (the graph
    fid.py / inception_score_general.py import), by node name."""
    _require(pb_path, 'frozen inception graph')
    out, scale_flags = read_frozen_graph_consts(pb_path)
    # Old-style fused BN nodes carry a scale_after_normalization attr; if
    # the graph says gamma is NOT applied, the converter must skip the
    # gamma fold even though gamma constants exist. Composed-op graphs
    # (Mul/Add) have no such attr: gamma is applied by construction.
    out['__scale_after_normalization__'] = np.asarray(
        all(scale_flags) if scale_flags else True)
    return out


# ---------------------------------------------------------------------------
# Frozen 2015 'classify_image_graph_def.pb' -> the 'fid' tower.
#
# The 2015 export names things by the ORIGINAL google/inception convention:
# stem convs conv/conv_1/../conv_4, blocks mixed/mixed_1/../mixed_10,
# branches conv (1x1), tower, tower_1, tower_2 (pool branch); each conv's
# weights are Consts '<scope>/conv2d_params' + '<scope>/batchnorm/{beta,
# gamma,moving_mean,moving_variance}'. The classifier is 'softmax/weights'
# [2048, 1008] (+ 'softmax/biases', which the reference IGNORES: general IS
# multiplies by the weight alone, inception_score_general.py:97-99, so the
# converted bias is zero).

_FROZEN_STEM = {'conv0': 'conv', 'conv1': 'conv_1', 'conv2': 'conv_2',
                'conv3': 'conv_3', 'conv4': 'conv_4'}

_FZ_M35 = {'branch1x1': 'conv',
           'branch5x5_1': 'tower/conv', 'branch5x5_2': 'tower/conv_1',
           'branch3x3dbl_1': 'tower_1/conv',
           'branch3x3dbl_2': 'tower_1/conv_1',
           'branch3x3dbl_3': 'tower_1/conv_2',
           'branch_pool': 'tower_2/conv'}
_FZ_M17R = {'branch3x3': 'conv',
            'branch3x3dbl_1': 'tower/conv',
            'branch3x3dbl_2': 'tower/conv_1',
            'branch3x3dbl_3': 'tower/conv_2'}
_FZ_M17 = {'branch1x1': 'conv',
           'branch7x7_1': 'tower/conv', 'branch7x7_2': 'tower/conv_1',
           'branch7x7_3': 'tower/conv_2',
           'branch7x7dbl_1': 'tower_1/conv',
           'branch7x7dbl_2': 'tower_1/conv_1',
           'branch7x7dbl_3': 'tower_1/conv_2',
           'branch7x7dbl_4': 'tower_1/conv_3',
           'branch7x7dbl_5': 'tower_1/conv_4',
           'branch_pool': 'tower_2/conv'}
_FZ_M8R = {'branch3x3_1': 'tower/conv', 'branch3x3_2': 'tower/conv_1',
           'branch7x7x3_1': 'tower_1/conv',
           'branch7x7x3_2': 'tower_1/conv_1',
           'branch7x7x3_3': 'tower_1/conv_2',
           'branch7x7x3_4': 'tower_1/conv_3'}
_FZ_M8 = {'branch1x1': 'conv',
          'branch3x3_1': 'tower/conv',
          'branch3x3_2a': 'tower/mixed/conv',
          'branch3x3_2b': 'tower/mixed/conv_1',
          'branch3x3dbl_1': 'tower_1/conv',
          'branch3x3dbl_2': 'tower_1/conv_1',
          'branch3x3dbl_3a': 'tower_1/mixed/conv',
          'branch3x3dbl_3b': 'tower_1/mixed/conv_1',
          'branch_pool': 'tower_2/conv'}

_FROZEN_BLOCKS = {
    'mixed_35x35x256a': ('mixed', _FZ_M35),
    'mixed_35x35x288a': ('mixed_1', _FZ_M35),
    'mixed_35x35x288b': ('mixed_2', _FZ_M35),
    'mixed_17x17x768a': ('mixed_3', _FZ_M17R),
    'mixed_17x17x768b': ('mixed_4', _FZ_M17),
    'mixed_17x17x768c': ('mixed_5', _FZ_M17),
    'mixed_17x17x768d': ('mixed_6', _FZ_M17),
    'mixed_17x17x768e': ('mixed_7', _FZ_M17),
    'mixed_8x8x1280a': ('mixed_8', _FZ_M8R),
    'mixed_8x8x2048a': ('mixed_9', _FZ_M8),
    'mixed_8x8x2048b': ('mixed_10', _FZ_M8),
}


def _flax_path_to_frozen(path) -> str:
    """Tree path -> the 2015 graph's conv scope (without the
    /conv2d_params or /batchnorm/... leaf)."""
    parts = [str(p) for p in path if str(p) not in ('params', 'batch_stats')]
    mods = [m for m in parts[:-1]
            if not m.startswith(('Conv', 'BatchNorm'))]
    if mods[0] in _FROZEN_STEM:
        return _FROZEN_STEM[mods[0]]
    block, branch_map = _FROZEN_BLOCKS[mods[0]]
    return '%s/%s' % (block, branch_map[mods[1]])


def frozen_graph_to_flax(consts: Dict[str, np.ndarray],
                         flax_variables: Dict[str, Any],
                         bn_eps: float = 1e-3) -> Dict[str, Any]:
    """Map the frozen 2015 graph's Const tensors (from
    ``load_frozen_graph_weights``) onto a 'fid'-flavor tree.

    The graph's BN has a gamma constant the scale-free BN lacks; it is
    folded EXACTLY into the variance: gamma*(x-m)/sqrt(v+eps) + beta ==
    (x-m)/sqrt(v'+eps) + beta with v' = (v+eps)/gamma^2 - eps (skipped when
    the graph's BatchNormWithGlobalNormalization nodes declare
    scale_after_normalization=False). The logits bias is zeroed: the
    reference multiplies 'softmax/weights' alone
    (inception_score_general.py:97-99). Raises KeyError listing unmapped
    leaves.
    """
    fold_gamma = bool(consts.get('__scale_after_normalization__', True))
    flat = _flatten_dict(flax_variables)
    new = {}
    missing = []
    for path, val in flat.items():
        leaf = str(path[-1])
        mods = [str(p) for p in path[:-1]]
        if 'logits' in mods:
            if leaf == 'kernel':
                src = consts.get('softmax/weights')
                if src is None:
                    missing.append('softmax/weights')
                    new[path] = val
                    continue
                src = np.asarray(src, np.float32).reshape(val.shape)
                new[path] = src
            else:  # bias: the reference ignores softmax/biases
                new[path] = np.zeros(val.shape, np.float32)
            continue
        scope = _flax_path_to_frozen(path)
        if leaf == 'kernel':
            name = scope + '/conv2d_params'
        else:
            bn_leaf = {'bias': 'beta', 'mean': 'moving_mean',
                       'var': 'moving_variance'}[leaf]
            name = '%s/batchnorm/%s' % (scope, bn_leaf)
        if name not in consts:
            missing.append('%s -> %s' % ('/'.join(str(p) for p in path),
                                         name))
            new[path] = val
            continue
        src = np.asarray(consts[name], np.float32)
        if leaf == 'var' and fold_gamma:
            gamma = consts.get('%s/batchnorm/gamma' % scope)
            if gamma is not None:
                g = np.asarray(gamma, np.float32)
                src = (src + bn_eps) / np.square(g) - bn_eps
        if src.shape != tuple(val.shape):
            raise ValueError('shape mismatch at %s (%s): %s vs %s' % (
                '/'.join(str(p) for p in path), name, src.shape, val.shape))
        new[path] = src
    if missing:
        raise KeyError('unmapped frozen-graph params: %s' % missing[:20])
    return _unflatten_dict(new)


#: where the reference downloads the frozen graph from (fid.py:190-206)
FROZEN_PB_URL = ('http://download.tensorflow.org/models/image/imagenet/'
                 'inception-2015-12-05.tgz')
FROZEN_PB_NAME = 'classify_image_graph_def.pb'


def frozen_pb_to_inception(pb_path: str):
    """One-call loader: frozen pb -> (the 'fid' tower's float32
    state_dict, num_classes). The compute dtype is the scorer's knob, not
    this loader's. num_classes comes from the graph's own
    softmax/weights (1008 in the released export, the padded 2015 label
    set)."""
    consts = load_frozen_graph_weights(pb_path)
    if 'softmax/weights' not in consts:
        raise KeyError(
            '%s has no softmax/weights: not the 2015 inception export? '
            'expected %s from %s' % (pb_path, FROZEN_PB_NAME, FROZEN_PB_URL))
    num_classes = int(consts['softmax/weights'].shape[-1])
    variables = frozen_graph_to_flax(consts,
                                     flax_template(num_classes, 'fid'))
    return inception_from_flax(variables, 'fid'), num_classes


# the tower's module name -> torchvision's top-level module name
_TORCHVISION_TOP = {
    'conv0': 'Conv2d_1a_3x3',
    'conv1': 'Conv2d_2a_3x3',
    'conv2': 'Conv2d_2b_3x3',
    'conv3': 'Conv2d_3b_1x1',
    'conv4': 'Conv2d_4a_3x3',
    'mixed_35x35x256a': 'Mixed_5b',
    'mixed_35x35x288a': 'Mixed_5c',
    'mixed_35x35x288b': 'Mixed_5d',
    'mixed_17x17x768a': 'Mixed_6a',
    'mixed_17x17x768b': 'Mixed_6b',
    'mixed_17x17x768c': 'Mixed_6c',
    'mixed_17x17x768d': 'Mixed_6d',
    'mixed_17x17x768e': 'Mixed_6e',
    'mixed_8x8x1280a': 'Mixed_7a',
    'mixed_8x8x2048a': 'Mixed_7b',
    'mixed_8x8x2048b': 'Mixed_7c',
    'logits': 'fc',
}


def torchvision_state_to_flax(state_dict: Dict[str, Any],
                              flax_variables: Dict[str, Any]):
    """A torchvision inception_v3 state dict (the reference's general-IS
    path downloads inception_v3_google-1a9a5a14, model.py:18-31) -> a
    'torch'-flavor tree. Conv kernels go OIHW -> HWIO; branch names inside
    each Mixed block are torchvision's own."""
    flat = _flatten_dict(flax_variables)
    new = {}
    missing = []
    for path, val in flat.items():
        parts = [str(p) for p in path[1:]]
        leaf = parts[-1]
        mods = parts[:-1]
        top = _TORCHVISION_TOP.get(mods[0], mods[0])
        if mods[0] == 'logits':
            torch_name = {'kernel': 'fc.weight', 'bias': 'fc.bias'}[leaf]
            t = _np(state_dict[torch_name])
            new[path] = t.T.astype(np.float32) if leaf == 'kernel' else \
                t.astype(np.float32)
            continue
        # inside: [branch name,] the ConvBN's Conv_0 / BatchNorm_0
        branch = [m for m in mods[1:] if not m.startswith(('Conv', 'Batch'))]
        prefix = '.'.join([top] + branch)
        if any(m.startswith('Conv') for m in mods):
            assert leaf == 'kernel'
            t = _np(state_dict[prefix + '.conv.weight'])
            new[path] = t.transpose(2, 3, 1, 0).astype(np.float32)
        else:  # BatchNorm
            leaf_map = {'scale': 'bn.weight', 'bias': 'bn.bias',
                        'mean': 'bn.running_mean', 'var': 'bn.running_var'}
            key = prefix + '.' + leaf_map[leaf]
            if key not in state_dict:
                missing.append(key)
                new[path] = val
                continue
            new[path] = _np(state_dict[key]).astype(np.float32)
    if missing:
        raise KeyError('unmapped torch params: %s' % missing[:20])
    return _unflatten_dict(new)
