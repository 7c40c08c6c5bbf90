"""InceptionV3 for IS and FID, PyTorch, NCHW, eval mode only.

Counterpart of ``text2img_ekl_tpu/models/inception_v3.py``: one tower in
three flavors, for the fine-tuned TF-slim IS checkpoint, the frozen 2015
ImageNet graph that FID and general IS run (``fid``, with its mixed_10
max-pool quirk) and torchvision's inception_v3 (``torch``). Module names
are the JAX package's (``conv0``..``conv4``, ``mixed_35x35x256a``..
``mixed_8x8x2048b``, ``logits``, and its branch names), so weights cross
by name (``io_utils/weights.py::inception_from_flax``).

Each ``ConvBN`` is conv without bias in the tower's dtype, then BatchNorm
with its moving statistics (eps 1e-3; gamma only with ``bn_scale``) and
ReLU in float32, cast back to the tower's dtype, as flax computes it.
``pool_3`` (the 2048-d global average) and the logits are float32. A
float32 tower, and the resize, compute in float32 on the card whatever
the process's TF32 settings say (PyTorch lets cuDNN run float32
convolutions in TF32 by default).

The preprocessing works on NCHW batches, as the tower does: 0..255
images (uint8 or float), or the generator's [-1, 1] output.
``preprocess_uint8`` and ``preprocess_gan_output`` resize to 299 as
``jax.image.resize(..., 'bilinear')`` does (half-pixel centres; a
triangle filter widened by the scale where an axis shrinks);
``preprocess_frozen`` resizes as the frozen graph's TF1 ResizeBilinear
does (``resize_bilinear_tf1``) and normalises (x - 128) / 128.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3


@contextlib.contextmanager
def _float32_exact():
    """float32 convolutions and products in float32, not TF32, inside;
    the process's settings outside."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.set_float32_matmul_precision(matmul)


class _BatchNorm(nn.Module):
    """Eval-mode BatchNorm parameters under torch's names: ``weight``
    (gamma, only with ``scale``), ``bias`` (beta), ``running_mean``,
    ``running_var``."""

    def __init__(self, n: int, scale: bool):
        super().__init__()
        if scale:
            self.weight = nn.Parameter(torch.ones(n))
        else:
            self.register_parameter('weight', None)
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer('running_mean', torch.zeros(n))
        self.register_buffer('running_var', torch.ones(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class ConvBN(nn.Module):
    """conv -> BN(eps 1e-3) -> ReLU. 'SAME' pads a stride-1 conv by half
    its kernel on each side; 'VALID' pads nothing."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: str = 'SAME',
                 bn_scale: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding == 'SAME':
            if stride != 1:
                raise ValueError('SAME padding is built for stride 1 only')
            pad = (kernel[0] // 2, kernel[1] // 2)
        else:
            pad = (0, 0)
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False,
                              dtype=dtype)
        self.bn = _BatchNorm(cout, bn_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.conv(x).float())
        return F.relu_(y).to(self.dtype)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride 2 'VALID' max pool of the grid reductions."""
    return F.max_pool2d(x, 3, 2)


def _branch_pool(x: torch.Tensor, torch_pool: bool) -> torch.Tensor:
    """The branch pools' 3x3 / stride 1 'SAME' average. TF, slim and
    keras leave the padded cells out of the divisor; torchvision's
    F.avg_pool2d counts them (its default): the flavor switch matters at
    the borders. A bf16 tower sums the window in float32 and rounds once;
    JAX's reduce_window on XLA:CPU rounds after every add."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=torch_pool)


class _Block(nn.Module):
    def __init__(self, bn_scale: bool, torch_pool: bool, dtype: torch.dtype):
        super().__init__()
        self.torch_pool = torch_pool
        self._kw = dict(bn_scale=bn_scale, dtype=dtype)

    def _conv(self, name, cin, cout, kernel, stride=1, padding='SAME'):
        setattr(self, name, ConvBN(cin, cout, kernel, stride, padding,
                                   **self._kw))


class Mixed35(_Block):
    """35x35 inception block (slim mixed_35x35x256a..288b)."""

    def __init__(self, cin: int, pool_features: int, **kw):
        super().__init__(**kw)
        self._conv('branch1x1', cin, 64, (1, 1))
        self._conv('branch5x5_1', cin, 48, (1, 1))
        self._conv('branch5x5_2', 48, 64, (5, 5))
        self._conv('branch3x3dbl_1', cin, 64, (1, 1))
        self._conv('branch3x3dbl_2', 64, 96, (3, 3))
        self._conv('branch3x3dbl_3', 96, 96, (3, 3))
        self._conv('branch_pool', cin, pool_features, (1, 1))

    def forward(self, x):
        b0 = self.branch1x1(x)
        b1 = self.branch5x5_2(self.branch5x5_1(x))
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        b3 = self.branch_pool(_branch_pool(x, self.torch_pool))
        return torch.cat([b0, b1, b2, b3], 1)


class Mixed17Reduce(_Block):
    """35 -> 17 grid reduction (slim mixed_17x17x768a)."""

    def __init__(self, cin: int, **kw):
        super().__init__(**kw)
        self._conv('branch3x3', cin, 384, (3, 3), 2, 'VALID')
        self._conv('branch3x3dbl_1', cin, 64, (1, 1))
        self._conv('branch3x3dbl_2', 64, 96, (3, 3))
        self._conv('branch3x3dbl_3', 96, 96, (3, 3), 2, 'VALID')

    def forward(self, x):
        b0 = self.branch3x3(x)
        b1 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b0, b1, _max_pool(x)], 1)


class Mixed17(_Block):
    """17x17 block with 7x1 / 1x7 factorisation (mixed_17x17x768b..e)."""

    def __init__(self, cin: int, c7: int, **kw):
        super().__init__(**kw)
        self._conv('branch1x1', cin, 192, (1, 1))
        self._conv('branch7x7_1', cin, c7, (1, 1))
        self._conv('branch7x7_2', c7, c7, (1, 7))
        self._conv('branch7x7_3', c7, 192, (7, 1))
        self._conv('branch7x7dbl_1', cin, c7, (1, 1))
        self._conv('branch7x7dbl_2', c7, c7, (7, 1))
        self._conv('branch7x7dbl_3', c7, c7, (1, 7))
        self._conv('branch7x7dbl_4', c7, c7, (7, 1))
        self._conv('branch7x7dbl_5', c7, 192, (1, 7))
        self._conv('branch_pool', cin, 192, (1, 1))

    def forward(self, x):
        b0 = self.branch1x1(x)
        b1 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b2 = self.branch7x7dbl_1(x)
        for k in range(2, 6):
            b2 = getattr(self, 'branch7x7dbl_%d' % k)(b2)
        b3 = self.branch_pool(_branch_pool(x, self.torch_pool))
        return torch.cat([b0, b1, b2, b3], 1)


class Mixed8Reduce(_Block):
    """17 -> 8 grid reduction (slim mixed_8x8x1280a)."""

    def __init__(self, cin: int, **kw):
        super().__init__(**kw)
        self._conv('branch3x3_1', cin, 192, (1, 1))
        self._conv('branch3x3_2', 192, 320, (3, 3), 2, 'VALID')
        self._conv('branch7x7x3_1', cin, 192, (1, 1))
        self._conv('branch7x7x3_2', 192, 192, (1, 7))
        self._conv('branch7x7x3_3', 192, 192, (7, 1))
        self._conv('branch7x7x3_4', 192, 192, (3, 3), 2, 'VALID')

    def forward(self, x):
        b0 = self.branch3x3_2(self.branch3x3_1(x))
        b1 = self.branch7x7x3_1(x)
        for k in range(2, 5):
            b1 = getattr(self, 'branch7x7x3_%d' % k)(b1)
        return torch.cat([b0, b1, _max_pool(x)], 1)


class Mixed8(_Block):
    """8x8 block with split 3x3 branches (mixed_8x8x2048a/b).

    ``pool_max`` is the frozen 2015 ImageNet export's quirk: its last 8x8
    block ('mixed_10') pools its pool branch with a 3x3 max where every
    other Inception-V3 (slim, keras, torchvision) averages. FID against
    the reference's statistics depends on that graph exactly."""

    def __init__(self, cin: int, pool_max: bool = False, **kw):
        super().__init__(**kw)
        self.pool_max = pool_max
        self._conv('branch1x1', cin, 320, (1, 1))
        self._conv('branch3x3_1', cin, 384, (1, 1))
        self._conv('branch3x3_2a', 384, 384, (1, 3))
        self._conv('branch3x3_2b', 384, 384, (3, 1))
        self._conv('branch3x3dbl_1', cin, 448, (1, 1))
        self._conv('branch3x3dbl_2', 448, 384, (3, 3))
        self._conv('branch3x3dbl_3a', 384, 384, (1, 3))
        self._conv('branch3x3dbl_3b', 384, 384, (3, 1))
        self._conv('branch_pool', cin, 192, (1, 1))

    def forward(self, x):
        b0 = self.branch1x1(x)
        b1 = self.branch3x3_1(x)
        b1 = torch.cat([self.branch3x3_2a(b1), self.branch3x3_2b(b1)], 1)
        b2 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b2 = torch.cat([self.branch3x3dbl_3a(b2), self.branch3x3dbl_3b(b2)],
                       1)
        if self.pool_max:  # 'SAME': -inf padding, as torch pads a max pool
            b3 = F.max_pool2d(x, 3, 1, 1)
        else:
            b3 = _branch_pool(x, self.torch_pool)
        return torch.cat([b0, b1, b2, self.branch_pool(b3)], 1)


class InceptionV3(nn.Module):
    """The whole tower; ``forward`` returns (logits, endpoints) with
    endpoints 'mixed_17x17x768e', 'pool_3' and 'logits'."""

    def __init__(self, num_classes: int = 1000, bn_scale: bool = False,
                 torch_pool: bool = True, last_pool_max: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        conv = dict(bn_scale=bn_scale, dtype=dtype)
        kw = dict(conv, torch_pool=torch_pool)
        self.conv0 = ConvBN(3, 32, (3, 3), 2, 'VALID', **conv)
        self.conv1 = ConvBN(32, 32, (3, 3), 1, 'VALID', **conv)
        self.conv2 = ConvBN(32, 64, (3, 3), **conv)
        self.conv3 = ConvBN(64, 80, (1, 1), 1, 'VALID', **conv)
        self.conv4 = ConvBN(80, 192, (3, 3), 1, 'VALID', **conv)
        self.mixed_35x35x256a = Mixed35(192, 32, **kw)
        self.mixed_35x35x288a = Mixed35(256, 64, **kw)
        self.mixed_35x35x288b = Mixed35(288, 64, **kw)
        self.mixed_17x17x768a = Mixed17Reduce(288, **kw)
        self.mixed_17x17x768b = Mixed17(768, 128, **kw)
        self.mixed_17x17x768c = Mixed17(768, 160, **kw)
        self.mixed_17x17x768d = Mixed17(768, 160, **kw)
        self.mixed_17x17x768e = Mixed17(768, 192, **kw)
        self.mixed_8x8x1280a = Mixed8Reduce(768, **kw)
        self.mixed_8x8x2048a = Mixed8(1280, **kw)
        self.mixed_8x8x2048b = Mixed8(2048, pool_max=last_pool_max, **kw)
        self.logits = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.dtype != torch.float32:
            return self._forward(x)
        with _float32_exact():
            return self._forward(x)

    def _forward(self, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        ep = {}
        x = x.to(self.dtype)
        x = self.conv2(self.conv1(self.conv0(x)))
        x = _max_pool(x)
        x = self.conv4(self.conv3(x))
        x = _max_pool(x)
        for name in ('mixed_35x35x256a', 'mixed_35x35x288a',
                     'mixed_35x35x288b', 'mixed_17x17x768a',
                     'mixed_17x17x768b', 'mixed_17x17x768c',
                     'mixed_17x17x768d', 'mixed_17x17x768e'):
            x = getattr(self, name)(x)
        ep['mixed_17x17x768e'] = x
        x = self.mixed_8x8x2048b(self.mixed_8x8x2048a(
            self.mixed_8x8x1280a(x)))
        # the global average: slim's 8x8 pool at 299 input, adaptive at
        # other sizes (as the frozen graph is); in the tower's dtype
        pool3 = x.mean((2, 3)).float()
        ep['pool_3'] = pool3
        logits = self.logits(pool3)
        ep['logits'] = logits
        return logits, ep


def make_inception(num_classes: int = 1000, flavor: str = 'slim',
                   dtype: torch.dtype = torch.float32) -> InceptionV3:
    """'slim': TF-slim / keras (BN without scale, border-exclusive average
    pools), for the fine-tuned IS checkpoint. 'torch': torchvision (BN
    scale, border-inclusive pools), for general IS in training. 'fid':
    the frozen 2015 export exactly, slim plus the mixed_10 max pool; use
    it with ``preprocess_frozen``."""
    if flavor == 'slim':
        return InceptionV3(num_classes, bn_scale=False, torch_pool=False,
                           dtype=dtype)
    if flavor == 'torch':
        return InceptionV3(num_classes, bn_scale=True, torch_pool=True,
                           dtype=dtype)
    if flavor == 'fid':
        return InceptionV3(num_classes, bn_scale=False, torch_pool=False,
                           last_pool_max=True, dtype=dtype)
    raise ValueError(flavor)


def _jax_bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """One axis of ``jax.image.resize(..., 'bilinear')`` as a [in, out]
    float32 matrix, in the arithmetic of JAX's compiled
    ``compute_weight_mat`` (jax._src.image.scale): half-pixel sample
    positions (XLA fuses their multiply-add: one rounding), a triangle
    kernel widened by in/out where the axis shrinks (JAX's antialias),
    columns normalised to sum 1, samples outside the input zeroed. torch's
    ``antialias=True`` resize computes these weights in another float32
    order and lands 2.5e-5 from JAX at 320 -> 299 px; these are within a
    float32 ulp of JAX's."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    centre = np.arange(out_size, dtype=f32) + f32(0.5)
    sample = (centre.astype(np.float64) * np.float64(inv_scale)
              - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _on_device(kind: str, in_size: int, out_size: int,
               device: torch.device):
    """The resize tables, built once per device: a table copied from
    pageable host memory on every call would wait for the stream."""
    if kind == 'jax':
        return torch.from_numpy(
            _jax_bilinear_weights(in_size, out_size)).to(device)
    return tuple(t.to(device) for t in _legacy_taps(in_size, out_size))


def _resize_bilinear(x: torch.Tensor, size=(299, 299)) -> torch.Tensor:
    """``jax.image.resize(x, ..., 'bilinear')`` over H and W of a float32
    NCHW batch, as JAX computes it: each axis that changes contracts with
    its weight matrix."""
    h, w = x.shape[-2:]
    with _float32_exact():
        if h != size[0]:
            x = _on_device('jax', h, size[0], x.device).t() @ x
        if w != size[1]:
            x = x @ _on_device('jax', w, size[1], x.device)
    return x


def preprocess_uint8(images: torch.Tensor) -> torch.Tensor:
    """0..255 NCHW batch (uint8 or float) -> 299x299 in [-1, 1]: bilinear
    resize of the raw pixels, then / 127.5 - 1 (inception_score.py:72-83).
    """
    x = _resize_bilinear(images.float())
    return x * (2.0 / 255.0) - 1.0


@functools.lru_cache(maxsize=None)
def _legacy_taps(in_size: int, out_size: int):
    """TF1 ResizeBilinear's taps for one axis: output i samples input
    i * in/out, computed in float32 as the TF kernel computes it, with
    the upper tap clamped to the last row or column."""
    scale = np.float32(in_size / out_size)
    pos = np.arange(out_size, dtype=np.float32) * scale
    lo = np.floor(pos).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (pos - lo).astype(np.float32)
    return (torch.from_numpy(lo.astype(np.int64)),
            torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(frac))


def _resize_axis_legacy(x: torch.Tensor, axis: int,
                        out_size: int) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    lo, hi, frac = _on_device('tf1', in_size, out_size, x.device)
    shape = [1] * x.dim()
    shape[axis] = out_size
    xlo = x.index_select(axis, lo)
    xhi = x.index_select(axis, hi)
    return xlo + (xhi - xlo) * frac.reshape(shape)


def resize_bilinear_tf1(images: torch.Tensor, size=(299, 299)
                        ) -> torch.Tensor:
    """TF1 legacy ResizeBilinear (align_corners False, half_pixel_centers
    False) of an NCHW batch, the resize baked into the frozen 2015 graph
    right after its input ('ExpandDims:0', fid.py:95). No half-pixel
    shift and no antialiasing, unlike ``preprocess_uint8``'s resize."""
    x = images.float()
    x = _resize_axis_legacy(x, 2, size[0])
    return _resize_axis_legacy(x, 3, size[1])


def preprocess_frozen(images: torch.Tensor) -> torch.Tensor:
    """0..255 NCHW batch -> the frozen graph's conv input: its legacy
    resize, then (x - 128) * 0.0078125 (fid.py:95,
    inception_score_general.py:78)."""
    return (resize_bilinear_tf1(images) - 128.0) * 0.0078125


def preprocess_gan_output(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW generator output -> 299x299 in [-1, 1] (the
    reference's detour through integer pixels,
    cub_trainer_splitz_cap_ca.py:621, does not move the score)."""
    return _resize_bilinear(images.float())
