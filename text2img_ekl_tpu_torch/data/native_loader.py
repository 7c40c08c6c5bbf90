"""ctypes binding of the port's native batch decode pipeline
(``csrc/dataloader.cpp``).

Counterpart of ``text2img_ekl_tpu/data/native_loader.py``. The library is
built with g++ and libjpeg on first use into ``build/``
(``ops/_build.py::host_library``). ``NativeUnavailable`` is raised only
where this host has no g++, jpeglib.h or libjpeg, or the library does not
load: the loader then falls back to the PIL path (``data/transforms.py``).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..ops._build import NativeUnavailable, host_library

__all__ = ['NativeUnavailable', 'NativeDecoder']


def _lib():
    lib = host_library('dataloader')
    lib.t2i_loader_create.restype = ctypes.c_void_p
    lib.t2i_loader_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_uint64]
    lib.t2i_loader_destroy.restype = None
    lib.t2i_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.t2i_decode_batch.restype = ctypes.c_int
    lib.t2i_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int, ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int]
    return lib


class NativeDecoder:
    """Batched JPEG -> multi-scale pyramids in C++ threads: [-1, 1]
    float32, or raw uint8 when ``uint8_output`` (the train step then
    normalises on the device: 4x less host bandwidth and H2D transfer)."""

    def __init__(self, sizes: Sequence[int], num_threads: int = 4,
                 seed: int = 0, uint8_output: bool = False):
        self.sizes = [int(s) for s in sizes]
        self.uint8_output = bool(uint8_output)
        self.lib = _lib()
        arr = (ctypes.c_int * len(self.sizes))(*self.sizes)
        # Scale(imsize * 76 / 64) before the crop (reference main.py:111)
        oversize = int(self.sizes[-1] * 76 / 64)
        self.handle = self.lib.t2i_loader_create(
            num_threads, len(self.sizes), arr, oversize, seed)

    def __del__(self):
        if getattr(self, 'handle', None) and getattr(self, 'lib', None):
            self.lib.t2i_loader_destroy(self.handle)
            self.handle = None

    def decode_batch(self, paths: Sequence[str],
                     bboxes: Optional[np.ndarray] = None,
                     train: bool = True, seed: int = 0) -> List[np.ndarray]:
        """[branch][n, s, s, 3] arrays: float32 in [-1, 1], or raw uint8
        with ``uint8_output``. ``bboxes`` [n, 4] (x, y, w, h) crop each
        image to its CUB square first. A file that fails to decode fills
        its slots with 0.0 (uint8: 128), and the count is printed."""
        n = len(paths)
        c_paths = (ctypes.c_char_p * n)(*[p.encode('utf-8') for p in paths])
        if bboxes is not None:
            bb = np.ascontiguousarray(bboxes, np.float32)
            if bb.shape != (n, 4):
                raise ValueError('bboxes of shape %s for %d paths'
                                 % (bb.shape, n))
            has = np.ones(n, np.uint8)
        else:
            bb = np.zeros((n, 4), np.float32)
            has = np.zeros(n, np.uint8)
        dtype = np.uint8 if self.uint8_output else np.float32
        outs = [np.empty((n, s, s, 3), dtype) for s in self.sizes]
        out_ptrs = (ctypes.c_void_p * len(outs))(
            *[o.ctypes.data_as(ctypes.c_void_p) for o in outs])
        failures = self.lib.t2i_decode_batch(
            self.handle, n, c_paths,
            bb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            has.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            1 if train else 0, seed, out_ptrs,
            1 if self.uint8_output else 0)
        if failures:
            print('!! native decoder: %d/%d images failed (zero-filled)'
                  % (failures, n))
        return outs
