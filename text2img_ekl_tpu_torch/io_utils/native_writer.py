"""ctypes binding of the port's async PNG writer (``csrc/imagewriter.cpp``).

Counterpart of ``text2img_ekl_tpu/io_utils/native_writer.py``. The offline
sampling protocol writes one PNG per (image, caption, noise) triple, 30k
files at TEST.SAMPLE_NUM (reference cub_trainer_splitz_cap_ca.py:758-774,
miscc/config.py:32), and the reference does it synchronously through PIL
inside the sampling loop. Here the encode runs on a C++ thread pool off the
GIL, overlapped with the device's sampling; ``flush()`` joins before the
directory is read.

The library is built with g++ and libpng on first use into ``build/``
(``ops/_build.py::host_library``). ``NativeUnavailable`` is raised only
where this host has no g++, png.h or libpng, or the library does not load;
callers fall back to PIL on it alone. One process-wide writer:
``T2I_WRITER_THREADS`` threads (default min(4, cores)), zlib level
``T2I_PNG_LEVEL`` (default 1). ``batches`` counts the batches enqueued.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Sequence

import numpy as np

from ..ops._build import NativeUnavailable, host_library

__all__ = ['NativeUnavailable', 'write_png_batch', 'flush']

_lock = threading.Lock()
_lib = None
_writer = None
# batches enqueued in this process, as the kernels count their launches
batches = 0


def _get_lib():
    global _lib
    if _lib is None:
        lib = host_library('imagewriter')
        lib.t2i_writer_create.restype = ctypes.c_void_p
        lib.t2i_writer_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.t2i_writer_destroy.restype = None
        lib.t2i_writer_destroy.argtypes = [ctypes.c_void_p]
        lib.t2i_write_png_batch.restype = ctypes.c_int
        lib.t2i_write_png_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.t2i_writer_flush.restype = ctypes.c_int
        lib.t2i_writer_flush.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def _get_writer():
    """The process-wide writer (its thread pool sized by the environment)."""
    global _writer
    with _lock:
        if _writer is None:
            lib = _get_lib()
            threads = int(os.environ.get(
                'T2I_WRITER_THREADS', min(4, os.cpu_count() or 1)))
            # zlib level 1 (still lossless): the files are transient IS/FID
            # inputs, their size is secondary to the encode's time
            level = int(os.environ.get('T2I_PNG_LEVEL', 1))
            _writer = ctypes.c_void_p(lib.t2i_writer_create(threads, level))
        return _writer


def write_png_batch(images: np.ndarray, paths: Sequence[str]) -> None:
    """Write ``images[i]`` (HW grey, or HWC with 1 or 3 channels, uint8) to
    ``paths[i]`` asynchronously.

    Returns once the batch is enqueued: the writer copies the pixels, so
    the caller may reuse ``images`` at once. Call ``flush()`` before
    reading the files back.
    """
    global batches
    images = np.asarray(images)
    if images.dtype != np.uint8:
        raise ValueError('write_png_batch takes uint8 pixels, got %s'
                         % images.dtype)
    if images.ndim == 3:
        images = images[..., None]
    if images.ndim != 4 or images.shape[-1] not in (1, 3):
        raise ValueError('write_png_batch takes [N, H, W] or [N, H, W, 1|3] '
                         'images, got shape %s' % (images.shape,))
    n, h, w, c = images.shape
    if len(paths) != n:
        raise ValueError('got %d paths for %d images' % (len(paths), n))
    if n == 0:
        return
    images = np.ascontiguousarray(images)
    writer = _get_writer()
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = _lib.t2i_write_png_batch(
        writer, n, arr,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c)
    if rc != 0:
        raise RuntimeError('t2i_write_png_batch returned %d' % rc)
    with _lock:
        batches += 1


def flush() -> int:
    """Block until every queued write has finished; return the number of
    writes that failed since the last flush (0 when nothing was ever
    enqueued)."""
    if _writer is None:
        return 0
    return _lib.t2i_writer_flush(_writer)
