"""Build the port's CUDA kernels on first use.

Each ``csrc/*.cu`` file of the package is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, which is
loaded with ``ctypes``. All the sources compile at once, one ``nvcc``
process each. A library lands in ``build/`` at the repository root
(git-ignored), named by the source's stem and a hash of the sources,
headers and flags, so an edited source builds anew and an unchanged one is
reused. Nothing builds at import time: the first kernel launch calls
``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin or '
                           '/usr/local/cuda/bin): the CUDA kernels cannot '
                           'be built')
    return path


def _sources():
    srcs = sorted(CSRC_DIR.glob('*.cu'))
    if not srcs:
        raise RuntimeError('no CUDA sources under %s' % CSRC_DIR)
    return srcs


def library_paths() -> Dict[str, Path]:
    """Source stem -> where its library lives (built or not). Every hash
    covers the headers, which any source may include."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    out = {}
    for src in _sources():
        hs = h.copy()
        hs.update(src.name.encode())
        hs.update(src.read_bytes())
        out[src.stem] = BUILD_DIR / ('lib%s_%s.so' % (src.stem,
                                                      hs.hexdigest()[:16]))
    return out


def build() -> Dict[str, Path]:
    """Compile every source whose library does not exist, all at once;
    returns stem -> library path. The compiler's ptxas report (registers,
    shared memory, spills per kernel) is kept beside each as ``.log``."""
    paths = library_paths()
    todo = {stem: so for stem, so in paths.items() if not so.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem, so in todo.items():
        tmp = so.with_name('%s.%d.tmp' % (so.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / ('%s.cu' % stem))]
        procs.append((so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for so, tmp, cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append('nvcc failed (%d):\n%s\n%s' % (
                proc.returncode, ' '.join(cmd), err))
            continue
        so.with_suffix('.log').write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError('\n'.join(failed))
    return paths


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first call."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build()[stem]))
        return _libs[stem]
