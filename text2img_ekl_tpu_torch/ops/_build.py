"""Build the port's CUDA kernels and its native host libraries on first use.

Each ``csrc/*.cu`` file of the package is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, which is
loaded with ``ctypes``. All the sources compile at once, one ``nvcc``
process each. A library lands in ``build/`` at the repository root
(git-ignored), named by the source's stem and a hash of the sources,
headers and flags, so an edited source builds anew and an unchanged one is
reused. Nothing builds at import time: the first kernel launch calls
``library()``.

The host code of ``csrc/*.cpp`` (the JPEG decode pipeline and the PNG
writer) is compiled by ``g++`` for the CPU that builds it
(``-march=native``) by ``host_library(stem)``, into the same ``build/``,
named by the stem and a hash of the source, the flags and the compiler's
target (its version and what ``-march=native`` selects on this CPU): a
library built on one host is never loaded on another. A host without
``g++``, the header or the library a source needs raises
``NativeUnavailable``, on which the callers fall back to PIL; a source
that does not compile where all three exist raises ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

HOST_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC', '-std=c++17')
# host source stem -> the header and the library (-l) it needs
HOST_DEPS = {'dataloader': ('jpeglib.h', 'jpeg'),
             'imagewriter': ('png.h', 'png')}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}
# host stem -> the NativeUnavailable its first build or load raised: the
# probe is not run again for every batch of a process that lacks a header
_host_missing: Dict[str, 'NativeUnavailable'] = {}


class NativeUnavailable(RuntimeError):
    """This host cannot build or load a native host library: no ``g++``, a
    missing header or library, or a failed load."""


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


def _gxx_ok(gxx: str, args, stdin: str) -> bool:
    return subprocess.run([gxx, *args], input=stdin, capture_output=True,
                          text=True).returncode == 0


def _has_header(gxx: str, header: str) -> bool:
    # jpeglib.h uses FILE and size_t without including stdio.h itself
    return _gxx_ok(gxx, ['-x', 'c++', '-E', '-o', os.devnull, '-'],
                   '#include <cstdio>\n#include <%s>\n' % header)


def _has_library(gxx: str, lib: str) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        return _gxx_ok(gxx, ['-x', 'c++', '-', '-o',
                             os.path.join(tmp, 'a.out'), '-l' + lib],
                       'int main() { return 0; }\n')


def host_probe() -> Dict[str, Any]:
    """What this host offers the native builds: g++'s version (None without
    g++), and whether g++ finds each header and each library."""
    gxx = shutil.which('g++')
    out: Dict[str, Any] = {'g++': None, 'headers': {}, 'libraries': {}}
    if gxx is None:
        return out
    out['g++'] = subprocess.run([gxx, '--version'], capture_output=True,
                                text=True).stdout.splitlines()[0]
    for header, lib in HOST_DEPS.values():
        out['headers'][header] = _has_header(gxx, header)
        out['libraries']['lib' + lib] = _has_library(gxx, lib)
    return out


def _host_library_path(stem: str, gxx: str) -> Path:
    """Where the library of ``csrc/<stem>.cpp`` built by ``gxx`` on this
    host lives (built or not)."""
    target = subprocess.run(
        [gxx, '--version'], capture_output=True, text=True).stdout + \
        subprocess.run([gxx, '-march=native', '-Q', '--help=target'],
                       capture_output=True, text=True).stdout
    src = CSRC_DIR / ('%s.cpp' % stem)
    h = hashlib.sha256(' '.join(HOST_FLAGS).encode())
    h.update(target.encode())
    h.update(src.read_bytes())
    return BUILD_DIR / ('libt2i_%s_%s.so' % (stem, h.hexdigest()[:16]))


def _build_host(stem: str) -> Path:
    header, lib = HOST_DEPS[stem]
    gxx = shutil.which('g++')
    if gxx is None:
        raise NativeUnavailable('g++ not found on PATH: csrc/%s.cpp cannot '
                                'be built' % stem)
    so = _host_library_path(stem, gxx)
    if so.exists():
        return so
    missing = [what for what, ok in (
        (header, _has_header(gxx, header)),
        ('lib' + lib, _has_library(gxx, lib))) if not ok]
    if missing:
        raise NativeUnavailable('csrc/%s.cpp cannot be built: g++ finds no %s'
                                % (stem, ' and no '.join(missing)))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name('%s.%d.tmp' % (so.name, os.getpid()))
    cmd = [gxx, *HOST_FLAGS, str(CSRC_DIR / ('%s.cpp' % stem)), '-o',
           str(tmp), '-l' + lib, '-lpthread']
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('g++ failed (%d):\n%s\n%s' % (
            proc.returncode, ' '.join(cmd), proc.stderr))
    os.replace(tmp, so)
    return so


def host_library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cpp``, built with g++ on first
    call; raises ``NativeUnavailable`` where this host cannot build or
    load it (again on every later call, without probing again)."""
    with _lock:
        if stem in _host_missing:
            raise _host_missing[stem]
        if stem not in _host_libs:
            try:
                so = _build_host(stem)
                try:
                    _host_libs[stem] = ctypes.CDLL(str(so))
                except OSError as e:
                    raise NativeUnavailable('loading %s failed: %s'
                                            % (so, e)) from e
            except NativeUnavailable as e:
                _host_missing[stem] = e
                raise
        return _host_libs[stem]
