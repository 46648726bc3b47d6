"""Compile ``csrc/*.cu`` into one shared library with nvcc, at first use.

The library has a plain C interface and is loaded with ctypes.  It is
built into ``larndsim_tpu_torch/build/`` under a name that carries the
hash of the sources and flags, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

#: -fmad=false: no fused multiply-add contraction, so every float32 op
#: rounds on its own as in the JAX reference (threshold crossings and
#: LUT bin edges depend on it)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC')

_LIB = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (nvcc on PATH or /usr/local/cuda/bin)')


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, '*.cu')))


def library_path() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f'libkernels-{h.hexdigest()[:12]}.so')


def load() -> ctypes.CDLL:
    """The kernels' library, compiled first if its sources changed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.isfile(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        t0 = time.perf_counter()
        cmd = [_nvcc(), *NVCC_FLAGS, '-o', tmp, *sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
        os.replace(tmp, path)
        build_seconds = time.perf_counter() - t0
    _LIB = ctypes.CDLL(path)
    return _LIB
