"""Compile ``csrc/*.cu`` into one shared library with nvcc, at first use.

Each source is compiled by its own nvcc process, all started together, and
the objects are linked into one library with a plain C interface, loaded
with ctypes.  It is built into ``larndsim_tpu_torch/build/`` under a name
that carries the hash of the sources and flags, so an edited source is
rebuilt.  The build-and-load runs under a lock: threads of one process
share the temporary object names.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

#: -fmad=false: no fused multiply-add contraction, so every float32 op
#: rounds on its own as in the JAX reference (threshold crossings and
#: LUT bin edges depend on it)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xcompiler', '-fPIC')

_LIB = None
_LOCK = threading.Lock()
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


#: the name of a ``__global__`` function (after any ``__launch_bounds__``)
_GLOBAL = re.compile(r'__global__\s+void\s+(?:__launch_bounds__\s*\(.*?\)\s+)?'
                     r'(\w+)\s*\(', re.S)


def kernel_names() -> list[str]:
    """The ``__global__`` functions of ``csrc/*.cu``, as the profiler's
    kernel names contain them."""
    names = []
    for path in sources():
        with open(path) as f:
            names += _GLOBAL.findall(f.read())
    return names


def library_path() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sources():
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f'libkernels-{h.hexdigest()[:12]}.so')


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise on the first that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode:
            raise RuntimeError(f'nvcc failed ({p.returncode}):\n'
                               f'{" ".join(cmd)}\n{out}{err}')


def load() -> ctypes.CDLL:
    """The kernels' library, compiled first if its sources changed."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tag = f'{os.getpid()}.tmp'
            t0 = time.perf_counter()
            nvcc = _nvcc()
            objs = [os.path.join(BUILD_DIR,
                                 f'{os.path.basename(src)}.{tag}.o')
                    for src in sources()]
            tmp = f'{path}.{tag}'
            try:
                _run([[nvcc, *NVCC_FLAGS, '-c', src, '-o', obj]
                      for src, obj in zip(sources(), objs)])
                _run([[nvcc, '-shared', '-o', tmp, *objs]])
                os.replace(tmp, path)
            finally:
                for leftover in (*objs, tmp):
                    if os.path.exists(leftover):
                        os.remove(leftover)
            build_seconds = time.perf_counter() - t0
        _LIB = ctypes.CDLL(path)
    return _LIB
