"""The host C++ libraries of ``csrc/host/``: each built with the host C++
compiler at first use and bound with ctypes.

The benchmark builds one of them, the LZF codec that the HDF5 reader
loads (``io/lzf.py``), into ``build/`` beside this copy, under a name
that carries a hash of its sources, the flags, the compiler's identity and
the platform, so an edited source is rebuilt and a library built on
another machine is not loaded.
There is no fallback: a library that does not build raises
``RuntimeError``, and so does every call that needs it.  Builds and loads
run under :data:`LOCK`: threads of one process share a temporary file's
name, and a library is loaded once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_DIR = os.path.join(_PKG, 'csrc', 'host')
BUILD_DIR = os.path.join(_PKG, 'build')
FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')
#: held by a caller while it builds, loads and binds a library
LOCK = threading.Lock()


def compiler() -> str:
    """The host C++ compiler (``c++``, else ``g++``, on PATH)."""
    for name in ('c++', 'g++'):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError('the host libraries need a C++ compiler (c++ or g++ '
                       'on PATH)')


def sources(*names: str) -> list[str]:
    """The paths of ``csrc/host`` files."""
    return [os.path.join(HOST_DIR, name) for name in names]


def library_path(name: str, srcs, build_dir: str, cxx: str) -> str:
    """``lib{name}-{hash}.so`` in ``build_dir``: the hash covers the
    sources (names and bytes), the flags, the compiler and the platform."""
    ident = subprocess.run([cxx, '-dumpfullversion', '-dumpmachine'],
                           capture_output=True, text=True).stdout
    h = hashlib.sha256((cxx + ident + platform.platform()
                        + ' '.join(FLAGS)).encode())
    for path in srcs:
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(build_dir, f'lib{name}-{h.hexdigest()[:12]}.so')


def load(name: str, srcs, build_dir: str, what: str) -> ctypes.CDLL:
    """The library ``name`` compiled from ``srcs`` (the first the
    translation unit, the rest the headers it includes), built into
    ``build_dir`` first if it is not there.  The caller holds
    :data:`LOCK`.  ``what`` names the library in a build error."""
    cxx = compiler()
    path = library_path(name, srcs, build_dir, cxx)
    if not os.path.isfile(path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        try:
            proc = subprocess.run([cxx, *FLAGS, '-o', tmp, srcs[0]],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f'{what} failed to build '
                                   f'({proc.returncode}):\n{proc.stderr}')
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(path)
