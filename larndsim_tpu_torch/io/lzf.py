"""The LZF chunk codec of ``io.h5``: ``csrc/host/h5lzf.cpp``, built with the
host C++ compiler at first use and bound with ctypes.

Chunks are shuffled and LZF-encoded in one pass, on several threads (the
call releases the GIL), as h5py's pipeline "shuffle, then LZF" stores them;
the decoder inverts it.  The library is built into
``larndsim_tpu_torch/build/`` under a hash of its sources, its flags, the
compiler's identity and the platform.  There is no other LZF path: if the
build fails, :func:`library` raises, and so does every read or write that
needs LZF.  The build-and-load runs under a lock: threads of one process
share the temporary file's name.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(_PKG, 'csrc', 'host', name)
           for name in ('h5lzf.cpp', 'lzf_core.h')]
BUILD_DIR = os.path.join(_PKG, 'build')
FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')
#: HDF5 filter id of LZF, and the client data h5py stores with it
#: (filter version 4, liblzf version 0x0105, then the chunk's bytes)
FILTER_LZF = 32000
LZF_CLIENT = (4, 0x0105)

_LIB = None
_LOCK = threading.Lock()
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def _compiler() -> str:
    for name in ('c++', 'g++'):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError('the LZF codec needs a C++ compiler (c++ or g++ on '
                       'PATH)')


def library_path(cxx: str) -> str:
    """The library's path: its name carries a hash of the sources, the
    flags, the compiler and the platform (a library built on another
    machine is not loaded)."""
    ident = subprocess.run([cxx, '-dumpfullversion', '-dumpmachine'],
                           capture_output=True, text=True).stdout
    h = hashlib.sha256((cxx + ident + platform.platform()
                        + ' '.join(FLAGS)).encode())
    for path in SOURCES:
        with open(path, 'rb') as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f'libh5lzf-{h.hexdigest()[:12]}.so')


def library() -> ctypes.CDLL:
    """The codec's library, compiled first if it is not built yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        cxx = _compiler()
        path = library_path(cxx)
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f'{path}.{os.getpid()}.tmp'
            try:
                proc = subprocess.run([cxx, *FLAGS, '-o', tmp, SOURCES[0]],
                                      capture_output=True, text=True)
                if proc.returncode:
                    raise RuntimeError(f'the LZF codec failed to build '
                                       f'({proc.returncode}):\n{proc.stderr}')
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        lib.h5lzf_encode_chunks.argtypes = [_P, _I64, _I, _I, _P, _P, _P, _I]
        lib.h5lzf_encode_chunks.restype = None
        lib.h5lzf_decode.argtypes = [_P, _I64, _I, _I, _P, _P, _I64]
        lib.h5lzf_decode.restype = _I64
        _LIB = lib
    return _LIB


def threads() -> int:
    """Encoder threads: the cores this process may run on."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except AttributeError:
        return os.cpu_count() or 1


def encode_chunks(raw: np.ndarray, rec: int):
    """Shuffle (``rec`` > 0: records of ``rec`` bytes) and LZF-encode each
    row of ``raw``, a (n_chunks, chunk_bytes) uint8 array, on
    :func:`threads` threads.  Returns
    (streams, sizes, skipped): chunk i's stream is ``streams[i, :sizes[i]]``,
    stored without LZF (shuffled only) where ``skipped[i]``."""
    raw = np.ascontiguousarray(raw, np.uint8)
    n, chunk_bytes = raw.shape
    if chunk_bytes >= 2 ** 31:
        raise ValueError('LZF chunks must hold less than 2 GiB')
    out = np.empty_like(raw)
    sizes = np.empty(n, np.int64)
    skipped = np.empty(n, np.uint8)
    library().h5lzf_encode_chunks(
        raw.ctypes.data, n, chunk_bytes, rec, out.ctypes.data,
        sizes.ctypes.data, skipped.ctypes.data, threads())
    return out, sizes, skipped


def decode(stream, nbytes: int, rec: int = 0,
           skip_lzf: bool = False) -> np.ndarray:
    """One chunk's ``nbytes`` (uint8) from its stored ``stream``: LZF-decoded
    unless ``skip_lzf``, then unshuffled when ``rec`` > 0."""
    src = np.frombuffer(stream, np.uint8)
    out = np.empty(nbytes, np.uint8)
    scratch = np.empty(nbytes if rec > 0 else 0, np.uint8)
    got = library().h5lzf_decode(src.ctypes.data, len(src), int(skip_lzf),
                                 rec, scratch.ctypes.data, out.ctypes.data,
                                 nbytes)
    if got != nbytes:
        raise OSError(f'corrupt LZF chunk: {got} bytes decoded, '
                      f'{nbytes} expected')
    return out
