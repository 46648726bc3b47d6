"""The light truth's record emitter: ``csrc/host/truth_emit.cpp``, a host
library of ``utils.host_build``, and its numpy version.

Both turn the (rows, S) truth values of one trigger's active contributor
rows into ``io.export.TRUTH_DTYPE`` records: a record for each value with
|v| > threshold (compared in float32), in the order channel, tick,
contributor row.  :func:`records` counts them and writes them in one
sequential pass; the call releases the GIL, so the host route's truth
workers emit at once.  :func:`records_plain` is the numpy version, which
tests and ``chip_smoke.py`` compare it with, and which the reference's
staged truth (records kept by slot activity, ``keep``) runs.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..io.export import TRUTH_DTYPE
from ..utils import host_build

SOURCES = host_build.sources('truth_emit.cpp')
BUILD_DIR = host_build.BUILD_DIR
_LIB = None


def library() -> ctypes.CDLL:
    """The emitter's library, compiled first if it is not built yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with host_build.LOCK:
        if _LIB is not None:
            return _LIB
        lib = host_build.load('truth_emit', SOURCES, BUILD_DIR,
                              'the truth emitter')
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        lib.truth_count.argtypes = [ctypes.c_void_p, i64, i64,
                                    ctypes.c_double]
        lib.truth_count.restype = i64
        lib.truth_emit.argtypes = ([ctypes.c_void_p] * 5
                                   + [i64, i64, i64, ctypes.c_double, i32,
                                      i32, ctypes.c_void_p])
        lib.truth_emit.restype = None
        _LIB = lib
    return _LIB


def records(res: np.ndarray, rows_k: np.ndarray, c_starts: np.ndarray,
            op_channel, ids: np.ndarray, threshold: float,
            event_id: int = 0, trigger_id: int = 0) -> np.ndarray:
    """The records of ``res`` (float32, (R, S)), whose rows
    ``c_starts[c]:c_starts[c + 1]`` are channel ``c``'s (``op_channel[c]``)
    contributors ``rows_k`` (columns of ``ids``, (C, K) segment ids)."""
    if res.dtype != np.float32 or res.ndim != 2:
        raise TypeError(f'truth values of {res.dtype}, {res.ndim} dims: '
                        '(rows, samples) float32 expected')
    ids = np.ascontiguousarray(ids, np.int64)
    C, K = ids.shape
    rows_k = np.ascontiguousarray(rows_k, np.int32)
    c_starts = np.ascontiguousarray(c_starts, np.int64)
    op_c = np.ascontiguousarray(np.asarray(op_channel)[:C], np.int32)
    R, S = res.shape
    if (rows_k.shape != (R,) or c_starts.shape != (C + 1,)
            or c_starts[0] != 0 or c_starts[-1] != R
            or (np.diff(c_starts) < 0).any() or op_c.shape != (C,)
            or (R and (rows_k.min() < 0 or rows_k.max() >= K))):
        raise ValueError(f'inconsistent truth rows: {R} rows, channel '
                         f'starts {c_starts.shape}, {C} x {K} ids')
    res = np.ascontiguousarray(res)
    lib = library()
    out = np.empty(lib.truth_count(res.ctypes.data, R, S, float(threshold)),
                   TRUTH_DTYPE)
    if len(out):
        lib.truth_emit(res.ctypes.data, rows_k.ctypes.data,
                       c_starts.ctypes.data, op_c.ctypes.data,
                       ids.ctypes.data, C, K, S, float(threshold),
                       int(event_id), int(trigger_id), out.ctypes.data)
    return out


def records_plain(res: np.ndarray, rows_k: np.ndarray, c_starts: np.ndarray,
                  op_channel, ids: np.ndarray, threshold: float,
                  event_id: int = 0, trigger_id: int = 0,
                  keep: np.ndarray | None = None) -> np.ndarray:
    """:func:`records` in numpy; ``keep`` ((R, S) bool), where given, picks
    the records in place of the threshold."""
    if keep is None:
        keep = np.abs(res) > threshold
    # count, then fill one record array channel by channel (each channel's
    # transpose stays in cache)
    cum_rows = np.concatenate(
        [[0], np.cumsum(keep.sum(axis=1, dtype=np.int64))])
    off_ch = cum_rows[c_starts]                        # (C+1,)
    out = np.empty(int(off_ch[-1]), TRUTH_DTYPE)
    for c in range(len(c_starts) - 1):
        i0, i1 = int(c_starts[c]), int(c_starts[c + 1])
        o0, o1 = int(off_ch[c]), int(off_ch[c + 1])
        if o0 == o1:
            continue
        sub_t = np.ascontiguousarray(res[i0:i1].T)     # (S, kc)
        keep_c = np.ascontiguousarray(keep[i0:i1].T)
        s_i, k_i = np.nonzero(keep_c)
        view = out[o0:o1]
        view['trigger_id'] = trigger_id
        view['op_channel_id'] = op_channel[c]
        view['tick'] = s_i
        view['event_id'] = event_id
        view['segment_id'] = ids[c, rows_k[i0:i1][k_i]]
        view['pe_current'] = sub_t[s_i, k_i]
    return out
