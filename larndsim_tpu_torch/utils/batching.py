"""Batch planner: one-pass segment -> (event, TPC-group) assignment.

Counterpart of ``larndsim_tpu.utils.batching_native.FastTPCBatcher``, so
that the port runs without the JAX package.  Batches iterate events in
ascending order and TPC groups of ``tpc_batch_size`` TPCs within each
event; each segment belongs to the first group whose sorted bounding box
contains its start or end point (reference util/batching.py:17-67).  The
assignment is ``csrc/host/batcher.cpp``, a host library of
``utils.host_build`` (no fallback: a failed build raises);
:func:`assign_groups_plain` is its numpy version, which tests compare it
with.
"""
from __future__ import annotations

import ctypes
from math import ceil

import numpy as np

from . import host_build

SOURCES = host_build.sources('batcher.cpp')
BUILD_DIR = host_build.BUILD_DIR
_LIB = None
_COORDS = tuple(c + sfx for sfx in ('_start', '_end') for c in 'xyz')


def library() -> ctypes.CDLL:
    """The assigner's library, compiled first if it is not built yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with host_build.LOCK:
        if _LIB is not None:
            return _LIB
        lib = host_build.load('batcher', SOURCES, BUILD_DIR,
                              'the batch assigner')
        i64 = ctypes.c_int64
        lib.assign_batches.argtypes = ([i64, i64] + [ctypes.c_void_p] * 7
                                       + [i64, ctypes.c_void_p])
        lib.assign_batches.restype = None
        _LIB = lib
    return _LIB


def _sorted_borders(tpc_borders) -> np.ndarray:
    return np.ascontiguousarray(
        np.sort(np.asarray(tpc_borders, np.float64), axis=-1))


def assign_groups(tracks, tpc_borders, tpc_batch_size: int) -> np.ndarray:
    """First containing TPC-group index per segment (-1 if outside all),
    int32."""
    borders = _sorted_borders(tpc_borders)
    if borders.ndim != 3 or borders.shape[1:] != (3, 2) \
            or tpc_batch_size < 1:
        raise ValueError(f'borders of shape {borders.shape} (n_tpc, 3, 2 '
                         f'expected), tpc_batch_size {tpc_batch_size}')
    coords = [np.ascontiguousarray(tracks[name], np.float64)
              for name in _COORDS]
    out = np.empty(tracks.shape[0], np.int32)
    library().assign_batches(out.shape[0], borders.shape[0],
                             *(c.ctypes.data for c in coords),
                             borders.ctypes.data, int(tpc_batch_size),
                             out.ctypes.data)
    return out


def assign_groups_plain(tracks, tpc_borders,
                        tpc_batch_size: int) -> np.ndarray:
    """:func:`assign_groups` in numpy: one masking pass per TPC."""
    borders = _sorted_borders(tpc_borders)
    group_of_tpc = np.arange(borders.shape[0]) // tpc_batch_size
    no_group = np.iinfo(np.int32).max
    best = np.full(tracks.shape[0], no_group, np.int32)
    for b, group in zip(borders, group_of_tpc):
        inside = np.zeros(tracks.shape[0], bool)
        for sfx in ('_start', '_end'):
            inside |= ((tracks['x' + sfx] > b[0, 0])
                       & (tracks['x' + sfx] < b[0, 1])
                       & (tracks['y' + sfx] > b[1, 0])
                       & (tracks['y' + sfx] < b[1, 1])
                       & (tracks['z' + sfx] > b[2, 0])
                       & (tracks['z' + sfx] < b[2, 1]))
        best[inside] = np.minimum(best[inside], group)
    return np.where(best == no_group, -1, best)


class TPCBatcher:
    """Iterates ``(event, segment mask)`` over (event, TPC-group) batches.

    Args:
        all_track_seg: every segment of the file (defines the events).
        track_seg: the segments to batch (drifted, detector coordinates).
    """

    def __init__(self, all_track_seg, track_seg, event_separator: str,
                 tpc_batch_size: int = 1,
                 tpc_borders=np.empty((0, 3, 2), dtype='f4')):
        n_tpc = np.asarray(tpc_borders).shape[0]
        self.n_groups = max(ceil(n_tpc / tpc_batch_size), 1)
        self.events = np.unique(all_track_seg[event_separator])
        group = (assign_groups(track_seg, tpc_borders, tpc_batch_size)
                 if n_tpc else np.full(track_seg.shape[0], -1, np.int32))
        ev_index = np.searchsorted(self.events, track_seg[event_separator])
        self.keys = np.where(group >= 0,
                             ev_index.astype(np.int64) * self.n_groups
                             + group, -1)

    def __len__(self):
        return len(self.events) * self.n_groups

    def __iter__(self):
        for i, ev in enumerate(self.events):
            for g in range(self.n_groups):
                yield ev, self.keys == i * self.n_groups + g
