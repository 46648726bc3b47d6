"""edep-sim HDF5 input: reading + normalization.

Counterpart of ``larndsim_tpu.io.edep``, reading through ``io.h5`` so that
no h5py is needed.

Input contract is the `segments`/`trajectories`/`vertices` (+ optional
`mc_hdr`/`mc_stack`) schema produced by the edep-sim converter
(cli/dumpTree.py:17-42).  Normalizations replicate the orchestrator's input
massaging (cli/simulate_pixels.py:480-587): synthesize `segment_id`,
`n_photons`, `t0*` for old files, reset spill-relative t0, swap x<->z from
the edep-sim beam convention to the drift convention.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import numpy.lib.recfunctions as rfn

from .h5 import File


@dataclasses.dataclass
class EdepInput:
    tracks: np.ndarray
    segment_ids: np.ndarray
    trajectory_ids: np.ndarray
    trajectories: np.ndarray | None
    vertices: np.ndarray | None
    mc_hdr: np.ndarray | None
    mc_stack: np.ndarray | None


def swap_coordinates(tracks: np.ndarray) -> np.ndarray:
    """Swap x and z segment coordinates in place (cli:66-90): edep-sim uses
    z as the beam axis, larnd-sim uses z as the drift axis."""
    for a, b in (('x_start', 'z_start'), ('x_end', 'z_end'), ('x', 'z')):
        tmp = np.copy(tracks[a])
        tracks[a] = tracks[b]
        tracks[b] = tmp
    return tracks


def load_edep(input_filename: str, n_events: int | None = None,
              event_separator: str = 'event_id',
              is_spill_sim: bool = True, spill_period: float = 1.2e6,
              max_events_per_file: int = 1000) -> EdepInput:
    """Read and normalize an edep-sim HDF5 file."""
    with File(input_filename, 'r') as f:
        tracks = np.array(f['segments'])
        datasets = {}
        for name in ('trajectories', 'vertices', 'mc_hdr', 'mc_stack'):
            datasets[name] = np.array(f[name]) if name in f else None

    if tracks.size == 0:
        raise ValueError('Empty input dataset')

    # synthesize segment ids for old files (cli:482-494)
    if 'segment_id' not in tracks.dtype.names:
        ids = np.arange(tracks.shape[0], dtype='u4')
        tracks = rfn.merge_arrays(
            (np.array(ids, dtype=[('segment_id', 'u4')]), tracks),
            flatten=True)

    # event truncation, gap-safe (cli:533-547)
    if n_events:
        max_ev = np.unique(tracks[event_separator])[n_events - 1]
        tracks = tracks[tracks[event_separator] <= max_ev]
        for name, arr in datasets.items():
            if arr is not None and event_separator in (arr.dtype.names or ()):
                datasets[name] = arr[arr[event_separator] <= max_ev]

    # back-compat fields (cli:549-568)
    if 'n_photons' not in tracks.dtype.names:
        tracks = rfn.merge_arrays(
            (tracks, np.zeros(tracks.shape[0], dtype=[('n_photons', 'f4')])),
            flatten=True)
    if 't0' not in tracks.dtype.names:
        extra = np.zeros(tracks.shape[0],
                         dtype=[('t0', 'f4'), ('t0_start', 'f4'),
                                ('t0_end', 'f4')])
        extra['t0'] = tracks['t']
        extra['t0_start'] = tracks['t_start']
        extra['t0_end'] = tracks['t_end']
        tracks = rfn.merge_arrays((tracks, extra), flatten=True)
        tracks['t'] = 0
        tracks['t_start'] = 0
        tracks['t_end'] = 0

    # spill-relative t0 (cli:574-582)
    if is_spill_sim:
        ev = tracks[event_separator]
        local_spill = ev - (ev // max_events_per_file) * max_events_per_file
        for fld in ('t0_start', 't0_end', 't0'):
            tracks[fld] = tracks[fld] - local_spill * spill_period

    tracks = swap_coordinates(tracks)

    traj_field = ('file_traj_id' if 'file_traj_id' in tracks.dtype.names
                  else 'traj_id' if 'traj_id' in tracks.dtype.names
                  else 'segment_id')
    return EdepInput(
        tracks=tracks,
        segment_ids=tracks['segment_id'],
        trajectory_ids=tracks[traj_field],
        trajectories=datasets['trajectories'],
        vertices=datasets['vertices'],
        mc_hdr=datasets['mc_hdr'],
        mc_stack=datasets['mc_stack'],
    )


def local_spill_ids(tracks, event_separator: str, max_events_per_file: int):
    ev = tracks[event_separator]
    return ev - (ev // max_events_per_file) * max_events_per_file
