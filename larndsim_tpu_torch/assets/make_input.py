"""Synthetic edep-sim input generator.

Counterpart of ``larndsim_tpu.assets.make_input``, writing through
``io.h5`` so that no h5py is needed.

Produces HDF5 files with the `segments`/`trajectories`/`vertices` schema of
the edep-sim converter (cli/dumpTree.py:17-42): straight muon-like tracks
chopped into segments inside the active volume, with spill timing.  Used by
tests and benchmarks since the reference's example inputs are git-lfs
objects absent from the snapshot.
"""
from __future__ import annotations

import numpy as np

from ..io.h5 import File

SEGMENTS_DTYPE = np.dtype([
    ('event_id', 'u4'), ('vertex_id', 'u8'), ('file_vertex_id', 'u8'),
    ('segment_id', 'u4'), ('z_end', 'f4'), ('traj_id', 'u4'),
    ('file_traj_id', 'u4'), ('tran_diff', 'f4'), ('z_start', 'f4'),
    ('x_end', 'f4'), ('y_end', 'f4'), ('n_electrons', 'u4'),
    ('pdg_id', 'i4'), ('x_start', 'f4'), ('y_start', 'f4'),
    ('t_start', 'f4'), ('t0_start', 'f8'), ('t0_end', 'f8'), ('t0', 'f8'),
    ('dx', 'f4'), ('long_diff', 'f4'), ('pixel_plane', 'i4'),
    ('t_end', 'f4'), ('dEdx', 'f4'), ('dE', 'f4'), ('t', 'f4'),
    ('y', 'f4'), ('x', 'f4'), ('z', 'f4'), ('n_photons', 'f4')], align=True)

TRAJECTORIES_DTYPE = np.dtype([
    ('event_id', 'u4'), ('vertex_id', 'u8'), ('file_vertex_id', 'u8'),
    ('traj_id', 'u4'), ('file_traj_id', 'u4'), ('parent_id', 'i4'),
    ('primary', '?'), ('E_start', 'f4'), ('pxyz_start', 'f4', (3,)),
    ('xyz_start', 'f4', (3,)), ('t_start', 'f8'), ('E_end', 'f4'),
    ('pxyz_end', 'f4', (3,)), ('xyz_end', 'f4', (3,)), ('t_end', 'f8'),
    ('pdg_id', 'i4'), ('start_process', 'u4'), ('start_subprocess', 'u4'),
    ('end_process', 'u4'), ('end_subprocess', 'u4'),
    ('dist_travel', 'f4')], align=True)

VERTICES_DTYPE = np.dtype([
    ('event_id', 'u4'), ('vertex_id', 'u8'), ('file_vertex_id', 'u8'),
    ('x_vert', 'f4'), ('y_vert', 'f4'), ('z_vert', 'f4'),
    ('t_vert', 'f4'), ('t_event', 'f4')], align=True)


def make_tracks(tpc_borders: np.ndarray, n_events: int = 2,
                tracks_per_event: int = 3, segments_per_track: int = 20,
                segment_length: float = 0.5, dEdx: float = 2.1,
                spill_period: float = 1.2e6, seed: int = 42,
                is_spill: bool = True, every_tpc: bool = False):
    """Generate straight tracks inside random TPCs (``every_tpc``: track
    k of an event inside TPC k modulo their number, so that every TPC has
    tracks in every event once ``tracks_per_event`` reaches it).

    NOTE: positions are produced in the *edep-sim convention* (z = beam
    axis): the segments' drift coordinate is written to `x`, since
    run_simulation swaps x<->z on load (cli/simulate_pixels.py:584-587).
    """
    rng = np.random.default_rng(seed)
    rows, traj_rows, vert_rows = [], [], []
    seg_id = 0
    file_traj = 0
    for ev in range(n_events):
        t_spill = ev * spill_period if is_spill else 0.0
        vert_rows.append((ev, ev, ev, 0, 0, 0, 0.0, 0.0))
        for trk in range(tracks_per_event):
            tpc = (trk % len(tpc_borders) if every_tpc
                   else rng.integers(len(tpc_borders)))
            b = np.sort(tpc_borders[tpc], axis=-1)
            lo, hi = b[:, 0], b[:, 1]
            start = lo + rng.uniform(0.2, 0.8, 3) * (hi - lo)
            theta = rng.uniform(0, np.pi)
            phi = rng.uniform(0, 2 * np.pi)
            direction = np.array([np.sin(theta) * np.cos(phi),
                                  np.sin(theta) * np.sin(phi),
                                  np.cos(theta)])
            t0 = t_spill + rng.uniform(0, 10)
            traj_rows.append((ev, ev, ev, trk, file_traj, -1, True,
                              1000.0, tuple(direction * 1000),
                              tuple(start), t0, 0.0,
                              (0, 0, 0), tuple(start), t0, 13,
                              0, 0, 0, 0,
                              segments_per_track * segment_length))
            pos = start.copy()
            for _ in range(segments_per_track):
                end = pos + direction * segment_length
                if ((end < lo) | (end > hi)).any():
                    break
                mid = 0.5 * (pos + end)
                dt_seg = segment_length / 30.0 * 1e-3  # ~c, us
                row = np.zeros(1, dtype=SEGMENTS_DTYPE)
                # swap: drift coordinate (detector z) stored in x
                row['event_id'] = ev
                row['vertex_id'] = row['file_vertex_id'] = ev
                row['segment_id'] = seg_id
                row['traj_id'] = trk
                row['file_traj_id'] = file_traj
                row['x_start'], row['x_end'], row['x'] = pos[2], end[2], mid[2]
                row['y_start'], row['y_end'], row['y'] = pos[1], end[1], mid[1]
                row['z_start'], row['z_end'], row['z'] = pos[0], end[0], mid[0]
                row['dx'] = segment_length
                row['dEdx'] = dEdx
                row['dE'] = dEdx * segment_length
                row['t0_start'] = t0
                row['t0_end'] = t0 + dt_seg
                row['t0'] = t0 + dt_seg / 2
                row['pdg_id'] = 13
                rows.append(row)
                seg_id += 1
                pos = end
                t0 += dt_seg
            file_traj += 1
    segments = np.concatenate(rows) if rows else np.zeros(0, SEGMENTS_DTYPE)
    trajectories = np.array(traj_rows, dtype=TRAJECTORIES_DTYPE)
    vertices = np.array(vert_rows, dtype=VERTICES_DTYPE)
    return segments, trajectories, vertices


def write_input(filename: str, tpc_borders: np.ndarray, **kwargs) -> int:
    segments, trajectories, vertices = make_tracks(tpc_borders, **kwargs)
    with File(filename, 'w') as f:
        f.create_dataset('segments', data=segments)
        f.create_dataset('trajectories', data=trajectories)
        f.create_dataset('vertices', data=vertices)
    return len(segments)
