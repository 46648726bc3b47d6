"""The edep-sim input schema: the `segments`/`trajectories`/`vertices`
record types of the converter (larnd-sim cli/dumpTree.py:17-42), copied
from the port's ``assets/make_input.py``.  The benchmark's generator
(``port_bench/traffic.py``) writes its files with them.
"""
from __future__ import annotations

import numpy as np

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
