"""Electron drift: TPC assignment, lifetime attenuation, diffusion, timing.

Counterpart of ``larndsim_tpu.ops.drift`` (reference drifting.py:11-58):
a broadcast containment test over the TPC axis picks the *first* matching
TPC, as the reference's ``break`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params.detector import DEFAULT_PLANE_INDEX, DetectorParams
from ..segments import Segments

#: Containment tolerance in cm (drifting.py:35-37)
TOLERANCE = 2e-2


def assign_pixel_plane(segs: Segments, det: DetectorParams) -> torch.Tensor:
    """First TPC whose (tolerance-padded) bounding box contains (x, y, z)."""
    b = det.tpc_borders  # (n_tpc, 3, 2)
    x, y, z = segs.x[:, None], segs.y[:, None], segs.z[:, None]
    in_x = (b[None, :, 0, 0] - TOLERANCE <= x) & (x <= b[None, :, 0, 1] + TOLERANCE)
    in_y = (b[None, :, 1, 0] - TOLERANCE <= y) & (y <= b[None, :, 1, 1] + TOLERANCE)
    z_lo = torch.minimum(b[:, 2, 1], b[:, 2, 0]) - TOLERANCE
    z_hi = torch.maximum(b[:, 2, 1], b[:, 2, 0]) + TOLERANCE
    in_z = (z_lo[None, :] <= z) & (z <= z_hi[None, :])
    inside = in_x & in_y & in_z  # (n_seg, n_tpc)
    first = torch.argmax(inside.to(torch.int32), dim=1)
    return torch.where(inside.any(dim=1), first,
                       DEFAULT_PLANE_INDEX).to(torch.int32)


def drift(segs: Segments, det: DetectorParams) -> Segments:
    """Propagate segments to the anode."""
    plane = assign_pixel_plane(segs, det)
    in_tpc = plane != DEFAULT_PLANE_INDEX
    safe_plane = torch.where(in_tpc, plane, 0).long()

    z_anode = det.tpc_borders[safe_plane, 2, 0]
    drift_distance = torch.abs(segs.z - z_anode)
    drift_start = torch.abs(torch.minimum(segs.z_start, segs.z_end) - z_anode)
    drift_end = torch.abs(torch.maximum(segs.z_start, segs.z_end) - z_anode)
    drift_time = drift_distance / det.v_drift
    lifetime_red = torch.exp(-drift_time / det.electron_lifetime)

    n_electrons = segs.n_electrons * lifetime_red
    long_diff = torch.sqrt(drift_time * 2 * det.long_diff)
    tran_diff = torch.sqrt(drift_time * 2 * det.tran_diff)
    t = segs.t + drift_time + segs.t0
    t_start = (segs.t_start
               + torch.minimum(drift_start, drift_end) / det.v_drift
               + segs.t0)
    t_end = (segs.t_end
             + torch.maximum(drift_start, drift_end) / det.v_drift + segs.t0)

    sel = lambda new, old: torch.where(in_tpc, new, old).float()
    return segs.replace(
        pixel_plane=plane,
        n_electrons=sel(n_electrons, segs.n_electrons),
        long_diff=sel(long_diff, segs.long_diff),
        tran_diff=sel(tran_diff, segs.tran_diff),
        t=sel(t, segs.t),
        t_start=sel(t_start, segs.t_start),
        t_end=sel(t_end, segs.t_end),
    )


def select_active_volume(tracks, tpc_borders, i_module: int = -1):
    """Boolean mask of segments with an endpoint inside any TPC box
    (host numpy, reference active_volume.py:4-46)."""
    borders = np.sort(np.asarray(tpc_borders), axis=-1)
    if i_module >= 1:
        borders = borders[(i_module - 1) * 2: i_module * 2]
    mask = np.zeros(tracks.shape[0], bool)
    for b in borders:
        for sfx in ('_start', '_end'):
            mask |= ((tracks['x' + sfx] > b[0, 0]) & (tracks['x' + sfx] < b[0, 1])
                     & (tracks['y' + sfx] > b[1, 0]) & (tracks['y' + sfx] < b[1, 1])
                     & (tracks['z' + sfx] > b[2, 0]) & (tracks['z' + sfx] < b[2, 1]))
    return mask
