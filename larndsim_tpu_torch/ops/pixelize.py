"""Segment -> pixel association (rasterization + neighbour dilation).

Counterpart of ``larndsim_tpu.ops.pixelize`` (reference
pixels_from_track.py:43-272): the anode projection of each segment is
walked with the no-diagonal Bresenham variant, dilated by ``radius``
pixels, and deduplicated per segment with a *stable* sort, so the first
duplicate in generation order keeps its backtrack-distance code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params.detector import DetectorParams
from ..segments import Segments

#: neighbour dilation codes: dsum/dmax quantization table
#: (pixels_from_track.py:248-268)
MAX_NEIGHBOR_BACKTRACK_DISTANCE = 4

_INT_MAX = torch.iinfo(torch.int32).max


def distance_code_table(radius: int) -> np.ndarray:
    """Static (2r+1, 2r+1) table of backtrack distance codes."""
    codes = np.full((2 * radius + 1, 2 * radius + 1), -1, np.int32)
    for x_r in range(-radius, radius + 1):
        for y_r in range(-radius, radius + 1):
            dx, dy = abs(x_r), abs(y_r)
            dmax, dmin = max(dx, dy), min(dx, dy)
            dsum = dmax + dmin
            if dsum > MAX_NEIGHBOR_BACKTRACK_DISTANCE:
                dist = -1
            elif dsum <= 1:
                dist = dsum
            elif dsum == 2:
                dist = 2 if dmax == 1 else 3
            elif dsum == 3:
                dist = 4 if dmax == 2 else 5
            else:
                dist = {2: 6, 3: 7, 4: 8}[dmax]
            codes[x_r + radius, y_r + radius] = dist
    return codes


def segment_pixel_endpoints(segs: Segments, det: DetectorParams):
    """Anode-plane pixel indices of each segment's endpoints
    (pixels_from_track.py:94-102: floor((x - border)/pitch))."""
    plane = segs.pixel_plane
    valid = (plane >= 0) & (plane < det.n_tpcs) & segs.valid
    safe_plane = torch.where(valid, plane, 0).long()
    bx = det.tpc_borders[safe_plane, 0, 0]
    by = det.tpc_borders[safe_plane, 1, 0]
    to_idx = lambda v, b: torch.floor((v - b) / det.pixel_pitch).to(torch.int32)
    return (to_idx(segs.x_start, bx), to_idx(segs.y_start, by),
            to_idx(segs.x_end, bx), to_idx(segs.y_end, by), safe_plane, valid)


def max_active_pixels(segs_np, det: DetectorParams, tpc_borders_np) -> int:
    """Host bound on active pixels per segment: |dx| + |dy| + 1 (exact for
    the no-diagonal walk)."""
    plane = np.clip(segs_np['pixel_plane'], 0, tpc_borders_np.shape[0] - 1)
    bx = tpc_borders_np[plane, 0, 0]
    by = tpc_borders_np[plane, 1, 0]
    pitch = det.f32('pixel_pitch')
    x0 = np.floor((segs_np['x_start'] - bx) / pitch)
    y0 = np.floor((segs_np['y_start'] - by) / pitch)
    x1 = np.floor((segs_np['x_end'] - bx) / pitch)
    y1 = np.floor((segs_np['y_end'] - by) / pitch)
    n = np.abs(x1 - x0) + np.abs(y1 - y0) + 1
    return int(n.max()) if n.size else 1


def rasterize(segs: Segments, det: DetectorParams, max_active: int):
    """Active pixels under each segment's projection.

    Returns (pix_x, pix_y, valid) of shape (S, max_active): the reference
    Bresenham walk (pixels_from_track.py:157-199) as a fixed-length loop
    with masking.
    """
    x0, y0, x1, y1, _, seg_valid = segment_pixel_endpoints(segs, det)
    dx = torch.abs(x1 - x0)
    dy = -torch.abs(y1 - y0)
    sx = torch.where(x0 < x1, 1, -1).to(torch.int32)
    sy = torch.where(y0 < y1, 1, -1).to(torch.int32)
    n_steps = dx - dy  # |dx| + |dy|

    x, y, err = x0, y0, dx + dy
    xs, ys, emit = [x], [y], [n_steps >= 0]
    for i in range(1, max_active):
        done = i > n_steps
        e2 = 2 * err
        move_x = e2 - dy > dx - e2
        x = torch.where(done, x, torch.where(move_x, x + sx, x))
        y = torch.where(done, y, torch.where(move_x, y, y + sy))
        err = torch.where(done, err, err + torch.where(move_x, dy, dx))
        xs.append(x)
        ys.append(y)
        emit.append(~done)
    xs, ys, emit = (torch.stack(v, dim=1) for v in (xs, ys, emit))

    in_bounds = ((xs >= 0) & (xs < det.n_pixels[0])
                 & (ys >= 0) & (ys < det.n_pixels[1]))
    return xs, ys, emit & in_bounds & seg_valid[:, None]


def get_pixels(segs: Segments, det: DetectorParams, *, max_active: int,
               radius: int, max_neighboring: int):
    """Active + neighbouring pixels per segment.

    Returns:
        pixels: (S, max_neighboring) int32 linear pixel ids, -1 padded,
            unique per segment, sorted ascending.
        distances: (S, max_neighboring) int32 backtrack distance codes,
            -1 padded / beyond the maximum distance.
        npix: (S,) int32 count of valid entries.
    """
    nx, ny = det.n_pixels
    dev = segs.x.device
    xs, ys, valid = rasterize(segs, det, max_active)
    plane = torch.where((segs.pixel_plane >= 0)
                        & (segs.pixel_plane < det.n_tpcs),
                        segs.pixel_plane, 0)

    codes = torch.from_numpy(distance_code_table(radius)).to(dev)
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32, device=dev)
    off_x = offs.repeat_interleave(2 * radius + 1)   # ((2r+1)^2,)
    off_y = offs.repeat(2 * radius + 1)
    off_code = codes.reshape(-1)

    cand_x = xs[:, :, None] + off_x[None, None, :]   # (S, A, K)
    cand_y = ys[:, :, None] + off_y[None, None, :]
    cand_ok = (valid[:, :, None]
               & (cand_x >= 0) & (cand_x < nx)
               & (cand_y >= 0) & (cand_y < ny))
    cand_id = cand_x + nx * (cand_y + ny * plane[:, None, None])
    cand_id = torch.where(cand_ok, cand_id, _INT_MAX)
    S = cand_id.shape[0]
    ids = cand_id.reshape(S, -1)
    dists = torch.where(off_code < 0, 127, off_code).to(torch.int32)
    dists = dists[None, None, :].expand(cand_id.shape).reshape(S, -1)

    # one stable sort per row: the candidate flatten order is the
    # reference's generation order, so the first duplicate keeps its code
    ids, order = torch.sort(ids, dim=1, stable=True)
    dists = torch.gather(dists, 1, order)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    first &= ids != _INT_MAX
    n = ids.shape[1]
    # compact first occurrences to the front; the rest go to a sink column
    dst = torch.where(first, torch.cumsum(first, dim=1) - 1, n).long()
    out_ids = torch.full((S, n + 1), -1, dtype=torch.int32, device=dev)
    out_dists = torch.full((S, n + 1), 127, dtype=torch.int32, device=dev)
    out_ids.scatter_(1, dst, ids)
    out_dists.scatter_(1, dst, dists)
    pixels = out_ids[:, :min(n, max_neighboring)]
    dists = out_dists[:, :min(n, max_neighboring)]
    keep = pixels >= 0
    distances = torch.where(keep & (dists < 127), dists, -1)
    npix = keep.sum(dim=1).to(torch.int32)
    return pixels, distances, npix


def time_intervals(segs: Segments, det: DetectorParams):
    """Per-segment signal start time and max signal length in ticks
    (detsim.time_intervals, detsim.py:18-40)."""
    dt = det.time_sampling
    dt_t = torch.tensor(dt, dtype=torch.float32, device=segs.x.device)
    t_end = torch.round((segs.t_end + 1) / dt_t) * dt_t
    t_start = torch.round((segs.t_start - det.time_padding) / dt_t) * dt_t
    ticks = torch.ceil((t_end - t_start) / dt_t)
    ticks = torch.where(segs.valid, ticks, 0)
    return t_start, torch.max(ticks).to(torch.int32)
