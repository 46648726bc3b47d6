"""Induced current per (segment, pixel, tick): the hot op of the chain.

Counterpart of ``larndsim_tpu.ops.current_pallas`` (the production
backend) and its host glue.  Reference semantics: detsim.tracks_current_mc
(detsim.py:258-348): Monte Carlo charge points along each diffused segment,
a response-LUT read per (point, pixel, tick).

The LUT time index is affine in the output tick: the point i of segment s
reads response row ``row(s, p, i)`` at column ``t - shift(s, i)``.  So::

    out[s, p, t] = scale[s, t]
                   * sum_{i < nstep[s]} R'[row(s, p, i), t - shift(s, i)]

with ``R'`` the phase-split response (:func:`phase_split_response`), reads
outside ``[0, ntp)`` and the trailing zero row contributing nothing, and
``scale = charge * [tick time >= 0]``.  :func:`prepare_points` computes the
points, rows and shifts; :func:`induced_current` evaluates the sum, on a
CUDA tensor with the kernel ``csrc/induced_current.cu`` and on a CPU
tensor with :func:`current_plain`.

The kernel takes one (segment, pixel) pair per block: it tables each
step's row once, gives the pair's distinct rows (about 40 at production
shapes) slots in shared memory, copies each slot's columns of one tick
tile there, and then adds one shared value per (step, tick) in ascending
step order.  The plain version adds the same values in the same order
(reads outside the response, zero-filled in the kernel, add exact zeros),
so the two agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..params.detector import DetectorParams
from ..segments import Segments
from .f32 import div

#: sentinel coordinate for masked sample points / pixels: far enough that
#: every distance check fails
FAR = 1e9


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def signal_start_times(segs: Segments, det: DetectorParams) -> torch.Tensor:
    """Drift-relative start time of each segment's signal window
    (detsim.py:297: round((t_start - t0_start - padding)/dt) * dt)."""
    dt = torch.tensor(det.time_sampling, dtype=torch.float32,
                      device=segs.x.device)
    return torch.round((segs.t_start - segs.t0_start - det.time_padding)
                       / dt) * dt


def prepare_points(segs: Segments, det: DetectorParams,
                   smear: torch.Tensor | None, *, n_steps: int, ratio: int,
                   min_step: float = 0.001):
    """Per-(segment, step) sample points, as ``current_pallas`` makes them.

    Args:
        smear: (3, S, n_steps) standard normals for the diffusion smear
            (rows: z, x, y), or None for the deterministic midpoints.

    Returns:
        xs, ys: (S, n_steps) float32 point coordinates (``xs`` is FAR
            where the step is masked).
        shift: (S, n_steps) int32 tick shift (phase-folded), 0 if masked.
        phase: (S, n_steps) int32 response-row phase, 0 if masked.
        charge: (S,) float32 charge per sample point.
        nstep: (S,) int32 live steps per segment (0 for invalid ones).
    """
    swap = segs.z_start >= segs.z_end
    sx = torch.where(swap, segs.x_end, segs.x_start)
    sy = torch.where(swap, segs.y_end, segs.y_start)
    sz = torch.where(swap, segs.z_end, segs.z_start)
    vx = torch.where(swap, segs.x_start, segs.x_end) - sx
    vy = torch.where(swap, segs.y_start, segs.y_end) - sy
    vz = torch.where(swap, segs.z_start, segs.z_end) - sz
    length = torch.sqrt(vx * vx + vy * vy + vz * vz)
    safe_len = torch.where(length > 0, length, 1.0)

    nstep = torch.clamp(torch.round(div(length, min_step)), min=1.0)
    nstep = torch.clamp(nstep, max=n_steps).to(torch.int32)
    step_len = length / nstep

    plane = torch.clamp(segs.pixel_plane, 0, det.n_tpcs - 1).long()
    z_anode = det.tpc_borders[plane, 2, 0]
    t_start = signal_start_times(segs, det)

    steps = torch.arange(n_steps, device=segs.x.device, dtype=torch.int32)
    arc = (steps[None, :] + 0.5) * step_len[:, None]           # (S, n)
    px = sx[:, None] + arc * (vx / safe_len)[:, None]
    py = sy[:, None] + arc * (vy / safe_len)[:, None]
    pz = sz[:, None] + arc * (vz / safe_len)[:, None]
    if smear is not None:
        pz = pz + smear[0] * segs.long_diff[:, None]
        px = px + smear[1] * segs.tran_diff[:, None]
        py = py + smear[2] * segs.tran_diff[:, None]

    t0 = torch.abs(pz - z_anode[:, None]) / det.v_drift - det.time_window
    # k = round((t_start + it*dt - t0)/resp_dt) = ratio*it - shift
    shift_fine = torch.round((t0 - t_start[:, None])
                             / det.response_sampling).to(torch.int32)
    phase = torch.remainder(-shift_fine, ratio)
    shift = torch.div(shift_fine + phase, ratio, rounding_mode='floor')

    seg_ok = segs.valid & (length > 0)
    ok = (steps[None, :] < nstep[:, None]) & seg_ok[:, None]
    px = torch.where(ok, px, FAR)
    shift = torch.where(ok, shift, 0).to(torch.int32)
    phase = torch.where(ok, phase, 0).to(torch.int32)
    charge = torch.where(seg_ok, segs.n_electrons / nstep.float(), 0.0)
    nstep = torch.where(seg_ok, nstep, 0).to(torch.int32)
    return px.float(), py.float(), shift, phase, charge.float(), nstep


def phase_split_response(response: torch.Tensor, ratio: int) -> torch.Tensor:
    """(nx, ny, nt) -> (nx*ny*ratio + 1, ceil(nt/ratio)): rows ordered
    [ij0/ph0, ij0/ph1, ..., ij1/ph0, ...], R'[(ij, ph), k] = R[ij, ratio*k
    + ph], and a trailing all-zero row for masked contributions."""
    nx, ny, nt = response.shape
    ntp = -(-nt // ratio)
    padded = torch.zeros((nx * ny, ntp * ratio), dtype=torch.float32,
                         device=response.device)
    padded[:, :nt] = response.reshape(nx * ny, nt)
    split = padded.reshape(nx * ny, ntp, ratio).transpose(1, 2)
    split = split.reshape(nx * ny * ratio, ntp)
    return torch.cat([split, split.new_zeros((1, ntp))])


def host_shift_band(segs_np: dict, det: DetectorParams,
                    mc_smear: bool = True) -> tuple[int, int]:
    """Conservative (shift_lo, shift_hi) from host segment fields.

    shift = round((t0 - t_start)/resp_dt) with t0 = |z - z_anode|/v - W;
    z is bounded by the segment extent +- 6 sigma of the longitudinal smear.
    """
    hc = det.host
    dt = float(det.time_sampling)
    resp_dt = hc['response_sampling']
    ratio = int(round(dt / resp_dt))
    v = hc['v_drift']
    borders = hc['tpc_borders']
    plane = np.clip(np.asarray(segs_np['pixel_plane'], np.int64), 0,
                    borders.shape[0] - 1)
    z_anode = borders[plane, 2, 0]
    pad = 6.0 * segs_np['long_diff'] if mc_smear else 0.0
    z_lo = np.minimum(segs_np['z_start'], segs_np['z_end']) - pad
    z_hi = np.maximum(segs_np['z_start'], segs_np['z_end']) + pad
    d_lo = np.minimum(np.abs(z_lo - z_anode), np.abs(z_hi - z_anode))
    d_lo = np.where((z_lo - z_anode) * (z_hi - z_anode) < 0, 0.0, d_lo)
    d_hi = np.maximum(np.abs(z_lo - z_anode), np.abs(z_hi - z_anode))
    t_start = np.round((segs_np['t_start'] - segs_np['t0_start']
                        - hc['time_padding']) / dt) * dt
    w = hc['time_window']
    lo = np.floor((d_lo / v - w - t_start) / resp_dt).min() - 2
    hi = np.ceil((d_hi / v - w - t_start) / resp_dt).max() + 2
    # fine shift -> phase-folded tick shift (see prepare_points)
    return int(np.floor(lo / ratio)), int(np.ceil(hi / ratio)) + 1


class LutGeometry:
    """Float32 constants of the response-row lookup, rounded as the JAX
    package rounds its Python-float statics (``_row_table``)."""

    def __init__(self, bin_size: float, nx_r: int, ny_r: int, ratio: int):
        self.nx_r, self.ny_r, self.ratio = nx_r, ny_r, ratio
        self.max_x = float(np.float32(bin_size * nx_r))
        self.max_y = float(np.float32(bin_size * ny_r))
        self.lim_x = float(np.float32(bin_size * nx_r + bin_size))
        self.lim_y = float(np.float32(bin_size * ny_r + bin_size))
        self.inv_bin = float(np.float32(1.0 / bin_size))
        self.zero_row = nx_r * ny_r * ratio


def row_table(xs, ys, phase, pxc, pyc, lut: LutGeometry) -> torch.Tensor:
    """(S, P, n_steps) int32 response-row index of each (pixel, point):
    the LUT bin of |pixel centre - point|, or the zero row out of range."""
    x_dist = torch.clamp(torch.abs(pxc[:, :, None] - xs[:, None, :]),
                         max=lut.lim_x)
    y_dist = torch.clamp(torch.abs(pyc[:, :, None] - ys[:, None, :]),
                         max=lut.lim_y)
    i_idx = torch.round(x_dist * lut.inv_bin - 0.5).to(torch.int32)
    j_idx = torch.round(y_dist * lut.inv_bin - 0.5).to(torch.int32)
    ok = ((x_dist <= lut.max_x) & (y_dist <= lut.max_y)
          & (i_idx >= 0) & (i_idx < lut.nx_r)
          & (j_idx >= 0) & (j_idx < lut.ny_r))
    i_c = torch.clamp(i_idx, 0, lut.nx_r - 1)
    j_c = torch.clamp(j_idx, 0, lut.ny_r - 1)
    return torch.where(ok, (i_c * lut.ny_r + j_c) * lut.ratio
                       + phase[:, None, :], lut.zero_row).to(torch.int32)


def current_plain(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi,
                  scale, resp, lut: LutGeometry) -> torch.Tensor:
    """Plain PyTorch version of the induced-current kernel.

    A loop over sample-point steps of gather + add, in ascending step
    order (the order of the JAX step loop).  ``tick_lo``/``tick_hi`` are
    the kernel's skip bounds; they change no value here (ticks below
    ``tick_lo`` have scale 0, ticks at or past ``tick_hi + ntp`` read past
    every response row), so this version ignores them.

    Returns:
        (S, P, t_sig) float32.
    """
    S, n_steps = xs.shape
    P = pxc.shape[1]
    ntp = resp.shape[1]
    t_sig = scale.shape[1]
    rows = row_table(xs, ys, phase, pxc, pyc, lut).long()
    resp_flat = resp.reshape(-1)
    t = torch.arange(t_sig, device=xs.device)
    acc = torch.zeros((S, P, t_sig), dtype=torch.float32, device=xs.device)
    for i in range(n_steps):
        k = t[None, :] - shift[:, i:i + 1]                      # (S, T)
        r = rows[:, :, i]                                        # (S, P)
        w = (((k >= 0) & (k < ntp))[:, None, :]
             & (i < nstep)[:, None, None]
             & (r != lut.zero_row)[:, :, None])
        idx = r[:, :, None] * ntp + k.clamp(0, ntp - 1)[:, None, :]
        acc = acc + torch.where(w, resp_flat[idx], 0.0)
    return acc * scale[:, None, :]


def induced_current(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo,
                    tick_hi, scale, resp, lut: LutGeometry) -> torch.Tensor:
    """Induced-current sum (module docstring); kernel on CUDA tensors.

    Args:
        xs, ys: (S, n_steps) float32 sample points.
        shift, phase: (S, n_steps) int32.
        pxc, pyc: (S, P) float32 pixel centres, FAR where invalid.
        nstep: (S,) int32 live steps; steps at or past it are skipped.
        tick_lo, tick_hi: (S,) int32: ticks below ``tick_lo`` have scale 0,
            and no step shifts past ``tick_hi``.
        scale: (S, t_sig) float32 charge x tick mask.
        resp: (n_rows, ntp) float32 phase-split response.

    Returns:
        (S, P, t_sig) float32.
    """
    if xs.device.type == 'cpu':
        return current_plain(xs, ys, shift, phase, pxc, pyc, nstep,
                             tick_lo, tick_hi, scale, resp, lut)
    from ..kernels import binding
    return binding.induced_current(xs, ys, shift, phase, pxc, pyc, nstep,
                                   tick_lo, tick_hi, scale, resp, lut)


def current_inputs(segs: Segments, pix_x, pix_y, pix_valid, response,
                   det: DetectorParams, smear: torch.Tensor | None, *,
                   n_steps: int, t_sig: int, shift_band: tuple[int, int],
                   min_step: float = 0.001) -> tuple:
    """The arguments of :func:`induced_current` for a batch; the arguments
    are those of :func:`current`."""
    nx_r, ny_r, nt_r = response.shape
    dt = float(det.time_sampling)
    resp_dt = det.f32('response_sampling')
    ratio = int(round(dt / resp_dt))
    if ratio < 1 or abs(ratio * resp_dt - dt) >= 1e-6:
        raise ValueError('response sampling must divide the readout sampling')

    xs, ys, shift, phase, charge, nstep = prepare_points(
        segs, det, smear, n_steps=n_steps, ratio=ratio, min_step=min_step)
    # the static shift band of current_pallas (K0 = round_up(shift_hi,
    # 128), span a multiple of 128): shifts outside it are clipped as there
    shift_lo, shift_hi = shift_band
    K0 = _round_up(shift_hi, 128)
    span = _round_up(max(K0 - shift_lo, 1), 128)
    shift = torch.clamp(shift, K0 - span, K0).to(torch.int32)

    live = (torch.arange(n_steps, device=xs.device)[None, :]
            < nstep[:, None])
    tick_hi = torch.where(live, shift, 0).amax(dim=1).to(torch.int32)
    t_start = signal_start_times(segs, det)
    ticks = t_start[:, None] + (torch.arange(t_sig, device=xs.device)
                                * torch.tensor(dt, dtype=torch.float32,
                                               device=xs.device))
    mask = ticks >= 0
    tick_lo = (~mask).sum(dim=1).to(torch.int32)
    scale = charge[:, None] * mask.float()

    pxc = torch.where(pix_valid, pix_x, FAR).float()
    pyc = torch.where(pix_valid, pix_y, FAR).float()
    lut = LutGeometry(det.f32('response_bin_size'), nx_r, ny_r, ratio)
    resp = phase_split_response(response, ratio)
    return (xs.contiguous(), ys.contiguous(), shift, phase, pxc.contiguous(),
            pyc.contiguous(), nstep, tick_lo, tick_hi, scale.contiguous(),
            resp, lut)


def current(segs: Segments, pix_x, pix_y, pix_valid, response,
            det: DetectorParams, smear: torch.Tensor | None, *,
            n_steps: int, t_sig: int, shift_band: tuple[int, int],
            min_step: float = 0.001) -> torch.Tensor:
    """Induced current per (segment, pixel, tick); the port of
    ``current_pallas``.

    Args:
        segs: drifted segment batch (S,).
        pix_x, pix_y: (S, P) pixel centres [cm]; pix_valid (S, P) mask.
        response: (nx, ny, nt) float32 response LUT on the segments' device.
        smear: (3, S, n_steps) standard normals, or None (midpoints).
        n_steps: sample-point cap per segment.
        t_sig: tick count of the output window.
        shift_band: (shift_lo, shift_hi) from :func:`host_shift_band`.
        min_step: MC step size [cm]; nstep = round(length/min_step).

    Returns:
        (S, P, t_sig) float32 induced current.
    """
    return induced_current(*current_inputs(
        segs, pix_x, pix_y, pix_valid, response, det, smear, n_steps=n_steps,
        t_sig=t_sig, shift_band=shift_band, min_step=min_step))
