"""Light readout: LUT visibility, waveform synthesis, triggers and
digitization.

Counterpart of ``larndsim_tpu.ops.light`` (reference lightLUT.py and
light_sim.py).  Plain PyTorch on every device; the JAX module has no
Pallas kernel.

* Photon arrival series are sums over (segment, channel[, profile bin]);
  they are added in a fixed order (:func:`ordered_sum`), the order of the
  JAX op's sequential scatter, so the sums are the same bits on every run
  and every device (float atomics would add in no fixed order, and the
  Poisson draw downstream turns a last-bit difference into another count).
* The causal scintillation and SiPM convolutions are FFT convolutions at
  the JAX op's power-of-two length (``torch.fft``: cuFFT on the card,
  pocketfft on the CPU), with taps evaluated in float64 and transforms in
  float64, so that both devices give the same rates to the draws
  (:func:`causal_convolve`); the noise is synthesized in float64 for the
  same reason.
* The MC truth with LUT smearing runs each top-K contributor's photon
  series through the linear chain on its own (:func:`light_truth_series`,
  or on the host from :func:`light_truth_select`'s metadata).
* Random draws are explicit: a :class:`LightDraw` supplies the Poisson
  counts, the normals and the noise phases.
* The chain's ops also take a stacked group of independent events on a
  leading axis (``models.light.simulate_light_group`` and
  ``simulate_light_group_mode0``); each event's values are those of a call
  with that event alone.
* The threshold trigger (mode 0) sums each channel group and averages
  each ADC sample's ticks in a fixed float32 order, so a tick at the
  threshold falls on the same side on every device, and walks the dead
  time by table lookups (:func:`dead_time_trigger_scan`); its trigger
  tables reach the host in one copy.
* The JAX ops run jitted, where XLA turns a division by a constant (a
  tick size, a window length) into a multiplication by the constant's
  float32 reciprocal; ``ops.f32.div_const`` does the same on every device,
  so each photon lands on the same tick as in the JAX package.  A
  division by a tensor leaf stays a true division.  XLA's CPU backend
  also contracts the arrival times' multiply-adds (LUT delay [ns] x 1e-3
  + segment time) into fused multiply-adds; ``ops.f32.fma`` rounds them
  once too, which matters where an arrival sits at a tick's edge, as the
  first arrival of a mode-0 window does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..params.detector import DEFAULT_PLANE_INDEX, DetectorParams, card_or
from ..params.light import LightParams
from ..segments import Segments
from . import f32


@dataclasses.dataclass(frozen=True)
class LightDraw:
    """The light chain's random draws, each taken once per batch, in this
    order: ``poisson(rate)`` counts at the (C, n_ticks) rates, then
    ``normal(shape)`` standard normals of that shape, then
    ``uniform(shape)`` noise phases on [0, 1) of shape (C, n_freq)."""
    poisson: Callable[[torch.Tensor], torch.Tensor]
    normal: Callable[[tuple], torch.Tensor]
    uniform: Callable[[tuple], torch.Tensor]


# --------------------------------------------------------------------------
# Light LUT container
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LightLUT:
    """Tensors unpacked from a light lookup table, on one device.

    The on-disk format is a structured array 'arr' of shape
    (nx, ny, nz, ndet_tpc) with fields vis / t0 / t0_avg / time_dist
    (cli/simulate_pixels.py:768-787).
    """
    vis: torch.Tensor         # (nx, ny, nz, ndet_tpc)
    t0: torch.Tensor          # (nx, ny, nz, ndet_tpc) earliest arrival [ns]
    t0_avg: torch.Tensor      # (nx, ny, nz, ndet_tpc) mean arrival [ns]
    time_dist: torch.Tensor   # (nx, ny, nz, ndet_tpc, nprof)
    #: host copy of ``time_dist`` (the host truth route's, models.light)
    time_dist_host: np.ndarray = dataclasses.field(repr=False,
                                                   compare=False)

    @classmethod
    def from_structured(cls, arr: np.ndarray, device='cuda') -> 'LightLUT':
        """The LUT on ``device`` (the card unless the caller names
        another), with zero-visibility voxels clipped to the minimum
        positive visibility (cli/simulate_pixels.py:780-782)."""
        device = card_or(device, 'the light LUT')
        vis = np.array(arr['vis'], np.float32)
        mask = vis > 0
        if mask.any():
            vis[~mask] = vis[mask].min()
        names = arr.dtype.names
        t0 = np.array(arr['t0'], np.float32) if 't0' in names else \
            np.zeros(vis.shape, np.float32)
        t0_avg = np.array(arr['t0_avg'], np.float32) if 't0_avg' in names \
            else np.zeros(vis.shape, np.float32)
        tdist = (np.array(arr['time_dist'], np.float32)
                 if 'time_dist' in names
                 else np.ones(vis.shape + (1,), np.float32))
        put = lambda a: torch.from_numpy(a).to(device)
        return cls(put(vis), put(t0), put(t0_avg), put(tdist),
                   time_dist_host=tdist)


# --------------------------------------------------------------------------
# Visibility lookup (lightLUT.py)
# --------------------------------------------------------------------------

def get_voxel(segs: Segments, det: DetectorParams, vox_div) -> torch.Tensor:
    """LUT voxel indices per segment (lightLUT.get_voxel, :15-63):
    fractional position in the (tolerance-padded) TPC volume, with x
    mirrored in odd TPCs to preserve left/right-ness.  (S, 3) int64."""
    plane = torch.clamp(segs.pixel_plane, 0, det.n_tpcs - 1).long()
    b = det.tpc_borders[plane]                       # (S, 3, 2)
    is_even = b[:, 2, 1] > b[:, 2, 0]
    pad = 2e-2
    x_min, x_max = b[:, 0, 0] - pad, b[:, 0, 1] + pad
    y_min, y_max = b[:, 1, 0] - pad, b[:, 1, 1] + pad
    z_min, z_max = b[:, 2, 0] - pad, b[:, 2, 1] + pad

    i_even = (segs.x - x_min) / (x_max - x_min) * vox_div[0]
    i_odd = (x_max - segs.x) / (x_max - x_min) * vox_div[0]
    i = torch.where(is_even, i_even, i_odd).to(torch.int32)
    j = ((y_max - segs.y) / (y_max - y_min) * vox_div[1]).to(torch.int32)
    k = ((segs.z - z_min) / (z_max - z_min) * vox_div[2]).to(torch.int32)
    i = torch.clamp(i, 0, vox_div[0] - 1)
    j = torch.clamp(j, 0, vox_div[1] - 1)
    k = torch.clamp(k, 0, vox_div[2] - 1)
    return torch.stack([i, j, k], dim=-1).long()


def _at_voxels(table: torch.Tensor, vox: torch.Tensor,
               lut_idx: torch.Tensor) -> torch.Tensor:
    """``table[vox..., lut_idx]`` for voxels (..., 3) against channel rows
    (C,) broadcast over the voxels' leading axes."""
    v = vox.unsqueeze(-2)                            # (..., 1, 3)
    return table[v[..., 0], v[..., 1], v[..., 2], lut_idx]


def calculate_light_incidence(segs: Segments, det: DetectorParams,
                              light: LightParams, lut_vis: torch.Tensor,
                              lut_t0: torch.Tensor, *, n_channels: int,
                              channel_offset: int = 0):
    """Photons incident on each optical channel (lightLUT.py:65-136).

    Args:
        n_channels: output channel count (a module's with module
            variation).
        channel_offset: absolute id of output channel 0 (with module
            variation, the module's first channel).

    Returns:
        (n_photons_det (S, n_channels) f32, t0_det (S, n_channels) f32 [us],
        voxel (S, 3) int64)
    """
    vox = get_voxel(segs, det, lut_vis.shape[:3])
    itpc = segs.pixel_plane
    in_tpc = (itpc != DEFAULT_PLANE_INDEX) & segs.valid

    out_i = torch.arange(n_channels, device=lut_vis.device)
    op_abs = out_i + channel_offset                  # absolute channel
    lut_idx = out_i % lut_vis.shape[3]

    vis = _at_voxels(lut_vis, vox, lut_idx)          # (S, C)
    t1 = _at_voxels(lut_t0, vox, lut_idx)
    eff = light.op_channel_efficiency[op_abs]
    same_tpc = light.op_channel_to_tpc[op_abs][None, :] == itpc[:, None]

    n_det = torch.where(in_tpc[:, None] & same_tpc,
                        eff[None, :] * vis * segs.n_photons[:, None], 0.0)
    # t0 in us: lut t0 [ns] + segment t0 [us] (lightLUT.py:135)
    t0_det = torch.where(in_tpc[:, None],
                         f32.fma(t1, 1e-3, segs.t0[:, None]), 0.0)
    return n_det.float(), t0_det.float(), vox


# --------------------------------------------------------------------------
# Waveform synthesis (light_sim.py)
# --------------------------------------------------------------------------

_HOST_COPIES: dict = {}


def host_array(t) -> np.ndarray:
    """A numpy copy of ``t``.  Tensors are copied once each, so host code
    reads a card's parameter tables without waiting for the card again."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    hit = _HOST_COPIES.get(id(t))
    if hit is not None and hit[0] is t:
        return hit[1]
    if len(_HOST_COPIES) > 64:
        _HOST_COPIES.clear()
    arr = t.detach().cpu().numpy()
    _HOST_COPIES[id(t)] = (t, arr)
    return arr


def upload(a: np.ndarray, device) -> torch.Tensor:
    """Host data as a tensor on ``device``.  To the card it goes through
    pinned memory, copied behind the stream's queued work, so the host does
    not wait for the card (a copy from pageable memory waits for the
    stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def get_nticks(n_photons_det, t0_det, light: LightParams) -> tuple[int, float]:
    """(n_ticks, start_time) of the simulated window (light_sim.get_nticks,
    :24-41): in the threshold mode (0) from the first to the last arrival
    of a detected photon, widened by the light window; the beam window
    otherwise, or when nothing is lit.  Host-side: ``n_photons_det`` and
    ``t0_det`` (S, C) are numpy arrays (tensors are copied to the host)."""
    if light.light_trig_mode == 0:
        n = np.asarray(n_photons_det.cpu() if isinstance(
            n_photons_det, torch.Tensor) else n_photons_det)
        mask = n > 0
        if mask.any():
            t0 = np.asarray(t0_det.cpu() if isinstance(t0_det, torch.Tensor)
                            else t0_det)
            start = float(t0[mask].min()) - light.light_window[0]
            end = float(t0[mask].max()) + light.light_window[1]
            return int(np.ceil((end - start) / light.light_tick_size)), start
    return int((light.light_window[1] + light.light_window[0])
               / light.light_tick_size), 0.0


def ordered_sum(keys: torch.Tensor, values: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Rows of ``values`` (M, W) summed by key into (n_out, W).

    ``out[k]`` adds every row ``i`` with ``keys[i] == k`` one after
    another, in ascending ``i`` -- the order of the JAX package's
    sequential scatter-add -- so the result is the same bits on every run
    and every device.  Rows whose key is ``n_out`` or more are dropped.
    Nothing waits for the device.
    """
    M, W = values.shape
    dev = values.device
    order = torch.sort(keys, stable=True).indices
    sk = keys[order]
    if n_out < M:
        # every key a segment, in key order, then the sink's (the rest)
        bounds = torch.searchsorted(sk, torch.arange(n_out + 1, device=dev))
        lengths = torch.diff(bounds, append=bounds.new_full((1,), M))
        return torch.segment_reduce(values[order], 'sum', lengths=lengths,
                                    axis=0, unsafe=True)[:n_out]
    # far more keys than rows (the truth series): one segment per run of
    # equal sorted keys, M segments, the unused ones empty (they sum to 0
    # into the sink)
    out = torch.zeros((n_out + 1, W), dtype=values.dtype, device=dev)
    if M == 0:
        return out[:n_out]
    sk = torch.clamp(sk, max=n_out)                   # n_out: the sink
    first = torch.ones(M, dtype=torch.bool, device=dev)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1                  # segment of each row
    lengths = torch.zeros(M, dtype=torch.long, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))
    seg_key = torch.full((M,), n_out, dtype=torch.long, device=dev).scatter_(
        0, seg, sk.long())
    out[seg_key] = torch.segment_reduce(values[order], 'sum',
                                        lengths=lengths, axis=0, unsafe=True)
    return out[:n_out]


def _event_offset(lead, stride: int, device):
    """Key offset ``g * stride`` of each event of a stacked group, shaped
    to broadcast against its (*lead, x, y) tensors; 0 without a group."""
    if not lead:
        return 0
    G = math.prod(lead)
    return (torch.arange(G, device=device) * stride).view(*lead, 1, 1)


def sum_light_signals(segs: Segments, voxels, n_photons_det, op_channel,
                      lut_time_dist, lut_t0_avg, start_time: float,
                      light: LightParams, *, n_ticks: int,
                      lut_smearing: bool) -> torch.Tensor:
    """Photon arrival time series per channel (light_sim.py:58-129).

    Args:
        voxels: (S, 3) LUT voxel per segment.
        n_photons_det: (S, C) photons on each simulated channel.
        op_channel: (C,) absolute channel index of each output row.
        lut_time_dist: (nx, ny, nz, ndet_tpc, nprof) normalized profiles.
        lut_t0_avg: (nx, ny, nz, ndet_tpc) mean arrival delay [ns].
        start_time: window start [us]; a (G, 1, 1) float32 tensor gives
            each event of a group its own.

    Returns:
        (C, n_ticks) photons/us.  A stacked group of events (segments
        (G, S), voxels (G, S, 3), photons (G, S, C)) gives (G, C, n_ticks):
        each event's keys are offset by its own range, so each series is
        the sum a call with that event alone gives, in the same order.
    """
    *lead, S, C = n_photons_det.shape
    G = math.prod(lead)
    dev = n_photons_det.device
    tick = light.light_tick_size
    lut_idx = (op_channel % lut_time_dist.shape[3]).long()
    track_time = segs.t0                                       # (..., S)
    if S == 0:
        return torch.zeros((*lead, C, n_ticks), dtype=torch.float32,
                           device=dev)
    if lut_smearing:
        nprof = lut_time_dist.shape[4]
        prof = _at_voxels(lut_time_dist, voxels, lut_idx)  # (.., S, C, nprof)
        # profile bin j arrives at track_time + j * 1 ns (light_sim.py:101:
        # assumes 1 ns profile bins); the tick of (segment, bin) is the same
        # for every channel
        j_arr = torch.arange(nprof, dtype=torch.float32, device=dev) * 1e-3
        t_arr = track_time[..., None] + j_arr                  # (.., S, nprof)
        tick_f = f32.div_const(t_arr - start_time, tick)
        itick = torch.ceil(tick_f).to(torch.int32) - 1
        # strict (start_tick_time, end_tick_time) interval as in the
        # reference
        ok = (tick_f > itick) & (itick >= 0) & (itick < n_ticks)
        photons = f32.div_const(n_photons_det[..., None] * prof, tick)
        # (g, s, j) major
        rows = photons.transpose(-1, -2).reshape(G * S * nprof, C)
        keys = torch.where(ok, itick + _event_offset(lead, n_ticks, dev),
                           G * n_ticks).reshape(-1).long()
        out = ordered_sum(keys, rows, G * n_ticks)
        return out.view(*lead, n_ticks, C).transpose(-1, -2).contiguous()
    t0_avg = _at_voxels(lut_t0_avg, voxels, lut_idx)           # (..., S, C)
    t_arr = f32.fma(t0_avg, 1e-3, track_time[..., None])       # ns -> us
    tick_f = f32.div_const(t_arr - start_time, tick)
    itick = torch.ceil(tick_f).to(torch.int32) - 1
    ok = (tick_f > itick) & (itick >= 0) & (itick < n_ticks)
    photons = f32.div_const(n_photons_det, tick)
    rows = (torch.arange(C, device=dev) * n_ticks
            + _event_offset(lead, C * n_ticks, dev))
    keys = torch.where(ok, rows + itick, G * C * n_ticks).reshape(-1)
    out = ordered_sum(keys, photons.reshape(G * S * C, 1), G * C * n_ticks)
    return out.view(*lead, C, n_ticks)


def _top_contributors(n_photons_det: torch.Tensor, k_truth: int):
    """The K strongest segments of each channel by detected photons, as
    (order (K, C) segment rows, contrib (K, C) photons, has (K, C) photons
    > 0); (G, K, C) each for a stacked group's (G, S, C).  A stable sort of
    ``0 - n`` (zeros sort as +0.0 on every device): ties between equal
    photon counts pick the same segments as the JAX package's
    ``argsort(-n)``."""
    k_truth = min(k_truth, n_photons_det.shape[-2])
    order = torch.argsort(0.0 - n_photons_det, dim=-2,
                          stable=True)[..., :k_truth, :]       # (..., K, C)
    contrib = torch.gather(n_photons_det, -2, order)
    return order, contrib, contrib > 0


def _take(values: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-segment ``values`` (..., S) at the rows ``order`` (..., K, C):
    (..., K, C)."""
    return torch.gather(values.unsqueeze(-1).expand(
        *values.shape, order.shape[-1]), -2, order)


def _take_voxels(voxels: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Voxels (..., S, 3) at the rows ``order`` (..., K, C): (..., K, C,
    3)."""
    return torch.stack([_take(voxels[..., i], order) for i in range(3)],
                       dim=-1)


def light_truth_points(segs: Segments, voxels, n_photons_det, op_channel,
                       lut_t0_avg, start_time: float, light: LightParams, *,
                       k_truth: int):
    """Top-K truth contributors as (segment id, photons/us, arrival tick).

    Without LUT smearing each contributor's photon series is a single
    delta, so the whole truth chain (two linear convolutions + digitizer
    interpolation) collapses to a lookup of the combined kernel (done on
    the host by ``models.light``).  Returns (ids (C,K), amp (C,K), itick
    (C,K)).
    """
    tick = light.light_tick_size
    order, contrib, has = _top_contributors(n_photons_det, k_truth)
    ids = torch.where(has, _take(segs.segment_id, order),
                      -1).transpose(-1, -2)                    # (C, K)

    lut_idx = (op_channel % lut_t0_avg.shape[3]).long()
    vox = _take_voxels(voxels, order)                          # (K, C, 3)
    t0_avg = lut_t0_avg[vox[..., 0], vox[..., 1], vox[..., 2],
                        lut_idx]                               # (K, C)
    t_arr = f32.fma(t0_avg, 1e-3, _take(segs.t0, order))
    tick_f = f32.div_const(t_arr - start_time, tick)
    itick = torch.ceil(tick_f).to(torch.int32) - 1             # (K, C)
    amp = torch.where(has & (tick_f > itick), f32.div_const(contrib, tick),
                      0.0)
    return ids, amp.transpose(-1, -2).float(), itick.transpose(-1, -2)


def light_truth_select(segs: Segments, voxels, n_photons_det, *,
                       k_truth: int):
    """Top-K truth contributor metadata per channel: the card's part of the
    host route of the LUT-smearing truth (``models.light``), where a
    worker rebuilds each contributor's series from the host LUT.

    Returns:
        ids (C, K) int32 segment ids (-1: none), contrib (C, K) float32
        photons (0 where none), t0 (C, K) float32 [us], voxels (C, K, 3)
        int32.
    """
    order, contrib, has = _top_contributors(n_photons_det, k_truth)
    ids = torch.where(has, _take(segs.segment_id, order), -1)
    return (ids.transpose(-1, -2).to(torch.int32).contiguous(),
            torch.where(has, contrib, 0.0).transpose(-1, -2).float()
            .contiguous(),
            _take(segs.t0, order).transpose(-1, -2).float().contiguous(),
            _take_voxels(voxels, order).transpose(-3, -2).to(torch.int32)
            .contiguous())


def light_truth_series(segs: Segments, voxels, n_photons_det, op_channel,
                       lut_time_dist, start_time: float, light: LightParams,
                       *, n_ticks: int, k_truth: int):
    """Per-(channel, top-K segment) photon series with LUT smearing
    (the JAX op's ``lut_smearing`` branch, light_sim.py:106-129): each
    contributor's LUT arrival profile, one row per contributor.  The truth
    chain is linear, so each row can be pushed through the transfer table
    on its own.  Duplicate ticks of one contributor add in the JAX
    scatter's order (:func:`ordered_sum`).

    Returns:
        ids (C, K) segment ids (-1 padding), series (C, K, n_ticks) float32
        photons/us; (G, C, K) and (G, C, K, n_ticks) for a stacked group
        (as :func:`sum_light_signals` takes one).
    """
    tick = light.light_tick_size
    dev = n_photons_det.device
    *lead, _, C = n_photons_det.shape
    G = math.prod(lead)
    order, contrib, has = _top_contributors(n_photons_det, k_truth)
    K = order.shape[-2]
    ids = torch.where(has, _take(segs.segment_id, order),
                      -1).transpose(-1, -2)                    # (..., C, K)

    lut_idx = (op_channel % lut_time_dist.shape[3]).long()
    vox = _take_voxels(voxels, order)                          # (..., K, C, 3)
    prof = lut_time_dist[vox[..., 0], vox[..., 1], vox[..., 2],
                         lut_idx]                              # (.., K, C, nprof)
    nprof = prof.shape[-1]
    j_arr = torch.arange(nprof, dtype=torch.float32, device=dev) * 1e-3
    t_arr = _take(segs.t0, order)[..., None] + j_arr           # (.., K, C, nprof)
    tick_f = f32.div_const(t_arr - start_time, tick)
    itick = torch.ceil(tick_f).to(torch.int32) - 1
    ok = ((tick_f > itick) & (itick >= 0) & (itick < n_ticks)
          & has[..., None])
    photons = f32.div_const(contrib[..., None] * prof, tick)
    # output row of (g, k, c): (g * C + c) * K + k; the rows run (g, k, c,
    # bin) major, the JAX scatter's update order within each event
    row = (torch.arange(C, device=dev)[None, :] * K
           + torch.arange(K, device=dev)[:, None]
           + _event_offset(lead, C * K, dev))                  # (..., K, C)
    n_out = G * C * K * n_ticks
    keys = torch.where(ok, row[..., None].long() * n_ticks + itick, n_out)
    series = ordered_sum(keys.reshape(-1), photons.reshape(-1, 1), n_out)
    return ids, series.view(*lead, C, K, n_ticks)


def scintillation_kernel(light: LightParams, conv_ticks: int) -> torch.Tensor:
    """Two-exponential emission-time kernel (light_sim.py:132-145), float32.

    conv_ticks + 1 taps: the reference convolution loop spans
    ``range(itick - conv_ticks, itick + 1)`` -- t-j in [0, conv_ticks]
    INCLUSIVE (light_sim.py:164).  The taps are evaluated in float64 from
    the float32 leaves and rounded to float32, so every device gets the
    same taps (float32 ``exp`` rounds differently on the card and on the
    CPU; each is within a few ulp of the JAX op's)."""
    k = torch.arange(conv_ticks + 1, dtype=torch.float64, device=light.device)
    tick = light.light_tick_size
    singlet = light.singlet_fraction.double()
    tau_s, tau_t = light.tau_s.double(), light.tau_t.double()
    p1 = (singlet * torch.exp(-k * tick / tau_s)
          * (1 - torch.exp(-tick / tau_s)))
    p3 = ((1 - singlet) * torch.exp(-k * tick / tau_t)
          * (1 - torch.exp(-tick / tau_t)))
    return (p1 + p3).float()


def sipm_kernel(light: LightParams, conv_ticks: int) -> torch.Tensor:
    """SiPM impulse response kernel (light_sim.py:274-300), float32,
    evaluated in float64 as the scintillation kernel.

    conv_ticks + 1 taps, matching the reference loop's inclusive bound
    (light_sim.py:318)."""
    k = torch.arange(conv_ticks + 1, dtype=torch.float64, device=light.device)
    tick = light.light_tick_size
    if light.sipm_response_model == 0:
        t = k * tick
        rt = light.light_response_time.double()
        op = light.light_oscillation_period.double()
        imp = torch.exp(-t / rt) * torch.sin(t / op)
        imp = imp / (op * rt * rt) * (op * op + rt * rt)
        return (imp * tick).float()
    # measured impulse, linearly interpolated to the light tick grid
    idx = k * tick / light.impulse_tick_size
    i0 = torch.floor(idx).long()
    frac = idx - i0
    arr = light.impulse_model.double()
    n = arr.shape[0]
    at = lambda i: torch.where((i >= 0) & (i < n),
                               arr[torch.clamp(i, 0, n - 1)], 0.0)
    v0, v1 = at(i0), at(i0 + 1)
    imp = torch.where(i0 > n - 2, 0.0, v0 + (v1 - v0) * frac)
    return (imp / (light.impulse_tick_size / light.light_tick_size)).float()


def causal_convolve(signal: torch.Tensor,
                    kernel: torch.Tensor) -> torch.Tensor:
    """FFT causal convolution along the last axis, output truncated to the
    signal length; the FFT length is the JAX op's power of two.

    The transforms run in float64 and the result is rounded to the
    signal's dtype.  A float32 transform is off by ~1e-6 of the peak, and
    cuFFT and pocketfft are off differently; the Poisson and Gaussian
    draws downstream turn such a difference into another count at many
    ticks.  In float64 the card and the CPU give the same float32 rates
    but at rounding ties (and stay within the JAX package's float32 FFT
    tolerance, rtol 2e-4).
    """
    n = signal.shape[-1]
    k = kernel.shape[-1]
    fft_len = int(2 ** np.ceil(np.log2(max(n + k - 1, 1))))
    ker_f = torch.fft.rfft(kernel.double(), n=fft_len)
    sig_f = torch.fft.rfft(signal.double(), n=fft_len, dim=-1)
    out = torch.fft.irfft(sig_f * ker_f, n=fft_len, dim=-1)[..., :n]
    return out.to(signal.dtype)


def calc_scintillation_effect(light_sample_inc, light: LightParams, *,
                              conv_ticks: int) -> torch.Tensor:
    """LAr scintillation time smearing (light_sim.py:148-168)."""
    return causal_convolve(light_sample_inc,
                           scintillation_kernel(light, conv_ticks))


def calc_stat_fluctuations(light_sample_inc, draw: LightDraw,
                           light: LightParams) -> torch.Tensor:
    """Poisson PE fluctuations per tick (light_sim.py:186-238): exact
    Poisson below mean 30, truncated gaussian above.  Both draws cover
    every tick, as in the JAX op."""
    tick = light.light_tick_size
    mean = light_sample_inc * tick
    small = draw.poisson(torch.clamp(mean, min=1e-30)).to(torch.float32)
    big = torch.clamp(torch.floor(
        draw.normal(tuple(mean.shape)) * torch.sqrt(torch.clamp(mean, min=0))
        + mean), min=0.0)
    n = torch.where(mean < 30, small, big)
    return torch.where(mean > 0, f32.div_const(n, tick), 0.0)


def calc_light_detector_response(light_sample_inc, gains,
                                 light: LightParams, *,
                                 conv_ticks: int) -> torch.Tensor:
    """SiPM response convolution x per-channel gain (light_sim.py:303-336);
    (..., C, n_ticks) in and out."""
    resp = causal_convolve(light_sample_inc, sipm_kernel(light, conv_ticks))
    return gains[:, None] * resp


# --------------------------------------------------------------------------
# Noise, digitizer
# --------------------------------------------------------------------------

def rfftfreq(n: int, d: float, device) -> torch.Tensor:
    """Sample frequencies of an rfft of length ``n`` (jnp.fft.rfftfreq's
    float32 arithmetic: k / (d * n), a constant divisor under jit)."""
    k = torch.arange(n // 2 + 1, dtype=torch.float32, device=device)
    return f32.div_const(k, d * n)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean`` of a 1-D float32 tensor under jit: the sum times the
    float32 reciprocal of the count (NaN when empty).  The sum is taken in
    float64, where these sums are exact, so no device's order of addition
    shows."""
    return f32.div_const(x.double().sum().float(), x.numel())


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor,
           left: float, right: float) -> torch.Tensor:
    """``jnp.interp(x, xp, row, left, right)`` for every row of ``fp``
    (..., len(xp)), with the JAX function's arithmetic (the bracketing
    knot by a right-sided search, equal at the knots)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    df = fp[..., i] - fp[..., i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[..., i - 1],
                    fp[..., i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], left, f)
    return torch.where(x > xp[-1], right, f)


def noise_spectrum(n: int, light_det_noise: torch.Tensor,
                   light: LightParams) -> torch.Tensor:
    """The measured amplitude spectra (C, n_bins) resampled onto the rfft
    bins of ``n`` simulation ticks and scaled, float32 (C, n // 2 + 1)
    (light_sim.py:339-366)."""
    dev = light_det_noise.device
    noise_freq = rfftfreq((light_det_noise.shape[-1] - 1) * 2,
                          light.light_det_noise_sample_spacing, dev)
    desired_freq = rfftfreq(n, light.light_tick_size, dev)
    bin_size = _mean(torch.diff(desired_freq))
    spectrum = interp(desired_freq, noise_freq, light_det_noise, 0.0, 0.0)
    return spectrum * f32.div_const(
        torch.sqrt(_mean(torch.diff(noise_freq)) / bin_size)
        * light.light_digit_sample_spacing, light.light_tick_size)


def noise_from_spectrum(spectrum: torch.Tensor, phase: torch.Tensor,
                        n: int, light: LightParams) -> torch.Tensor:
    """Noise of ``n`` ticks from amplitudes and phases (C, n_freq; the
    phases may carry leading axes): inverse FFT, rounded to whole quanta,
    zero-padded to ``n`` (light_sim.py:367-377); in the inputs' dtype,
    returned as float32."""
    noise_f = torch.complex(spectrum * torch.cos(phase),
                            spectrum * torch.sin(phase))
    quant = 2 ** (16 - light.light_nbit)
    if n < 2:
        noise = torch.round(noise_f.real) * quant
    else:
        noise = torch.round(torch.fft.irfft(noise_f, dim=-1)) * quant
    noise = noise.float()
    if noise.shape[-1] < n:
        noise = torch.nn.functional.pad(noise, (0, n - noise.shape[-1]))
    return noise[..., :n]


def gen_light_detector_noise(shape, light_det_noise: torch.Tensor,
                             draw: LightDraw,
                             light: LightParams) -> torch.Tensor:
    """Frequency-domain noise synthesis (light_sim.py:339-377): resample the
    measured amplitude spectrum onto the simulation tick grid, randomize
    phases, inverse FFT.

    Args:
        shape: (C, n) of the noise, or (G, C, n) for a stacked group (each
            event's phases drawn at (C, n_freq) by the group's draw).
        light_det_noise: (C, n_bins) float32 amplitude spectra.
    """
    if shape[-2] == 0:
        return torch.zeros(shape, dtype=torch.float32,
                           device=light_det_noise.device)
    spectrum = noise_spectrum(shape[-1], light_det_noise, light)
    phase = (2 * math.pi) * draw.uniform(tuple(shape[:-1])
                                         + (spectrum.shape[-1],))
    # phases and the inverse transform in float64 (as in causal_convolve):
    # the rounding to whole quanta then gives the same noise on every
    # device but at ties
    return noise_from_spectrum(spectrum.double(), phase.double(), shape[-1],
                               light)


# --------------------------------------------------------------------------
# Threshold trigger (mode 0)
# --------------------------------------------------------------------------

def sample_factor(light: LightParams) -> int:
    """Simulation ticks per ADC sample."""
    return round(light.light_digit_sample_spacing / light.light_tick_size)


def digit_ticks(light: LightParams) -> int:
    """Dead time after a trigger: the digitized window, in ticks."""
    return int(np.ceil((light.light_trig_window[1]
                        + light.light_trig_window[0])
                       / light.light_tick_size))


def group_above_threshold(signal: torch.Tensor, group_threshold: torch.Tensor,
                          *, per_trig: int, sample_factor: int) -> torch.Tensor:
    """Per-trigger-group threshold comparison at the ADC sample rate
    (light_sim.py:394-409): each group of ``per_trig`` channels summed,
    the sum averaged over blocks of ``sample_factor`` ticks (the last block
    zero-padded) and repeated back, compared with the group's threshold
    by ``<``: the pulses are negative-going (light_sim.py:407).

    The sums are float32 adds in a fixed order, the JAX op's on the CPU
    (:func:`_lane_sum`), so a tick at the threshold falls on the same side
    on every device and in both packages.

    Args:
        signal: (C, T) response; (G, C, T) for a stacked group.
        group_threshold: (n_grp,) thresholds [ADC].

    Returns:
        (n_grp, T) bool; (G, n_grp, T) for a group.
    """
    *lead, C, T = signal.shape
    n_grp = C // per_trig
    grouped = signal[..., :n_grp * per_trig, :].reshape(*lead, n_grp,
                                                        per_trig, T)
    s = grouped[..., 0, :]
    for j in range(1, per_trig):
        s = s + grouped[..., j, :]
    pad = (-T) % sample_factor
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    b = _lane_sum(s.reshape(*lead, n_grp, -1, sample_factor))
    above = f32.div_const(b, sample_factor) < group_threshold[:, None]
    return above.repeat_interleave(sample_factor, dim=-1)[..., :T]


#: vector lanes of the JAX op's block sum on the CPU
_LANES = 8


def _lane_sum(blocks: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order XLA's CPU backend adds a block
    of :func:`group_above_threshold` (the block sum fused behind the
    groups' sum): over 8 vector lanes, lane L adding ticks L, L + 8, ...
    one after another, then the lanes pairwise by halves (lane i + lane
    i + 4, then i + 2, then i + 1; absent lanes hold 0)."""
    f = blocks.shape[-1]
    lanes = []
    for lane in range(min(f, _LANES)):
        acc = blocks[..., lane]
        for t in range(lane + _LANES, f, _LANES):
            acc = acc + blocks[..., t]
        lanes.append(acc)
    lanes += [torch.zeros_like(lanes[0])] * (_LANES - len(lanes))
    while len(lanes) > 1:
        half = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + half] for i in range(half)]
    return lanes[0]


def dead_time_trigger_scan(above: torch.Tensor, *, digit_ticks: int,
                           max_trig: int):
    """The sequential dead-time trigger walk (light_sim.py:430-443) as
    table lookups: each row's first above-threshold tick at or after 0,
    then the first at or after each trigger + ``digit_ticks``.

    A next-above table (the least above tick ``t' >= t``, by a reversed
    cumulative minimum) answers each step, so the walk is ``max_trig``
    gathers, integer work that gives the same result on every device, and
    nothing waits for it.

    Args:
        above: (M, T) bool, per-module above-threshold flags; (G, M, T)
            for a stacked group.
        max_trig: output slots (``T // digit_ticks + 1`` is an exact
            bound).

    Returns:
        idx: (M, max_trig) int32 trigger ticks, ascending, -1 padded.
        counts: (M,) int32 triggers per row.
        (Each with the group's leading axis.)
    """
    T = above.shape[-1]
    ticks = torch.arange(T, device=above.device)
    first = torch.where(above, ticks, T)
    # next_above[..., t] for t in [0, T]; T: none left
    next_above = torch.flip(torch.cummin(torch.flip(first, (-1,)), -1).values,
                            (-1,))
    next_above = torch.nn.functional.pad(next_above, (0, 1), value=T)
    step = max(digit_ticks, 1)
    t = next_above[..., :1]
    idx = [t]
    for _ in range(max_trig - 1):
        t = torch.gather(next_above, -1, torch.clamp(t + step, max=T))
        idx.append(t)
    idx = torch.cat(idx, dim=-1)
    fired = idx < T
    return (torch.where(fired, idx, -1).to(torch.int32),
            fired.sum(-1).to(torch.int32))


def mode0_module_masks(op_channel_idx: np.ndarray, light: LightParams,
                       module_to_tpcs, tpc_to_module):
    """Per-module trigger-group membership for the mode-0 scan
    (light_sim.py:418-428): which threshold groups belong to each module
    sharing channels with ``op_channel_idx``.  Host numpy.

    Returns (gmasks (n_mod, n_grp) bool, ops_per_mod list of channel-id
    arrays) in ascending module-id order: the trigger emission order the
    solo and grouped paths share.
    """
    n_grp = len(op_channel_idx) // light.op_channel_per_trig
    op_to_tpc = host_array(light.op_channel_to_tpc)
    tpc_to_op = host_array(light.tpc_to_op_channel)
    tpc_ids = np.unique(op_to_tpc[op_channel_idx])
    mod_ids = np.unique([tpc_to_module[t] for t in tpc_ids])
    gmasks, ops_per_mod = [], []
    for mod_id in mod_ids:
        op_channels = tpc_to_op[module_to_tpcs[mod_id]].ravel()
        mask = np.isin(op_channel_idx, op_channels)
        gmasks.append(mask.reshape(n_grp,
                                   light.op_channel_per_trig).any(axis=1))
        ops_per_mod.append(op_channels)
    return np.stack(gmasks), ops_per_mod


def mode0_group_threshold(op_channel_idx: np.ndarray,
                          light: LightParams) -> np.ndarray:
    """Per-trigger-group thresholds for the simulated channels
    (light_sim.py:399-404).  Host numpy."""
    thr = np.repeat(host_array(light.light_trig_threshold)[:, None],
                    light.op_channel_per_trig, axis=-1).ravel()
    return thr[op_channel_idx].reshape(-1, light.op_channel_per_trig)[:, 0]


def trigger_tables(signal: torch.Tensor, group_threshold: np.ndarray,
                   gmasks: np.ndarray, light: LightParams):
    """Mode 0's trigger tables on the signal's device: the groups' flags
    (:func:`group_above_threshold`), each module's as any of its groups',
    then the scan.  (idx (M, max_trig), counts (M,)); each with the
    group's leading axis for a (G, C, T) signal."""
    dev = signal.device
    above = group_above_threshold(
        signal, upload(np.asarray(group_threshold, np.float32), dev),
        per_trig=light.op_channel_per_trig,
        sample_factor=sample_factor(light))                   # (.., n_grp, T)
    gm = upload(np.asarray(gmasks, bool), dev)
    module_above = (gm[:, :, None] & above.unsqueeze(-3)).any(-2)  # (.., M, T)
    T = signal.shape[-1]
    dt = digit_ticks(light)
    return dead_time_trigger_scan(module_above, digit_ticks=dt,
                                  max_trig=T // max(dt, 1) + 1)


def trigger_lists(idx: np.ndarray, counts: np.ndarray, ops_per_mod,
                  n_channels: int) -> list:
    """Each event's (trigger_idx, trigger_op_channel_idx, trigger_type)
    from host copies of the trigger tables, idx (G, M, max_trig) and
    counts (G, M), in module order (light_sim.get_triggers' emission
    order)."""
    out = []
    for idx_g, counts_g in zip(idx, counts):
        trigger_idx, trig_op = [], []
        for m, ops in enumerate(ops_per_mod):
            n = int(counts_g[m])
            trigger_idx += [int(t) for t in idx_g[m, :n]]
            trig_op += [ops] * n
        out.append(_trigger_arrays(trigger_idx, trig_op,
                                   [0] * len(trigger_idx), n_channels))
    return out


def _trigger_arrays(trigger_idx, trig_op, trig_type, n_channels: int):
    if trigger_idx:
        return (np.array(trigger_idx), np.array(trig_op), np.array(trig_type))
    return (np.empty((0,), int), np.empty((0, n_channels), int),
            np.empty((0,), int))


def get_triggers(signal: torch.Tensor, group_threshold: np.ndarray,
                 op_channel_idx: np.ndarray, i_subbatch: int,
                 light: LightParams, module_to_tpcs, tpc_to_module,
                 device_scan: bool = True):
    """Trigger scan (light_sim.get_triggers, :380-477) of one (C, T)
    signal.  Mode 0: the threshold groups and the dead-time walk on the
    signal's device, one pull of the trigger tables; ``device_scan=False``
    pulls the groups' flags and walks them on the host as the reference
    does (the oracle the tests hold the scan to).  Mode 1: one forced
    trigger at tick 0 on an event's first batch (``i_subbatch`` 0).

    Returns (trigger_idx, trigger_op_channel_idx, trigger_type) numpy
    arrays.
    """
    C = len(op_channel_idx)
    if light.light_trig_mode == 0:
        gmasks, ops_per_mod = mode0_module_masks(
            op_channel_idx, light, module_to_tpcs, tpc_to_module)
        if device_scan:
            idx, counts = trigger_tables(signal, group_threshold, gmasks,
                                         light)
            table = torch.cat([idx, counts[:, None]], dim=-1).cpu().numpy()
            return trigger_lists(table[None, :, :-1], table[None, :, -1],
                                 ops_per_mod, C)[0]
        grp_above = group_above_threshold(
            signal, upload(np.asarray(group_threshold, np.float32),
                           signal.device),
            per_trig=light.op_channel_per_trig,
            sample_factor=sample_factor(light)).cpu().numpy()
        dt = digit_ticks(light)
        trigger_idx, trig_op = [], []
        for gmask, op_channels in zip(gmasks, ops_per_mod):
            module_above = np.any(grp_above[gmask], axis=0)
            last_trigger = 0
            while module_above.any():
                next_idx = int(np.nonzero(module_above)[0].min()
                               + last_trigger)
                trigger_idx.append(next_idx)
                trig_op.append(op_channels)
                module_above = module_above[next_idx - last_trigger + dt:]
                last_trigger = next_idx + dt
        return _trigger_arrays(trigger_idx, trig_op, [0] * len(trigger_idx),
                               C)
    if light.light_trig_mode == 1 and i_subbatch == 0:
        # beam mode: one forced trigger per event (light_sim.py:444-451)
        return _trigger_arrays([0], [np.asarray(op_channel_idx)], [1], C)
    return _trigger_arrays([], [], [], C)


def digitize_signal(signal: torch.Tensor, padded_trigger_idx: torch.Tensor,
                    light: LightParams, *, digit_samples: int,
                    ref_exact: bool = False) -> torch.Tensor:
    """Interpolate to the ADC sample grid (light_sim.digitize_signal,
    :480-543) and truncate to the digitizer bit depth.

    Args:
        signal: (C, n_padded_ticks) waveform including front padding of
            ceil(trig_window[0]/tick); (G, C, n_padded_ticks) for a group.
        padded_trigger_idx: (ntrig,) int trigger tick in the padded signal.
        ref_exact: reproduce the reference's *active* code line, which
            ignores `trigger_idx` (light_sim.py:498: every trigger samples
            from padded tick 0); the two agree for a trigger at tick 0
            (beam mode).

    Returns:
        (ntrig, C, digit_samples); (G, ntrig, C, digit_samples) for a
        group.
    """
    dev = signal.device
    f = light.light_digit_sample_spacing / light.light_tick_size
    pre = int(np.ceil(light.light_trig_window[0] / light.light_tick_size))
    s = torch.arange(digit_samples, dtype=torch.float32, device=dev) * f
    trig = padded_trigger_idx.to(torch.int32)
    if ref_exact:
        sample_tick = s[None, :].expand(trig.shape[0], digit_samples)
    else:
        sample_tick = (trig[:, None] - pre).to(torch.float32) + s[None, :]
    i0 = torch.floor(sample_tick).to(torch.int32)                # (ntrig, M)
    frac = sample_tick - i0
    n = signal.shape[-1]
    ok0 = (i0 >= 0) & (i0 <= n - 1)
    ok1 = (i0 + 1 >= 0) & (i0 + 1 <= n - 1)
    at = lambda i: signal[..., torch.clamp(i, 0, n - 1).long()].movedim(
        -2, -3)
    v0 = torch.where(ok0[:, None, :], at(i0), 0.0)               # (ntrig,C,M)
    v1 = torch.where(ok1[:, None, :], at(i0 + 1), 0.0)
    # linear interp with reference edge handling (light_sim.interp :241-271)
    out = torch.where((i0 > n - 2)[:, None, :], 0.0,
                      v0 + (v1 - v0) * frac[:, None, :])
    quant = 2 ** (16 - light.light_nbit)
    return torch.round(f32.div_const(out, quant)) * quant
