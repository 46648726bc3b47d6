"""Charge-readout chain: segments -> LArPix ADC hits.

Counterpart of ``larndsim_tpu.models.charge``: quench -> drift ->
pixelize -> induced current -> per-pixel sum -> self-trigger FSM ->
current fractions -> digitization, with host-side shape selection.  The
per-batch extents (active pixels, signal length, unique pixels, sample
count) are measured on the host and rounded up to power-of-two buckets,
as in the JAX package: the random draws take those shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..ops import accumulate, current, fee, pixelize
from ..ops.drift import drift
from ..ops.quench import quench
from ..params import physics
from ..params.detector import DetectorModel, DetectorParams
from ..params.sim import SimParams
from ..segments import Segments
from ..utils import trace

#: draw(name, shape) -> standard normals of that shape.  Both entries of
#: the chain draw 'smear' (3, S, n_steps), 'q_init' (U,) and 'fee_noise'
#: (n_scan, 5, U) once a batch in this order, which a generator's values
#: depend on and the benchmark's reference reproduces.
Draw = Callable[[str, tuple], torch.Tensor]


def bucket(n: int, lo: int = 16) -> int:
    """Round up to the next power of two (>= lo)."""
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def generator_draw(generator: torch.Generator, device) -> Draw:
    """A :data:`Draw` that takes every draw from ``generator``."""
    return lambda name, shape: torch.randn(shape, generator=generator,
                                           device=device)


@dataclasses.dataclass
class ChargeChainResult:
    """Charge-chain output: per-pixel rows + compact hit lists, in
    (pixel-row, adc-slot) row-major order."""
    unique_pix: np.ndarray        # (U,) pixel ids (-1 padded)
    n_unique: int
    n_adc: np.ndarray             # (U,)
    track_pixel_map: np.ndarray   # (U, max_tracks) batch-local segment index
    overflow: bool
    segments: Segments            # quenched + drifted segments
    max_adc_slots: int
    hit_row: np.ndarray           # (H,) pixel-row index of each hit
    hit_slot: np.ndarray          # (H,) adc slot of each hit
    hit_adc: np.ndarray           # (H,) digitized ADC counts
    hit_ticks: np.ndarray         # (H,) [us]
    hit_integrals: np.ndarray     # (H,) [e-]
    hit_fractions: np.ndarray     # (H, max_tracks)


def pixel_centers(pixels: torch.Tensor, det: DetectorParams):
    """Pixel-centre coordinates from linear ids (detsim.py:180-191 plus
    the +pitch/2 of detsim.py:286-288)."""
    nx, ny = det.n_pixels
    ix = pixels % nx
    iy = (pixels // nx) % ny
    plane = torch.clamp(pixels // (nx * ny), 0, det.n_tpcs - 1).long()
    half = det.pixel_pitch / 2
    x = ix * det.pixel_pitch + det.tpc_borders[plane, 0, 0] + half
    y = iy * det.pixel_pitch + det.tpc_borders[plane, 1, 0] + half
    return x.float(), y.float()


_HOST_FIELDS = ('x_start', 'y_start', 'x_end', 'y_end', 'z_start', 'z_end',
                'pixel_plane', 'tran_diff', 'long_diff', 'dx', 't_start',
                't_end', 't0_start')


@dataclasses.dataclass
class BatchStage:
    """One batch staged for the chain: drifted segments, the host-chosen
    shapes and the pixel maps (everything before the induced current)."""
    segs: Segments                # quenched + drifted, padded
    max_active: int               # active pixels per segment (bucketed)
    radius: int                   # neighbour radius [pixels]
    max_nb: int                   # pixels per segment (bucketed)
    t_sig: int                    # ticks of each signal window
    n_steps: int                  # sample-point cap per segment
    min_step: float               # MC step size [cm]
    n_unique_cap: int             # unique-pixel axis (bucketed exact count)
    pixels: torch.Tensor          # (S, max_nb) pixel ids, -1 padded
    uniq: torch.Tensor            # (n_unique_cap,) unique ids, -1 padded
    n_unique: torch.Tensor        # () unique count
    pix_idx: torch.Tensor         # (S, max_nb) row in uniq, -1 padded
    track_map: torch.Tensor       # (n_unique_cap, max_tracks)
    slot: torch.Tensor            # (S, max_nb) track slot, -1 if none
    overflow: torch.Tensor        # (n_unique_cap,) bool
    csr: accumulate.PixelCSR      # each pixel's entries, for D1 and D2
    px: torch.Tensor              # (S, max_nb) pixel centres [cm]
    py: torch.Tensor
    track_starts: torch.Tensor    # (S,) signal window starts [us]
    thresholds: torch.Tensor | None
    gains: torch.Tensor | None
    shift_band: tuple[int, int]


def _stage(segs: Segments, det: DetectorParams, pixels: torch.Tensor,
           keyed: torch.Tensor, distances: torch.Tensor, *,
           n_unique_cap: int, max_tracks: int, **shapes) -> BatchStage:
    """The device half of staging on ``get_pixels``' ids, ``keyed`` by
    event or not, under the rest of :class:`BatchStage`'s ``shapes``."""
    uniq, n_unique = accumulate.unique_pixels(keyed, n_unique_cap)
    pix_idx = accumulate.pixel_index_map(keyed, uniq)
    track_map, slot, overflow = accumulate.track_pixel_map(
        pix_idx, distances, n_unique_cap, max_tracks=max_tracks)
    # the centres of the pixels themselves, not of their keys
    px, py = pixel_centers(torch.clamp(pixels, min=0), det)
    track_starts, _ = pixelize.time_intervals(segs, det)
    # made once, walked by the waveform sum and the current fractions
    csr = accumulate.pixel_csr(pix_idx, track_starts, n_unique_cap,
                               time_sampling=det.time_sampling)
    return BatchStage(
        segs=segs, n_unique_cap=n_unique_cap, pixels=pixels, uniq=uniq,
        n_unique=n_unique, pix_idx=pix_idx, track_map=track_map, slot=slot,
        overflow=overflow, csr=csr, px=px, py=py, track_starts=track_starts,
        **shapes)


def stage_batch(segs: Segments, det_model: DetectorModel, sim: SimParams, *,
                pixel_thresholds=None, pixel_gains=None,
                already_drifted: bool = False, step_scale: float = 1.0,
                host_segs: np.ndarray | None = None,
                event_slot=None) -> BatchStage:
    """Quench (Birks) and drift (unless ``already_drifted``), choose the
    batch's shapes on the host, and build the pixel maps; the arguments
    are those of :func:`simulate_charge_batch`."""
    det = det_model.params
    dev = segs.x.device
    if not already_drifted:
        segs = drift(quench(segs, det, physics.BIRKS), det)

    # --- host-side shape selection ---
    if host_segs is not None and already_drifted:
        n_real = min(len(host_segs), segs.size)
        seg_np = {k: host_segs[k][:n_real].astype(np.float32)
                  for k in _HOST_FIELDS}
    else:
        stacked = torch.stack([getattr(segs, k).float()
                               for k in _HOST_FIELDS]).cpu().numpy()
        valid = segs.valid.cpu().numpy()
        seg_np = {k: stacked[i][valid] for i, k in enumerate(_HOST_FIELDS)}
    seg_np['pixel_plane'] = seg_np['pixel_plane'].astype(np.int32)
    if len(seg_np['dx']) == 0:
        raise ValueError('empty batch')

    hconst = det.host
    max_radius = max(int(np.ceil(seg_np['tran_diff'].max() * 5
                                 / hconst['pixel_pitch'])), 1)  # cli:918
    max_active = bucket(pixelize.max_active_pixels(
        seg_np, det, hconst['tpc_borders']), lo=8)
    max_nb = bucket((2 * max_radius + 1) * max_active
                    + (1 + 2 * max_radius) * max_radius * 2, lo=16)

    # signal window length (time_intervals, detsim.py:18-40); not capped at
    # time_ticks: the global-waveform sum crops out-of-window ticks
    dt = det.time_sampling
    t_end_r = np.round((seg_np['t_end'] + 1) / dt) * dt
    t_start_r = np.round((seg_np['t_start'] - hconst['time_padding'])
                         / dt) * dt
    t_sig = bucket(int(np.ceil((t_end_r - t_start_r).max() / dt)), lo=64)

    # nstep = round(length/min_step) (detsim.py:320); step_scale > 1
    # widens the steps, which conserves charge exactly
    min_step = float(sim.min_step_size) * float(step_scale)
    n_steps = bucket(int(np.ceil(seg_np['dx'].max() / min_step))
                     * sim.mc_sample_multiplier, lo=8)
    shift_band = current.host_shift_band(seg_np, det, mc_smear=True)

    with trace.phase('charge/get_pixels', dev):
        pixels, distances, npix = pixelize.get_pixels(
            segs, det, max_active=max_active, radius=max_radius,
            max_neighboring=max_nb)

    nx, ny = det.n_pixels
    n_pix_total = nx * ny * det.n_tpcs
    keyed = pixels
    if event_slot is not None:
        # each event of a group in a pixel-id space of its own, so events
        # never share a waveform; unique ids decode as key // n_pix_total
        # (the event's slot) and key % n_pix_total (the pixel)
        slot_np = np.asarray(event_slot)
        if n_pix_total * (int(slot_np.max()) + 1) >= 2 ** 31:
            raise ValueError('event grouping would overflow int32 pixel '
                             'keys')
        slot_t = torch.as_tensor(slot_np, dtype=pixels.dtype, device=dev)
        keyed = torch.where(pixels >= 0,
                            pixels + slot_t[:, None] * n_pix_total, -1)

    # the unique axis is sized from the exact unique count (one host read)
    with trace.phase('charge/npix_sync', dev):
        counts = accumulate.batch_pixel_counts(keyed, npix).cpu().numpy()
        n_unique_cap = bucket(int(counts[1]), lo=32)

    with trace.phase('charge/prep', dev):
        st = _stage(segs, det, pixels, keyed, distances,
                    n_unique_cap=n_unique_cap,
                    max_tracks=sim.max_tracks_per_pixel,
                    max_active=max_active, radius=max_radius, max_nb=max_nb,
                    t_sig=t_sig, n_steps=n_steps, min_step=min_step,
                    shift_band=shift_band, thresholds=None, gains=None)
        # per-pixel values by pixel id: a grouped event's key is the id
        # plus its slot's offset (the JAX package looks the key up, so an
        # event past the group's first gets the default)
        pid = torch.clamp(st.uniq, min=0) % n_pix_total
        if pixel_thresholds is not None:
            st.thresholds = pixel_thresholds.lookup(pid)
        if pixel_gains is not None:
            st.gains = pixel_gains.lookup(pid)[:, None]
    return st


@contextlib.contextmanager
def _signals_and_fsm(st: BatchStage, det: DetectorParams,
                     response: torch.Tensor, draw: Draw, *, max_adc: int):
    """Induced current, waveform sum and FSM; yields (signals, fee_res)
    with ``charge/fee_stage`` still open for the caller's work on them."""
    dev = st.segs.x.device
    n_unique_cap = st.n_unique_cap
    # the JAX package's label of its induced-current kernel, so the two
    # phase tables line up
    with trace.phase('charge/current_pallas', dev):
        signals = current.current(
            st.segs, st.px, st.py, st.pixels >= 0, response, det,
            draw('smear', (3, st.segs.size, st.n_steps)), n_steps=st.n_steps,
            t_sig=st.t_sig, shift_band=st.shift_band, min_step=st.min_step)
    with trace.phase('charge/fee_stage', dev):
        # the waveform sum writes the FSM's tick-major rows itself
        n_scan = fee.scan_ticks(det)
        sig_rows = accumulate.sum_pixel_signals(
            signals, st.pix_idx, st.track_starts, n_unique_cap,
            n_ticks=det.time_ticks, time_sampling=det.time_sampling,
            rows=n_scan, csr=st.csr)
        thresholds = st.thresholds
        if thresholds is None:
            thresholds = torch.full((n_unique_cap,),
                                    det.f32('discrimination_threshold'),
                                    dtype=torch.float32, device=dev)
        s = fee.fsm_scalars(det, max_adc=max_adc)
        q_init = draw('q_init', (n_unique_cap,)) * s.sigma_reset
        fee_res = fee.get_adc_values_rows(
            sig_rows, fee.tick_times(det, dev), thresholds, det,
            max_adc=max_adc,
            noise=draw('fee_noise', (n_scan, 5, n_unique_cap)),
            q_init=q_init)
        yield signals, fee_res


def _fractions_and_adc(st: BatchStage, signals: torch.Tensor, fee_res,
                       det: DetectorParams, n_adc_scan: int):
    """The fractions of the first ``n_adc_scan`` ADC slots; the ADC."""
    fractions = fee.current_fractions(
        signals, st.pix_idx, st.slot, st.track_starts, fee_res, det,
        max_adc=fee_res.integrals.shape[1], max_tracks=st.track_map.shape[1],
        n_adc_scan=n_adc_scan, csr=st.csr)
    return fractions, fee.digitize(fee_res.integrals, det, gain=st.gains)


def charge_step(segs: Segments, det: DetectorParams, response: torch.Tensor,
                draw: Draw, *, thresholds=None, gains=None, max_active: int,
                radius: int, max_nb: int, t_sig: int, n_steps: int,
                n_unique_cap: int, max_adc: int, max_tracks: int,
                shift_band: tuple[int, int], min_step: float = 0.001):
    """The charge chain on drifted segments with every shape given
    (JAX ``models.charge.charge_step``, :122-173) and without the host
    reads of :func:`simulate_charge_batch`: one call a batch of a
    ``parallel.mesh`` cell.  ``shift_band`` is the induced current's
    (``ops.current.host_shift_band``), chosen on the host like the other
    shapes; ``thresholds`` (n_unique_cap,) and ``gains`` (n_unique_cap, 1)
    optional tensors.  Returns (uniq, n_unique, adc, fee_res, fractions, track_map,
    overflow)."""
    dev = segs.x.device
    with trace.phase('charge/get_pixels', dev):
        pixels, distances, _ = pixelize.get_pixels(
            segs, det, max_active=max_active, radius=radius,
            max_neighboring=max_nb)
    with trace.phase('charge/prep', dev):
        st = _stage(segs, det, pixels, pixels, distances,
                    n_unique_cap=n_unique_cap, max_tracks=max_tracks,
                    max_active=max_active, radius=radius, max_nb=max_nb,
                    t_sig=t_sig, n_steps=n_steps, min_step=min_step,
                    shift_band=shift_band, thresholds=thresholds,
                    gains=gains)
    with _signals_and_fsm(st, det, response, draw,
                          max_adc=max_adc) as (signals, fee_res):
        fractions, adc = _fractions_and_adc(st, signals, fee_res, det,
                                            max_adc)
    return (st.uniq, st.n_unique, adc, fee_res, fractions, st.track_map,
            st.overflow)


def simulate_charge_batch(segs: Segments, det_model: DetectorModel,
                          sim: SimParams, draw: Draw, response: torch.Tensor,
                          *, pixel_thresholds=None, pixel_gains=None,
                          already_drifted: bool = False,
                          step_scale: float = 1.0,
                          host_segs: np.ndarray | None = None,
                          event_slot=None) -> ChargeChainResult:
    """Run the full charge chain on one (padded) segment batch.

    Args:
        segs: segment batch (quench/drift applied here unless
            ``already_drifted``).
        draw: source of every random draw (see :data:`Draw`);
            :func:`generator_draw` in production.
        response: (nx, ny, nt) float32 response LUT on the batch's device.
        pixel_thresholds, pixel_gains: optional ``utils.pixel_lut.PixelLUT``.
        step_scale: >1 coarsens the MC sampling (1.0 is the reference's
            MIN_STEP_SIZE density).
        host_segs: the batch's drifted rows on the host (with
            ``already_drifted``), which spares a device read.
        event_slot: optional (S,) int array that groups several
            independent events into one call: pixel ids are keyed by
            ``id + slot * n_pixels_total`` so events never share a
            waveform; ``unique_pix`` holds the keys (decode the event's
            slot with ``// n_pixels_total``, the pixel with ``%``).
            Per-pixel thresholds and gains are looked up by pixel id.
    """
    det = det_model.params
    dev = segs.x.device
    st = stage_batch(segs, det_model, sim, pixel_thresholds=pixel_thresholds,
                     pixel_gains=pixel_gains, already_drifted=already_drifted,
                     step_scale=step_scale, host_segs=host_segs,
                     event_slot=event_slot)
    a_full = sim.max_adc_values
    with _signals_and_fsm(st, det, response, draw,
                          max_adc=a_full) as (signals, fee_res):
        # one host read: unique count, per-pixel hit counts, track
        # occupancy
        n_unique_i = int(st.n_unique)
        n_u = min(bucket(max(n_unique_i, 1), lo=32), st.n_unique_cap)
        t_cnt = (st.track_map[:n_u] >= 0).sum(dim=1).max()
        sync_h = torch.cat([fee_res.n_adc[:n_u],
                            t_cnt[None].to(fee_res.n_adc.dtype)]
                           ).cpu().numpy()
        n_adc_host, t_max = sync_h[:-1], int(sync_h[-1])
        max_hits = int(n_adc_host.max()) if n_adc_host.size else 0

        # fractions only for the ADC slots that latched somewhere
        fractions, adc = _fractions_and_adc(st, signals, fee_res, det,
                                            max_hits)

    # pull only the hit entries and the occupied track prefix
    K_full = sim.max_tracks_per_pixel
    t_cap = min(bucket(max(t_max, 1), lo=4), K_full)

    def _pad_tracks(arr_np, fill):
        out = np.full((arr_np.shape[0], K_full), fill, arr_np.dtype)
        out[:, :arr_np.shape[1]] = arr_np
        return out

    with trace.phase('charge/pull', dev):
        hit_mask = (torch.arange(a_full, device=dev)[None, :]
                    < fee_res.n_adc[:n_u, None])
        u_h, a_h = torch.nonzero(hit_mask, as_tuple=True)
        return ChargeChainResult(
            unique_pix=st.uniq[:n_u].cpu().numpy(),
            n_unique=n_unique_i,
            n_adc=n_adc_host,
            track_pixel_map=_pad_tracks(
                st.track_map[:n_u, :t_cap].cpu().numpy(), -1),
            overflow=bool(st.overflow.any()),
            segments=st.segs,
            max_adc_slots=a_full,
            hit_row=u_h.to(torch.int32).cpu().numpy(),
            hit_slot=a_h.to(torch.int32).cpu().numpy(),
            hit_adc=adc[u_h, a_h].cpu().numpy(),
            hit_ticks=fee_res.ticks[u_h, a_h].cpu().numpy(),
            hit_integrals=fee_res.integrals[u_h, a_h].cpu().numpy(),
            hit_fractions=_pad_tracks(
                fractions[u_h, a_h, :t_cap].cpu().numpy(), 0.0),
        )
