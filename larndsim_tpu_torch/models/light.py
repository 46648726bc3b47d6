"""Light-readout chain: segments -> SiPM waveforms + triggers.

Counterpart of ``larndsim_tpu.models.light``: the per-batch pipeline the
reference runs at cli/simulate_pixels.py:1119-1205 -- photon time series
-> scintillation smear -> Poisson PE statistics -> SiPM response ->
triggers -> noise + ADC-rate digitization -- and its MC truth.  Two
trigger modes:

* the beam trigger (mode 1): a fixed window, one forced trigger at tick 0
  on an event's first batch;
* the threshold trigger (mode 0): the window spans the batch's photon
  arrivals (:func:`mode0_window`); each module triggers where a channel
  group's sum falls below its threshold, with a dead time of one
  digitized window; every trigger is digitized, with noise drawn at the
  shape padded around them.  Its one wait per batch or group is the copy
  of the trigger tables to the host, whose counts set the shapes that
  follow.

The truth:

* without LUT smearing, the contributor points, zero-suppressed on the
  host (:func:`_host_truth_sparse`);
* with LUT smearing, each top-K contributor's series pushed through the
  linear chain as one product with a transfer table (n_ticks x samples,
  built on the host, :func:`_transfer_table_host`), by one of two routes
  (``truth_path``): ``'device'`` builds the dense series and the product
  on the batch's device and pulls the kept records
  (:func:`_smeared_truth_stage`, :func:`_pull_dense_truth`); ``'host'``
  pulls the (C, K) contributor metadata and recomputes the records on the
  host with a windowed GEMM (:func:`_host_smeared_truth_sparse`), on a
  worker thread when the caller gives an executor.  Several triggers take
  one transfer table each (records trigger-major).

:func:`simulate_light_group` (beam) and :func:`simulate_light_group_mode0`
(threshold) run G independent events' batches as one: each op takes the
group on a leading axis, each event draws from its own
:class:`ops.light.LightDraw` as its solo call would, and each event's
results equal those of its own :func:`simulate_light_batch` call.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import warnings

import numpy as np
import torch

from ..io.export import TRUTH_DTYPE
from ..ops import f32
from ..ops import light as light_ops
from ..ops.light import LightDraw
from ..params.light import LightParams
from ..params.sim import SimParams
from ..segments import Segments, stack
from ..utils import trace

#: cap on the simulated light ticks of one batch (cli:1125:
#: min(nticks, 5e4))
MAX_TICKS = 50_000
#: the routes of the LUT-smearing truth (module docstring)
TRUTH_PATHS = ('device', 'host')


@dataclasses.dataclass
class LightBatchResult:
    trigger_idx: np.ndarray        # (ntrig,) simulation tick of each trigger
    trigger_type: np.ndarray       # (ntrig,) 0=threshold 1=beam
    op_channel_idx: np.ndarray     # (ntrig, C) channels digitized per trigger
    waveforms: torch.Tensor        # (ntrig, C, digit_samples), on the device
    start_time: float              # simulation window start [us]
    n_ticks: int
    # MC truth (sim.max_mc_truth_ids > 0), zero-suppressed: (trig,
    # op_channel, tick, segment_id, pe_current) columns
    truth_sparse: dict | None = None
    # the host route on a worker: a future of TRUTH_DTYPE records
    # (trigger_id counted from 0 within the batch)
    truth_future: object | None = None


def generator_draw(generator: torch.Generator, device) -> LightDraw:
    """A :class:`LightDraw` that takes every draw from ``generator``."""
    return LightDraw(
        poisson=lambda rate: torch.poisson(rate, generator=generator),
        normal=lambda shape: torch.randn(shape, generator=generator,
                                         device=device),
        uniform=lambda shape: torch.rand(shape, generator=generator,
                                         device=device))


def group_draw(draws: list) -> LightDraw:
    """The draws of a stacked group of events: event g's slice of each
    draw comes from ``draws[g]`` at the shape its solo call draws, in the
    solo call's order (Poisson counts, normals, noise phases)."""
    return LightDraw(
        poisson=lambda rate: torch.stack(
            [d.poisson(r) for d, r in zip(draws, rate)]),
        normal=lambda shape: torch.stack(
            [d.normal(tuple(shape[1:])) for d in draws]),
        uniform=lambda shape: torch.stack(
            [d.uniform(tuple(shape[1:])) for d in draws]))


def digit_samples(light: LightParams) -> int:
    """ADC samples of one trigger's waveform."""
    return int(np.ceil((light.light_trig_window[1]
                        + light.light_trig_window[0])
                       / light.light_digit_sample_spacing))


def window(light: LightParams, n_ticks: int) -> tuple[int, int]:
    """(n_ticks, conv_ticks): the simulated window capped at MAX_TICKS
    and bucketed to the JAX package's power-of-two shapes (>= 256), and
    the length of the convolution kernels (models/light.py:1492-1500)."""
    n_ticks = max(256, 1 << math.ceil(math.log2(max(min(n_ticks, MAX_TICKS),
                                                    1))))
    conv_ticks = int(np.ceil((light.light_window[1] - light.light_window[0])
                             / light.light_tick_size))
    return n_ticks, max(min(conv_ticks, n_ticks), 1)


def mode0_window(n_photons_det, t0_det, light: LightParams) -> tuple[int,
                                                                      float]:
    """The threshold trigger's (n_ticks, start_time), bucketed as
    :func:`simulate_light_batch` sizes it (models/light.py:1901-1913):
    ``ops.light.get_nticks`` on the host, capped at MAX_TICKS, in
    power-of-two buckets of at least 256.  Events of one
    :func:`simulate_light_group_mode0` call share the bucket."""
    n_ticks, start = light_ops.get_nticks(n_photons_det, t0_det, light)
    return window(light, n_ticks)[0], start


def check_supported(light: LightParams, truth_path: str) -> None:
    """Raise for a trigger mode the reference does not have, and for a
    truth route that does not exist."""
    if light.light_trig_mode not in (0, 1):
        raise NotImplementedError(
            f'light_trig_mode {light.light_trig_mode}: the threshold (0) '
            'and beam (1) triggers are ported')
    if truth_path not in TRUTH_PATHS:
        raise ValueError(f'truth_path {truth_path!r}: use one of '
                         f'{TRUTH_PATHS}')


def _channels(light: LightParams, light_noise, add_noise: bool, device,
              op_channel=None):
    """The simulated channels (``op_channel``, a tensor of absolute ids;
    None: every channel in the TPCs' order) on the host and on ``device``,
    with their gains and noise spectra (None without noise)."""
    if op_channel is None:
        op_channel = light_ops.host_array(light.tpc_to_op_channel).ravel()
        op_channel_dev = light.tpc_to_op_channel.reshape(-1)
    else:
        op_channel_dev = op_channel.to(device)
        op_channel = light_ops.host_array(op_channel)
    gains = light.light_gain[op_channel_dev.long()]
    noise_rows = None
    if add_noise:
        noise = torch.as_tensor(light_noise, dtype=torch.float32,
                                device=device)
        noise_rows = noise[(op_channel_dev % noise.shape[0]).long()]
    return op_channel, op_channel_dev, gains, noise_rows


def _signal_stage(segs, voxels, n_det, op_channel, time_dist, t0_avg,
                  start_time, gains, draw: LightDraw, light: LightParams, *,
                  n_ticks: int, conv_ticks: int, lut_smearing: bool):
    """Photon series -> scintillation -> Poisson -> SiPM response."""
    inc = light_ops.sum_light_signals(
        segs, voxels, n_det, op_channel, time_dist, t0_avg, start_time,
        light, n_ticks=n_ticks, lut_smearing=lut_smearing)
    scint = light_ops.calc_scintillation_effect(inc, light,
                                                conv_ticks=conv_ticks)
    disc = light_ops.calc_stat_fluctuations(scint, draw, light)
    return light_ops.calc_light_detector_response(disc, gains, light,
                                                  conv_ticks=conv_ticks)


def _beam_digitize_stage(response, noise_rows, draw: LightDraw,
                         light: LightParams, segs, voxels, n_det, op_channel,
                         t0_avg, start_time, *, digit_samples: int,
                         pad_front: int, pad_back: int, k_truth: int):
    """Pad + noise + digitize (+ truth points) for the beam trigger (fixed
    trigger at tick 0); ``noise_rows`` None adds no noise."""
    signal = torch.nn.functional.pad(response, (pad_front, pad_back))
    if noise_rows is not None:
        signal = signal + light_ops.gen_light_detector_noise(
            tuple(signal.shape), noise_rows, draw, light)
    trig = torch.tensor([pad_front], device=signal.device)
    wvfms = light_ops.digitize_signal(signal, trig, light,
                                      digit_samples=digit_samples)
    truth_ids = amp = itick = None
    if k_truth > 0:
        truth_ids, amp, itick = light_ops.light_truth_points(
            segs, voxels, n_det, op_channel, t0_avg, start_time, light,
            k_truth=k_truth)
    return wvfms, truth_ids, amp, itick


def _stage_kernels_host(light: LightParams, L: int):
    """(scintillation, SiPM) kernel taps k=0..L-1 on host, float64 -- the
    same math as ops.light.{scintillation,sipm}_kernel
    (light_sim.py:132-145, :274-300)."""
    hs = light.host
    tau_s, tau_t, singlet, resp_t, osc_p = (
        hs['tau_s'], hs['tau_t'], hs['singlet_fraction'],
        hs['light_response_time'], hs['light_oscillation_period'])
    tick = float(light.light_tick_size)
    k = np.arange(L, dtype=np.float64)
    scint = (singlet * np.exp(-k * tick / tau_s)
             * (1 - np.exp(-tick / tau_s))
             + (1 - singlet) * np.exp(-k * tick / tau_t)
             * (1 - np.exp(-tick / tau_t)))
    if light.sipm_response_model == 0:
        t = k * tick
        imp = (np.exp(-t / resp_t) * np.sin(t / osc_p)
               / (osc_p * resp_t ** 2) * (osc_p ** 2 + resp_t ** 2) * tick)
    else:
        arr = hs['impulse_model'].astype(np.float64)
        idx = k * tick / float(light.impulse_tick_size)
        i0 = np.floor(idx).astype(np.int64)
        frac = idx - i0
        n_imp = arr.shape[0]
        v0 = np.where((i0 >= 0) & (i0 < n_imp),
                      arr[np.clip(i0, 0, n_imp - 1)], 0.0)
        v1 = np.where((i0 + 1 >= 0) & (i0 + 1 < n_imp),
                      arr[np.clip(i0 + 1, 0, n_imp - 1)], 0.0)
        imp = np.where(i0 > n_imp - 2, 0.0, v0 + (v1 - v0) * frac)
        imp = imp / (float(light.impulse_tick_size) / tick)
    return scint, imp


def _combined_kernel_host(light: LightParams, conv_ticks: int) -> np.ndarray:
    """Combined scintillation*SiPM kernel on host, float64 numpy rounded to
    float32."""
    scint, imp = _stage_kernels_host(light, conv_ticks + 1)
    # causal FFT convolution, signal = scint zero-padded: combined support
    # is t-j in [0, 2*conv_ticks] (each reference stage spans [0, conv])
    # (matches ops.light.causal_convolve's fft sizing + truncation)
    n = 2 * conv_ticks + 1
    fft_len = int(2 ** np.ceil(np.log2(max(n + conv_ticks, 1))))
    combined = np.fft.irfft(np.fft.rfft(scint, fft_len)
                            * np.fft.rfft(imp, fft_len), fft_len)[:n]
    return combined.astype(np.float32)


def _host_truth_sparse(truth_ids, amp, itick, kernel, trigger_idx,
                       light: LightParams, digit_samples: int,
                       op_channel, threshold: float) -> dict:
    """Zero-suppressed truth records computed on host from the (C, K)
    contributor points -- no dense (ntrig, C, samples, K) tensor anywhere.

    Contributor rows are pre-filtered by the rigorous bound
    |amp| * max|kernel| > threshold (a dropped row's samples can never
    clear the record threshold), and the kernel lookup is a direct
    floor/lerp on the integer-gridded kernel.
    """
    ids = np.asarray(truth_ids)
    amp = np.asarray(amp)
    itick = np.asarray(itick)
    kmax = float(np.abs(kernel).max()) if kernel.size else 0.0
    act = (ids >= 0) & (np.abs(amp) * kmax > threshold)
    chan_r, k_r = np.nonzero(act)                               # (R,)
    amp_r = amp[chan_r, k_r]
    it_r = itick[chan_r, k_r].astype(np.int64)
    f = light.light_digit_sample_spacing / light.light_tick_size
    pre = int(np.ceil(light.light_trig_window[0] / light.light_tick_size))
    n = kernel.shape[0]
    trigger_idx = np.asarray(trigger_idx)
    # per (trigger, row), only the <= ceil((n-1)/f)+1 samples whose tick
    # lands inside the kernel's [0, n-1] support can be nonzero -- build
    # exactly that window per pair instead of the full sample axis; +1
    # slack sample on each side: the s0 division is float and must never
    # exclude a borderline in-support sample (extra samples are zeroed by
    # the in-bounds mask)
    w = min(int(np.floor((n - 1) / f)) + 3, digit_samples)
    parts = {k: [] for k in ('trig', 'row', 'tick', 'pe')}
    for t in range(trigger_idx.shape[0]):
        base = int(trigger_idx[t]) - pre                       # int
        # first sample index with x >= 0:  s*f + (base - it) >= 0
        s0 = np.maximum(
            np.ceil((it_r - base) / f).astype(np.int64) - 1, 0)
        sidx = s0[:, None] + np.arange(w)[None, :]             # (R, w)
        # x with the same float association as a dense np.interp
        # formulation: (trig - pre + s*f) - itick
        x = (base + sidx * f) - it_r[:, None]
        inb = (x >= 0.0) & (x <= n - 1) & (sidx < digit_samples)
        i0 = np.clip(np.floor(x).astype(np.int64), 0, max(n - 2, 0))
        frac = x - i0
        kv = (kernel[i0] + (kernel[np.minimum(i0 + 1, n - 1)]
                            - kernel[i0]) * frac) if n > 1 \
            else np.broadcast_to(kernel[:1], x.shape)
        vals = amp_r[:, None] * np.where(inb, kv, 0.0)
        row, s_loc = np.nonzero(np.abs(vals) > threshold)
        parts['trig'].append(np.full(row.shape[0], t, np.int32))
        parts['row'].append(row)
        parts['tick'].append(sidx[row, s_loc].astype(np.int32))
        parts['pe'].append(vals[row, s_loc].astype(np.float64))
    cat = lambda k, dt: (np.concatenate(parts[k]) if parts[k]
                         else np.empty(0, dt))
    trig, row = cat('trig', np.int32), cat('row', np.int64)
    tick, pe = cat('tick', np.int32), cat('pe', np.float64)
    return dict(
        trig=trig,
        op_channel=np.asarray(op_channel)[chan_r[row]].astype(np.int32),
        tick=tick,
        segment_id=ids[chan_r[row], k_r[row]].astype(np.int64),
        pe_current=pe,
    )


# --------------------------------------------------------------------------
# LUT-smearing truth: the transfer table (host-built, shared by both routes)
# --------------------------------------------------------------------------

_TRANSFER_CACHE: dict = {}
_COL_BOUNDS_CACHE: dict = {}
_DEVICE_TABLES: dict = {}


def _kernel_leaf_key(light: LightParams) -> tuple:
    """Every scalar (and the impulse content) that defines the combined
    kernel, so two configurations differing in any of them never share a
    cached table."""
    hs = light.host
    imp = hs['impulse_model']
    return (hs['tau_s'], hs['tau_t'], hs['singlet_fraction'],
            hs['light_response_time'], hs['light_oscillation_period'],
            float(light.light_tick_size), float(light.impulse_tick_size),
            int(light.sipm_response_model), imp.shape[0],
            hash(np.asarray(imp).tobytes()))


def _digit_scalars(light: LightParams) -> tuple:
    """(tick, samples per tick f, pre-trigger ticks) as host numbers."""
    tick = float(light.light_tick_size)
    f = float(light.light_digit_sample_spacing) / tick
    pre = int(np.ceil(float(light.light_trig_window[0]) / tick))
    return tick, f, pre


def _digit_geometry(light: LightParams, n_ticks: int, digit_samples: int,
                    pad_front: int, n_padded: int, dtype=np.float32,
                    offset: int = 0):
    """Per-sample interpolation geometry of the digitizer for a trigger at
    flat tick ``offset`` (0: beam): (i0, frac, in0, in1, edge) -- sample s
    reads ticks i0[s], i0[s]+1 with weight frac[s]; in0 / in1 / edge are
    the bounds masks of ``ops.light.digitize_signal``.  float32 for the
    transfer table, float64 for the staged chain (the reference computes
    the sample tick in double, light_sim.py:499)."""
    tick, f, pre = _digit_scalars(light)
    y = (dtype(offset - pre)
         + np.arange(digit_samples, dtype=dtype) * dtype(f))
    i0 = np.floor(y).astype(np.int64)
    frac = (y - i0.astype(dtype)).astype(dtype)
    in0 = ((i0 >= 0) & (i0 < n_ticks)).astype(dtype)
    in1 = ((i0 + 1 >= 0) & (i0 + 1 < n_ticks)).astype(dtype)
    edge = ((i0 + pad_front) <= n_padded - 2).astype(dtype)
    return i0, frac, in0, in1, edge


def _transfer_table_host(light: LightParams, conv_ticks: int, n_ticks: int,
                         digit_samples: int, pad_front: int,
                         n_padded: int, offset: int = 0) -> np.ndarray:
    """Transfer table T (n_ticks, digit_samples) float32 of the linear
    truth chain for one trigger at flat tick ``offset``: causal convolution
    with the combined scintillation x SiPM kernel, padding, and the
    digitizer's interpolation with its edge rules (light_sim.py:170-183,
    :322-336, :480-543), so ``series (R, n_ticks) @ T`` is each row's
    digitized truth.  Cached per configuration and offset."""
    tick, f, pre = _digit_scalars(light)
    key = (conv_ticks, n_ticks, digit_samples, pad_front, n_padded,
           tick, f, pre, int(offset), *_kernel_leaf_key(light))
    hit = _TRANSFER_CACHE.get(key)
    if hit is not None:
        return hit
    kernel = _combined_kernel_host(light, conv_ticks)
    i0, frac, in0, in1, edge = _digit_geometry(
        light, n_ticks, digit_samples, pad_front, n_padded,
        offset=int(offset))
    LK = kernel.shape[0]
    # T[j, s] = interp(kernel at i0[s] - j), masked: each column is a
    # reversed kernel slice, so the columns are sliding windows over a
    # zero-padded reversed kernel
    D = np.zeros(2 * n_ticks + LK, np.float32)
    D[n_ticks:n_ticks + LK] = kernel[::-1]
    W = np.lib.stride_tricks.sliding_window_view(D, n_ticks)
    start0 = n_ticks + LK - 1 - i0.astype(np.int64)
    hi = W.shape[0] - 1
    V0 = W[np.clip(start0, 0, hi)] * in0[:, None]        # (S, n_ticks)
    V1 = W[np.clip(start0 - 1, 0, hi)] * in1[:, None]
    Ts = (V0 + (V1 - V0) * frac[:, None]) * edge[:, None]
    T = np.ascontiguousarray(Ts.T)                       # (n_ticks, S)
    if len(_TRANSFER_CACHE) > 16:
        _TRANSFER_CACHE.clear()
    _TRANSFER_CACHE[key] = T
    return T


def _transfer_col_bounds(T: np.ndarray) -> tuple:
    """Per-tick bounds of T's nonzero columns: fc[t] = min over t' >= t of
    the first nonzero column of row t' (the chain is causal: a photon at
    tick t reaches no earlier sample), lc[t] = max over t' <= t of the last
    one (the kernel is finite).  A GEMM block whose rows occupy ticks
    [t_lo, t_hi) reaches only columns [fc[t_lo], lc[t_hi - 1]]."""
    hit = _COL_BOUNDS_CACHE.get(id(T))
    if hit is not None and hit[0] is T:
        return hit[1], hit[2]
    nz = T != 0
    any_row = nz.any(axis=1)
    first = np.where(any_row, nz.argmax(axis=1), T.shape[1])
    fc = np.minimum.accumulate(first[::-1])[::-1].astype(np.int32)
    last = np.where(any_row, T.shape[1] - 1 - nz[:, ::-1].argmax(axis=1), -1)
    lc = np.maximum.accumulate(last).astype(np.int32)
    if len(_COL_BOUNDS_CACHE) > 8:
        _COL_BOUNDS_CACHE.clear()
    _COL_BOUNDS_CACHE[id(T)] = (T, fc, lc)
    return fc, lc


def _device_table(T: np.ndarray, device) -> torch.Tensor:
    """``T`` on ``device``, uploaded once per host table and stream, behind
    the stream's queued work (nothing waits for it, so another stream
    gets a copy of its own)."""
    device = torch.device(device)
    stream = (torch.cuda.current_stream(device).cuda_stream
              if device.type == 'cuda' else 0)
    key = (id(T), str(device), stream)
    hit = _DEVICE_TABLES.get(key)
    if hit is not None and hit[0] is T:
        return hit[1]
    if len(_DEVICE_TABLES) > 8:
        _DEVICE_TABLES.clear()
    table = light_ops.upload(T, device)
    _DEVICE_TABLES[key] = (T, table)
    return table


def _trigger_table(light: LightParams, conv_ticks: int, n_ticks: int,
                   digit_samples: int, pad_front: int, n_padded: int,
                   trigger_idx, device) -> torch.Tensor:
    """The transfer tables of every trigger side by side on ``device``:
    (n_ticks, ntrig * digit_samples), trigger t's columns from its own
    table (:func:`_transfer_table_host` at offset ``trigger_idx[t]``)."""
    tables = [_transfer_table_host(light, conv_ticks, n_ticks, digit_samples,
                                   pad_front, n_padded, offset=int(t))
              for t in trigger_idx]
    if len(tables) == 1:
        return _device_table(tables[0], device)
    return light_ops.upload(np.concatenate(tables, axis=1), device)


# --------------------------------------------------------------------------
# LUT-smearing truth, device route: dense series, one product, kept records
# --------------------------------------------------------------------------

def _smeared_truth_stage(segs, voxels, n_det, op_channel, time_dist,
                         start_time: float, light: LightParams,
                         table: torch.Tensor, *, n_ticks: int, k_truth: int,
                         ntrig: int = 1):
    """Each contributor's series (C * K, n_ticks) times the transfer table
    of ``ntrig`` triggers (n_ticks, ntrig * digit_samples) in full float32
    (JAX: ``Precision.HIGHEST``): (ids (C, K), truth (ntrig, C,
    digit_samples, K)) on the batch's device; for a stacked group, one
    product of its G * C * K rows, (G, C, K) and (G, ntrig, C,
    digit_samples, K)."""
    ids, series = light_ops.light_truth_series(
        segs, voxels, n_det, op_channel, time_dist, start_time, light,
        n_ticks=n_ticks, k_truth=k_truth)
    *lead, C, K = ids.shape
    tw = f32.matmul(series.view(-1, n_ticks), table)   # (G*C*K, ntrig*S)
    # (..., C, K, ntrig, S) -> (..., ntrig, C, S, K)
    return ids, tw.view(*lead, C, K, ntrig, -1).movedim(
        (-2, -4, -1, -3), (-4, -3, -2, -1)).contiguous()


def _empty_truth_sparse() -> dict:
    return dict(
        trig=np.empty(0, np.int32), op_channel=np.empty(0, np.int32),
        tick=np.empty(0, np.int32), segment_id=np.empty(0, np.int64),
        pe_current=np.empty(0, np.float64))


def _pull_group_dense_truth(ids: torch.Tensor, tw: torch.Tensor,
                            op_channel, threshold: float) -> list:
    """Zero-suppressed records of G events' (G, ntrig, C, S, K) truth: the
    slots of a contributor (id >= 0) with |pe| > threshold, found on the
    device in one pass; only their flat indices and values are pulled, then
    split per event on the host.  Record order is flat-index ascending:
    (trigger, channel, tick, contributor) within each event."""
    G, ntrig, C, S, K = tw.shape
    keep = (ids[:, None, :, None, :] >= 0) & (tw.abs() > threshold)
    idx = torch.nonzero(keep.view(-1)).squeeze(1)
    vals = tw.view(-1)[idx]
    idx_h = idx.cpu().numpy()
    if not idx_h.size:
        return [_empty_truth_sparse() for _ in range(G)]
    vals_h = vals.cpu().numpy()
    ids_h = ids.cpu().numpy()
    op_channel = np.asarray(op_channel)
    g, rem = np.divmod(idx_h, ntrig * C * S * K)
    trig, rem = np.divmod(rem, C * S * K)
    chan, rem = np.divmod(rem, S * K)
    tick, k = np.divmod(rem, K)
    bounds = np.searchsorted(g, np.arange(G + 1))
    out = []
    for gi in range(G):
        sl = slice(int(bounds[gi]), int(bounds[gi + 1]))
        out.append(dict(trig=trig[sl].astype(np.int32),
                        op_channel=op_channel[chan[sl]].astype(np.int32),
                        tick=tick[sl].astype(np.int32),
                        segment_id=ids_h[gi][chan[sl], k[sl]].astype(
                            np.int64),
                        pe_current=vals_h[sl].astype(np.float64)))
    return out


def _pull_dense_truth(ids: torch.Tensor, tw: torch.Tensor, op_channel,
                      threshold: float) -> dict:
    """One batch's (ntrig, C, S, K) truth through
    :func:`_pull_group_dense_truth`."""
    return _pull_group_dense_truth(ids[None], tw[None], op_channel,
                                   threshold)[0]


# --------------------------------------------------------------------------
# LUT-smearing truth, host route: (C, K) metadata -> windowed GEMM on host
# --------------------------------------------------------------------------

#: per-thread scratch of the host route (workers may run in parallel)
_SCRATCH_TLS = threading.local()


def _scratch2d(name: str, n: int, m: int, dtype) -> np.ndarray:
    """An (n, m) scratch array of this thread, reused across batches."""
    d = getattr(_SCRATCH_TLS, 'bufs', None)
    if d is None:
        d = _SCRATCH_TLS.bufs = {}
    buf = d.get(name)
    if buf is None or buf.dtype != dtype or buf.shape[1] != m \
            or buf.shape[0] < n:
        buf = np.empty((max(int(n * 1.25), 1024), m), dtype)
        d[name] = buf
    return buf[:n]


def _staged_truth_res(ph_rows: np.ndarray, it_rows: np.ndarray,
                      light: LightParams, threshold: float,
                      conv_ticks: int, n_ticks: int, digit_samples: int,
                      pad_front: int, n_padded: int):
    """The reference's staged truth chain (sim.ref_exact_truth_staging)
    instead of the linear transfer table: the scintillation stage drops
    per-(output tick, input tick) increments with ``w*x < threshold`` (no
    abs, light_sim.py:175), the SiPM stage drops ``|w*x| < threshold``
    (light_sim.py:327, no gain on truth), and digitization zeroes samples
    whose left-neighbour tick is below threshold (light_sim.py:528).
    Kernel support is t-j in [0, conv_ticks] inclusive.  The SiPM stage
    reads the contributor at the output tick, so output ticks where the
    scintillation-stage slot is inactive collect nothing (the ``s1 > 0``
    mask); digitization writes the id before the threshold check, so the
    returned ``keep`` mask (records kept by slot activity) can hold
    samples of pe 0.  O(rows * n_ticks * conv_ticks): validation scale.
    """
    R, nprof = ph_rows.shape
    L = conv_ticks + 1
    w_s, w_r = _stage_kernels_host(light, L)
    i0, frac, in0, in1, edge = _digit_geometry(
        light, n_ticks, digit_samples, pad_front, n_padded,
        dtype=np.float64)
    i0c = np.clip(i0, 0, n_ticks - 1)
    i1c = np.clip(i0 + 1, 0, n_ticks - 1)
    in0b = in0 > 0
    res = np.empty((R, digit_samples), np.float64)
    keep = np.empty((R, digit_samples), np.bool_)
    thr = np.float64(threshold)
    for r in range(R):
        p = np.zeros(n_ticks, np.float64)
        np.add.at(p, it_rows[r], ph_rows[r].astype(np.float64))
        # stage 1: scintillation with the signed increment cut
        M = np.outer(p, w_s)                      # (n_ticks, L)
        M[M < thr] = 0.0
        s1 = np.zeros(n_ticks + L)
        for k in range(L):
            s1[k:k + n_ticks] += M[:, k]
        s1 = s1[:n_ticks]
        act1 = s1 > 0
        # stage 2: SiPM response with the |increment| cut
        M = np.outer(s1, w_r)
        M[np.abs(M) < thr] = 0.0
        cnt2 = np.zeros(n_ticks + L)
        s2 = np.zeros(n_ticks + L)
        nz = (M != 0.0).astype(np.float64)
        for k in range(L):
            s2[k:k + n_ticks] += M[:, k]
            cnt2[k:k + n_ticks] += nz[:, k]
        s2 = s2[:n_ticks] * act1
        act2 = (cnt2[:n_ticks] > 0) & act1
        # digitize: linear interpolation, id written before the value gate
        v0 = s2[i0c] * in0
        v1 = s2[i1c] * in1 * act2[i1c]
        val = (v0 + (v1 - v0) * frac) * edge
        val[np.abs(v0) < thr] = 0.0
        res[r] = val
        keep[r] = act2[i0c] & in0b
    return res, keep


def _emit_truth(res, rows, ids, op_channel, C: int, K: int,
                threshold: float, as_records: bool, digit_samples: int,
                keep_override=None, event_id: int = 0, trigger_id: int = 0):
    """Zero-suppress the (rows, S) truth values of the active contributor
    rows (``rows`` = c * K + k, ascending) of trigger ``trigger_id`` into
    records (TRUTH_DTYPE) or a dict of columns.  Record order is (channel,
    tick, contributor)."""
    if as_records:
        rows_k = (rows % K).astype(np.int32)
        c_starts = np.searchsorted(rows // K, np.arange(C + 1))
        if keep_override is not None:
            keep_all = keep_override                       # (R, S)
        else:
            ab = _scratch2d('abs', rows.size, digit_samples, np.float32)
            keep_all = _scratch2d('keep', rows.size, digit_samples,
                                  np.bool_)
            np.absolute(res, out=ab)
            np.greater(ab, threshold, out=keep_all)
        # count, then fill one preallocated record array channel by
        # channel (each channel's transpose stays in cache)
        cum_rows = np.concatenate(
            [[0], np.cumsum(keep_all.sum(axis=1, dtype=np.int64))])
        off_ch = cum_rows[c_starts]                        # (C+1,)
        out_rec = np.empty(int(off_ch[-1]), TRUTH_DTYPE)
        for c in range(C):
            i0, i1 = int(c_starts[c]), int(c_starts[c + 1])
            o0, o1 = int(off_ch[c]), int(off_ch[c + 1])
            if o0 == o1:
                continue
            sub_t = np.ascontiguousarray(res[i0:i1].T)     # (S, kc)
            keep_c = np.ascontiguousarray(keep_all[i0:i1].T)
            s_i, k_i = np.nonzero(keep_c)
            view = out_rec[o0:o1]
            view['trigger_id'] = trigger_id
            view['op_channel_id'] = op_channel[c]
            view['tick'] = s_i
            view['event_id'] = event_id
            view['segment_id'] = ids[c, rows_k[i0:i1][k_i]]
            view['pe_current'] = sub_t[s_i, k_i]
        return out_rec

    dense = _scratch2d('dense', C * digit_samples, K,
                       np.asarray(res).dtype).reshape(C, digit_samples, K)
    dense.fill(0)
    dense[rows // K, :, rows % K] = res
    if keep_override is not None:
        keep = np.zeros(dense.shape, np.bool_)
        keep[rows // K, :, rows % K] = keep_override
    else:
        keep = np.abs(dense) > threshold
    c_idx, s_idx, k_idx = np.nonzero(keep)
    return dict(
        trig=np.full(len(c_idx), trigger_id, np.int32),
        op_channel=op_channel[c_idx].astype(np.int32),
        tick=s_idx.astype(np.int32),
        segment_id=ids[c_idx, k_idx].astype(np.int64),
        pe_current=dense[keep].astype(np.float64),
    )


def _host_smeared_truth_sparse(ids, contrib, t0_sel, vox,
                               lut_td_host: np.ndarray, op_channel,
                               light: LightParams, threshold: float,
                               conv_ticks: int, n_ticks: int,
                               digit_samples: int, pad_front: int,
                               pad_back: int, start_time: float, *,
                               as_records: bool = False,
                               staged: bool = False, event_id: int = 0,
                               trigger_idx=None):
    """LUT-smearing truth recomputed on the host from the (C, K)
    contributor metadata of ``ops.light.light_truth_select``: each
    contributor's profile from the host LUT, placed on ticks as
    ``ops.light.light_truth_series`` places it (float32, ceil - 1 rule),
    then the transfer table of each trigger.

    ``trigger_idx``: the flat trigger ticks (default [0], the beam
    trigger); several triggers (mode 0) take one transfer table each, and
    the records come trigger-major, the reference's zero-suppression
    order (light_sim.py:621-661).

    Each contributor's profile occupies ``nprof`` consecutive ticks, so the
    rows are bucketed by first tick and each bucket is one dense GEMM of
    its scattered profiles against a contiguous view of the table, limited
    to the columns the bucket can reach (:func:`_transfer_col_bounds`).
    The terms are those of the device route's product; only the grouping
    of the float32 sums differs.  ``staged`` runs the reference's staged
    chain instead (:func:`_staged_truth_res`; the beam trigger only).

    Returns TRUTH_DTYPE records (``as_records``; trigger_id counted from 0
    within the batch) or a dict of (trig, op_channel, tick, segment_id,
    pe_current) columns.
    """
    trigger_idx = (np.zeros(1, np.int64) if trigger_idx is None
                   else np.asarray(trigger_idx, np.int64))
    ids = np.asarray(ids)
    contrib = np.asarray(contrib).astype(np.float32)
    t0_sel = np.asarray(t0_sel).astype(np.float32)
    vox = np.asarray(vox)
    C, K = ids.shape
    nprof = lut_td_host.shape[-1]
    tick32 = np.float32(_digit_scalars(light)[0])

    op_channel = np.asarray(op_channel)
    lut_idx = op_channel % lut_td_host.shape[3]
    prof = lut_td_host[vox[..., 0], vox[..., 1], vox[..., 2],
                       lut_idx[:, None]]                        # (C,K,nprof)
    j = np.arange(nprof, dtype=np.float32) * np.float32(1e-3)
    t_arr = t0_sel[..., None] + j
    tick_f = (t_arr - np.float32(start_time)) / tick32
    # contributors without photons may carry any t0: move a tick that
    # would not cast to int32 out of range first (the mask drops it)
    tick_f = np.where(np.isfinite(tick_f)
                      & (np.abs(tick_f) < np.float32(2 ** 31 - 128)),
                      tick_f, np.float32(-2))
    itick = np.ceil(tick_f).astype(np.int32) - 1
    ok = ((tick_f > itick) & (itick >= 0) & (itick < n_ticks)
          & (contrib[..., None] > 0))
    photons = np.where(ok, contrib[..., None] / tick32 * prof,
                       np.float32(0))

    rows = np.nonzero(photons.any(axis=-1).reshape(C * K))[0]
    if rows.size == 0:
        return np.empty(0, TRUTH_DTYPE) if as_records \
            else _empty_truth_sparse()
    it_all = itick.reshape(C * K, nprof)[rows]
    it_c = np.clip(it_all, 0, n_ticks - 1)
    ph_all = photons.reshape(C * K, nprof)[rows]
    n_padded = n_ticks + pad_front + pad_back

    if staged:
        if trigger_idx.shape[0] != 1 or int(trigger_idx[0]) != 0:
            raise NotImplementedError(
                'ref_exact_truth_staging supports only the beam trigger '
                '(single trigger at tick 0)')
        if rows.size * n_ticks > 5e7:
            warnings.warn('ref_exact_truth_staging at production scale: '
                          f'{rows.size} rows x {n_ticks} ticks is a '
                          'validation-mode cost')
        res, keep = _staged_truth_res(ph_all, it_c, light, threshold,
                                      conv_ticks, n_ticks, digit_samples,
                                      pad_front, n_padded)
        return _emit_truth(res, rows, ids, op_channel, C, K, threshold,
                           as_records, digit_samples, keep_override=keep,
                           event_id=event_id)

    res = _scratch2d('res', rows.size, digit_samples, np.float32)
    row_lo = it_c.min(axis=1)
    row_hi = it_c.max(axis=1)
    # a block ~2x the profile span wide: each row occupies <= nprof + 1
    # ticks, so wider blocks only add products with zeros
    win = max(2 * nprof + 8, 128, nprof + 2)
    order = np.argsort(row_lo, kind='stable')
    lo_sorted = row_lo[order]
    parts = []
    for t, offset in enumerate(trigger_idx):
        T = _transfer_table_host(light, conv_ticks, n_ticks, digit_samples,
                                 pad_front, n_padded, offset=int(offset))
        first_col, last_col = _transfer_col_bounds(T)
        i = 0
        while i < rows.size:
            t_lo = int(lo_sorted[i])
            jend = int(np.searchsorted(lo_sorted, t_lo + win - nprof - 1,
                                       side='right'))
            blk = order[i:jend]
            t_hi = min(int(row_hi[blk].max()) + 1, n_ticks)
            ph_blk = np.zeros((len(blk), t_hi - t_lo), np.float32)
            # duplicate (clipped) ticks of a row add, as the series scatter
            np.add.at(ph_blk, (np.repeat(np.arange(len(blk)), nprof),
                               (it_c[blk] - t_lo).reshape(-1)),
                      ph_all[blk].reshape(-1))
            s0 = int(first_col[t_lo])
            s1 = int(last_col[t_hi - 1]) + 1
            if s0 >= s1:
                res[blk] = 0.0
            else:
                res[blk, :s0] = 0.0
                res[blk, s1:] = 0.0
                res[blk, s0:s1] = ph_blk @ T[t_lo:t_hi, s0:s1]
            i = jend
        parts.append(_emit_truth(res, rows, ids, op_channel, C, K, threshold,
                                 as_records, digit_samples,
                                 event_id=event_id, trigger_id=t))
    if len(parts) == 1:
        return parts[0]
    if as_records:
        return np.concatenate(parts)
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _start_host_copy(tensors) -> 'callable':
    """Start copies of ``tensors`` into pinned host memory on the current
    stream, behind the work that makes them; the returned function waits
    for the copies and gives numpy arrays.  Later work on the stream may
    reuse the tensors' memory: the copies come first.  CPU tensors pass
    through."""
    if tensors[0].device.type != 'cuda':
        return lambda: [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return [h.numpy() for h in host]
    return wait


def _worker_smeared_truth(fetch, *args, **kw):
    """Truth-worker entry of the host route: waits for the metadata's
    copies (``fetch``, :func:`_start_host_copy`), then recomputes the
    records (:func:`_host_smeared_truth_sparse`); traced as
    ``truth/worker``."""
    with trace.phase('truth/worker'):
        return _host_smeared_truth_sparse(*fetch(), *args, **kw)


def simulate_light_batch(segs: Segments, light: LightParams, sim: SimParams,
                         n_photons_det, voxels, lut: light_ops.LightLUT,
                         light_noise: torch.Tensor, draw: LightDraw,
                         i_subbatch: int = 0,
                         add_noise: bool = True,
                         truth_path: str = 'device',
                         truth_executor=None,
                         event_id: int = 0, *, t0_det=None,
                         module_to_tpcs: dict | None = None,
                         sim_window: tuple | None = None,
                         op_channel=None) -> LightBatchResult:
    """Run the light chain for one batch, in the configuration's trigger
    mode: the beam trigger (1) or the threshold trigger (0, one event of
    :func:`simulate_light_group_mode0`).

    Args:
        n_photons_det: (S, C) from calculate_light_incidence, on the LUT's
            device.
        voxels: (S, 3) LUT voxels.
        light_noise: (n_channels, n_bins) noise amplitude spectra (rows
            picked by channel id modulo their count).
        draw: the batch's random draws (:class:`ops.light.LightDraw`).
        i_subbatch: 0 for an event's first batch; in beam mode only that
            batch triggers (light_sim.py:444-451).  Mode 0 triggers on
            every batch.
        add_noise: False simulates without the detector noise.
        truth_path: the route of the LUT-smearing truth, ``'device'`` or
            ``'host'`` (module docstring).
        truth_executor: on the host route, an executor whose worker
            recomputes the records (``truth_future``); None computes them
            here (``truth_sparse``).
        event_id: the records' event id on a worker.
        t0_det: mode 0: (S, C) first arrivals from calculate_light_incidence
            (they set the window).
        module_to_tpcs: mode 0: the detector's module -> TPCs map (each
            module triggers on its own channels).
        sim_window: mode 0: (n_ticks, start_time) from :func:`mode0_window`
            on host copies of the incidence; None computes it here from
            ``n_photons_det`` and ``t0_det`` (copied to the host).
        op_channel: (C,) int32 tensor of the simulated channels' absolute
            ids, the columns of ``n_photons_det`` (None: every channel;
            with module variation the CLI passes the first module's, as the
            JAX CLI does, cli:634-637).
    """
    check_supported(light, truth_path)
    if light.light_trig_mode == 0:
        if sim_window is None:
            if t0_det is None:
                raise ValueError('the threshold trigger needs t0_det (or '
                                 'sim_window) to size its window')
            sim_window = mode0_window(n_photons_det, t0_det, light)
        return simulate_light_group_mode0(
            stack([segs]), light, sim, n_photons_det[None], voxels[None],
            lut, light_noise, [draw], windows=[sim_window],
            module_to_tpcs=module_to_tpcs, add_noise=add_noise,
            truth_path=truth_path, truth_executor=truth_executor,
            event_ids=[event_id], op_channel=op_channel)[0]
    if i_subbatch != 0:
        # the beam trigger fires on an event's first batch only: a later
        # batch has no trigger, and its waveforms would be discarded (the
        # JAX package computes and drops them; the outputs are the same)
        C = (light.tpc_to_op_channel.numel() if op_channel is None
             else len(op_channel))
        n_ticks, start_time = light_ops.get_nticks(None, None, light)
        return LightBatchResult(
            np.empty(0, int), np.empty(0, int), np.empty((0, C), int),
            torch.zeros((0, C, digit_samples(light)),
                        device=n_photons_det.device),
            start_time, window(light, n_ticks)[0])
    return simulate_light_group(
        stack([segs]), light, sim, n_photons_det[None], voxels[None], lut,
        light_noise, [draw], add_noise=add_noise, truth_path=truth_path,
        truth_executor=truth_executor, event_ids=[event_id],
        op_channel=op_channel)[0]


def simulate_light_group(segs: Segments, light: LightParams, sim: SimParams,
                         n_photons_det, voxels, lut: light_ops.LightLUT,
                         light_noise: torch.Tensor, draws: list,
                         add_noise: bool = True,
                         truth_path: str = 'device',
                         truth_executor=None,
                         event_ids=None,
                         op_channel=None) -> list[LightBatchResult]:
    """Run the light chain for G independent events' first batches at
    once, beam trigger (mode 1): one pass of each op over the group.

    Each event's result equals its own :func:`simulate_light_batch` call
    (``i_subbatch`` 0) with its row of the group and its draw: the
    waveforms and the contributor and host-route truth records bit for
    bit; the device route's truth is one product of the group's G * C * K
    contributor rows, float32 sums that may differ from a solo call's in
    the last bits.

    Args:
        segs: (G, S) stacked segments (``segments.from_structured_group``
            or ``segments.stack``).
        n_photons_det: (G, S, C); voxels: (G, S, 3).
        draws: G :class:`ops.light.LightDraw`, event g's draws as its solo
            call takes them.
        event_ids: (G,) the records' event ids on a worker.
        The other arguments are those of :func:`simulate_light_batch`.
    """
    check_supported(light, truth_path)
    if light.light_trig_mode != 1:
        raise ValueError('simulate_light_group runs the beam trigger; '
                         'simulate_light_group_mode0 the threshold trigger')
    G = len(draws)
    event_ids = [0] * G if event_ids is None else event_ids
    dev = n_photons_det.device
    n_samples = digit_samples(light)
    n_ticks, start_time = light_ops.get_nticks(None, None, light)
    n_ticks, conv_ticks = window(light, n_ticks)
    op_channel, op_channel_dev, gains, noise_rows = _channels(
        light, light_noise, add_noise, dev, op_channel)

    draw = group_draw(draws)
    response = _signal_stage(
        segs, voxels, n_photons_det, op_channel_dev, lut.time_dist,
        lut.t0_avg, start_time, gains, draw, light, n_ticks=n_ticks,
        conv_ticks=conv_ticks, lut_smearing=light.enable_lut_smearing)

    # beam mode forces one trigger at tick 0 (light_sim.py:444-451); pad +
    # noise + digitize (light_sim.sim_triggers, :545-619)
    trigger_idx = np.zeros(1, int)
    trig_op = op_channel[None, :]
    trig_type = np.ones(1, int)
    pad_front, pad_back = _pads(light, trigger_idx, n_ticks)
    k_truth = sim.max_mc_truth_ids
    points = k_truth > 0 and not light.enable_lut_smearing
    wvfms, truth_ids, amp, itick = _beam_digitize_stage(
        response, noise_rows, draw, light, segs, voxels, n_photons_det,
        op_channel_dev, lut.t0_avg, start_time, digit_samples=n_samples,
        pad_front=pad_front, pad_back=pad_back,
        k_truth=k_truth if points else 0)

    truth_sparse, truth_future = [None] * G, [None] * G
    thr = sim.mc_truth_threshold
    if points:
        # sample the combined kernel at the (C, K) contributor points in
        # numpy; only those small arrays leave the device
        kernel = _combined_kernel_host(light, conv_ticks)
        ids_h, amp_h, it_h = (t.cpu().numpy() for t in (truth_ids, amp,
                                                        itick))
        truth_sparse = [_host_truth_sparse(
            ids_h[g], amp_h[g], it_h[g], kernel, trigger_idx, light,
            n_samples, op_channel, thr) for g in range(G)]
    elif k_truth > 0 and truth_path == 'device':
        if sim.ref_exact_truth_staging:
            warnings.warn('ref_exact_truth_staging has no effect on the '
                          "device route; truth_path='host' runs the staged "
                          'chain')
        table = _trigger_table(light, conv_ticks, n_ticks, n_samples,
                               pad_front, n_ticks + pad_front + pad_back,
                               trigger_idx, dev)
        ids, tw = _smeared_truth_stage(
            segs, voxels, n_photons_det, op_channel_dev, lut.time_dist,
            start_time, light, table, n_ticks=n_ticks, k_truth=k_truth)
        with trace.phase('truth/pull', dev):
            truth_sparse = _pull_group_dense_truth(ids, tw, op_channel, thr)
    elif k_truth > 0:
        # the device selects each event's top-K contributors; their (C, K)
        # metadata is copied now, behind the group's work, and each event's
        # records are recomputed on the host from the host LUT
        sel = light_ops.light_truth_select(segs, voxels, n_photons_det,
                                           k_truth=k_truth)
        args = (lut.time_dist_host, op_channel, light, thr, conv_ticks,
                n_ticks, n_samples, pad_front, pad_back, start_time)
        staged = sim.ref_exact_truth_staging
        for g in range(G):
            fetch = _start_host_copy([t[g] for t in sel])
            if truth_executor is not None:
                truth_future[g] = truth_executor.submit(
                    _worker_smeared_truth, fetch, *args, as_records=True,
                    staged=staged, event_id=int(event_ids[g]))
            else:
                truth_sparse[g] = _host_smeared_truth_sparse(
                    *fetch(), *args, staged=staged)
    return [LightBatchResult(
        trigger_idx=trigger_idx, trigger_type=trig_type,
        op_channel_idx=trig_op, waveforms=wvfms[g], start_time=start_time,
        n_ticks=n_ticks, truth_sparse=truth_sparse[g],
        truth_future=truth_future[g]) for g in range(G)]


def _pads(light: LightParams, trigger_idx: np.ndarray, n_ticks: int):
    """(pad_front, pad_back) ticks around the simulated window that hold
    every trigger's digitized window (light_sim.sim_triggers, :545-619)."""
    tick = light.light_tick_size
    pre = int(np.ceil(light.light_trig_window[0] / tick))
    post = int(np.ceil(light.light_trig_window[1] / tick))
    pad_front = max(pre - int(trigger_idx.min()), 0)
    return pad_front, max(post + int(trigger_idx.max()) + pad_front
                          - (n_ticks + pad_front), 0)


def simulate_light_group_mode0(segs: Segments, light: LightParams,
                               sim: SimParams, n_photons_det, voxels,
                               lut: light_ops.LightLUT,
                               light_noise: torch.Tensor, draws: list, *,
                               windows: list, module_to_tpcs: dict,
                               add_noise: bool = True,
                               truth_path: str = 'device',
                               truth_executor=None,
                               event_ids=None,
                               op_channel=None) -> list[LightBatchResult]:
    """Run the light chain for G independent events' batches with the
    threshold trigger (mode 0, light_sim.py:380-477): the signal, the
    threshold groups and the dead-time scan over the group's leading axis,
    one wait for the group's trigger tables (their counts set the shapes
    that follow; the contributor-point truth comes in the same copy), then
    each event's tail -- padding around its triggers, noise drawn at the
    padded shape, digitization of every trigger, truth -- as its solo call
    runs it (models/light.py:1538-1658, :2001-2129).

    Each event's result equals its own :func:`simulate_light_batch` call
    (the one-event case of this function): triggers, waveforms and truth
    records, bit for bit.

    Args:
        segs: (G, S) stacked segments; n_photons_det: (G, S, C); voxels:
            (G, S, 3).
        draws: G :class:`ops.light.LightDraw`, event g's draws as its solo
            call takes them.
        windows: G (n_ticks, start_time) from :func:`mode0_window`; every
            event of a group shares one n_ticks bucket.
        module_to_tpcs: the detector's module -> TPCs map.
        event_ids: (G,) the records' event ids on a worker.
        The other arguments are those of :func:`simulate_light_batch`.
    """
    check_supported(light, truth_path)
    if light.light_trig_mode != 0:
        raise ValueError('simulate_light_group_mode0 runs the threshold '
                         'trigger (light_trig_mode 0)')
    if module_to_tpcs is None:
        raise ValueError('the threshold trigger needs the detector\'s '
                         'module_to_tpcs map')
    G = len(draws)
    event_ids = [0] * G if event_ids is None else event_ids
    n_ticks = windows[0][0]
    if any(w[0] != n_ticks for w in windows):
        raise ValueError('grouped mode-0 events must share one n_ticks '
                         f'bucket, not {[w[0] for w in windows]}')
    conv_ticks = window(light, n_ticks)[1]
    starts = [float(w[1]) for w in windows]
    dev = n_photons_det.device
    n_samples = digit_samples(light)
    op_channel, op_channel_dev, gains, noise_rows = _channels(
        light, light_noise, add_noise, dev, op_channel)
    C = len(op_channel)
    tpc_to_module = {t: m for m, tpcs in module_to_tpcs.items() for t in tpcs}
    gmasks, ops_per_mod = light_ops.mode0_module_masks(
        op_channel, light, module_to_tpcs, tpc_to_module)
    start = light_ops.upload(np.array(starts, np.float32).reshape(G, 1, 1),
                             dev)
    k_truth = sim.max_mc_truth_ids
    thr = sim.mc_truth_threshold
    points = k_truth > 0 and not light.enable_lut_smearing
    smear_host = (k_truth > 0 and light.enable_lut_smearing
                  and truth_path == 'host')

    with trace.phase('light/mode0_scan', dev):
        response = _signal_stage(
            segs, voxels, n_photons_det, op_channel_dev, lut.time_dist,
            lut.t0_avg, start, gains, group_draw(draws), light,
            n_ticks=n_ticks, conv_ticks=conv_ticks,
            lut_smearing=light.enable_lut_smearing)
        pulled = list(light_ops.trigger_tables(
            response, light_ops.mode0_group_threshold(op_channel, light),
            gmasks, light))
        if points:
            pulled += light_ops.light_truth_points(
                segs, voxels, n_photons_det, op_channel_dev, lut.t0_avg,
                start, light, k_truth=k_truth)
        fetches = []
        if smear_host:
            # each event's (C, K) contributor metadata, copied behind the
            # group's work (light_ops.light_truth_select)
            sel = light_ops.light_truth_select(segs, voxels, n_photons_det,
                                               k_truth=k_truth)
            fetches = [_start_host_copy([t[g] for t in sel])
                       for g in range(G)]
        # the one wait of the group
        idx_h, counts_h, *points_h = _start_host_copy(pulled)()
    trigs = light_ops.trigger_lists(idx_h, counts_h, ops_per_mod, C)
    kernel = _combined_kernel_host(light, conv_ticks) if points else None
    if sim.ref_exact_truth_staging and k_truth > 0 and not smear_host:
        warnings.warn('ref_exact_truth_staging has no effect on this truth '
                      "route; truth_path='host' with LUT smearing runs the "
                      'staged chain')

    out = []
    for g in range(G):
        trigger_idx, trig_op, trig_type = trigs[g]
        res = LightBatchResult(trigger_idx, trig_type, trig_op,
                               response.new_zeros((0, C, n_samples)),
                               starts[g], n_ticks)
        out.append(res)
        if not len(trigger_idx):
            continue
        pad_front, pad_back = _pads(light, trigger_idx, n_ticks)
        signal = torch.nn.functional.pad(response[g], (pad_front, pad_back))
        if noise_rows is not None:
            signal = signal + light_ops.gen_light_detector_noise(
                tuple(signal.shape), noise_rows, draws[g], light)
        res.waveforms = light_ops.digitize_signal(
            signal, light_ops.upload(trigger_idx + pad_front, dev), light,
            digit_samples=n_samples, ref_exact=sim.ref_exact_light_digitize)
        if points:
            res.truth_sparse = _host_truth_sparse(
                *(a[g] for a in points_h), kernel, trigger_idx, light,
                n_samples, op_channel, thr)
        elif k_truth > 0 and truth_path == 'device':
            table = _trigger_table(
                light, conv_ticks, n_ticks, n_samples, pad_front,
                n_ticks + pad_front + pad_back, trigger_idx, dev)
            ids, tw = _smeared_truth_stage(
                segs.event(g), voxels[g], n_photons_det[g], op_channel_dev,
                lut.time_dist, starts[g], light, table, n_ticks=n_ticks,
                k_truth=k_truth, ntrig=len(trigger_idx))
            with trace.phase('truth/pull', dev):
                res.truth_sparse = _pull_dense_truth(ids, tw, op_channel, thr)
        elif k_truth > 0:
            args = (lut.time_dist_host, op_channel, light, thr, conv_ticks,
                    n_ticks, n_samples, pad_front, pad_back, starts[g])
            kw = dict(staged=sim.ref_exact_truth_staging,
                      trigger_idx=trigger_idx)
            if truth_executor is not None:
                res.truth_future = truth_executor.submit(
                    _worker_smeared_truth, fetches[g], *args,
                    as_records=True, event_id=int(event_ids[g]), **kw)
            else:
                res.truth_sparse = _host_smeared_truth_sparse(
                    *fetches[g](), *args, **kw)
    return out
