"""Light-readout chain: segments -> SiPM waveforms + triggers.

Counterpart of the beam-trigger path of ``larndsim_tpu.models.light``: the
per-batch pipeline the reference runs at cli/simulate_pixels.py:1119-1205
-- photon time series -> scintillation smear -> Poisson PE statistics ->
SiPM response -> forced beam trigger -> noise + ADC-rate digitization --
with the contributor-point MC truth (no LUT smearing) zero-suppressed on
the host.  The threshold trigger (mode 0) and the LUT-smearing truth are
refused (:func:`check_supported`).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..ops import light as light_ops
from ..ops.light import LightDraw
from ..params.light import LightParams
from ..params.sim import SimParams
from ..segments import Segments

#: cap on the simulated light ticks of one batch (cli:1125:
#: min(nticks, 5e4))
MAX_TICKS = 50_000


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


def generator_draw(generator: torch.Generator, device) -> LightDraw:
    """A :class:`LightDraw` that takes every draw from ``generator``."""
    return LightDraw(
        poisson=lambda rate: torch.poisson(rate, generator=generator),
        normal=lambda shape: torch.randn(shape, generator=generator,
                                         device=device),
        uniform=lambda shape: torch.rand(shape, generator=generator,
                                         device=device))


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


def check_supported(light: LightParams, sim: SimParams) -> None:
    """Raise for the light routes this port does not run yet."""
    if light.light_trig_mode != 1:
        raise NotImplementedError(
            f'light_trig_mode {light.light_trig_mode}: only the beam trigger '
            '(mode 1) is ported')
    if light.enable_lut_smearing and sim.max_mc_truth_ids > 0:
        raise NotImplementedError(
            'MC truth with LUT smearing (max_light_truth_ids > 0 and '
            'enable_lut_smearing) is not ported')


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


def simulate_light_batch(segs: Segments, light: LightParams, sim: SimParams,
                         n_photons_det, voxels, lut: light_ops.LightLUT,
                         light_noise: torch.Tensor, draw: LightDraw,
                         i_subbatch: int = 0,
                         add_noise: bool = True) -> LightBatchResult:
    """Run the light chain for one batch, beam trigger (mode 1).

    Args:
        n_photons_det: (S, C) from calculate_light_incidence, on the LUT's
            device.
        voxels: (S, 3) LUT voxels.
        light_noise: (n_channels, n_bins) noise amplitude spectra (rows
            picked by channel id modulo their count).
        draw: the batch's random draws (:class:`ops.light.LightDraw`).
        i_subbatch: 0 for an event's first batch; only that batch triggers
            (light_sim.py:444-451).
        add_noise: False simulates without the detector noise.
    """
    check_supported(light, sim)
    dev = n_photons_det.device
    # every channel of the module, in the TPCs' order
    op_channel = light.tpc_to_op_channel.cpu().numpy().ravel()
    C = len(op_channel)
    n_samples = digit_samples(light)
    n_ticks, start_time = light_ops.get_nticks(light)
    n_ticks, conv_ticks = window(light, n_ticks)
    if i_subbatch != 0:
        # the beam trigger fires on an event's first batch only: a later
        # batch has no trigger, and its waveforms would be discarded (the
        # JAX package computes and drops them; the outputs are the same)
        return LightBatchResult(np.empty(0, int), np.empty(0, int),
                                np.empty((0, C), int),
                                torch.zeros((0, C, n_samples), device=dev),
                                start_time, n_ticks)

    op_channel_dev = torch.from_numpy(op_channel).to(dev)
    gains = light.light_gain[op_channel_dev.long()]
    noise_rows = None
    if add_noise:
        noise = torch.as_tensor(light_noise, dtype=torch.float32, device=dev)
        noise_rows = noise[(op_channel_dev % noise.shape[0]).long()]

    response = _signal_stage(
        segs, voxels, n_photons_det, op_channel_dev, lut.time_dist,
        lut.t0_avg, start_time, gains, draw, light, n_ticks=n_ticks,
        conv_ticks=conv_ticks, lut_smearing=light.enable_lut_smearing)

    # beam mode forces one trigger at tick 0 (light_sim.py:444-451); pad +
    # noise + digitize (light_sim.sim_triggers, :545-619)
    trigger_idx = np.zeros(1, int)
    trig_op = op_channel[None, :]
    trig_type = np.ones(1, int)
    tick = light.light_tick_size
    pre = int(np.ceil(light.light_trig_window[0] / tick))
    post = int(np.ceil(light.light_trig_window[1] / tick))
    pad_front = max(pre - int(trigger_idx.min()), 0)
    pad_back = max(post + int(trigger_idx.max()) + pad_front
                   - (n_ticks + pad_front), 0)
    do_truth = sim.max_mc_truth_ids > 0
    wvfms, truth_ids, amp, itick = _beam_digitize_stage(
        response, noise_rows, draw, light, segs, voxels, n_photons_det,
        op_channel_dev, lut.t0_avg, start_time, digit_samples=n_samples,
        pad_front=pad_front, pad_back=pad_back,
        k_truth=sim.max_mc_truth_ids if do_truth else 0)

    truth_sparse = None
    if do_truth:
        # sample the combined kernel at the (C, K) contributor points in
        # numpy; only those small arrays leave the device
        kernel = _combined_kernel_host(light, conv_ticks)
        truth_sparse = _host_truth_sparse(
            truth_ids.cpu().numpy(), amp.cpu().numpy(),
            itick.cpu().numpy(), kernel, trigger_idx, light, n_samples,
            op_channel, sim.mc_truth_threshold)
    return LightBatchResult(
        trigger_idx=trigger_idx, trigger_type=trig_type,
        op_channel_idx=trig_op, waveforms=wvfms, start_time=start_time,
        n_ticks=n_ticks, truth_sparse=truth_sparse)
