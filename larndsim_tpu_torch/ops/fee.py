"""LArPix front-end electronics: self-trigger FSM + ADC digitization.

Counterpart of ``larndsim_tpu.ops.fee`` (reference fee.get_adc_values,
fee.py:517-656, and fee.digitize, fee.py:499-515).  The filtered charge is
the exact O(1)-per-tick IIR of the JAX package:
S(t) = A*S(t-1) + I(t), q(t) = S(t)*dt*(1-A), A = exp(-dt/tau).  The FSM
runs in :func:`fee_fsm`: on CUDA tensors the kernel ``csrc/fee_fsm.cu``,
on CPU tensors :func:`fee_fsm_plain`; the current fractions in
:func:`current_fractions`: the kernel ``csrc/current_fractions.cu``, or
:func:`current_fractions_plain`.  The chain calls :func:`get_adc_values_rows`
on the tick-major rows that the waveform sum writes
(``ops.accumulate.sum_pixel_signals(..., rows=scan_ticks(det))``);
:func:`get_adc_values` is the JAX package's signature over it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import units
from ..params.detector import DetectorParams


class FeeResult(NamedTuple):
    integrals: torch.Tensor    # (U, max_adc) integrated charge [e-]
    ticks: torch.Tensor        # (U, max_adc) trigger times [us]
    n_adc: torch.Tensor        # (U,) hits per pixel
    reset_start: torch.Tensor  # (U, max_adc) first accumulated global tick
    latch_end: torch.Tensor    # (U, max_adc) last accumulated global tick


@dataclasses.dataclass(frozen=True)
class FsmScalars:
    """Float32 constants (as Python floats) and tick counts of the FSM."""
    A: float
    dt: float
    C: float
    sigma_uncorr: float
    sigma_disc: float
    sigma_reset: float
    time_padding: float
    max_adc: int
    interval: int
    reset_ticks: int
    busy_ticks: int


def fsm_scalars(det: DetectorParams, *, max_adc: int,
                time_padding: float = 0.0) -> FsmScalars:
    """The FSM constants, computed in float32 as the JAX scan computes them."""
    f = lambda name: torch.tensor(det.f32(name), dtype=torch.float32)
    A = torch.exp(torch.tensor(-det.time_sampling, dtype=torch.float32)
                  / f('buffer_risetime'))
    return FsmScalars(
        A=float(A), dt=float(np.float32(det.time_sampling)),
        C=float(1.0 - A),
        sigma_uncorr=float(f('uncorrelated_noise_charge') * units.e),
        sigma_disc=float(f('discriminator_noise') * units.e),
        sigma_reset=float(f('reset_noise_charge') * units.e),
        time_padding=float(np.float32(time_padding)),
        max_adc=max_adc, interval=det.integrate_ticks,
        reset_ticks=det.reset_ticks, busy_ticks=det.busy_ticks)


def fee_fsm_plain(sig_rows, noise, q_init, thresholds, tick_times,
                  s: FsmScalars):
    """Plain PyTorch version of the FSM kernel: a Python tick loop over
    (U,) vectors with the scan body of ops/fee.py (step()) in its order."""
    n_scan, U = sig_rows.shape
    dev = sig_rows.device
    m = s.max_adc
    n_times = tick_times.shape[0]
    izero = torch.zeros(U, dtype=torch.int32, device=dev)
    s_filt = torch.zeros(U, dtype=torch.float32, device=dev)
    q_sum = q_init.clone()
    busy, integ_rem, skip_rem, iadc, last_reset = (izero.clone()
                                                   for _ in range(5))
    integrals = torch.zeros((U, m), dtype=torch.float32, device=dev)
    ticks_us = torch.zeros((U, m), dtype=torch.float32, device=dev)
    r_out = torch.full((U, m), -1, dtype=torch.int32, device=dev)
    e_out = torch.full((U, m), -1, dtype=torch.int32, device=dev)

    def write(buf, sel, idx, val):
        cur = buf.gather(1, idx)
        buf.scatter_(1, idx, torch.where(sel[:, None], val, cur))

    for t in range(n_scan):
        n_q, n_disc, n_adc, n_disc2, n_reset = noise[t]
        curre_t = sig_rows[t]
        skipping = skip_rem > 0
        integrating = integ_rem > 0
        s_filt = torch.where(skipping, 0.0, s.A * s_filt + curre_t)
        q = torch.where(skipping, 0.0, s_filt * s.dt * s.C)
        q_sum = q_sum + q

        integ_rem = torch.where(integrating & ~skipping, integ_rem - 1,
                                integ_rem)
        latch = integrating & ~skipping & (integ_rem == 0)
        adc = q_sum + n_adc * s.sigma_uncorr
        success = latch & (adc >= thresholds + n_disc2 * s.sigma_disc)

        idx = torch.clamp(iadc, max=m - 1).long()[:, None]
        crossing = min(t + 1, n_times - 1)
        post = max(t + 1 - (n_times - 1), 0)
        tick_val = tick_times[crossing] + s.time_padding - 2 + post
        write(integrals, success, idx, adc[:, None])
        write(ticks_us, success, idx, tick_val.expand(U, 1))
        write(r_out, success, idx, last_reset[:, None])
        write(e_out, success, idx,
              torch.full((U, 1), t, dtype=torch.int32, device=dev))
        iadc = torch.where(success, iadc + 1, iadc)

        idle = ~skipping & ~integrating
        busy = torch.where(idle, torch.clamp(busy - 1, min=0), busy)
        fire = (idle & (busy == 0) & (iadc < m)
                & (q_sum + n_q * s.sigma_uncorr
                   >= thresholds + n_disc * s.sigma_disc))
        integ_rem = torch.where(fire, s.interval, integ_rem)

        skip_rem = torch.where(skip_rem > 0, skip_rem - 1, 0)
        skip_rem = torch.where(latch, s.reset_ticks, skip_rem)
        last_reset = torch.where(latch, t + s.reset_ticks + 1, last_reset)
        busy = torch.where(success, s.busy_ticks, busy)
        q_sum = torch.where(latch, n_reset * s.sigma_reset, q_sum)
        s_filt = torch.where(latch, 0.0, s_filt)
    return (integrals, ticks_us, iadc.to(torch.int32), r_out, e_out)


def fee_fsm(sig_rows, noise, q_init, thresholds, tick_times,
            s: FsmScalars):
    """The self-trigger FSM over ``n_scan`` ticks; kernel on CUDA tensors.

    Args:
        sig_rows: (n_scan, U) float32 tick-major induced current.
        noise: (n_scan, 5, U) float32 standard normals, rows
            [n_q, n_disc, n_adc, n_disc2, n_reset].
        q_init: (U,) float32 initial q_sum (reset noise).
        thresholds: (U,) float32 discriminator thresholds [e-].
        tick_times: (T+1,) float32 tick -> time map [us].

    Returns:
        (integrals, ticks, n_adc, reset_start, latch_end), see FeeResult.
    """
    if sig_rows.device.type == 'cpu':
        return fee_fsm_plain(sig_rows, noise, q_init, thresholds,
                             tick_times, s)
    from ..kernels import binding
    return binding.fee_fsm(sig_rows, noise, q_init, thresholds, tick_times, s)


def tick_times(det: DetectorParams, device=None) -> torch.Tensor:
    """``jnp.linspace(0, time_interval[1], time_ticks + 1)`` with the
    float32 rounding XLA gives it (i * f32(stop * f32(1/n)), last = stop),
    on ``device`` (the detector's own by default)."""
    n = det.time_ticks
    stop = np.float32(det.time_interval[1])
    c = np.float32(stop * (np.float32(1) / np.float32(n)))
    out = np.concatenate([np.arange(n, dtype=np.float32) * c, [stop]])
    return torch.from_numpy(out.astype(np.float32)).to(
        det.device if device is None else device)


def scan_ticks(det: DetectorParams) -> int:
    """The FSM's scan length: the readout's ticks plus one integration and
    busy window (and 4), as the charge chain scans them."""
    return det.time_ticks + det.integrate_ticks + det.busy_ticks + 4


def get_adc_values(pixels_signals: torch.Tensor, tick_times: torch.Tensor,
                   pixel_thresholds: torch.Tensor, det: DetectorParams, *,
                   max_adc: int, n_scan: int, time_padding: float = 0.0,
                   noise: torch.Tensor | None = None,
                   q_init: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> FeeResult:
    """Run the self-trigger cycle on per-pixel waveforms: the JAX
    package's signature over :func:`get_adc_values_rows`.

    Args:
        pixels_signals: (U, T) induced current per unique pixel.
        tick_times: (T+1,) tick -> time map [us].
        pixel_thresholds: (U,) discriminator thresholds [e-].
        max_adc: hits per pixel (sim.max_adc_values).
        n_scan: scan length; covers T plus one integration + busy window.
        noise, q_init, generator: as :func:`get_adc_values_rows`.
    """
    U, T = pixels_signals.shape
    sig_rows = torch.zeros((n_scan, U), dtype=torch.float32,
                           device=pixels_signals.device)
    sig_rows[:min(n_scan, T)] = pixels_signals.t()[:min(n_scan, T)]
    return get_adc_values_rows(
        sig_rows, tick_times, pixel_thresholds, det, max_adc=max_adc,
        time_padding=time_padding, noise=noise, q_init=q_init,
        generator=generator)


def get_adc_values_rows(sig_rows: torch.Tensor, tick_times: torch.Tensor,
                        pixel_thresholds: torch.Tensor, det: DetectorParams,
                        *, max_adc: int, time_padding: float = 0.0,
                        noise: torch.Tensor | None = None,
                        q_init: torch.Tensor | None = None,
                        generator: torch.Generator | None = None
                        ) -> FeeResult:
    """Run the self-trigger cycle on the FSM's tick-major input.

    Args:
        sig_rows: (n_scan, U) float32 induced current, tick-major (the
            waveform sum's ``rows`` form); n_scan is the scan length.
        noise: (n_scan, 5, U) standard normals, drawn from ``generator``
            when None (the shape of the JAX draw ``normal(k_scan, ...)``).
        q_init: (U,) initial q_sum; ``randn(U) * sigma_reset`` from
            ``generator`` when None.
    """
    n_scan, U = sig_rows.shape
    dev = sig_rows.device
    s = fsm_scalars(det, max_adc=max_adc, time_padding=time_padding)
    if q_init is None:
        q_init = torch.randn((U,), generator=generator,
                             device=dev) * s.sigma_reset
    if noise is None:
        noise = torch.randn((n_scan, 5, U), generator=generator, device=dev)
    return FeeResult(*fee_fsm(
        sig_rows, noise.float().contiguous(), q_init.float().contiguous(),
        pixel_thresholds.float().contiguous(), tick_times.float().contiguous(),
        s))


def fraction_decay(det: DetectorParams, device) -> torch.Tensor:
    """A = exp(-dt / buffer_risetime), 0-d float32 on ``device``, by the
    plain version's expression, made there with no copy from the host."""
    # a fill, not a copy from the host: the same float32 as torch.tensor
    dt_t = torch.full((), det.time_sampling, dtype=torch.float32,
                      device=device)
    return torch.exp(-dt_t / det.buffer_risetime)


def current_fractions(signals: torch.Tensor, pix_idx: torch.Tensor,
                      slot: torch.Tensor, track_starts: torch.Tensor,
                      fee: FeeResult, det: DetectorParams, *, max_adc: int,
                      max_tracks: int, n_adc_scan: int,
                      csr=None) -> torch.Tensor:
    """Per-(pixel, adc, track-slot) current fractions; the kernel
    ``csrc/current_fractions.cu`` on CUDA tensors (no launch when no ADC
    slot is scanned: the fractions are then zeros; another device
    raises), walking the batch's ``ops.accumulate.pixel_csr`` ``csr``
    (made here when None), and :func:`current_fractions_plain` on CPU
    tensors.  The two agree at rtol 1e-5 / atol 1e-6 (their sums run in
    other orders).

    Returns:
        (U, max_adc, max_tracks) float32.
    """
    if signals.device.type == 'cpu':
        return current_fractions_plain(
            signals, pix_idx, slot, track_starts, fee, det, max_adc=max_adc,
            max_tracks=max_tracks, n_adc_scan=n_adc_scan)
    from ..kernels import binding
    from .accumulate import pixel_csr
    U = fee.reset_start.shape[0]
    if csr is None:
        csr = pixel_csr(pix_idx, track_starts, U,
                        time_sampling=det.time_sampling)
    return binding.current_fractions(
        signals, csr.pairs, csr.offsets, slot, fee.reset_start,
        fee.latch_end, fraction_decay(det, signals.device),
        float(np.float32(det.time_sampling)),
        max_adc=max_adc, max_tracks=max_tracks,
        n_adc_scan=max(min(n_adc_scan, max_adc), 0),
        n_weights=scan_ticks(det) + 2)


def current_fractions_plain(signals: torch.Tensor, pix_idx: torch.Tensor,
                            slot: torch.Tensor, track_starts: torch.Tensor,
                            fee: FeeResult, det: DetectorParams, *,
                            max_adc: int, max_tracks: int,
                            n_adc_scan: int) -> torch.Tensor:
    """Plain PyTorch version of the fraction kernel, closed form.

    The weight of current I(j) in an ADC with accumulation window [r, e] is
    dt*(1 - A^(e-j+1)); fractions are normalized by the total accumulated
    (noise-free) charge.  Only ADC slots below ``n_adc_scan`` are
    evaluated: pass the batch's max hit count (later slots carry no
    window).  Each (pixel, slot) receives one entry per ADC slot, so the
    scatter writes every address once.

    Returns:
        (U, max_adc, max_tracks) float32.
    """
    S, P, T = signals.shape
    U = fee.integrals.shape[0]
    dev = signals.device
    dt = det.time_sampling
    dt_t = torch.tensor(dt, dtype=torch.float32, device=dev)
    A = torch.exp(-dt_t / det.buffer_risetime)

    start_tick = torch.round(track_starts / dt_t).to(torch.int32)
    j_global = start_tick[:, None] + torch.arange(T, device=dev,
                                                  dtype=torch.int32)
    ok_entry = (pix_idx >= 0) & (slot >= 0)
    safe_u = torch.where(ok_entry, pix_idx, 0).long()
    dst_u = torch.where(ok_entry, pix_idx, U).long()
    dst_k = torch.where(ok_entry, slot, 0).long()

    num = torch.zeros((U + 1, max_adc, max_tracks), dtype=torch.float32,
                      device=dev)
    for a in range(min(n_adc_scan, max_adc)):
        r_sp = fee.reset_start[:, a][safe_u]                    # (S, P)
        e_sp = fee.latch_end[:, a][safe_u]
        in_win = ((j_global[:, None, :] >= r_sp[:, :, None])
                  & (j_global[:, None, :] <= e_sp[:, :, None])
                  & (e_sp >= 0)[:, :, None])
        expo = (e_sp[:, :, None] - j_global[:, None, :] + 1).float()
        w = dt * (1.0 - torch.pow(A, torch.clamp(expo, min=0.0)))
        contrib = torch.sum(torch.where(in_win, signals * w, 0.0), dim=2)
        num[dst_u, a, dst_k] = contrib
    num = num[:U]
    true_q = num.sum(dim=2, keepdim=True)
    return torch.where(true_q > 0, num / true_q, 0.0)


def digitize(integral_list: torch.Tensor, det: DetectorParams,
             gain: torch.Tensor | None = None) -> torch.Tensor:
    """Charge -> ADC counts (fee.digitize, fee.py:499-515)."""
    if gain is None:
        gain = det.gain
    gain = gain * units.mV / units.e
    v = (integral_list * gain + det.v_pedestal * units.mV
         - det.v_cm * units.mV)
    adcs = torch.clamp(
        torch.round(torch.clamp(v, min=0) * det.adc_counts
                    / (det.v_ref * units.mV - det.v_cm * units.mV)),
        max=det.adc_counts - 1)
    return adcs
