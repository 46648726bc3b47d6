"""Per-op device-time guard of the charge chain's hot ops, on the card.

Counterpart of ``tools/perf_guard.py``.  Stages the JAX guard's 2x2
workload (4 events x 24 tracks x 42 segments of 0.4 cm, dEdx 8, seed 2,
padded to 4096 segments) on the port's generated Module-0-shaped detector,
exactly as ``models.charge.simulate_charge_batch`` stages a batch (the 2x2
YAMLs are not in the repository; the output says so), then times with CUDA
events the ops the JAX guard times:

  induced_current      the induced-current kernel (K1) alone
  sum_pixel_signals_with_csr  the per-pixel waveform sum (D1) into the
                       FSM's tick-major rows, its CSR made in the call
  sum_pixel_signals_kernel  the same with the batch's CSR given (the
                       chain's call): D1 alone
  fee_fsm              the FEE FSM kernel (K2) alone, on D1's rows
  get_adc_values_rows  the FSM as the chain calls it (``ops.fee.
                       get_adc_values_rows`` on D1's rows), noise draws
                       included
  current_fractions_4_with_csr  current fractions (D2) over 4 ADC slots,
                       the CSR made in the call
  current_fractions_4_kernel  the same with the batch's CSR given (the
                       chain's call): D2 and the three launches that make
                       its A
  digitize             charge -> ADC counts

and, on the same batch with the light keys of one 2x2 module (96
channels, 16 us beam window: 16384 ticks, FFTs of 32768; the synthetic
(14, 26, 8) x 48 LUT of 100 profile bins), the light chain's ops:

  light_sum_t0avg      photon series, one arrival tick per (segment, channel)
  light_sum_smearing   photon series, 100 profile bins per (segment, channel)
  light_scintillation  the scintillation convolution (FFT)
  light_stat           the Poisson / Gaussian PE statistics, draws included
  light_sipm           the SiPM response convolution (FFT) x gains
  light_noise          the noise synthesis (inverse FFT), draws included
  light_digitize       the beam trigger's 256 ADC samples per channel
  light_trigger_scan   the threshold trigger's scan (mode 0): the groups'
                       threshold flags, each module's, the dead-time walk
                       and the copy of the trigger tables to the host

and the whole beam stage of ``models.light`` (LUT smearing on, truth off)
on the batch cut into 4 events of S / 4 segments each:

  light_group_beam     the 4 events as one ``simulate_light_group`` call
  light_solo_beam_x4   the same 4 events as 4 ``simulate_light_batch`` calls

and, beside the port's float64 transforms, the same convolutions and noise
in float32, the JAX ops' arithmetic (``light_scintillation_f32``,
``light_sipm_f32``, ``light_noise_f32``; not on the port's path: they
give the cost of its float64 choice), and the MC truth with LUT smearing
at the 2x2 production setting (K 50 contributors per channel, threshold
0.1 pe/us; the (16384, 256) transfer table):

  light_truth_series   the dense (C x K, 16384) contributor series
  light_truth_product  the series times the transfer table, float32
  light_truth_pull     keep mask, nonzero and the kept records to the host
  light_truth_host     the host route's recompute of one batch, its records
                       by the native emitter (``csrc/host/truth_emit.cpp``)
                       (host wall, no bound)
  light_truth_host_plain  the same with the emitter's numpy version

For each op: the bytes it must move (each input read once, each output
written once) and the operations it does on these inputs, counted from this
run's shapes and data; the bound on this card (the larger of bytes / 3.35
TB/s and float32 operations / 33.5e12 per second, from an H100 SXM's
published peaks); which of the two sets it; and the share of the bound
reached (the light ops: bytes only, but the truth product: its
multiply-adds at the FMA rate, 67e12 FLOP/s counting one as two).  The
four kernels of the charge chain (K1, K2, the waveform sum D1 and the
current fractions D2) also get their launches per batch and the time of
one PyTorch call that computes the same function, where one exists (D1:
``Tensor.index_put_(..., accumulate=True)`` of the aligned entries, timed
here only and checked against the kernel once; the port never calls it);
D1 and D2 also the time of their plain versions on the same inputs.

``--config ndlar`` stages instead the JAX guard's ND-LAr workload (one
event of 82 tracks x 42 segments, the same cut, padded to 4096 segments;
tools/perf_guard.py:76-86) on the generated ND-LAr-shaped tree
(``assets.geometry.write_ndlar``: 70 TPCs, 8.96 M pixel ids, 50 ns
sampling, 6401 ticks) and times the charge ops alone: that tree has no
light.  Its K1 entry also gives the kernel's tile choice on that batch,
counted by the kernel (``kernels.binding.induced_current_tiling``).

    python -m larndsim_tpu_torch.tools.perf_guard [--config module0|ndlar]
        [--log PATH]

Prints one JSON line naming the card; appends it to PATH (default
``larndsim_tpu_torch/build/perf_guard.jsonl``, git-ignored) and warns when
an op is slower than 1.5x the median of its last three runs at the same
shapes on the same card.  Needs a CUDA device: without one it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.build import BUILD_DIR

#: an H100 SXM's published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
#: the operations counted here are single float32 adds, multiplies,
#: compares and selects (the kernels are built with -fmad=false); each
#: takes the issue slot of a fused multiply-add, which the FLOP peak counts
#: as two, so they run at most at half of it
F32_OPS_PER_S = F32_FLOP_PER_S / 2
#: timed calls of each op, after one warm-up call
REPS = 3
#: launches between two events in a ``*_kernel`` row: the host enqueues
#: them behind each other, so the row is the device's time of one launch
#: without the host's call overhead (:func:`timed_queued`)
QUEUED = 10
REGRESSION_FACTOR = 1.5
LOG_PATH = os.path.join(BUILD_DIR, 'perf_guard.jsonl')
#: the JAX guard's 2x2 workload (tools/perf_guard.py: build_workload)
WORKLOAD = dict(n_events=4, tracks_per_event=24, segments_per_track=42,
                segment_length=0.4, dEdx=8.0, seed=2)
PAD_N = 4096
#: the JAX guard's ND-LAr workload (tools/perf_guard.py:76-86: one event of
#: 82 tracks, written as the 2x2 one)
NDLAR_WORKLOAD = dict(WORKLOAD, n_events=1, tracks_per_event=82)
#: the guard's workloads by ``--config``: (input, detector description)
CONFIGS = dict(
    module0=(WORKLOAD, 'Module-0-shaped, generated (the 2x2 YAMLs of the '
             'JAX guard are not in the repository)'),
    ndlar=(NDLAR_WORKLOAD, 'ND-LAr-shaped, generated (assets.geometry.'
           'write_ndlar; the ND-LAr YAMLs are not in the repository)'))
#: the shapes the JAX guard logged on the TPU (PERF_LOG.jsonl rows 16, 17,
#: 24, 25; ND-LAr: max_nb 18)
LOGGED_SHAPES = dict(pad_n=4096, n_steps=512, t_sig=2048, n_unique_cap=16384,
                     max_nb=15, max_adc=30, max_tracks=50)
N_ADC_SCAN = 4
#: float32 operations per (tick, pixel) of the FSM body (ops/fee.py step():
#: integrator 2, charge 2, sum 1, ADC 2, latch test 3, fire test 5)
FSM_OPS = 15
#: per (slot, segment, pixel, tick) of current_fractions inside the slot's
#: window: window tests 3, exponent 3, weight 3, product, select, sum
FRACTION_OPS = 12
#: per value of digitize: gain, offsets, clamp, scale, divide, round, clamp
DIGITIZE_OPS = 8
#: per live (segment, pixel, step) of K1: the response row of the point
ROW_OPS = 10
#: the LUT-smearing truth of the JAX bench's 2x2 production configuration
#: (bench.py: max_light_truth_ids 50, mc_truth_threshold 0.1)
TRUTH_K = 50
TRUTH_THRESHOLD = 0.1
#: events of the grouped beam-stage rows (bench.py's event_group_size)
N_GROUP = 4
#: the PyTorch call that computes each kernel's function, or why none does
LIBRARY = dict(
    induced_current='none: a data-dependent gather-accumulate (each '
    '(segment, pixel, step) picks its own response row and shift); no one '
    'PyTorch call computes it',
    fee_fsm='none: a sequential per-pixel state machine with data-dependent '
    'writes; no one PyTorch call computes it',
    sum_pixel_signals='Tensor.index_put_(accumulate=True) of the aligned '
    'entries into the zeroed (n_scan, U) tick-major rows (atomic adds, in '
    'another order on each run); timed here only, never called by the '
    'port',
    current_fractions='none: weighted sums over data-dependent tick '
    'windows, scattered by track slot and normalised; no one PyTorch call '
    'computes it')
#: the guard's row of D1 and D2, the chain's kernels timed beside their
#: plain versions (their CSR made in the call), and the row of each alone.
#: The rows of D1, D2 and the FSM as the chain calls it are named for the
#: work they time (the CSR built, the FSM's rows given), so that the log
#: never compares them with the older rows of other work (the (U, n_ticks)
#: waveforms, the FSM with their transpose copied in)
CHAIN_ROWS = dict(sum_pixel_signals='sum_pixel_signals_with_csr',
                  current_fractions='current_fractions_4_with_csr')
KERNEL_ROWS = dict(sum_pixel_signals_with_csr='sum_pixel_signals_kernel',
                   current_fractions_4_with_csr='current_fractions_4_kernel')


class Timing(NamedTuple):
    min_ms: float
    mean_ms: float


def timed(fn, *args, reps: int = REPS, **kw) -> Timing:
    """Device time of ``fn(*args, **kw)`` on the current stream: one warm-up
    call, then CUDA events around each of ``reps`` calls, each followed by
    ``torch.cuda.synchronize()``; minimum and mean in ms."""
    fn(*args, **kw)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(min(times), sum(times) / len(times))


def timed_queued(fn, *args, n: int = QUEUED, **kw) -> Timing:
    """Device time of one of ``n`` calls of ``fn(*args, **kw)`` enqueued
    behind each other between two CUDA events, after one warm-up call;
    minimum and mean over ``REPS`` such runs, in ms a call."""
    fn(*args, **kw)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return Timing(min(times), sum(times) / len(times))


def card() -> dict:
    """The card's name as PyTorch and nvidia-smi give it, with its power
    limit."""
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = 'nvidia-smi unavailable: power limit not read'
    return dict(name=torch.cuda.get_device_name(0), smi=smi)


def card_name() -> str:
    c = card()
    return c['smi'] if c['smi'].startswith(c['name']) else \
        f'{c["name"]} ({c["smi"]})'


def bound(n_bytes: float, n_ops: float, ms: float | None = None) -> dict:
    """The least time of the work on this card, what sets it, and the
    share of it reached in ``ms``."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / F32_OPS_PER_S * 1e3
    rec = dict(bytes=int(n_bytes), ops=int(n_ops),
               bound_ms=max(b_ms, o_ms),
               bound_by='bytes' if b_ms >= o_ms else 'operations')
    if ms:
        rec['share'] = rec['bound_ms'] / ms
    return rec


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_costs(args) -> dict:
    """Bytes and operations of the induced current on these inputs: every
    input and the (S, P, t_sig) output once; one add per response value
    summed (live step, in-range pixel, tick in [tick_lo, t_sig) that the
    shifted row covers), one multiply per output tick from tick_lo on, and
    the row lookup of each live (segment, pixel, step)."""
    from ..ops import current
    xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi, scale, resp, \
        lut = args
    S, n_steps = xs.shape
    P = pxc.shape[1]
    t_sig = scale.shape[1]
    ntp = resp.shape[1]
    live = (torch.arange(n_steps, device=xs.device)[None, :]
            < nstep[:, None].long())                               # (S, n)
    rows = current.row_table(xs, ys, phase, pxc, pyc, lut)          # (S,P,n)
    pix_live = (rows != lut.zero_row).sum(dim=1)                    # (S, n)
    sh = shift.long()
    n_t = (torch.clamp(sh + ntp, max=t_sig)
           - torch.maximum(sh, tick_lo[:, None].long())).clamp(min=0)
    adds = int((n_t * pix_live * live).sum())
    valid_pix = (pxc.abs() < current.FAR / 10).sum(dim=1)           # (S,)
    muls = int((valid_pix * (t_sig - tick_lo.long()).clamp(min=0)).sum())
    lookups = int(((rows != lut.zero_row) & live[:, None, :]).sum())
    return dict(bytes=nbytes(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo,
                             tick_hi, scale, resp) + S * P * t_sig * 4,
                ops=adds + muls + ROW_OPS * lookups)


def _start_ticks(track_starts, time_sampling: float) -> torch.Tensor:
    """Each segment's first global tick, round(track_start / dt) in
    float32 as the waveform sum and the fractions compute it (int64)."""
    dt = torch.full((), time_sampling, dtype=torch.float32,
                    device=track_starts.device)
    return torch.round(track_starts / dt).long()


def sum_costs(signals, pix_idx, track_starts, n_unique_cap: int,
              n_ticks: int, time_sampling: float,
              rows: int | None = None) -> dict:
    """One add per valid entry's tick that lands inside [0, n_ticks) (and
    below ``rows``); the signal values those adds read (the rest of the
    (S, P, T) signals, the padding entries' rows and the ticks outside the
    readout, is not needed: this run's data sets the count), the maps and
    the output once: the (U, n_ticks) waveforms, or with ``rows`` the
    (rows, U) tick-major rows the kernel writes for the FSM."""
    S, P, T = signals.shape
    n_out = n_ticks if rows is None else rows
    g_sum = min(n_ticks, n_out)
    start = _start_ticks(track_starts, time_sampling)
    inside = (torch.clamp(start + T, max=g_sum)
              - torch.clamp(start, min=0)).clamp(min=0)             # (S,)
    adds = int(((pix_idx >= 0).sum(dim=1) * inside).sum())
    return dict(bytes=adds * signals.element_size()
                + nbytes(pix_idx, track_starts)
                + n_unique_cap * n_out * 4, ops=adds)


def fsm_costs(n_scan: int, n_pix: int, max_adc: int, n_times: int, *,
              drawn: bool) -> dict:
    """K2 alone: signal rows, noise, q_init, thresholds and tick times in,
    the five outputs out.  ``drawn`` (get_adc_values_rows): the signal
    rows, thresholds and tick times in, the noise made inside (its bytes
    and its generator's operations are not counted, so the bound is a
    lower bound)."""
    out = n_pix * max_adc * 4 * 4 + n_pix * 4
    if drawn:
        n_in = n_pix * n_scan * 4 + n_pix * 4 + n_times * 4
    else:
        n_in = (n_scan * 6 * n_pix + 2 * n_pix + n_times) * 4
    return dict(bytes=n_in + out, ops=FSM_OPS * n_scan * n_pix)


def window_ticks(signals, pix_idx, slot, track_starts, reset_start,
                 latch_end, n_adc_scan: int, time_sampling: float) -> int:
    """The (scanned slot, valid entry, tick) triples of the current
    fractions: the ticks of each entry's row inside its pixel's window
    [reset_start, latch_end] of each scanned slot that latched.  A
    pixel's windows do not overlap, so each is also a signal value read
    once."""
    T = signals.shape[2]
    ok = (pix_idx >= 0) & (slot >= 0)
    u = torch.where(ok, pix_idx, 0).long()
    st = _start_ticks(track_starts, time_sampling)[:, None]
    n = 0
    for a in range(n_adc_scan):
        r, e = reset_start[:, a].long()[u], latch_end[:, a].long()[u]
        length = (torch.clamp(e - st, max=T - 1)
                  - torch.clamp(r - st, min=0) + 1).clamp(min=0)
        n += int(torch.where(ok & (e >= 0), length, 0).sum())
    return n


def fraction_costs(signals, pix_idx, slot, track_starts, reset_start,
                   latch_end, max_tracks: int, n_adc_scan: int,
                   time_sampling: float) -> dict:
    """FRACTION_OPS per (scanned slot, valid entry, tick inside the slot's
    window), :func:`window_ticks`; the signal values in those windows
    (this run's data sets the count, not the whole (S, P, T) signals),
    the maps and the windows of the scanned slots in, the (U, max_adc,
    max_tracks) fractions out."""
    n_pix, max_adc = reset_start.shape
    n_in = window_ticks(signals, pix_idx, slot, track_starts, reset_start,
                        latch_end, n_adc_scan, time_sampling)
    return dict(bytes=n_in * signals.element_size()
                + nbytes(pix_idx, slot, track_starts)
                + 2 * n_pix * n_adc_scan * 4 + n_pix * max_adc
                * max_tracks * 4,
                ops=FRACTION_OPS * n_in)


def aligned_entries(signals, pix_idx, track_starts, n_unique_cap: int, *,
                    n_ticks: int, time_sampling: float,
                    rows: int | None = None):
    """The waveform sum's yardstick inputs: the flat address g * U + u of
    the (rows, U) tick-major rows the kernel writes and the value of every
    valid entry's tick g inside [0, min(n_ticks, rows)), its window
    placed at round(track_start / dt) (the start ticks of
    ``ops.accumulate.pixel_csr``).  ``rows`` None: n_ticks."""
    T = signals.shape[2]
    g_sum = min(n_ticks, n_ticks if rows is None else rows)
    start = _start_ticks(track_starts, time_sampling)
    g = start[:, None, None] + torch.arange(T, device=signals.device)
    keep = (pix_idx >= 0)[:, :, None] & (g >= 0) & (g < g_sum)
    addr = g * n_unique_cap + pix_idx.long()[:, :, None]
    return addr[keep], signals[keep]


def pixel_sum_library(args, kw) -> tuple:
    """D1's yardstick: (one call of ``index_put_`` with accumulate=True of
    the aligned entries into a zeroed (rows, U) buffer, that buffer), the
    entries made once, outside the call."""
    addr, vals = aligned_entries(*args, **kw)
    rows = kw.get('rows') or kw['n_ticks']
    out = torch.zeros((rows, args[3]), dtype=torch.float32,
                      device=vals.device)
    flat = out.view(-1)
    return (lambda: flat.index_put_((addr,), vals, accumulate=True)), out


def plain_kw(kw: dict) -> dict:
    """A chain kernel's keywords without the CSR its plain version does
    not take."""
    return {k: v for k, v in kw.items() if k != 'csr'}


def chain_kernel_rows(calls: dict) -> dict:
    """D1's and D2's plain versions timed on their rows' inputs, and D1's
    yardstick timed and checked once against the kernel (atol 1e-6 x
    peak: its atomic adds run in any order): {kernel: {plain_ms,
    library_ms}}."""
    from ..ops import accumulate, fee
    plains = dict(sum_pixel_signals=accumulate.sum_pixel_signals_plain,
                  current_fractions=fee.current_fractions_plain)
    rows = {}
    for name, row in CHAIN_ROWS.items():
        _, args, kw = calls[row]
        rows[name] = dict(row=row, kernel_row=KERNEL_ROWS[row],
                          library_ms=None, plain_ms=timed(
                              plains[name], *args, **plain_kw(kw)).min_ms)
    _, args, kw = calls[CHAIN_ROWS['sum_pixel_signals']]
    call, out = pixel_sum_library(args, kw)
    call()
    want = accumulate.sum_pixel_signals(*args, **kw)
    peak = float(want.abs().max())
    err = float((out - want).abs().max())
    if not err <= 1e-6 * peak:
        raise AssertionError(f'index_put_ yardstick disagrees with the '
                             f'waveform sum: max |err| {err}, peak {peak}')
    rows['sum_pixel_signals']['library_ms'] = timed(call).min_ms
    del out
    return rows


def build_workload(device, directory: str, *, workload: dict = WORKLOAD,
                   pad_n: int = PAD_N, geometry: dict | None = None,
                   seed: int = 3, config: str = 'module0') -> dict:
    """Stage the guard's batch on ``device``: a Module-0-shaped tree with
    the light keys (``config`` 'module0') or an ND-LAr-shaped one
    ('ndlar'; ``geometry``: keyword arguments of ``write_module0`` or
    ``write_ndlar``, the published widths by default) in ``directory``,
    the input ``workload`` padded to ``pad_n`` segments, staged by
    ``models.charge.stage_batch``, and the induced current's arguments with
    a smear drawn from ``seed``."""
    from ..assets.geometry import write_module0, write_ndlar
    from ..assets.make_input import write_input
    from ..assets.response import make_response
    from ..io.edep import load_edep
    from ..models.charge import generator_draw, stage_batch
    from ..ops import current
    from ..ops.drift import select_active_volume
    from ..params import load_detector, load_sim
    from ..segments import from_structured

    if config == 'ndlar':
        paths = write_ndlar(os.path.join(directory, 'ndlar'),
                            **(geometry or {}))
    else:
        paths = write_module0(os.path.join(directory, 'module0'),
                              light=True, **(geometry or {}))
    dm = load_detector(paths['detector_properties'], paths['pixel_layout'],
                       device=device)
    sim = load_sim(paths['simulation_properties'])
    det = dm.params
    inp = os.path.join(directory, 'guard_in.h5')
    write_input(inp, dm.tpc_borders, **workload)
    tracks = load_edep(inp, event_separator=sim.event_separator,
                       is_spill_sim=sim.is_spill_sim,
                       spill_period=sim.spill_period,
                       max_events_per_file=sim.max_events_per_file).tracks
    tracks = tracks[select_active_volume(tracks, dm.tpc_borders)]
    segs = from_structured(tracks, pad_to=pad_n, device=device)
    stage = stage_batch(segs, dm, sim)
    n_t = int(round(det.f32('time_window') / det.f32('response_sampling')))
    response = torch.from_numpy(make_response(
        n_xy=45, n_t=n_t, bin_size=det.f32('response_bin_size'),
        sampling=det.f32('response_sampling'),
        pixel_pitch=det.f32('pixel_pitch'))).to(device)
    gen = torch.Generator(device).manual_seed(seed)
    k1_args = current.current_inputs(
        stage.segs, stage.px, stage.py, stage.pixels >= 0, response, det,
        generator_draw(gen, device)('smear', (3, pad_n, stage.n_steps)),
        n_steps=stage.n_steps, t_sig=stage.t_sig,
        shift_band=stage.shift_band, min_step=stage.min_step)
    shapes = dict(pad_n=pad_n, n_steps=stage.n_steps, t_sig=stage.t_sig,
                  n_unique_cap=stage.n_unique_cap, max_nb=stage.max_nb,
                  max_adc=sim.max_adc_values,
                  max_tracks=sim.max_tracks_per_pixel)
    return dict(det_model=dm, det=det, sim=sim, segs=segs, stage=stage,
                response=response, k1_args=k1_args, generator=gen,
                shapes=shapes, n_segments=len(tracks), paths=paths)


def build_light_workload(w: dict) -> dict:
    """The light chain's inputs for the guard's batch: the tree's light
    params, the synthetic LUT, the staged segments' incidence, and the
    window and shapes ``models.light.simulate_light_batch`` chooses."""
    import math
    from ..assets.light_lut import load_light_lut, make_light_noise
    from ..models import light as light_model
    from ..ops import light as light_ops
    from ..params import load_light
    dev = w['det'].device
    light = load_light(w['paths']['detector_properties'], device=dev)
    lut = light_ops.LightLUT.from_structured(
        load_light_lut(None, n_det_tpc=light.n_op_channel // 2), dev)
    segs = w['stage'].segs
    n_det, t0_det, vox = light_ops.calculate_light_incidence(
        segs, w['det'], light, lut.vis, lut.t0,
        n_channels=light.n_op_channel)
    n_ticks, conv_ticks = light_model.window(
        light, light_ops.get_nticks(n_det, t0_det, light)[0])
    C = light.n_op_channel
    shapes = dict(pad_n=segs.size, n_op_channel=C, n_ticks=n_ticks,
                  conv_ticks=conv_ticks,
                  fft_len=1 << math.ceil(math.log2(n_ticks + conv_ticks)),
                  nprof=lut.time_dist.shape[4],
                  pad_front=int(math.ceil(light.light_trig_window[0]
                                          / light.light_tick_size)),
                  digit_samples=light_model.digit_samples(light))
    noise = torch.tensor(make_light_noise(C), dtype=torch.float32,
                         device=dev)
    return dict(light=light, lut=lut, segs=segs, n_det=n_det, vox=vox,
                op_channel=torch.arange(C, device=dev), noise=noise,
                shapes=shapes, generator=w['generator'],
                module_to_tpcs=w['det_model'].module_to_tpcs)


def causal_convolve_f32(signal: torch.Tensor,
                        kernel: torch.Tensor) -> torch.Tensor:
    """``ops.light.causal_convolve`` with float32 transforms."""
    import math
    n = signal.shape[-1]
    fft_len = 1 << math.ceil(math.log2(n + kernel.shape[-1] - 1))
    return torch.fft.irfft(torch.fft.rfft(signal, n=fft_len)
                           * torch.fft.rfft(kernel, n=fft_len),
                           n=fft_len)[..., :n]


def light_noise_f32(shape, light_det_noise, draw, light) -> torch.Tensor:
    """``ops.light.gen_light_detector_noise`` with the phases and the
    inverse transform in float32."""
    import math
    from ..ops import light as lo
    spectrum = lo.noise_spectrum(shape[1], light_det_noise, light)
    phase = (2 * math.pi) * draw.uniform(tuple(spectrum.shape))
    return lo.noise_from_spectrum(spectrum, phase, shape[1], light)


def trigger_scan(response: torch.Tensor, group_threshold: np.ndarray,
                 gmasks: np.ndarray, light) -> np.ndarray:
    """Mode 0's trigger tables of one (C, T) response, copied to the host
    (``ops.light.trigger_tables`` and the copy ``models.light`` makes)."""
    from ..models.light import _start_host_copy
    from ..ops import light as lo
    return _start_host_copy(list(lo.trigger_tables(
        response, group_threshold, gmasks, light)))()


def trigger_scan_args(lw: dict, response: torch.Tensor) -> tuple:
    """The scan's inputs for the module's every channel."""
    from ..ops import light as lo
    light = lw['light']
    op = lo.host_array(light.tpc_to_op_channel).ravel()
    modules = lw['module_to_tpcs']
    t2m = {t: m for m, tpcs in modules.items() for t in tpcs}
    gmasks, _ = lo.mode0_module_masks(op, light, modules, t2m)
    return (response, lo.mode0_group_threshold(op, light), gmasks, light)


def light_op_calls(lw: dict) -> dict:
    """Each light op as (function, args, kwargs), with its inputs made by
    running the ops before it once (LUT smearing on)."""
    from ..models.light import generator_draw
    from ..ops import light as lo
    light, lut, sh = lw['light'], lw['lut'], lw['shapes']
    dev = lw['n_det'].device
    draw = generator_draw(lw['generator'], dev)
    conv = dict(conv_ticks=sh['conv_ticks'])
    sum_args = (lw['segs'], lw['vox'], lw['n_det'], lw['op_channel'],
                lut.time_dist, lut.t0_avg, 0.0, light)
    inc = lo.sum_light_signals(*sum_args, n_ticks=sh['n_ticks'],
                               lut_smearing=True)
    scint = lo.calc_scintillation_effect(inc, light, **conv)
    disc = lo.calc_stat_fluctuations(scint, draw, light)
    gains = light.light_gain[lw['op_channel']]
    resp = lo.calc_light_detector_response(disc, gains, light, **conv)
    signal = torch.nn.functional.pad(resp, (sh['pad_front'], 0))
    trig = torch.tensor([sh['pad_front']], device=dev)
    ctk = sh['conv_ticks']
    return dict(
        light_sum_t0avg=(lo.sum_light_signals, sum_args,
                         dict(n_ticks=sh['n_ticks'], lut_smearing=False)),
        light_sum_smearing=(lo.sum_light_signals, sum_args,
                            dict(n_ticks=sh['n_ticks'], lut_smearing=True)),
        light_scintillation=(lo.calc_scintillation_effect, (inc, light),
                             conv),
        light_stat=(lo.calc_stat_fluctuations, (scint, draw, light), {}),
        light_sipm=(lo.calc_light_detector_response, (disc, gains, light),
                    conv),
        light_noise=(lo.gen_light_detector_noise,
                     (tuple(signal.shape), lw['noise'], draw, light), {}),
        light_digitize=(lo.digitize_signal, (signal, trig, light),
                        dict(digit_samples=sh['digit_samples'])),
        light_trigger_scan=(trigger_scan, trigger_scan_args(lw, resp), {}),
        light_scintillation_f32=(
            lambda x: causal_convolve_f32(
                x, lo.scintillation_kernel(light, ctk)), (inc,), {}),
        light_sipm_f32=(
            lambda x: gains[:, None] * causal_convolve_f32(
                x, lo.sipm_kernel(light, ctk)), (disc,), {}),
        light_noise_f32=(light_noise_f32,
                         (tuple(signal.shape), lw['noise'], draw, light), {}))


def light_op_costs(lw: dict) -> dict:
    """Bytes each light op must move: its inputs read once (of the LUT, the
    entries the batch gathers; of the signal, the samples the digitizer
    interpolates) and its output written once.  The draws are made inside
    the ops and not counted, so those bounds are lower bounds."""
    sh = lw['shapes']
    S, C, T = sh['pad_n'], sh['n_op_channel'], sh['n_ticks']
    series = C * T * 4
    segs_in = S * 4 + S * 3 * 8 + S * C * 4 + C * 8    # t0, voxels, photons
    costs = dict(
        light_sum_t0avg=dict(bytes=segs_in + S * C * 4 + series, ops=0),
        light_sum_smearing=dict(bytes=segs_in + S * C * sh['nprof'] * 4
                                + series, ops=0),
        light_scintillation=dict(bytes=2 * series, ops=0),
        light_stat=dict(bytes=2 * series, ops=0),
        light_sipm=dict(bytes=2 * series + C * 4, ops=0),
        light_noise=dict(bytes=nbytes(lw['noise'])
                         + C * (T + sh['pad_front']) * 4, ops=0),
        light_digitize=dict(bytes=3 * C * sh['digit_samples'] * 4, ops=0),
        # the response read once, thresholds and group masks in, the
        # (M, max_trig) ticks and (M,) counts out
        light_trigger_scan=dict(bytes=series + scan_io_bytes(lw), ops=0))
    for name in ('light_scintillation', 'light_sipm', 'light_noise'):
        costs[name + '_f32'] = costs[name]
    return costs


def scan_io_bytes(lw: dict) -> int:
    """Bytes of the trigger scan's small inputs and outputs."""
    from ..ops import light as lo
    sh, light = lw['shapes'], lw['light']
    _, _, gmasks, _ = trigger_scan_args(lw, None)
    n_grp, M = gmasks.shape[1], gmasks.shape[0]
    max_trig = sh['n_ticks'] // max(lo.digit_ticks(light), 1) + 1
    return n_grp * 4 + gmasks.size + M * (max_trig + 1) * 4


def _group_inputs(lw: dict, n_events: int) -> tuple:
    """The guard's light batch cut into ``n_events`` events of equal size:
    (stacked segments, (G, S/G, C) photons, (G, S/G, 3) voxels)."""
    from ..segments import Segments
    segs = lw['segs']
    G = n_events
    return (Segments(**{f.name: getattr(segs, f.name).view(G, -1)
                        for f in dataclasses.fields(segs)}),
            lw['n_det'].view(G, -1, lw['n_det'].shape[-1]),
            lw['vox'].view(G, -1, 3))


def light_group_calls(lw: dict, sim, n_events: int = N_GROUP) -> dict:
    """The beam stage of ``n_events`` events as one group call and as
    ``n_events`` solo calls, each event with draws of its own generator
    (the groups's and the solo calls' generators seeded alike)."""
    from ..models import light as lm
    sim = dataclasses.replace(sim, max_mc_truth_ids=0)
    light = lw['light'].replace(enable_lut_smearing=True)
    segs_g, n_det_g, vox_g = _group_inputs(lw, n_events)
    dev = n_det_g.device
    gens = [torch.Generator(dev).manual_seed(100 + g)
            for g in range(n_events)]
    args = (light, sim)
    tail = (lw['lut'], lw['noise'])

    def group():
        return lm.simulate_light_group(
            segs_g, *args, n_det_g, vox_g, *tail,
            [lm.generator_draw(gen, dev) for gen in gens])

    def solo():
        return [lm.simulate_light_batch(
            segs_g.event(g), *args, n_det_g[g], vox_g[g], *tail,
            lm.generator_draw(gens[g], dev)) for g in range(n_events)]
    return dict(light_group_beam=(group, (), {}),
                light_solo_beam_x4=(solo, (), {}))


def light_group_costs(lw: dict, n_events: int = N_GROUP) -> dict:
    """Bytes of the beam stage, each event's light ops' bytes (as
    :func:`light_op_costs` counts them at S / G segments) summed over the
    events; the same for the group call and the solo calls."""
    sh = lw['shapes']
    per_event = light_op_costs(dict(
        lw, shapes=dict(sh, pad_n=sh['pad_n'] // n_events)))
    chain = ('light_sum_smearing', 'light_scintillation', 'light_stat',
             'light_sipm', 'light_noise', 'light_digitize')
    n_bytes = n_events * sum(per_event[k]['bytes'] for k in chain)
    return dict(light_group_beam=dict(bytes=n_bytes, ops=0),
                light_solo_beam_x4=dict(bytes=n_bytes, ops=0))


def light_truth_calls(lw: dict, k_truth: int = TRUTH_K) -> tuple:
    """The LUT-smearing truth of the guard's batch, each stage as
    (function, args, kwargs), with its inputs made by running the stages
    before it once: (device calls, host calls, shapes)."""
    from ..models import light as lm
    from ..ops import f32
    from ..ops import light as lo
    light, lut, sh = lw['light'], lw['lut'], lw['shapes']
    dev = lw['n_det'].device
    n_ticks, S = sh['n_ticks'], sh['digit_samples']
    post = int(np.ceil(light.light_trig_window[1] / light.light_tick_size))
    pad_back = max(post - n_ticks, 0)
    T = lm._transfer_table_host(light, sh['conv_ticks'], n_ticks, S,
                                sh['pad_front'],
                                n_ticks + sh['pad_front'] + pad_back)
    table = lm._device_table(T, dev)
    series_args = (lw['segs'], lw['vox'], lw['n_det'], lw['op_channel'],
                   lut.time_dist, 0.0, light)
    series_kw = dict(n_ticks=n_ticks, k_truth=k_truth)
    ids, series = lo.light_truth_series(*series_args, **series_kw)
    C, K = ids.shape
    rows = series.view(C * K, n_ticks)
    tw = f32.matmul(rows, table).view(C, K, 1, S).permute(
        2, 0, 3, 1).contiguous()
    op_host = lw['op_channel'].cpu().numpy()
    sel = [t.cpu().numpy() for t in lo.light_truth_select(
        lw['segs'], lw['vox'], lw['n_det'], k_truth=k_truth)]
    host_args = (*sel, lut.time_dist_host, op_host, light, TRUTH_THRESHOLD,
                 sh['conv_ticks'], n_ticks, S, sh['pad_front'], pad_back,
                 0.0)
    shapes = dict(pad_n=sh['pad_n'], n_op_channel=C, k_truth=K,
                  n_ticks=n_ticks, digit_samples=S,
                  threshold=TRUTH_THRESHOLD)
    return (dict(light_truth_series=(lo.light_truth_series, series_args,
                                     series_kw),
                 light_truth_product=(f32.matmul, (rows, table), {}),
                 light_truth_pull=(lm._pull_dense_truth,
                                   (ids, tw, op_host, TRUTH_THRESHOLD), {})),
            dict(light_truth_host=(lm._host_smeared_truth_sparse, host_args,
                                   dict(as_records=True)),
                 light_truth_host_plain=(host_truth_plain, host_args,
                                         dict(as_records=True))),
            shapes)


def host_truth_plain(*args, **kw):
    """``models.light._host_smeared_truth_sparse`` with the records of
    ``models.truth_emit.records_plain`` (the numpy emitter) in place of the
    native emitter's."""
    from ..models import light as lm
    from ..models import truth_emit
    native = truth_emit.records
    truth_emit.records = truth_emit.records_plain
    try:
        return lm._host_smeared_truth_sparse(*args, **kw)
    finally:
        truth_emit.records = native


def light_truth_costs(calls: dict, n_records: int) -> dict:
    """Bytes and operations of the truth stages on this run's inputs.

    series: its dense (C x K, n_ticks) float32 output written once and the
    profiles it gathers read once (the zero fill the scatter-add needs
    first is the implementation's, not counted).
    product: series and table read once, (C x K, S) written once; one
    multiply-add per (row, tick, sample), at the FMA rate (one instruction
    each, :data:`F32_OPS_PER_S`).  pull: the (1, C, S, K) truth and the ids read
    once, each kept record's flat index and value (12 bytes) written once;
    its device-to-host copy is not in the bound.
    """
    ids, tw = calls['light_truth_pull'][1][:2]
    rows, table = calls['light_truth_product'][1]
    R, n_ticks = rows.shape
    S = table.shape[1]
    nprof = calls['light_truth_series'][1][4].shape[-1]
    return dict(
        light_truth_series=dict(bytes=nbytes(rows) + R * nprof * 4,
                                ops=0),
        light_truth_product=dict(bytes=nbytes(rows, table) + R * S * 4,
                                 ops=R * n_ticks * S),
        light_truth_pull=dict(bytes=nbytes(ids, tw) + 12 * n_records,
                              ops=0))


def host_timed(fn, *args, reps: int = REPS, **kw) -> Timing:
    """Host wall time of ``fn(*args, **kw)``: one warm-up call, then
    ``reps`` timed calls; minimum and mean in ms."""
    fn(*args, **kw)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args, **kw)
        times.append((time.perf_counter() - t0) * 1e3)
    return Timing(min(times), sum(times) / len(times))


def op_calls(w: dict) -> dict:
    """Each guarded op as (function, args, kwargs), with its inputs made by
    running the ops before it once."""
    from ..ops import accumulate, current, fee
    det, sim, st = w['det'], w['sim'], w['stage']
    gen = w['generator']
    dev = det.device
    U, m = st.n_unique_cap, sim.max_adc_values
    signals = current.induced_current(*w['k1_args'])
    n_scan = fee.scan_ticks(det)
    sum_args = (signals, st.pix_idx, st.track_starts, U)
    sum_kw = dict(n_ticks=det.time_ticks, time_sampling=det.time_sampling,
                  rows=n_scan)
    # the FSM's rows as D1 writes them on the chain
    sig_rows = accumulate.sum_pixel_signals(*sum_args, **sum_kw,
                                            csr=st.csr)
    s = fee.fsm_scalars(det, max_adc=m)
    thresholds = torch.full((U,), det.f32('discrimination_threshold'),
                            device=dev)
    times = fee.tick_times(det)
    noise = torch.randn((n_scan, 5, U), generator=gen, device=dev)
    q_init = torch.randn((U,), generator=gen, device=dev) * s.sigma_reset
    fsm_args = (sig_rows, noise, q_init, thresholds, times, s)
    fee_res = fee.FeeResult(*fee.fee_fsm(*fsm_args))
    d2_args = (signals, st.pix_idx, st.slot, st.track_starts, fee_res, det)
    d2_kw = dict(max_adc=m, max_tracks=sim.max_tracks_per_pixel,
                 n_adc_scan=N_ADC_SCAN)
    return dict(
        induced_current=(current.induced_current, w['k1_args'], {}),
        sum_pixel_signals_with_csr=(accumulate.sum_pixel_signals, sum_args,
                                    sum_kw),
        sum_pixel_signals_kernel=(accumulate.sum_pixel_signals, sum_args,
                                  dict(sum_kw, csr=st.csr)),
        fee_fsm=(fee.fee_fsm, fsm_args, {}),
        get_adc_values_rows=(fee.get_adc_values_rows,
                             (sig_rows, times, thresholds, det),
                             dict(max_adc=m, generator=gen)),
        current_fractions_4_with_csr=(fee.current_fractions, d2_args, d2_kw),
        current_fractions_4_kernel=(fee.current_fractions, d2_args,
                                    dict(d2_kw, csr=st.csr)),
        digitize=(fee.digitize, (fee_res.integrals, det), {}))


def op_costs(w: dict, calls: dict) -> dict:
    """Bytes and operations of each guarded op on this run's inputs."""
    det, sim, st = w['det'], w['sim'], w['stage']
    U, m = st.n_unique_cap, sim.max_adc_values
    d1_row, d2_row = CHAIN_ROWS.values()
    signals = calls[d1_row][1][0]
    sig_rows = calls['fee_fsm'][1][0]
    n_scan, n_times = sig_rows.shape[0], calls['fee_fsm'][1][4].shape[0]
    d2_args = calls[d2_row][1]
    costs = {
        'induced_current': k1_costs(w['k1_args']),
        d1_row: sum_costs(signals, st.pix_idx, st.track_starts, U,
                          det.time_ticks, det.time_sampling, rows=n_scan),
        'fee_fsm': fsm_costs(n_scan, U, m, n_times, drawn=False),
        'get_adc_values_rows': fsm_costs(n_scan, U, m, n_times, drawn=True),
        d2_row: fraction_costs(
            *d2_args[:4], d2_args[4].reset_start, d2_args[4].latch_end,
            sim.max_tracks_per_pixel, N_ADC_SCAN, det.time_sampling),
        'digitize': dict(bytes=2 * U * m * 4, ops=DIGITIZE_OPS * U * m)}
    # a kernel alone does the function's work: the same bound
    costs.update({k: costs[row] for row, k in KERNEL_ROWS.items()})
    return costs


def launches_per_batch(w: dict) -> dict:
    """Kernel launches of one ``simulate_charge_batch`` on the guard's
    batch (counters reset before it, read after it)."""
    from ..kernels import binding
    from ..models.charge import generator_draw, simulate_charge_batch
    dev = w['det'].device
    binding.reset_launches()
    simulate_charge_batch(w['segs'], w['det_model'], w['sim'],
                          generator_draw(w['generator'], dev), w['response'])
    torch.cuda.synchronize()
    return dict(binding.launches)


def regressions(entry: dict, log_path: str) -> list[str]:
    """Ops slower than REGRESSION_FACTOR x the median of their last three
    logged runs at the same shapes on the same card."""
    prior: dict[str, list] = {}
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if (e.get('shapes') == entry['shapes']
                        and e.get('card') == entry['card']):
                    for k, v in e.get('ops_ms', {}).items():
                        prior.setdefault(k, []).append(v['min_ms'])
    warnings = []
    for k, v in entry['ops_ms'].items():
        hist = prior.get(k, [])[-3:]
        if hist:
            ref_ms = sorted(hist)[len(hist) // 2]
            if v['min_ms'] > ref_ms * REGRESSION_FACTOR:
                warnings.append(f'{k} regressed: {v["min_ms"]:.3f} ms vs '
                                f'median {ref_ms:.3f} ms of the last '
                                f'{len(hist)} runs')
    return warnings


def _git_rev() -> str:
    try:
        return subprocess.run(
            ['git', 'rev-parse', '--short', 'HEAD'], capture_output=True,
            text=True, timeout=30,
            cwd=os.path.dirname(BUILD_DIR)).stdout.strip() or 'unknown'
    except (OSError, subprocess.SubprocessError):
        return 'unknown'


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--log', default=LOG_PATH,
                    help='JSON-lines log to append to and compare with')
    ap.add_argument('--config', default='module0', choices=sorted(CONFIGS),
                    help='the workload: the Module-0-shaped tree with light '
                    '(default) or the ND-LAr-shaped tree, charge only')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('perf_guard times the card: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    workload, detector = CONFIGS[opts.config]
    light = opts.config == 'module0'
    with tempfile.TemporaryDirectory() as tmp:
        w = build_workload(dev, tmp, workload=workload, config=opts.config)
        lw = build_light_workload(w) if light else None
    launches = launches_per_batch(w)
    calls = op_calls(w)
    costs = op_costs(w, calls)
    host_calls, extra = {}, {}
    if light:
        calls.update(light_op_calls(lw))
        costs.update(light_op_costs(lw))
        calls.update(light_group_calls(lw, w['sim']))
        costs.update(light_group_costs(lw))
        truth_calls, host_calls, truth_shapes = light_truth_calls(lw)
        calls.update(truth_calls)
        n_records = len(truth_calls['light_truth_pull'][0](
            *truth_calls['light_truth_pull'][1])['tick'])
        costs.update(light_truth_costs(truth_calls, n_records))
        extra = dict(light_shapes=lw['shapes'],
                     group_shapes=dict(events=N_GROUP,
                                       pad_n=lw['shapes']['pad_n']
                                       // N_GROUP),
                     truth_shapes=dict(truth_shapes, records=n_records))
    ops_ms = {}
    for name, (fn, args, kw) in calls.items():
        t = (timed_queued if name in KERNEL_ROWS.values() else timed)(
            fn, *args, **kw)
        ops_ms[name] = dict(min_ms=t.min_ms, mean_ms=t.mean_ms)
    host_ms = {}
    for name, (fn, args, kw) in host_calls.items():
        t = host_timed(fn, *args, **kw)
        host_ms[name] = dict(min_ms=t.min_ms, mean_ms=t.mean_ms)
    roofline = {name: bound(c['bytes'], c['ops'], ops_ms[name]['min_ms'])
                for name, c in costs.items()}
    c = card()
    entry = dict(
        ts=round(time.time(), 1), rev=_git_rev(), card=c['name'],
        smi=c['smi'], config=opts.config,
        workload=dict(workload, pad_n=PAD_N, segments=w['n_segments'],
                      detector=detector, time_ticks=w['det'].time_ticks),
        shapes=w['shapes'], **extra,
        logged_shapes=LOGGED_SHAPES, ops_ms=ops_ms, host_ms=host_ms,
        roofline=roofline,
        kernels={name: dict(launches_per_batch=launches[name],
                            library_ms=None, library=LIBRARY[name])
                 for name in ('induced_current', 'fee_fsm')})
    for name, r in chain_kernel_rows(calls).items():
        entry['kernels'][name] = dict(launches_per_batch=launches[name],
                                      library=LIBRARY[name], **r)
    from ..kernels import binding
    entry['kernels']['induced_current']['tiling'] = \
        binding.induced_current_tiling(*w['k1_args'])[1]
    warnings = regressions(entry, opts.log)
    entry['status'] = 'regressed' if warnings else 'ok'
    for msg in warnings:
        print(f'WARN: {msg}', file=sys.stderr)
    for name, r in roofline.items():
        print(f'guard {name:>20}: {ops_ms[name]["min_ms"]:9.3f} ms min '
              f'({ops_ms[name]["mean_ms"]:.3f} mean), bound '
              f'{r["bound_ms"]:.4f} ms by {r["bound_by"]}, share '
              f'{r["share"]:.4f}  [{c["smi"]}]', flush=True)
    for name, k in entry['kernels'].items():
        if 'plain_ms' in k:
            lib = 'none' if k['library_ms'] is None else \
                f'{k["library_ms"]:.3f} ms'
            print(f'guard {k["row"]:>20}: plain version {k["plain_ms"]:9.3f}'
                  f' ms min, library call {lib}  [{c["smi"]}]', flush=True)
    for name, t in host_ms.items():
        print(f'guard {name:>20}: {t["min_ms"]:9.3f} ms min '
              f'({t["mean_ms"]:.3f} mean), host wall, no bound  '
              f'[{c["smi"]}]', flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(opts.log)), exist_ok=True)
    with open(opts.log, 'a') as f:
        f.write(json.dumps(entry) + '\n')
    print(json.dumps(entry), flush=True)
    return entry


if __name__ == '__main__':
    main()
    sys.exit(0)
