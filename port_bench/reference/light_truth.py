"""The benchmark's reference of the light truth: larnd-sim's backtracking
of the beam-triggered light (``light_sim.py``'s truth of each ADC sample,
written as the records of ``light_wvfm_mc_assn``) for every (spill,
module) of an input file.

For each module's beam trigger (the light rows of ``reference/light.py``:
an event's first batch with segments) and each of its channels: the K
segments (``max_light_truth_ids``) of most detected photons on the
channel; each one's expected arrival series over the 1 ns ticks of the
window, its LUT time profile placed as ``light.arrival_series`` places
it, with no Poisson draw and no noise; the singlet / triplet
scintillation and the SiPM's RLC response, without the channel's gain
(larnd-sim's truth carries none), convolved as ``light.convolve``
convolves the waveform; the padding around the trigger's window and the
ADC's interpolation onto its samples, with no quantisation; and a record
(trigger, channel, sample, event, segment, value) for each value whose
magnitude passes ``mc_truth_threshold``.

What it shares with the program: the input file, the YAMLs and the LUT
files.  No random stream enters the truth.

Behaviours of the program, and of larnd-sim's CLI as the JAX package's
copy of it writes them, reproduced here:

- with module variation every module is simulated on the first module's
  channel ids, and its records carry those ids (0-95 on the 2x2), not its
  own channels'; a record's module is its segment's;
- trigger ids count a module's triggering rows from 0 in each module's
  pass; a row of zeros (a spill in which the module holds no segment)
  takes no id and has no records;
- a record's event id is its spill's.

Departures from ``light_sim.py``, each the program's too:

- top K a channel, not a tick: larnd-sim keeps, at each (channel, tick),
  the K segments of most light there and follows those slots through
  each stage; here each channel's K segments of most detected photons
  over the window are followed through every sample;
- the linear chain: larnd-sim drops increments below the threshold
  inside each stage (the scintillation's, the SiPM's, and a sample whose
  left tick is below it); here only the final value is held to it;
- ties between equal photon counts go to the segment that comes first in
  the batch (a stable sort);
- the convolutions are FFT convolutions in float64 at a power-of-two
  length (``light.convolve``), where larnd-sim sums them directly in
  float32.

Arithmetic: float32 where larnd-sim's is (the series, the taps, the
interpolation), float64 where the program's is (the convolutions).  The
series and the convolutions run in blocks of channels, so that a
trigger's (channels x K, ticks) series is never whole on the device.

``precision='bf16'`` sums each contributor's series in bfloat16: the
control, a precision below the chain's float32.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import yaml

from . import charge, light
from .light import F32, recip

#: ``light_wvfm_mc_assn``'s records
RECORD = np.dtype([('trigger_id', 'i4'), ('op_channel_id', 'i4'),
                   ('tick', 'i4'), ('event_id', 'i4'), ('segment_id', 'i8'),
                   ('pe_current', 'f8')])
#: larnd-sim's defaults of the truth keys of a simulation YAML
SIM_DEFAULTS = dict(max_light_truth_ids=0, mc_truth_threshold=0.1)
#: contributor rows (channels x K) a block of the chain holds at most
BLOCK_ROWS = 512


def truth_keys(sim_yaml: str) -> tuple[int, float]:
    """(K, threshold [pe/us]) of a simulation YAML; K 0: no truth."""
    with open(sim_yaml) as f:
        sim = yaml.safe_load(f) or {}
    return (int(sim.get('max_light_truth_ids',
                        SIM_DEFAULTS['max_light_truth_ids'])),
            float(sim.get('mc_truth_threshold',
                          SIM_DEFAULTS['mc_truth_threshold'])))


def contributors(n_det: torch.Tensor, k: int):
    """Each channel's ``k`` segments of most detected photons among the
    batch's (segments, channels) ``n_det``: (rows (k, C) into the batch,
    photons (k, C), has (k, C): photons > 0)."""
    order = torch.argsort(-n_det, dim=0, stable=True)[:min(k, len(n_det))]
    photons = torch.gather(n_det, 0, order)
    return order, photons, photons > 0


def series(t0, photons, has, vox, time_dist, cols, light_keys, n_ticks: int,
           precision: str) -> torch.Tensor:
    """(C x K, ticks) photons a us of each contributor (row ``c * K +
    k``): its photons spread over its voxel's time profile of channel
    column ``cols[c]`` (bin ``b`` arriving ``b`` ns after the segment's
    time), summed on the tick each bin falls on; a bin on a tick's edge
    goes to the tick it closes.  ``t0``, ``photons``, ``has``: (K, C);
    ``vox``: (K, C, 3)."""
    dev = photons.device
    tick = light_keys.c['light_tick_size']
    K, C = photons.shape
    prof = time_dist[vox[..., 0], vox[..., 1], vox[..., 2], cols[None, :]]
    n_prof = prof.shape[-1]
    t = t0[..., None] + torch.arange(n_prof, dtype=F32, device=dev) * 1e-3
    at = t * recip(tick)
    itick = torch.ceil(at).to(torch.int32) - 1
    ok = (at > itick) & (itick >= 0) & (itick < n_ticks) & has[..., None]
    rate = (photons[..., None] * prof) * recip(tick)          # (K, C, bins)
    row = (torch.arange(C, device=dev)[None, :] * K
           + torch.arange(K, device=dev)[:, None])            # (K, C)
    at_row = row[..., None].long() * n_ticks + itick.long()
    dtype = torch.bfloat16 if precision == 'bf16' else F32
    out = torch.zeros(C * K * n_ticks, dtype=dtype, device=dev)
    out.index_add_(0, at_row[ok], rate[ok].to(dtype))
    return out.float().view(C * K, n_ticks)


def sample(signal: torch.Tensor, light_keys) -> torch.Tensor:
    """The beam trigger's ADC samples of the padded ``signal``, each
    interpolated between the two ticks about it (none past the last but
    one tick), not quantised: ``light.digitize`` without its rounding."""
    c = light_keys.c
    n = signal.shape[-1]
    m = light_keys.digit_samples()
    at = torch.arange(m, dtype=F32, device=signal.device) * (
        c['light_digit_sample_spacing'] / c['light_tick_size'])
    i0 = torch.floor(at).to(torch.int32)
    frac = at - i0
    v0 = torch.where((i0 >= 0) & (i0 <= n - 1),
                     signal[:, i0.clamp(0, n - 1).long()], 0.0)
    v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= n - 1),
                     signal[:, (i0 + 1).clamp(0, n - 1).long()], 0.0)
    return torch.where(i0 > n - 2, 0.0, v0 + (v1 - v0) * frac)


def trigger_records(t0, n_det, vox, segment_ids: np.ndarray, time_dist,
                    simulated: np.ndarray, light_keys, k: int,
                    threshold: float, *, trigger_id: int, event: int,
                    precision: str = 'float32') -> np.ndarray:
    """The records of one beam trigger of a batch's segments: their times
    ``t0``, (segments, channels) detected photons ``n_det``, voxels
    ``vox`` and ids ``segment_ids``, the channels simulated on the ids
    ``simulated``; in (channel, sample, contributor) order."""
    dev = n_det.device
    n_ticks, conv = light_keys.window()
    scint = light.scintillation_taps(light_keys, conv + 1)
    sipm = light.sipm_taps(light_keys, conv + 1)
    front, back = light_keys.pads(n_ticks)
    order, photons, has = contributors(n_det, k)
    K, C = photons.shape
    if K == 0:
        return np.zeros(0, RECORD)
    t0_k = t0[order]
    vox_k = vox[order]                                        # (K, C, 3)
    cols = torch.from_numpy(simulated % time_dist.shape[3]).to(dev)
    ids = np.where(has.cpu().numpy(), segment_ids[order.cpu().numpy()], -1)
    step = max(BLOCK_ROWS // K, 1)
    out = []
    for c0 in range(0, C, step):
        cs = slice(c0, min(c0 + step, C))
        s = series(t0_k[:, cs], photons[:, cs], has[:, cs], vox_k[:, cs],
                   time_dist, cols[cs], light_keys, n_ticks, precision)
        s = light.convolve(light.convolve(s, scint), sipm)
        s = torch.nn.functional.pad(s, (front, back))
        v = sample(s, light_keys).cpu().numpy()          # (Cb * K, samples)
        nb = v.shape[0] // K
        v = v.reshape(nb, K, -1).transpose(0, 2, 1)      # (Cb, samples, K)
        c, tick, kk = np.nonzero((np.abs(v) > threshold)
                                 & (ids[:, cs].T[:, None, :] >= 0))
        rec = np.zeros(len(c), RECORD)
        rec['trigger_id'] = trigger_id
        rec['op_channel_id'] = simulated[c0 + c]
        rec['tick'] = tick
        rec['event_id'] = event
        rec['segment_id'] = ids[kk, c0 + c]
        rec['pe_current'] = v[c, tick, kk]
        out.append(rec)
    return np.concatenate(out)


def run(tracks: np.ndarray, mods: list, files: dict, run_keys: dict,
        device, precision: str = 'float32', log=None) -> list:
    """The light truth of every (spill, module) of an input's segments
    (``charge.read_segments``) for the charge passes ``mods``: for each
    light pass, its triggers in the program's order as (event, trigger
    id, records)."""
    if precision not in light.PRECISIONS:
        raise ValueError(f'precision {precision!r}: one of '
                         f'{light.PRECISIONS}')
    k, threshold = truth_keys(files['simulation_properties'])
    keys = light.load(files['detector_properties'])
    calls, groups = charge.plan(tracks, mods)
    t0_all = torch.from_numpy(np.ascontiguousarray(tracks['t0'], np.float32))
    segment_ids = np.asarray(tracks['segment_id'], np.int64)
    out = []
    for p in light.passes(files, run_keys, mods, keys):
        t_pass = time.perf_counter()
        det = p.mod.det
        lut = light.read_lut(p.lut_path, device)
        seg = charge.quench_and_drift(tracks, det, device)
        vox = light.voxels(seg, det, lut['vis'].shape[:3])
        n_det = light.detected(seg, light.photons(tracks, det, device), vox,
                               keys, p, lut['vis'])
        t0 = t0_all.to(device)
        made = []
        for ev, rows in light.batches(tracks, calls, groups, p):
            if rows is None or k <= 0:
                continue
            take = torch.from_numpy(rows).to(device)
            made.append((ev, len(made), trigger_records(
                t0[take], n_det[take], vox[take], segment_ids[rows],
                lut['time_dist'], p.simulated, keys, k, threshold,
                trigger_id=len(made), event=ev, precision=precision)))
        out.append(made)
        if log:
            log(f'[reference] light truth of module {p.mod.i_mod}: '
                f'{len(made)} triggers, '
                f'{sum(len(r) for *_, r in made)} records, '
                f'{time.perf_counter() - t_pass:.3f} s')
    return out
