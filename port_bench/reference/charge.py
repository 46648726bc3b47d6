"""The benchmark's reference of the charge readout: larnd-sim's charge
chain written plainly for a few (spill, TPC group) units of an input file.

For each unit it reads the input's segments, and quenches (Birks), drifts,
pixelises (the no-diagonal walk of each segment's anode projection, widened
by the diffusion radius), samples the charge along each diffused segment,
reads the pixel response table for every (point, pixel), sums each pixel's
waveform, runs the LArPix front end (discriminator, hold, reset, busy, with
its noise), digitises, and writes the data packets' words and their
backtracking fractions.  The arithmetic is float32 where larnd-sim's is,
so that its thresholds and tick roundings fall as the program's do; the
sums of the response and of the fractions are float64.

What it shares with the program: the input file, the configuration's
YAMLs and response tables, and the random streams that ``rand_seed``
defines.  The program draws each charge batch's normals from a generator
seeded from (rand_seed, module, event, batch number) in a fixed order and
in shapes its batching fixes (the diffusion smear (3, S, steps), the reset
noise (U,), the front end's noise (ticks, 5, U)); the reference makes the
same generator and draws the same shapes, from its own count of the
segments, steps and pixels.  Nothing of the program is imported.

A detector with module variation is simulated module by module, as
larnd-sim's module loop does (:func:`modules`): each module with its own
pixel layout, response and per-module constants (lifetime, field,
thresholds, response binning), over the segments inside its two TPCs, its
batches numbered from 1 and its draws keyed by its number.  Without
variation the whole detector is one pass, keyed as module 0.

``precision='bf16'`` rounds every (segment, pixel) current to bfloat16
before the pixel sum: the control, a precision below the chain's float32.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from . import detector
from .detector import MV, Detector

F32 = torch.float32
#: Birks' model (Amoruso et al., NIM A 523 (2004) 275) and the ionisation
#: work function [MeV]
BIRKS_AB, BIRKS_KB, W_ION, LAR_DENSITY = 0.800, 0.0486, 23.6e-6, 1.38
#: containment tolerance of a segment's TPC [cm]
TOLERANCE = 2e-2
#: the largest (dx + dy) pixel distance that backtracking keeps
MAX_DISTANCE = 4


def bucket(n: int, lo: int) -> int:
    """The power of two at or above ``n`` (and ``lo``): the program sizes
    a batch's axes so, and its random draws take those sizes."""
    return max(lo, 1 << max(0, math.ceil(math.log2(max(n, 1)))))


def generator(rand_seed: int, i_mod: int, event: int, seq: int, device):
    """The charge batch's generator: (rand_seed, its module, 0 for a
    detector without module variation (``i_mod`` -1), the batch's event,
    its number in its module's pass)."""
    seed = np.random.SeedSequence([rand_seed, max(i_mod, 0), int(event),
                                   seq])
    g = torch.Generator(device=device)
    return g.manual_seed(int(seed.generate_state(1)[0]))


@dataclasses.dataclass
class Module:
    """One pass of larnd-sim's module loop: the module's number (-1: the
    whole of a detector without module variation), its reading of the
    YAMLs, its response table and the TPCs it simulates."""
    i_mod: int
    det: Detector
    response: np.ndarray
    tpcs: tuple

    def tpc_groups(self) -> list[tuple]:
        """The TPCs of each of its (event, TPC group) batches' groups."""
        per = self.det.sim['event_batch_size']
        return [self.tpcs[i:i + per]
                for i in range(0, len(self.tpcs), per)] or [()]


def modules(files: dict, run: dict) -> list[Module]:
    """The module loop of a configuration's files (``assets.prepare``) and
    run keys: with ``run['mod2mod_variation']`` and more than one module,
    module ``m`` on the TPCs ``2m - 2`` and ``2m - 1`` with the pixel
    layout and response that ``run['pixel_layout_id']`` and
    ``run['response_id']`` pick for it (:func:`detector.of_module`), else
    one pass over every TPC with the one layout and response."""
    det_yaml, sim_yaml = (files['detector_properties'],
                          files['simulation_properties'])
    layouts, responses = files['pixel_layout'], files['response_file']
    ids = detector.module_ids(det_yaml)
    if not (run.get('mod2mod_variation') and len(ids) > 1):
        if isinstance(layouts, list) or isinstance(responses, list):
            raise ValueError('several layouts or responses without module '
                             'variation')
        det = detector.load(det_yaml, layouts, sim_yaml)
        return [Module(-1, det, np.load(responses), tuple(range(det.n_tpcs)))]
    out = []
    for m in ids:
        det = detector.load(det_yaml, detector.of_module(
            layouts, m, run.get('pixel_layout_id')), sim_yaml, i_module=m)
        out.append(Module(m, det, np.load(detector.of_module(
            responses, m, run.get('response_id'))),
            (2 * m - 2, 2 * m - 1)))
    return out


def _t(x, device):
    return torch.tensor(np.float32(x), dtype=F32, device=device)


# ------------------------------------------------------------------ input

def read_segments(path: str, det: Detector) -> np.ndarray:
    """The input's segments as the simulator takes them: times made
    spill-relative, x and z swapped into the drift frame, and only those
    with an end inside a TPC."""
    from .frozen.io.h5 import File
    with File(path, 'r') as f:
        tracks = np.array(f['segments'])
    sim = det.sim
    if sim['is_spill_sim']:
        ev = tracks['event_id']
        local = ev - (ev // sim['max_events_per_file']) \
            * sim['max_events_per_file']
        for name in ('t0_start', 't0_end', 't0'):
            tracks[name] = tracks[name] - local * sim['spill_period']
    for a, b in (('x_start', 'z_start'), ('x_end', 'z_end'), ('x', 'z')):
        tracks[a], tracks[b] = tracks[b].copy(), tracks[a].copy()
    return tracks[inside_any(tracks, det.borders)]


def inside_any(tracks, borders) -> np.ndarray:
    """Segments with an end strictly inside one of the boxes."""
    b = np.sort(borders, axis=-1)
    out = np.zeros(len(tracks), bool)
    for box in b:
        for end in ('_start', '_end'):
            out |= np.all([(tracks[c + end] > box[k, 0])
                           & (tracks[c + end] < box[k, 1])
                           for k, c in enumerate('xyz')], axis=0)
    return out


def units_of(tracks: np.ndarray, det: Detector,
             tpcs=None) -> list[tuple]:
    """The program's charge calls of a pass over the TPCs ``tpcs`` (all by
    default), in its order: (event, TPC group, rows, batch number), the
    groups and batches counted within the pass; a unit (event, group) of
    more than ``batch_size`` segments is cut into calls of that many.  A
    segment belongs to the first group with an end inside one of its
    TPCs; rows index ``tracks``."""
    sim = det.sim
    per = sim['event_batch_size']
    tpcs = range(det.n_tpcs) if tpcs is None else tpcs
    n_groups = max(math.ceil(len(tpcs) / per), 1)
    b = np.sort(det.borders, axis=-1)
    group = np.full(len(tracks), n_groups, np.int64)
    for i, tpc in enumerate(tpcs):
        inside = np.zeros(len(tracks), bool)
        for end in ('_start', '_end'):
            inside |= np.all([(tracks[c + end] > b[tpc, k, 0])
                              & (tracks[c + end] < b[tpc, k, 1])
                              for k, c in enumerate('xyz')], axis=0)
        group[inside] = np.minimum(group[inside], i // per)
    # the units in (event, group) order, each unit's rows in file order
    events, ev_index = np.unique(tracks['event_id'], return_inverse=True)
    key = np.where(group < n_groups, ev_index * n_groups + group, -1)
    order = np.argsort(key, kind='stable')
    order = order[key[order] >= 0]
    keys, first = np.unique(key[order], return_index=True)
    calls, seq = [], 0
    for k, lo, hi in zip(keys, first, list(first[1:]) + [len(order)]):
        rows = order[lo:hi]
        for i0 in range(0, len(rows), sim['batch_size']):
            seq += 1
            calls.append((int(events[k // n_groups]), int(k % n_groups),
                          rows[i0:i0 + sim['batch_size']], seq))
    return calls


def plan(tracks: np.ndarray, mods: list) -> tuple[list, list]:
    """The program's charge calls over the module loop ``mods``
    (:func:`modules`), module by module: (event, group, rows, batch
    number), the groups numbered on across the modules; and each group's
    (module, TPCs)."""
    calls, groups = [], []
    for mod in mods:
        base = len(groups)
        calls += [(ev, base + g, rows, seq) for ev, g, rows, seq
                  in units_of(tracks, mod.det, mod.tpcs)]
        groups += [(mod, tpcs) for tpcs in mod.tpc_groups()]
    return calls, groups


# ------------------------------------------------- quenching and drifting

def quench_and_drift(tracks: np.ndarray, det: Detector, device) -> dict:
    """Electrons at the anode, diffusion widths, TPC and times of every
    segment, float32 on ``device``."""
    c = det.c
    col = {k: torch.from_numpy(np.ascontiguousarray(tracks[k], np.float32))
           .to(device) for k in ('x', 'y', 'z', 'x_start', 'y_start',
                                 'z_start', 'x_end', 'y_end', 'z_end', 'dE',
                                 'dEdx', 't', 't_start', 't_end', 't0',
                                 't0_start', 'dx')}
    e_field = _t(c['e_field'], device)
    recomb = (1 + BIRKS_KB * col['dEdx'] / (e_field * LAR_DENSITY))
    recomb = recomb.reciprocal() * BIRKS_AB
    electrons = recomb * col['dE'] / _t(W_ION, device)

    b = torch.tensor(det.borders, dtype=F32, device=device)
    inside = ((b[None, :, 0, 0] - TOLERANCE <= col['x'][:, None])
              & (col['x'][:, None] <= b[None, :, 0, 1] + TOLERANCE)
              & (b[None, :, 1, 0] - TOLERANCE <= col['y'][:, None])
              & (col['y'][:, None] <= b[None, :, 1, 1] + TOLERANCE)
              & (torch.minimum(b[:, 2, 0], b[:, 2, 1])[None] - TOLERANCE
                 <= col['z'][:, None])
              & (col['z'][:, None] <= torch.maximum(b[:, 2, 0], b[:, 2, 1])
                 [None] + TOLERANCE))
    in_tpc = inside.any(dim=1)
    plane = torch.where(in_tpc, inside.int().argmax(dim=1), -1)
    anode = b[plane.clamp(min=0), 2, 0]
    v = _t(c['v_drift'], device)
    t_drift = torch.abs(col['z'] - anode) / v
    z_lo = torch.minimum(col['z_start'], col['z_end'])
    z_hi = torch.maximum(col['z_start'], col['z_end'])
    d_a, d_b = torch.abs(z_lo - anode), torch.abs(z_hi - anode)
    out = dict(col)
    out.update(
        plane=plane,
        electrons=torch.where(in_tpc, electrons * torch.exp(
            -t_drift / _t(c['lifetime'], device)), electrons),
        long_diff=torch.where(in_tpc, torch.sqrt(
            t_drift * 2 * _t(c['long_diff'], device)), 0.0),
        tran_diff=torch.where(in_tpc, torch.sqrt(
            t_drift * 2 * _t(c['tran_diff'], device)), 0.0),
        t_start=torch.where(in_tpc, col['t_start'] + torch.minimum(d_a, d_b)
                            / v + col['t0'], col['t_start']),
        t_end=torch.where(in_tpc, col['t_end'] + torch.maximum(d_a, d_b) / v
                          + col['t0'], col['t_end']))
    return out


# ---------------------------------------------------------- pixelisation

def distance_code(dx: int, dy: int) -> int:
    """larnd-sim's backtracking distance code of a neighbour (dx, dy)
    pixels away, or -1 beyond the largest it keeps."""
    hi, lo = max(abs(dx), abs(dy)), min(abs(dx), abs(dy))
    s = hi + lo
    if s > MAX_DISTANCE:
        return -1
    if s <= 1:
        return s
    if s == 2:
        return 2 if hi == 1 else 3
    if s == 3:
        return 4 if hi == 2 else 5
    return {2: 6, 3: 7, 4: 8}[hi]


def segment_pixels(x0, y0, x1, y1, plane, radius, det) -> dict:
    """One segment's pixels: {pixel id: distance code of its first
    appearance}, walking its projection pixel by pixel (a step in x or in
    y, never both) and widening each step by ``radius``."""
    nx, ny = det.n_pixels
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx, sy = (1 if x0 < x1 else -1), (1 if y0 < y1 else -1)
    err, x, y = dx + dy, x0, y0
    out = {}
    for _ in range(dx - dy + 1):
        if 0 <= x < nx and 0 <= y < ny:
            for ox in range(-radius, radius + 1):
                for oy in range(-radius, radius + 1):
                    cx, cy = x + ox, y + oy
                    if 0 <= cx < nx and 0 <= cy < ny:
                        key = cx + nx * (cy + ny * plane)
                        if key not in out:
                            out[key] = distance_code(ox, oy)
        e2 = 2 * err
        if e2 - dy > dx - e2:
            err, x = err + dy, x + sx
        else:
            err, y = err + dx, y + sy
    return out


# ------------------------------------------------------------ one call

class Call:
    """One charge call of the program, recomputed: its hits, the pixels
    they are on, and each hit's segment fractions."""

    def __init__(self, seg: dict, rows: np.ndarray, det: Detector,
                 response: torch.Tensor, gen, precision: str):
        self.det, self.dev = det, response.device
        self.response = response
        c, sim = det.c, det.sim
        dev = self.dev
        S = len(rows)
        take = torch.from_numpy(rows).to(dev)
        s = {k: v[take] for k, v in seg.items()}
        host = {k: v.cpu().numpy() for k, v in s.items()}
        pitch = np.float32(c['pixel_pitch'])
        dt = c['time_sampling']

        # the batch's sizes, from its segments as the program sizes them
        radius = max(int(np.ceil(host['tran_diff'].max() * 5
                                 / c['pixel_pitch'])), 1)
        t_end = np.round((host['t_end'] + 1) / dt) * dt
        t_beg = np.round((host['t_start'] - c['time_padding']) / dt) * dt
        t_sig = bucket(int(np.ceil((t_end - t_beg).max() / dt)), 64)
        min_step = float(sim['min_step_size'])
        n_steps = bucket(int(np.ceil(np.max(host['dx']) / min_step))
                         * sim['mc_sample_multiplier'], 8)

        # pixels: each segment's, then the batch's, sorted
        b32 = det.borders.astype(np.float32)
        ok_seg = (host['plane'] >= 0)
        pl = np.clip(host['plane'], 0, None)
        ends = [np.floor((host[k] - b32[pl, a, 0]) / pitch).astype(np.int64)
                for k, a in (('x_start', 0), ('y_start', 1), ('x_end', 0),
                             ('y_end', 1))]
        per_seg = [segment_pixels(*(int(e[i]) for e in ends), int(pl[i]),
                                  radius, det) if ok_seg[i] else {}
                   for i in range(S)]
        uniq = np.array(sorted(set().union(*per_seg)), np.int64)
        self.pixels = uniq
        U = bucket(len(uniq), 32)
        rank = {int(p): u for u, p in enumerate(uniq)}
        entries = [(i, rank[p], code) for i, d in enumerate(per_seg)
                   for p, code in d.items()]
        ent = np.array(entries, np.int64).reshape(-1, 3)
        # backtracking: a pixel's segments by distance code, then index
        K = sim['max_tracks_per_pixel']
        self.tracks = np.full((len(uniq), K), -1, np.int64)
        slot = np.full(len(ent), -1, np.int64)
        order = np.lexsort((ent[:, 0], np.where(ent[:, 2] < 0, 15,
                                                ent[:, 2]), ent[:, 1]))
        n_seen = np.zeros(len(uniq), np.int64)
        for e in order:
            i, u, code = ent[e]
            if code >= 0 and n_seen[u] < K:
                self.tracks[u, n_seen[u]] = i
                slot[e] = n_seen[u]
            n_seen[u] += 1

        # the sampled charge: points along each diffused segment
        S_pad = bucket(S, 32)
        smear = torch.randn((3, S_pad, n_steps), generator=gen,
                            device=dev)[:, :S]
        signals = self._current(s, smear, n_steps, t_sig, min_step, ent,
                                precision)                    # (E, t_sig)
        # each segment's window starts at its readout tick: the start of
        # its signal, padded, rounded to the sampling
        dt_t = _t(dt, dev)
        starts = torch.round(torch.round(
            (s['t_start'] - _t(c['time_padding'], dev)) / dt_t) * dt_t
            / dt_t).long()
        n_ticks = det.ticks
        seg_of = torch.from_numpy(ent[:, 0]).to(dev)
        pix_of = torch.from_numpy(ent[:, 1]).to(dev)
        g = starts[seg_of][:, None] + torch.arange(t_sig, device=dev)
        keep = (g >= 0) & (g < n_ticks)
        wave = torch.zeros(U * n_ticks, dtype=torch.float64, device=dev)
        wave.index_add_(0, (pix_of[:, None] * n_ticks + g.clamp(0, n_ticks
                                                                - 1))[keep],
                        signals[keep])
        n_scan = det.scan_ticks()
        rows_ = torch.zeros((n_scan, U), dtype=F32, device=dev)
        rows_[:n_ticks] = wave.view(U, n_ticks).t().float()

        # the front end's draws; it runs over every call's lanes at once
        self.q_init = torch.randn((U,), generator=gen, device=dev)
        self.noise = torch.randn((n_scan, 5, U), generator=gen, device=dev)
        self.rows = rows_
        self._kept = dict(signals=signals, starts=starts, seg_of=seg_of,
                          slot=slot, ent=ent, t_sig=t_sig)
        self.segment_rows = rows

    def finish(self, fe: dict) -> None:
        """The hits of this call's lanes of the front end's output ``fe``:
        their ADC words, times and segment fractions."""
        c, dev = self.det.c, self.dev
        K = self.det.sim['max_tracks_per_pixel']
        dt = c['time_sampling']
        uniq = self.pixels
        k = self._kept
        signals, starts, seg_of = k['signals'], k['starts'], k['seg_of']
        slot, ent, t_sig = k['slot'], k['ent'], k['t_sig']
        self.n_adc = fe['n'][:len(uniq)].cpu().numpy()

        # fractions of each hit's charge by segment slot
        hits = [(u, a) for u in range(len(uniq))
                for a in range(int(self.n_adc[u]))]
        self.hits = np.array(hits, np.int64).reshape(-1, 2)
        frac = np.zeros((len(hits), K))
        if len(hits):
            A = math.exp(-dt / c['buffer_risetime'])
            hu = torch.from_numpy(self.hits[:, 0]).to(dev)
            ha = torch.from_numpy(self.hits[:, 1]).to(dev)
            # every (hit, entry of its pixel that holds a slot) pair
            held = np.nonzero(slot >= 0)[0]
            held = held[np.argsort(ent[held, 1], kind='stable')]
            first = np.searchsorted(ent[held, 1], np.arange(len(uniq) + 1))
            per = (first[1:] - first[:-1])[self.hits[:, 0]]
            ph = np.repeat(np.arange(len(hits)), per)
            pe = held[np.repeat(first[self.hits[:, 0]], per)
                      + np.arange(per.sum()) - np.repeat(np.cumsum(per)
                                                         - per, per)]
            r = fe['reset'][hu, ha].long()
            e = fe['latch'][hu, ha].long()
            num = torch.zeros((len(hits), K), dtype=torch.float64,
                              device=dev)
            for lo in range(0, len(ph), 8192):
                h = torch.from_numpy(ph[lo:lo + 8192]).to(dev)
                q = torch.from_numpy(pe[lo:lo + 8192]).to(dev)
                j = starts[seg_of[q]][:, None] + torch.arange(t_sig,
                                                              device=dev)
                w = torch.where((j >= r[h][:, None]) & (j <= e[h][:, None]),
                                dt * (1 - A ** (e[h][:, None] - j + 1)
                                      .double()), 0.0)
                num[h, torch.from_numpy(slot[pe[lo:lo + 8192]]).to(dev)] = \
                    (signals[q] * w).sum(dim=1)
            tot = num.sum(dim=1, keepdim=True)
            frac = torch.where(tot > 0, num / tot, 0.0).cpu().numpy()
        self.fractions = frac
        self.ticks_us = fe['ticks'][hu, ha].cpu().numpy() if len(hits) \
            else np.zeros(0, np.float32)
        integ = fe['integral'][hu, ha] if len(hits) \
            else torch.zeros(0, dtype=F32, device=dev)
        self.adc = self._digitize(integ).cpu().numpy()
        del self._kept, self.rows, self.noise, self.q_init

    def _current(self, s, smear, n_steps, t_sig, min_step, ent, precision):
        """Every (segment, pixel) entry's induced current over its
        segment's window, (E, t_sig) float64: each point's charge times the
        response at the point's offset from the pixel's centre, read at the
        tick the point's drift time gives it."""
        c, det, dev = self.det.c, self.det, self.dev
        resp = self.response
        nxr, nyr, nt = resp.shape
        dt = c['time_sampling']
        ratio = int(round(dt / np.float32(c['response_sampling'])))
        swap = s['z_start'] >= s['z_end']
        a = {k: torch.where(swap, s[k + '_end'], s[k + '_start'])
             for k in 'xyz'}
        v = {k: torch.where(swap, s[k + '_start'], s[k + '_end']) - a[k]
             for k in 'xyz'}
        length = torch.sqrt(v['x'] * v['x'] + v['y'] * v['y']
                            + v['z'] * v['z'])
        safe = torch.where(length > 0, length, 1.0)
        nstep = torch.clamp(torch.round(length / _t(min_step, dev)), min=1)
        nstep = torch.clamp(nstep, max=n_steps).int()
        step = length / nstep
        arc = (torch.arange(n_steps, device=dev, dtype=torch.int32)[None]
               + 0.5) * step[:, None]
        p = {k: a[k][:, None] + arc * (v[k] / safe)[:, None] for k in 'xyz'}
        p['z'] = p['z'] + smear[0] * s['long_diff'][:, None]
        p['x'] = p['x'] + smear[1] * s['tran_diff'][:, None]
        p['y'] = p['y'] + smear[2] * s['tran_diff'][:, None]
        b = torch.tensor(det.borders, dtype=F32, device=dev)
        plane = s['plane'].clamp(min=0)
        anode = b[plane, 2, 0]
        dt_t = _t(dt, dev)
        t0_sig = torch.round((s['t_start'] - s['t0_start']
                              - _t(c['time_padding'], dev)) / dt_t) * dt_t
        arrival = (torch.abs(p['z'] - anode[:, None]) / _t(c['v_drift'], dev)
                   - _t(c['time_window'], dev))
        fine = torch.round((arrival - t0_sig[:, None])
                           / _t(c['response_sampling'], dev)).long()
        live = ((torch.arange(n_steps, device=dev)[None] < nstep[:, None])
                & (length > 0)[:, None] & (s['plane'] >= 0)[:, None])
        charge = (s['electrons'] / nstep.float()).double()
        on = (t0_sig[:, None] + torch.arange(t_sig, device=dev) * dt_t) >= 0

        # the pixels' centres
        nx, ny = det.n_pixels
        pid = torch.from_numpy(self.pixels).to(dev)
        pitch = _t(c['pixel_pitch'], dev)
        pl = torch.clamp(pid // (nx * ny), 0, det.n_tpcs - 1)
        cx = (pid % nx) * pitch + b[pl, 0, 0] + pitch / 2
        cy = ((pid // nx) % ny) * pitch + b[pl, 1, 0] + pitch / 2
        bin_ = np.float32(c['response_bin_size'])
        lim = (float(np.float32(bin_ * nxr + bin_)),
               float(np.float32(bin_ * nyr + bin_)))
        top = (float(np.float32(bin_ * nxr)), float(np.float32(bin_ * nyr)))
        inv = float(np.float32(1.0) / bin_)
        flat = resp.reshape(-1)
        out = torch.zeros((len(ent), t_sig), dtype=torch.float64, device=dev)
        seg_of = torch.from_numpy(ent[:, 0]).to(dev)
        pix_of = torch.from_numpy(ent[:, 1]).to(dev)
        tt = torch.arange(t_sig, device=dev)
        for lo in range(0, len(ent), 2048):
            es, ep = seg_of[lo:lo + 2048], pix_of[lo:lo + 2048]
            xd = torch.clamp(torch.abs(cx[ep][:, None] - p['x'][es]),
                             max=lim[0])
            yd = torch.clamp(torch.abs(cy[ep][:, None] - p['y'][es]),
                             max=lim[1])
            i = torch.round(xd * inv - 0.5).long()
            j = torch.round(yd * inv - 0.5).long()
            ok = (live[es] & (xd <= top[0]) & (yd <= top[1]) & (i >= 0)
                  & (i < nxr) & (j >= 0) & (j < nyr))           # (e, n)
            pe, pk = ok.nonzero(as_tuple=True)
            row = (i[pe, pk] * nyr + j[pe, pk]) * nt
            shift = fine[es[pe], pk]
            acc = torch.zeros((len(es), t_sig), dtype=torch.float64,
                              device=dev)
            # every (entry, point) adds its response row, shifted
            for q in range(0, len(pe), 4096):
                kk = ratio * tt[None] - shift[q:q + 4096, None]
                use = (kk >= 0) & (kk < nt)
                vals = torch.where(use, flat[row[q:q + 4096, None]
                                             + kk.clamp(0, nt - 1)], 0.0)
                acc.index_add_(0, pe[q:q + 4096], vals.double())
            cur = acc * charge[es][:, None] * on[es]
            if precision == 'bf16':
                cur = cur.to(torch.bfloat16).double()
            out[lo:lo + 2048] = cur
        return out

    def _digitize(self, integral: torch.Tensor) -> torch.Tensor:
        c = self.det.c
        gain = np.float32(np.float32(c['larpix_gain']) * MV)
        v = (integral * float(gain) + float(np.float32(c['v_pedestal']) * MV)
             - float(np.float32(c['v_cm']) * MV))
        span = float(np.float32(c['v_ref']) * MV - np.float32(c['v_cm']) * MV)
        counts = self.det.c['adc_counts']
        span = torch.tensor(span, dtype=F32, device=integral.device)
        return torch.clamp(torch.round(torch.clamp(v, min=0) * counts / span),
                           max=counts - 1)


def front_end(det: Detector, rows, noise, q_init) -> dict:
    """LArPix's self-trigger over the scan, a pixel per lane (of any
    number of calls at once: the lanes are independent): the
    charge integrates (a one-pole filter of the current); when it and
    the noise pass the threshold, the hold runs for ``integ`` ticks,
    the charge with its noise is latched if still above, the pixel
    resets for ``reset`` ticks and stays busy for ``busy``."""
    c, dev = det.c, rows.device
    n_scan, U = rows.shape
    m = det.sim['max_adc_values']
    integ, reset, busy_n = det.fee_ticks()
    dt32 = np.float32(c['time_sampling'])
    A = float(torch.exp(torch.tensor(-c['time_sampling'], dtype=F32)
                        / torch.tensor(np.float32(c['buffer_risetime']))))
    C = float(np.float32(1.0) - np.float32(A))
    s_unc = float(np.float32(c['uncorrelated_noise_charge']))
    s_disc = float(np.float32(c['discriminator_noise']))
    s_reset = float(np.float32(c['reset_noise_charge']))
    thr = torch.full((U,), float(np.float32(c['discrimination_threshold'])),
                     dtype=F32, device=dev)
    n_t = det.ticks
    stop = np.float32(c['time_interval'][1])
    step = np.float32(stop * (np.float32(1) / np.float32(n_t)))
    times = np.append(np.arange(n_t, dtype=np.float32) * step, stop)

    filt = torch.zeros(U, dtype=F32, device=dev)
    q = q_init * s_reset
    hold = torch.zeros(U, dtype=torch.int64, device=dev)
    dead = torch.zeros_like(hold)
    busy = torch.zeros_like(hold)
    n = torch.zeros_like(hold)
    since = torch.zeros_like(hold)
    out = dict(integral=torch.zeros((U, m), dtype=F32, device=dev),
               ticks=torch.zeros((U, m), dtype=F32, device=dev),
               reset=torch.full((U, m), -1, dtype=torch.int64,
                                device=dev),
               latch=torch.full((U, m), -1, dtype=torch.int64,
                                device=dev))
    # each tick's latches, gathered into the hit slots after the scan
    log_kept = torch.zeros((n_scan, U), dtype=torch.bool, device=dev)
    log_adc = torch.zeros((n_scan, U), dtype=F32, device=dev)
    log_since = torch.zeros((n_scan, U), dtype=torch.int64, device=dev)
    for t in range(n_scan):
        nq, nd, na, nd2, nr = noise[t]
        off = dead > 0
        holding = hold > 0
        filt = torch.where(off, 0.0, A * filt + rows[t])
        q = q + torch.where(off, 0.0, filt * dt32 * C)
        hold = torch.where(holding & ~off, hold - 1, hold)
        latch = holding & ~off & (hold == 0)
        adc = q + na * s_unc
        kept = latch & (adc >= thr + nd2 * s_disc)
        log_kept[t], log_adc[t], log_since[t] = kept, adc, since
        n = torch.where(kept, n + 1, n)
        idle = ~off & ~holding
        busy = torch.where(idle, (busy - 1).clamp(min=0), busy)
        fire = (idle & (busy == 0) & (n < m)
                & (q + nq * s_unc >= thr + nd * s_disc))
        hold = torch.where(fire, integ, hold)
        dead = torch.where(dead > 0, dead - 1, 0)
        dead = torch.where(latch, reset, dead)
        since = torch.where(latch, t + reset + 1, since)
        busy = torch.where(kept, busy_n, busy)
        q = torch.where(latch, nr * s_reset, q)
        filt = torch.where(latch, 0.0, filt)
    tk, lane = log_kept.nonzero(as_tuple=True)        # tick-major
    order = torch.argsort(lane * n_scan + tk)
    tk, lane = tk[order], lane[order]
    a = torch.arange(len(lane), device=dev) - torch.searchsorted(
        lane, lane)                                   # a lane's k-th
    tick_us = torch.from_numpy(np.float32(times[np.minimum(
        np.arange(n_scan) + 1, n_t)]) - np.float32(2) + np.maximum(
        np.arange(n_scan) + 1 - n_t, 0).astype(np.float32)).to(dev)
    out['integral'][lane, a] = log_adc[tk, lane]
    out['ticks'][lane, a] = tick_us[tk]
    out['reset'][lane, a] = log_since[tk, lane]
    out['latch'][lane, a] = tk
    out['n'] = n
    return out


def zero_adc(det: Detector) -> int:
    """The ADC word of no charge: data words at or below it are not sent."""
    c = det.c
    v = (c['v_pedestal'] - c['v_cm']) * MV
    return min(round(max(v, 0.0) * c['adc_counts']
                     / ((c['v_ref'] - c['v_cm']) * MV)), c['adc_counts'] - 1)


def packets(call: Call, event: int, segment_ids: np.ndarray,
            det: Detector) -> list:
    """The call's data packets: [(io group, io channel, chip, channel,
    timestamp, ADC word), {segment id: fraction}] for each hit above the
    ADC's zero on a mapped pixel."""
    c, sim = det.c, det.sim
    if not len(call.hits):
        return []
    above = call.adc > zero_adc(det)
    pix = call.pixels[call.hits[:, 0]]
    grp, ioc, chip, chan, ok = det.readout(pix)
    local = event % sim['max_events_per_file']
    t0 = int(local * sim['spill_period'] / c['clock_cycle'])
    # float32 ticks over the clock, plus the spill's start as an integer
    t0 = np.full(len(call.hits), t0, np.int64)
    tick = np.floor(call.ticks_us.astype(np.float32) / c['clock_cycle']
                    + t0).astype(np.int64)
    stamp = tick % c['clock_reset_period']
    store = sim['association_count_to_store']
    out = []
    for h in np.nonzero(above & ok)[0]:
        u = call.hits[h, 0]
        fr = call.fractions[h]
        seg = call.tracks[u]
        top = np.argsort(-fr, kind='stable')[:store]
        assoc = {int(segment_ids[call.segment_rows[seg[k]]]): float(fr[k])
                 for k in top if seg[k] >= 0}
        out.append(((int(grp[h]), int(ioc[h]), int(chip[h]), int(chan[h]),
                     int(stamp[h]), int(call.adc[h]) & 0xFF), assoc))
    return out


def io_groups(det: Detector, tpcs) -> list[int]:
    """The io groups of the pixels of the TPCs ``tpcs``."""
    nx, ny = det.n_pixels
    out = set()
    for plane in tpcs:
        ids = plane * nx * ny + np.arange(0, nx * ny, 7, dtype=np.int64)
        g, _, _, _, ok = det.readout(ids)
        out.update(int(x) for x in np.unique(g[ok]))
    return sorted(out)


def unit_io_groups(groups: list, group: int) -> list[int]:
    """The io groups of group ``group`` of a :func:`plan`."""
    mod, tpcs = groups[group]
    return io_groups(mod.det, tpcs)


def occupied(calls: list, groups: list) -> set:
    """The (event, io group) pairs whose TPC group holds segments
    (``calls``, ``groups``: :func:`plan`)."""
    found = {}
    out = set()
    for ev, g, _, _ in calls:
        if g not in found:
            found[g] = unit_io_groups(groups, g)
        out.update((ev, x) for x in found[g])
    return out


def choose_units(calls: list, n: int, rng) -> list:
    """``n`` (event, TPC group) units of ``calls`` (:func:`units_of`),
    drawn with ``rng``: one in each spill first (in ``n`` spills drawn
    where there are more), then the rest among all."""
    units = sorted({(ev, g) for ev, g, _, _ in calls})
    by_event = {}
    for u in units:
        by_event.setdefault(u[0], []).append(u)
    events = sorted(by_event)
    if len(events) > n:
        events = sorted(rng.choice(events, size=n, replace=False).tolist())
    out = [by_event[ev][rng.integers(len(by_event[ev]))] for ev in events]
    rest = [u for u in units if u not in out]
    take = rng.choice(len(rest), size=min(n - len(out), len(rest)),
                      replace=False) if rest and n > len(out) else []
    return out + [rest[i] for i in sorted(take)]


def run(tracks: np.ndarray, calls: list, groups: list, rand_seed: int,
        sample, device, precision: str = 'float32', log=None) -> dict:
    """The data packets of the units ``sample`` ((event, group) pairs) of
    an input's segments (:func:`read_segments`, planned into ``calls`` and
    ``groups`` by :func:`plan`), as the reference makes them: {(event, io
    groups): [(packet key, {segment id: fraction})]}; ``log`` takes a line
    a call.  Each module's segments are quenched and drifted with its own
    constants, and its calls' lanes run through one front end."""
    want = {(int(e), int(g)) for e, g in sample}
    made = {}
    prepared = {}
    for ev, g, rows, seq in calls:
        if (ev, g) not in want:
            continue
        mod = groups[g][0]
        if id(mod) not in prepared:
            prepared[id(mod)] = (
                quench_and_drift(tracks, mod.det, device),
                torch.from_numpy(np.asarray(mod.response, np.float32))
                .to(device))
        seg, resp = prepared[id(mod)]
        t0 = time.perf_counter()
        call = Call(seg, rows, mod.det, resp, generator(
            rand_seed, mod.i_mod, ev, seq, device), precision)
        made.setdefault(id(mod), (mod, []))[1].append((ev, g, call))
        if log:
            log(f'[reference] module {mod.i_mod} event {ev} group {g} call '
                f'{seq}: {len(rows)} segments, {len(call.pixels)} pixels, '
                f'{time.perf_counter() - t0:.3f} s')
    out = {}
    for mod, done in made.values():
        t0 = time.perf_counter()
        lanes = [call.rows.shape[1] for *_, call in done]
        fe = front_end(mod.det, torch.cat([call.rows for *_, call in done], 1),
                       torch.cat([call.noise for *_, call in done], 2),
                       torch.cat([call.q_init for *_, call in done]))
        at = np.cumsum([0] + lanes)
        for i, (ev, g, call) in enumerate(done):
            call.finish({k: v[at[i]:at[i + 1]] for k, v in fe.items()})
            out.setdefault((ev, tuple(unit_io_groups(groups, g))),
                           []).extend(packets(call, ev, tracks['segment_id'],
                                              mod.det))
        if log:
            log(f'[reference] module {mod.i_mod}: front end over {at[-1]} '
                f'lanes and the hits of {len(done)} calls: '
                f'{time.perf_counter() - t0:.3f} s')
    for e, g in want:
        out.setdefault((e, tuple(unit_io_groups(groups, g))), [])
    return out
