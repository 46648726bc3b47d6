"""Port parity: the current fractions (D2) and its kernel's inputs.

The kernel ``csrc/current_fractions.cu`` runs only on the card; here its
inputs (the CSR of ``ops.accumulate.pixel_csr``, shared with the waveform
sum, and A of ``ops.fee.fraction_decay``), its weight table
(:func:`fraction_weights`) and a numpy transcription of its
arithmetic, in its order (each (pixel, scanned slot, track slot) summed by
one warp, whichever of its block's warps takes the entry: the entry's row
clipped to the slot's window, 32 strided partial sums, each lane's ticks
in ascending order with the tabled weights (the expression itself past
the table), and a shuffle tree; then each slot normalised over k in
ascending order), are held to ``current_fractions_plain``, and the
wrapper on CPU tensors to the JAX op on ``tests/test_torch_fee.py``'s
chain.

Tolerance: rtol 1e-5 / atol 1e-6, the JAX package's for this op (the sums
run in other orders, and the transcription's power is numpy's); the
weight table and the per-tick weights bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from larndsim_tpu.ops import fee as jfee
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import accumulate as tacc
from larndsim_tpu_torch.ops import fee as tfee
from larndsim_tpu_torch.tools import perf_guard as pg

import torch_port_assets as tpa
from test_torch_fee import chain, det  # noqa: F401  (shared fixtures)

LANES = 32


def fraction_weights(A: torch.Tensor, det, n: int) -> torch.Tensor:
    """The weights dt * (1 - A^m) of m = 0 .. n - 1 by the plain
    version's expression: the table the fraction kernel makes once per
    launch (with powf) for m up to ``scan_ticks(det) + 1``."""
    m = torch.arange(n, dtype=torch.float32, device=A.device)
    return det.time_sampling * (1.0 - torch.pow(A, m))


def _warp_sum(part):
    """The kernel's __shfl_down_sync tree: lane 0's sum."""
    part = part.copy()
    o = LANES // 2
    while o:
        part[:LANES - o] = part[:LANES - o] + part[o:]
        o //= 2
    return part[0]


def _weight(A, dt, m):
    f = np.float32
    return f(f(dt) * f(f(1.0) - np.power(f(A), f(m))))


def kernel_order_fractions(signals, pairs, offsets, slot, A, dt,
                           reset_start, latch_end, max_tracks, n_scan, n_w):
    """csrc/current_fractions.cu in numpy float32: (fractions, the number
    of (slot, entry, tick) terms summed).  Pixel by pixel: which of the
    kernel's warps sums an (entry, slot) does not change its bits."""
    S, P, T = signals.shape
    U, max_adc = reset_start.shape
    f = np.float32
    table = np.array([_weight(A, dt, m) for m in range(n_w)], f)
    rows = signals.reshape(S * P, T)
    flat_slot = slot.reshape(-1)
    out = np.zeros((U, max_adc, max_tracks), f)
    terms = 0
    for u in range(U):
        win = list(zip(reset_start[u, :n_scan].tolist(),
                       latch_end[u, :n_scan].tolist()))
        lo, hi = int(offsets[u]), int(offsets[u + 1])
        if not any(e >= 0 for _, e in win) or lo == hi:
            continue
        num = np.zeros((n_scan, max_tracks), f)
        for i, st in pairs[lo:hi].tolist():
            k = int(flat_slot[i])
            if k < 0:
                continue
            for a, (r, e) in enumerate(win):
                t_lo, t_hi = max(r - st, 0), min(e - st, T - 1)
                if e < 0 or t_lo > t_hi:
                    continue
                part = np.zeros(LANES, f)
                terms += t_hi + 1 - t_lo
                for t in range(t_lo, t_hi + 1):
                    m = e - (st + t) + 1
                    w = table[m] if m < n_w else _weight(A, dt, m)
                    lane = (t - t_lo) % LANES
                    part[lane] = f(part[lane] + f(rows[i, t] * w))
                num[a, k] = _warp_sum(part)
        for a in range(n_scan):
            total = f(0.0)
            for k in range(max_tracks):
                total = f(total + num[a, k])
            out[u, a] = num[a] / total if total > 0 else 0.0
    return out, terms


def _case(name, rng):
    """(signals, pix_idx, slot, track_starts, reset_start, latch_end,
    max_tracks) of a named case: every valid (pixel, slot) once."""
    S, P, T, U, max_adc, max_tracks = 10, 4, 80, 8, 3, 6
    pix = np.full((S, P), -1, np.int32)
    slot = np.full((S, P), -1, np.int32)
    used = set()
    for s in range(S):
        for p in range(P):
            u, k = int(rng.integers(U)), int(rng.integers(max_tracks))
            if (u, k) not in used and rng.uniform() < 0.8:
                used.add((u, k))
                pix[s, p], slot[s, p] = u, k
            elif rng.uniform() < 0.5:
                pix[s, p] = u      # a pixel entry beyond the track slots
    starts = np.round(rng.uniform(0.0, 30.0, S), 2).astype(np.float32)
    st = np.round(starts / np.float32(0.1)).astype(np.int64)
    r = rng.integers(0, 200, (U, max_adc)).astype(np.int32)
    e = (r + rng.integers(5, 120, (U, max_adc))).astype(np.int32)
    if name == 'r_after_e':
        e[::2] = r[::2] - rng.integers(1, 5, (U // 2 + U % 2, max_adc))
    elif name == 'unlatched':
        e[:, 1:] = -1
        r[:, 1:] = -1
        e[1] = -1
    elif name == 'partly_outside':
        # windows that open before the row, close after it, or both
        for u in range(U):
            s0 = int(st[u % S])
            r[u] = (s0 - 10, s0 + T - 20, s0 - 30)
            e[u] = (s0 + 15, s0 + T + 40, s0 + T + 30)
    signals = (rng.normal(size=(S, P, T)) * 1e3 + 500.0).astype(np.float32)
    return signals, pix, slot, starts, r, e, max_tracks


CASES = ('random', 'r_after_e', 'unlatched', 'partly_outside')
#: the guard's staging at a tiny input (as tests/test_torch_perf_guard.py)
TINY = dict(n_events=1, tracks_per_event=3, segments_per_track=6,
            segment_length=0.4, dEdx=8.0, seed=2)


def _fractions_inputs(pix, starts, U, det, n_w=None):
    """The kernel's CSR, A and table length, as ``ops.fee.
    current_fractions`` makes them on the card."""
    pairs, offsets = tacc.pixel_csr(torch.from_numpy(pix),
                                    torch.from_numpy(starts), U,
                                    time_sampling=det.time_sampling)
    A = tfee.fraction_decay(det, 'cpu')
    return pairs.numpy(), offsets.numpy(), float(A), \
        tfee.scan_ticks(det) + 2 if n_w is None else n_w


@pytest.mark.parametrize('name', CASES)
def test_kernel_order_matches_plain(det, name):  # noqa: F811
    rng = np.random.default_rng(10 + CASES.index(name))
    signals, pix, slot, starts, r, e, max_tracks = _case(name, rng)
    tdet = tpa.port_params(det).replace(time_sampling=0.1)
    U, max_adc = r.shape
    fee = tfee.FeeResult(torch.zeros((U, max_adc)), torch.zeros((U, max_adc)),
                         torch.zeros(U, dtype=torch.int32),
                         torch.from_numpy(r), torch.from_numpy(e))
    ts = torch.from_numpy(starts)
    A = tfee.fraction_decay(tdet, 'cpu')
    assert A.dtype == torch.float32 and A.shape == ()
    # a table shorter than these windows' m: the kernel computes the rest
    pairs, offsets, _, n_w = _fractions_inputs(pix, starts, U, tdet, n_w=64)
    for n_scan in (1, max_adc):
        want = tfee.current_fractions_plain(
            torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(slot), ts, fee, tdet, max_adc=max_adc,
            max_tracks=max_tracks, n_adc_scan=n_scan).numpy()
        got, terms = kernel_order_fractions(
            signals, pairs, offsets, slot, float(A), np.float32(0.1), r, e,
            max_tracks, n_scan, n_w)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        # the guard's count of the kernel's work (its bound) is these terms
        assert pg.window_ticks(
            torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(slot), ts, fee.reset_start, fee.latch_end,
            n_scan, 0.1) == terms
        assert not want[:, n_scan:].any()
        if name == 'unlatched':
            assert not want[1].any()
            assert not want[:, 1:].any()
        else:
            assert want.max() > 0


def test_weight_table_equals_the_per_tick_weights(det):  # noqa: F811
    """``fraction_weights`` (the table the kernel makes once a launch)
    equals the plain version's per-tick weight dt * (1 - A^(e - j + 1))
    bit for bit over m = e - j + 1 in [1, n_scan + 1]; the kernel's table
    (its numpy transcription, powf) the per-tick powf expression a kernel
    without the table would compute."""
    tdet = tpa.port_params(det)
    n_scan = tfee.scan_ticks(tdet)
    A = tfee.fraction_decay(tdet, 'cpu')
    table = fraction_weights(A, tdet, n_scan + 2)
    # the plain version's expression on a window [0, e] of e = n_scan
    j = torch.arange(n_scan + 1, dtype=torch.int32)
    expo = (n_scan - j + 1).float()[None, None, :]
    dt = tdet.time_sampling
    per_tick = (dt * (1.0 - torch.pow(A, torch.clamp(expo, min=0.0))))[0, 0]
    assert table.dtype == torch.float32 and table.shape == (n_scan + 2,)
    np.testing.assert_array_equal(table[1:].flip(0).numpy().view(np.int32),
                                  per_tick.numpy().view(np.int32))
    f = np.float32
    e, st = n_scan - 1, 0
    ticks = [_weight(float(A), dt, m) for m in range(n_scan + 2)]
    for t in range(0, n_scan, 97):
        expo = f(e - (st + t) + 1)
        w = f(f(dt) * f(f(1.0) - np.power(f(float(A)), expo)))
        assert ticks[e - (st + t) + 1] == w
    assert table[0] == 0.0 and float(table[-1]) > 0


def test_shared_csr_equals_the_one_built_for_the_fractions(
        tmp_path_factory):
    """The CSR that ``stage_batch`` makes once a batch for D1 and D2
    equals the one ``current_fractions`` builds without it, and the
    kernel's transcription fed each gives the same bits."""
    w = pg.build_workload('cpu', str(tmp_path_factory.mktemp('guard')),
                          workload=TINY, pad_n=32, geometry=tpa.SMALL)
    _, args, kw = pg.op_calls(w)['current_fractions_4_with_csr']
    signals, pix_idx, slot, track_starts, res, tdet = args
    shared = w['stage'].csr
    U = res.reset_start.shape[0]
    built = tacc.pixel_csr(pix_idx, track_starts, U,
                           time_sampling=tdet.time_sampling)
    assert torch.equal(shared.pairs, built.pairs)
    assert torch.equal(shared.offsets, built.offsets)
    A = float(tfee.fraction_decay(tdet, 'cpu'))
    n_w = tfee.scan_ticks(tdet) + 2
    outs = [kernel_order_fractions(
        signals.numpy(), csr.pairs.numpy(), csr.offsets.numpy(),
        slot.numpy(), A, np.float32(tdet.time_sampling),
        res.reset_start.numpy(), res.latch_end.numpy(), kw['max_tracks'],
        kw['n_adc_scan'], n_w)[0] for csr in (shared, built)]
    np.testing.assert_array_equal(outs[0].view(np.int32),
                                  outs[1].view(np.int32))
    want = tfee.current_fractions(*args, **kw, csr=shared).numpy()
    assert want.max() > 0
    np.testing.assert_allclose(outs[0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('scan', ['hits', 'all', 'none'])
def test_wrapper_on_cpu_matches_jax(det, chain, scan):  # noqa: F811
    c = chain
    n_hits = int(np.asarray(c['fee'].n_adc).max())
    n_scan = dict(hits=n_hits, all=c['max_adc'], none=0)[scan]
    kw = dict(max_adc=c['max_adc'], max_tracks=c['max_tracks'])
    want = np.asarray(jfee.current_fractions(
        c['signals'], c['pix_idx'], c['slot'], c['track_starts'], c['fee'],
        det, n_adc_scan=n_scan, **kw))
    t = lambda a: torch.from_numpy(np.array(a))
    got = tfee.current_fractions(
        t(c['signals']), t(c['pix_idx']), t(c['slot']), t(c['track_starts']),
        tfee.FeeResult(*(t(a) for a in c['fee'])), tpa.port_params(det),
        n_adc_scan=n_scan, **kw).numpy()
    assert got.shape == want.shape
    assert (want.max() > 0) == (scan != 'none')
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_wrapper_raises_on_meta_and_counts_nothing(det):  # noqa: F811
    before = binding.launches['current_fractions']
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device='meta')
    i32 = torch.int32
    fee = tfee.FeeResult(meta(8, 3), meta(8, 3), meta(8, dtype=i32),
                         meta(8, 3, dtype=i32), meta(8, 3, dtype=i32))
    for n_scan in (2, 0):
        with pytest.raises(ValueError, match='CUDA'):
            tfee.current_fractions(
                meta(4, 3, 16), meta(4, 3, dtype=i32), meta(4, 3, dtype=i32),
                meta(4), fee, tpa.port_params(det), max_adc=3, max_tracks=5,
                n_adc_scan=n_scan)
    with pytest.raises(ValueError, match='CUDA'):
        binding.current_fractions(
            meta(4, 3, 16), meta(12, 2, dtype=i32), meta(9, dtype=i32),
            meta(4, 3, dtype=i32), fee.reset_start, fee.latch_end, meta(),
            0.1, max_adc=3, max_tracks=5, n_adc_scan=2, n_weights=40)
    assert binding.launches['current_fractions'] == before
