"""Port parity: the current fractions (D2) and its kernel's inputs.

The kernel ``csrc/current_fractions.cu`` runs only on the card; here its
inputs (``ops.fee.fraction_inputs``: the start ticks and A) and a numpy
transcription of its arithmetic, in its order (per valid entry and scanned
ADC slot, the entry's row clipped to the window [r, e], 32 strided partial
sums and a shuffle tree; then each (pixel, slot) row normalised over k in
ascending order), are held to ``current_fractions_plain``, and the wrapper
on CPU tensors to the JAX op on ``tests/test_torch_fee.py``'s chain.

Tolerance: rtol 1e-5 / atol 1e-6, the JAX package's for this op (the sums
run in other orders, and the transcription's power is numpy's).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from larndsim_tpu.ops import fee as jfee
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import fee as tfee
from larndsim_tpu_torch.tools import perf_guard as pg

import torch_port_assets as tpa
from test_torch_fee import chain, det  # noqa: F401  (shared fixtures)

LANES = 32


def _warp_sum(part):
    """The kernel's __shfl_down_sync tree: lane 0's sum."""
    part = part.copy()
    o = LANES // 2
    while o:
        part[:LANES - o] = part[:LANES - o] + part[o:]
        o //= 2
    return part[0]


def kernel_order_fractions(signals, pix_idx, slot, start, A, dt,
                           reset_start, latch_end, max_tracks, n_scan):
    """csrc/current_fractions.cu in numpy float32: (fractions, the number
    of (slot, entry, tick) terms summed)."""
    S, P, T = signals.shape
    U, max_adc = reset_start.shape
    f = np.float32
    num = np.zeros((U, max_adc, max_tracks), f)
    terms = 0
    for i in range(S * P):
        s, p = divmod(i, P)
        u, k = int(pix_idx[s, p]), int(slot[s, p])
        if u < 0 or k < 0:
            continue
        st = int(start[s])
        for a in range(n_scan):
            e, r = int(latch_end[u, a]), int(reset_start[u, a])
            if e < 0:
                continue
            t_lo, t_hi = max(r - st, 0), min(e - st, T - 1)
            if t_lo > t_hi:
                continue
            part = np.zeros(LANES, f)
            terms += t_hi + 1 - t_lo
            for t in range(t_lo, t_hi + 1):
                expo = f(e - (st + t) + 1)
                w = f(f(dt) * f(f(1.0) - np.power(f(A), expo)))
                lane = (t - t_lo) % LANES
                part[lane] = f(part[lane] + f(signals[s, p, t] * w))
            num[u, a, k] = _warp_sum(part)
    for u in range(U):
        for a in range(n_scan):
            total = f(0.0)
            for k in range(max_tracks):
                total = f(total + num[u, a, k])
            num[u, a] = num[u, a] / total if total > 0 else 0.0
    return num, terms


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
    start, A = tfee.fraction_inputs(ts, tdet)
    assert start.dtype == torch.int32 and A.dtype == torch.float32
    np.testing.assert_array_equal(
        start.numpy(), torch.round(ts / torch.tensor(
            0.1, dtype=torch.float32)).to(torch.int32).numpy())
    for n_scan in (1, max_adc):
        want = tfee.current_fractions_plain(
            torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(slot), ts, fee, tdet, max_adc=max_adc,
            max_tracks=max_tracks, n_adc_scan=n_scan).numpy()
        got, terms = kernel_order_fractions(
            signals, pix, slot, start.numpy(), float(A), np.float32(0.1), r,
            e, max_tracks, n_scan)
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
            meta(4, 3, 16), meta(4, 3, dtype=i32), meta(4, 3, dtype=i32),
            meta(4, dtype=i32), fee.reset_start, fee.latch_end, meta(), 0.1,
            max_adc=3, max_tracks=5, n_adc_scan=2)
    assert binding.launches['current_fractions'] == before
