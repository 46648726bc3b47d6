"""Port parity: the per-pixel waveform sum (D1) and its kernel's inputs.

The kernel ``csrc/pixel_sum.cu`` runs only on the card; here its inputs
(``ops.accumulate.pixel_sum_inputs``: the CSR of entries and the clamped
start ticks) and a numpy transcription of its loop, in its order (per pixel
and tile of ticks, entries in CSR order, one float32 add each), are held
to ``sum_pixel_signals_plain``, and the wrapper on CPU tensors to the JAX
op on ``tests/test_torch_fee.py``'s chain.

Tolerance: the transcription equals the plain version bit for bit (the
kernel's claim on the card); the wrapper against the JAX op atol 1e-6 x
peak (the one-hot matmul adds in another order; as
tests/test_torch_accumulate.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from larndsim_tpu.ops import accumulate as jacc
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import accumulate as tacc

from test_torch_fee import chain, det  # noqa: F401  (shared fixtures)

#: the kernel's ticks per block (csrc/pixel_sum.cu: kThreads x kPerThread)
TILE = 512


def kernel_order_sum(signals, entries, offsets, start, n_ticks):
    """csrc/pixel_sum.cu in numpy: per (pixel, tile of TILE ticks), the
    pixel's entries in CSR order, an entry whose window misses the tile
    skipped, one float32 add per covered tick, every element written."""
    S, P, T = signals.shape
    U = offsets.shape[0] - 1
    rows = signals.reshape(S * P, T)
    out = np.empty((U, n_ticks), np.float32)
    for u in range(U):
        for g0 in range(0, n_ticks, TILE):
            g_end = min(g0 + TILE, n_ticks)
            acc = np.zeros(g_end - g0, np.float32)
            for e in entries[offsets[u]:offsets[u + 1]]:
                st = int(start[e // P])
                if st >= g_end or st + T <= g0:
                    continue
                lo, hi = max(st, g0), min(st + T, g_end)
                acc[lo - g0:hi - g0] = (acc[lo - g0:hi - g0]
                                        + rows[e, lo - st:hi - st])
            out[u, g0:g_end] = acc
    return out


def _case(name, rng):
    """(signals, pix_idx, track_starts, U, n_ticks, dt) of a named case."""
    S, P, T, n_ticks, dt = 12, 5, 96, 700, 0.1
    U = 24
    pix = rng.integers(0, U, (S, P)).astype(np.int32)
    starts = rng.uniform(0.0, 60.0, S)
    if name == 'clamped_both_ends':
        # before tick 0, past n_ticks and far past both clamps
        starts = rng.choice([-15.0, -5.0, -200.0, 65.0, 69.5, 500.0, 30.0],
                            S)
    elif name == 'many_entries':
        pix[:, 0] = 3
        pix[::2, 1] = 3
    elif name == 'empty_pixels':
        pix = (rng.integers(0, U // 4, (S, P)) * 4).astype(np.int32)
    elif name == 'padding':
        pix[rng.uniform(size=(S, P)) < 0.4] = -1
        pix[-2:] = -1
    elif name == 'u_larger':
        U = 4 * S * P
        pix = rng.choice(U, (S, P), replace=False).astype(np.int32)
    signals = (rng.normal(size=(S, P, T)) * 1e3).astype(np.float32)
    signals[pix < 0] = 0.0
    return signals, pix, np.round(starts, 2).astype(np.float32), U, \
        n_ticks, dt


CASES = ('clamped_both_ends', 'many_entries', 'empty_pixels', 'padding',
         'u_larger')


@pytest.mark.parametrize('name', CASES)
def test_kernel_order_equals_plain(name):
    signals, pix, starts, U, n_ticks, dt = _case(name, np.random.default_rng(
        CASES.index(name)))
    args = (torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(starts), U)
    kw = dict(n_ticks=n_ticks, time_sampling=dt)
    entries, offsets, start = tacc.pixel_sum_inputs(*args, **kw)
    assert entries.dtype == torch.int64 and offsets.dtype == torch.int32
    assert start.dtype == torch.int32 and tuple(offsets.shape) == (U + 1,)
    # the CSR holds every entry of a pixel id < U, in ascending flat order
    counts = np.bincount(pix[pix >= 0], minlength=U)
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
    flat = pix.reshape(-1)
    for u in range(U):
        np.testing.assert_array_equal(
            entries[offsets[u]:offsets[u + 1]].numpy(),
            np.flatnonzero(flat == u))
    want = tacc.sum_pixel_signals_plain(*args, **kw).numpy()
    got = kernel_order_sum(signals, entries.numpy(), offsets.numpy(),
                           start.numpy(), n_ticks)
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == 'clamped_both_ends':
        st = start.numpy()
        assert st.min() == -signals.shape[2] and st.max() == n_ticks
    if name in ('empty_pixels', 'u_larger'):
        assert (counts == 0).any() and not want[counts == 0].any()


def test_wrapper_on_cpu_matches_jax(det, chain):  # noqa: F811
    c = chain
    cap = int(c['fee'].n_adc.shape[0])
    kw = dict(n_ticks=det.time_ticks, time_sampling=det.time_sampling)
    want = np.asarray(jacc.sum_pixel_signals(
        c['signals'], c['pix_idx'], c['track_starts'], cap, **kw))
    got = tacc.sum_pixel_signals(
        *(torch.from_numpy(np.array(c[k]))
          for k in ('signals', 'pix_idx', 'track_starts')), cap, **kw)
    assert got.shape == want.shape == (cap, det.time_ticks)
    peak = np.abs(want).max()
    assert peak > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * peak)


def test_wrapper_raises_on_meta_and_counts_nothing():
    before = binding.launches['sum_pixel_signals']
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        tacc.sum_pixel_signals(meta(4, 3, 8), meta(4, 3, dtype=torch.int32),
                               meta(4), 16, n_ticks=32, time_sampling=0.1)
    with pytest.raises(ValueError, match='CUDA'):
        binding.sum_pixel_signals(meta(4, 3, 8),
                                  meta(12, dtype=torch.int64),
                                  meta(17, dtype=torch.int32),
                                  meta(4, dtype=torch.int32), 32)
    assert binding.launches['sum_pixel_signals'] == before
