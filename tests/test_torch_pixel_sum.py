"""Port parity: the per-pixel waveform sum (D1) and its kernel's inputs.

The kernel ``csrc/pixel_sum.cu`` runs only on the card; here its inputs
(``ops.accumulate.pixel_csr``: each pixel's (entry, start tick) pairs) and
a numpy transcription of its loop, in its order (per group of 32 pixels
and tile of 128 ticks, each pixel's entries in CSR order, an entry whose
window misses the tile skipped, one float32 add each; the tile written
tick-major, groups without an entry and tiles past the sums as zeros),
are held to ``sum_pixel_signals_plain`` in both of its forms, and the
wrapper on CPU tensors to the JAX op on ``tests/test_torch_fee.py``'s
chain.

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

#: the kernel's pixels and ticks per block (csrc/pixel_sum.cu: kGroup,
#: kTile)
GROUP, TILE = 32, 128


def kernel_order_rows(signals, pairs, offsets, n_ticks, rows):
    """csrc/pixel_sum.cu in numpy: the (rows, U) tick-major sums."""
    S, P, T = signals.shape
    U = offsets.shape[0] - 1
    sig = signals.reshape(S * P, T)
    g_sum = min(n_ticks, rows)
    out = np.empty((rows, U), np.float32)
    for u0 in range(0, U, GROUP):
        n_pix = min(GROUP, U - u0)
        for g0 in range(0, rows, TILE):
            r_end = min(TILE, rows - g0)
            g_hi = min(g0 + TILE, g_sum)
            if g0 >= g_sum or offsets[u0] == offsets[u0 + n_pix]:
                out[g0:g0 + r_end, u0:u0 + n_pix] = 0.0
                continue
            tile = np.zeros((TILE, n_pix), np.float32)
            for p in range(n_pix):
                for e, st in pairs[offsets[u0 + p]:offsets[u0 + p + 1]]:
                    if not (st < g_hi and st + T > g0):
                        continue
                    lo, hi = max(st, g0), min(st + T, g_hi)
                    tile[lo - g0:hi - g0, p] = (tile[lo - g0:hi - g0, p]
                                                + sig[e, lo - st:hi - st])
            out[g0:g0 + r_end, u0:u0 + n_pix] = tile[:r_end]
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


def _csr(signals, pix, starts, U, dt):
    pairs, offsets = tacc.pixel_csr(torch.from_numpy(pix),
                                    torch.from_numpy(starts), U,
                                    time_sampling=dt)
    return pairs.numpy(), offsets.numpy()


@pytest.mark.parametrize('name', CASES)
def test_kernel_order_equals_plain(name):
    signals, pix, starts, U, n_ticks, dt = _case(name, np.random.default_rng(
        CASES.index(name)))
    args = (torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(starts), U)
    kw = dict(n_ticks=n_ticks, time_sampling=dt)
    pairs_t, offsets_t = tacc.pixel_csr(args[1], args[2], U,
                                        time_sampling=dt)
    assert pairs_t.dtype == offsets_t.dtype == torch.int32
    assert tuple(pairs_t.shape) == (pix.size, 2)
    assert tuple(offsets_t.shape) == (U + 1,)
    pairs, offsets = pairs_t.numpy(), offsets_t.numpy()
    # the CSR holds every entry of a pixel id < U, in ascending flat order,
    # each with its segment's round(start / dt), not clamped
    counts = np.bincount(pix[pix >= 0], minlength=U)
    np.testing.assert_array_equal(np.diff(offsets), counts)
    flat = pix.reshape(-1)
    st = torch.round(args[2] / torch.tensor(dt, dtype=torch.float32)).to(
        torch.int32).numpy()
    for u in range(U):
        np.testing.assert_array_equal(pairs[offsets[u]:offsets[u + 1], 0],
                                      np.flatnonzero(flat == u))
    np.testing.assert_array_equal(pairs[:, 1], st[pairs[:, 0] // pix.shape[1]])
    want = tacc.sum_pixel_signals_plain(*args, **kw).numpy()
    got = kernel_order_rows(signals, pairs, offsets, n_ticks, n_ticks).T
    assert np.abs(want).max() > 0
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if name == 'clamped_both_ends':
        # windows wholly before tick 0 and wholly past the readout
        assert st.min() < -signals.shape[2] and st.max() > n_ticks
    if name in ('empty_pixels', 'u_larger'):
        assert (counts == 0).any() and not want[counts == 0].any()


@pytest.mark.parametrize('extra', [37, -200])
def test_rows_form_is_the_padded_transpose(extra):
    """The rows form (the FSM's input) of the plain version, and the
    kernel's transcription, are the (U, n_ticks) sums transposed, cut or
    zero-padded to n_ticks + extra rows, bit for bit."""
    signals, pix, starts, U, n_ticks, dt = _case(
        'clamped_both_ends', np.random.default_rng(7))
    args = (torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(starts), U)
    kw = dict(n_ticks=n_ticks, time_sampling=dt)
    rows = n_ticks + extra
    wave = tacc.sum_pixel_signals_plain(*args, **kw).numpy()
    want = np.zeros((rows, U), np.float32)
    want[:min(rows, n_ticks)] = wave.T[:rows]
    assert np.abs(want).max() > 0
    for got in (tacc.sum_pixel_signals(*args, **kw, rows=rows).numpy(),
                tacc.sum_pixel_signals_plain(*args, **kw, rows=rows).numpy(),
                kernel_order_rows(signals, *_csr(signals, pix, starts, U,
                                                 dt), n_ticks, rows)):
        assert got.shape == (rows, U)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_fewer_occupied_pixels_than_the_cap():
    """Pixels 0-19 occupied of a 256-pixel axis: the groups past them are
    zeros, the rest the plain version's bits."""
    rng = np.random.default_rng(11)
    signals, pix, starts, _, n_ticks, dt = _case('padding', rng)
    pix = np.where(pix >= 0, pix % 20, -1).astype(np.int32)
    U = 256
    args = (torch.from_numpy(signals), torch.from_numpy(pix),
            torch.from_numpy(starts), U)
    pairs, offsets = _csr(signals, pix, starts, U, dt)
    assert offsets[20] == offsets[U] and offsets[19] < offsets[20]
    rows = n_ticks + 40
    want = tacc.sum_pixel_signals_plain(
        *args, n_ticks=n_ticks, time_sampling=dt, rows=rows).numpy()
    got = kernel_order_rows(signals, pairs, offsets, n_ticks, rows)
    assert np.abs(want[:, :20]).max() > 0 and not want[:, 20:].any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


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
        tacc.sum_pixel_signals(meta(4, 3, 8), meta(4, 3, dtype=torch.int32),
                               meta(4), 16, n_ticks=32, time_sampling=0.1,
                               rows=40)
    with pytest.raises(ValueError, match='CUDA'):
        binding.sum_pixel_rows(meta(4, 3, 8),
                               meta(12, 2, dtype=torch.int32),
                               meta(17, dtype=torch.int32), 32, 40)
    assert binding.launches['sum_pixel_signals'] == before
