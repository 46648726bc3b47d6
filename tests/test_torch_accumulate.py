"""Port parity: unique pixels, index maps, track map and waveform sums.

Tolerance: ``uniq``, ``pix_idx``, ``track_map``, ``slot`` and ``overflow``
equal; summed waveforms atol 1e-6 x peak (the one-hot matmul of the JAX
op and the port's ordered passes add in different orders).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.ops import accumulate as jacc
from larndsim_tpu.ops import pixelize as jpix
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import physics
from larndsim_tpu_torch.ops import accumulate as tacc

import torch_port_assets as tpa


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    det = tpa.load_jax(tpa.write_tree(tmp_path_factory.mktemp('tree'))).params
    tracks = tpa.detector_tracks(np.asarray(det.tpc_borders), seed=2,
                                 tracks_per_event=10)
    segs = jdrift(jquench(jseg.from_structured(tracks, pad_to=64), det,
                          physics.BIRKS), det)
    radius = 2
    max_active = 8
    pixels, dists, npix = jpix.get_pixels(
        segs, det, max_active=max_active, radius=radius,
        max_neighboring=jcharge.bucket((2 * radius + 1) * max_active
                                       + (1 + 2 * radius) * radius * 2))
    return det, segs, np.asarray(pixels), np.asarray(dists), np.asarray(npix)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_unique_and_index_map(setup):
    _, _, pixels, _, npix = setup
    counts_j = np.asarray(jacc.batch_pixel_counts(pixels, npix))
    counts_t = tacc.batch_pixel_counts(_t(pixels), _t(npix)).numpy()
    np.testing.assert_array_equal(counts_t, counts_j)
    cap = jcharge.bucket(int(counts_j[1]), lo=32)
    uj, nj = jacc.unique_pixels(pixels, cap)
    ut, nt = tacc.unique_pixels(_t(pixels), cap)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert int(nt) == int(nj) > 0
    np.testing.assert_array_equal(
        tacc.pixel_index_map(_t(pixels), ut).numpy(),
        np.asarray(jacc.pixel_index_map(pixels, uj)))


@pytest.mark.parametrize('max_tracks', [50, 3])
def test_track_pixel_map(setup, max_tracks):
    _, _, pixels, dists, _ = setup
    cap = 512
    uj, _ = jacc.unique_pixels(pixels, cap)
    pix_idx = np.asarray(jacc.pixel_index_map(pixels, uj))
    want = jacc.track_pixel_map(pix_idx, dists, cap, max_tracks=max_tracks)
    got = tacc.track_pixel_map(_t(pix_idx), _t(dists), cap,
                               max_tracks=max_tracks)
    for name, a, b in zip(('track_map', 'slot', 'overflow'), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    if max_tracks == 3:
        assert np.asarray(want[2]).any(), 'test must exercise overflow'


def test_sum_pixel_signals(setup):
    det, segs, pixels, _, _ = setup
    cap = 512
    uj, _ = jacc.unique_pixels(pixels, cap)
    pix_idx = np.asarray(jacc.pixel_index_map(pixels, uj))
    S, P = pixels.shape
    T = 256
    rng = np.random.default_rng(4)
    signals = (rng.normal(size=(S, P, T)) * (pixels >= 0)[:, :, None]) \
        .astype(np.float32)
    # starts before, inside and past the readout window
    track_starts = np.round(rng.uniform(-20.0, 40.0, S), 1) \
        .astype(np.float32)
    kw = dict(n_ticks=det.time_ticks, time_sampling=det.time_sampling)
    want = np.asarray(jacc.sum_pixel_signals(signals, pix_idx, track_starts,
                                             cap, **kw))
    got = tacc.sum_pixel_signals(_t(signals), _t(pix_idx), _t(track_starts),
                                 cap, **kw).numpy()
    assert got.shape == want.shape == (cap, det.time_ticks)
    peak = np.abs(want).max()
    assert peak > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * peak)
