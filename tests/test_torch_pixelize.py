"""Port parity: segment -> pixel association.

Tolerance: pixel ids, distance codes, ``npix`` and the host bounds equal.
"""
from __future__ import annotations

import numpy as np
import pytest

from larndsim_tpu import segments as jseg
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.ops import pixelize as jpix
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import physics
from larndsim_tpu_torch.ops import pixelize as tpix

import torch_port_assets as tpa


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    det = tpa.load_jax(tpa.write_tree(tmp_path_factory.mktemp('tree'))).params
    tracks = tpa.detector_tracks(np.asarray(det.tpc_borders), seed=7,
                                 tracks_per_event=8, segment_length=0.9)
    segs = jdrift(jquench(jseg.from_structured(tracks, pad_to=64), det,
                          physics.BIRKS), det)
    return det, segs


@pytest.mark.parametrize('radius', [1, 2, 4])
def test_distance_code_table(radius):
    np.testing.assert_array_equal(tpix.distance_code_table(radius),
                                  jpix.distance_code_table(radius))


def test_max_active_pixels(setup):
    det, segs = setup
    valid = np.asarray(segs.valid)
    seg_np = {k: np.asarray(getattr(segs, k))[valid] for k in
              ('x_start', 'y_start', 'x_end', 'y_end', 'pixel_plane')}
    borders = np.asarray(det.tpc_borders)
    assert tpix.max_active_pixels(seg_np, tpa.port_params(det), borders) \
        == jpix.max_active_pixels(seg_np, det, borders)


@pytest.mark.parametrize('radius', [1, 2])
def test_get_pixels(setup, radius):
    det, segs = setup
    max_active = 16
    max_nb = jcharge.bucket((2 * radius + 1) * max_active
                            + (1 + 2 * radius) * radius * 2)
    want = jpix.get_pixels(segs, det, max_active=max_active, radius=radius,
                           max_neighboring=max_nb)
    got = tpix.get_pixels(tpa.port_segments(segs), tpa.port_params(det),
                          max_active=max_active, radius=radius,
                          max_neighboring=max_nb)
    for name, a, b in zip(('pixels', 'distances', 'npix'), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert int(np.asarray(want[2]).sum()) > 0


def test_rasterize_and_time_intervals(setup):
    det, segs = setup
    tdet, tsegs = tpa.port_params(det), tpa.port_segments(segs)
    for a, b in zip(jpix.rasterize(segs, det, 16),
                    tpix.rasterize(tsegs, tdet, 16)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jpix.time_intervals(segs, det),
                    tpix.time_intervals(tsegs, tdet)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
