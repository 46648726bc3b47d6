"""Port parity: recombination (quench) and drift.

Tolerance: rtol 1e-6 on the float fields (exp/log/sqrt implementations
differ by a few ULP); ``pixel_plane`` and the active-volume mask equal.
"""
from __future__ import annotations

import numpy as np
import pytest

from larndsim_tpu import segments as jseg
from larndsim_tpu.ops import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import physics
from larndsim_tpu_torch.ops import drift as tdrift
from larndsim_tpu_torch.ops.quench import quench as tquench

import torch_port_assets as tpa

RTOL = 1e-6


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    dm = tpa.load_jax(tpa.write_tree(tmp_path_factory.mktemp('tree')))
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=5, tracks_per_event=6)
    # a few rows outside every TPC exercise the sentinel plane
    tracks['z'][:3] += 100.0
    return dm.params, tracks


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=RTOL,
                               atol=0, err_msg=name)


@pytest.mark.parametrize('mode', [physics.BOX, physics.BIRKS])
def test_quench(setup, mode):
    det, tracks = setup
    js = jquench(jseg.from_structured(tracks, pad_to=64), det, mode)
    ts = tquench(tpa.port_segments(jseg.from_structured(tracks, pad_to=64)),
                 tpa.port_params(det), mode)
    for name in ('n_electrons', 'n_photons'):
        _close(getattr(js, name), getattr(ts, name), name)


def test_drift(setup):
    det, tracks = setup
    js = jquench(jseg.from_structured(tracks, pad_to=64), det, physics.BIRKS)
    ts = tpa.port_segments(js)
    js = jdrift.drift(js, det)
    ts = tdrift.drift(ts, tpa.port_params(det))
    np.testing.assert_array_equal(ts.pixel_plane.numpy(),
                                  np.asarray(js.pixel_plane))
    assert (ts.pixel_plane.numpy() == tdrift.DEFAULT_PLANE_INDEX).sum() >= 3
    for name in ('n_electrons', 'long_diff', 'tran_diff', 't', 't_start',
                 't_end'):
        _close(getattr(js, name), getattr(ts, name), name)


def test_select_active_volume(setup):
    det, tracks = setup
    borders = np.asarray(det.tpc_borders)
    for i_module in (-1, 1):
        np.testing.assert_array_equal(
            tdrift.select_active_volume(tracks, borders, i_module),
            jdrift.select_active_volume(tracks, borders, i_module))
