"""Port parity: detector/simulation parameters, segments and response.

Tolerance: every float32 leaf equal to the JAX leaf, statics equal.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets import response as jresp
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.assets import response as tresp
from larndsim_tpu_torch.params import load_sim as tload_sim
from larndsim_tpu_torch.params.detector import LEAVES, STATICS

import torch_port_assets as tpa


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return tpa.write_tree(tmp_path_factory.mktemp('tree'))


@pytest.mark.parametrize('size', ['small', 'module0'])
def test_detector_leaves_and_statics(tmp_path, size):
    paths = (tpa.write_tree(tmp_path) if size == 'small'
             else tpa.write_module0(str(tmp_path)))
    jm, tm = tpa.load_jax(paths), tpa.load_port(paths)
    jd, td = jm.params, tm.params
    for name in LEAVES:
        got = getattr(td, name)
        assert got.dtype.is_floating_point and got.dtype.itemsize == 4, name
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jd, name)), err_msg=name)
    for name in STATICS:
        assert getattr(td, name) == getattr(jd, name), name
    for name in ('integrate_ticks', 'reset_ticks', 'busy_ticks'):
        assert getattr(td, name) == getattr(jd, name), name
    np.testing.assert_array_equal(tm.tpc_borders, jm.tpc_borders)
    assert tm.module_to_io_groups == jm.module_to_io_groups
    assert tm.module_to_tpcs == jm.module_to_tpcs
    assert tm.tpc_to_module == jm.tpc_to_module
    if size == 'module0':
        # the published Module-0 widths
        assert td.n_pixels == (140, 280) and td.n_tpcs == 2
        assert td.time_ticks == 2001
        assert td.time_ticks + td.integrate_ticks + td.busy_ticks + 4 == 2032


def test_from_numpy_round_trip(tree):
    jd = tpa.load_jax(tree).params
    carried = tpa.port_params(jd)
    loaded = tpa.load_port(tree).params
    for name in LEAVES:
        np.testing.assert_array_equal(getattr(carried, name).numpy(),
                                      getattr(loaded, name).numpy(),
                                      err_msg=name)
        if name != 'tpc_borders':
            assert carried.f32(name) == float(np.asarray(getattr(jd, name)))
    for name in STATICS:
        assert getattr(carried, name) == getattr(loaded, name), name


def test_sim_params_equal(tree):
    js = jload_sim(tree['simulation_properties'])
    ts = tload_sim(tree['simulation_properties'])
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    assert ts.is_spill_sim and ts.max_adc_values == 30 \
        and ts.max_tracks_per_pixel == 50


@pytest.mark.parametrize('pad_to', [None, 64])
def test_segments_round_trip(tree, pad_to):
    tracks = tpa.detector_tracks(tpa.load_jax(tree).tpc_borders, seed=11)
    js = jseg.from_structured(tracks, pad_to=pad_to)
    ts = tseg.from_structured(tracks, pad_to=pad_to, device='cpu')
    names = [f.name for f in dataclasses.fields(tseg.Segments)]
    assert ts.size == js.size
    tpa.assert_same_leaves(js, ts, names)
    back_j = jseg.to_structured(js, dtype=tracks.dtype)
    back_t = tseg.to_structured(ts, dtype=tracks.dtype)
    for name in tracks.dtype.names:
        np.testing.assert_array_equal(back_t[name], back_j[name], err_msg=name)


@pytest.mark.parametrize('n_t,sampling', [(89, 0.1), (1891, 0.1), (178, 0.05)])
def test_response_equal(n_t, sampling):
    a = jresp.make_response(n_xy=45, n_t=n_t, sampling=sampling)
    b = tresp.make_response(n_xy=45, n_t=n_t, sampling=sampling)
    assert b.shape == (45, 45, n_t) and b.dtype == np.float32
    np.testing.assert_array_equal(b, a)
    assert tresp.load_response('__missing__.npy', n_xy=4, n_t=8).shape \
        == (4, 4, 8)


def test_detector_defaults_to_the_card(tmp_path, monkeypatch):
    """A call that names no device builds on the card: without one it
    raises rather than building CPU tensors; the tick-time map follows the
    detector's own device."""
    from larndsim_tpu_torch.ops.fee import tick_times
    from larndsim_tpu_torch.params import from_numpy, load_detector
    paths = tpa.write_tree(tmp_path)
    det = tpa.load_port(paths, device='cpu').params
    assert tick_times(det).device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        load_detector(paths['detector_properties'], paths['pixel_layout'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        from_numpy({k: getattr(det, k).numpy() for k in LEAVES},
                   {k: getattr(det, k) for k in STATICS})
