"""Port parity: the host modules the port carries copies of.

``units``, ``config``, ``geometry.tiles``, the batch planner and the
synthetic light assets are numpy code of the JAX package; the port keeps
its own copies so that it runs without that package.  Each copy is held
equal to its original.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import yaml

from larndsim_tpu import config as jconfig
from larndsim_tpu import units as junits
from larndsim_tpu.assets import light_lut as jlight_lut
from larndsim_tpu.geometry import tiles as jtiles
from larndsim_tpu.utils.batching_native import FastTPCBatcher
from larndsim_tpu_torch import config as tconfig
from larndsim_tpu_torch import units as tunits
from larndsim_tpu_torch.assets import light_lut as tlight_lut
from larndsim_tpu_torch.geometry import tiles as ttiles
from larndsim_tpu_torch.utils.batching import TPCBatcher

import torch_port_assets as tpa


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith('_') and isinstance(v, (int, float))}


def test_units_equal():
    assert _public(tunits) == _public(junits)


@pytest.mark.parametrize('keyword', sorted(jconfig.CONFIG_MAP))
def test_config_equal(tmp_path, monkeypatch, keyword):
    assert tconfig.CONFIG_MAP[keyword] == jconfig.CONFIG_MAP[keyword]
    # one bundle file present under its category, one only flat
    (tmp_path / 'detector_properties').mkdir()
    (tmp_path / 'detector_properties' / 'module0.yaml').touch()
    (tmp_path / 'response_44.npy').touch()
    monkeypatch.setenv('LARNDSIM_ASSETS', str(tmp_path))
    assert tconfig.get_config(keyword) == jconfig.get_config(keyword)


@pytest.mark.parametrize('size', ['small', 'module0'])
def test_tiles_equal(tmp_path, size):
    paths = (tpa.write_tree(tmp_path) if size == 'small'
             else tpa.write_module0(str(tmp_path)))
    with open(paths['detector_properties']) as f:
        detprop = yaml.safe_load(f)
    want = jtiles.load_tile_layout(paths['pixel_layout'], detprop['tile_map'])
    got = ttiles.load_tile_layout(paths['pixel_layout'], detprop['tile_map'])
    for field in dataclasses.fields(want):
        a, b = getattr(want, field.name), getattr(got, field.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=field.name)
        else:
            assert b == a, field.name
    np.testing.assert_array_equal(ttiles.derive_tpc_borders(detprop, got),
                                  jtiles.derive_tpc_borders(detprop, want))
    assert (ttiles.electron_mobility(0.5, 87.17)
            == jtiles.electron_mobility(0.5, 87.17))


@pytest.mark.parametrize('tpc_batch_size', [1, 2])
def test_batcher_equal(tmp_path, tpc_batch_size):
    dm = tpa.load_port(tpa.write_tree(tmp_path))
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=4, n_events=3,
                                 tracks_per_event=4)
    # a few segments outside every TPC
    tracks['x_start'][::7] = tracks['x_end'][::7] = 1e4
    kw = dict(tpc_batch_size=tpc_batch_size, tpc_borders=dm.tpc_borders)
    want = list(FastTPCBatcher(tracks, tracks, 'event_id', **kw))
    got = list(TPCBatcher(tracks, tracks, 'event_id', **kw))
    assert len(TPCBatcher(tracks, tracks, 'event_id', **kw)) == len(want)
    assert len(got) == len(want) > 1
    for (ev_a, mask_a), (ev_b, mask_b) in zip(want, got):
        assert ev_a == ev_b
        np.testing.assert_array_equal(mask_b, mask_a)


@pytest.mark.parametrize('kw', [
    dict(vox_div=(4, 5, 3), n_det_tpc=6, n_prof=20),
    dict(vox_div=(14, 26, 8), n_det_tpc=48)], ids=['small', 'module0'])
def test_light_lut_equal(tmp_path, kw):
    want = jlight_lut.make_light_lut(**kw)
    got = tlight_lut.make_light_lut(**kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    for name in want.dtype.names:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # a file on disk is read as it is; an absent one gives the synthetic LUT
    path = str(tmp_path / 'lut.npz')
    np.savez(path, arr=want[:2])
    np.testing.assert_array_equal(tlight_lut.load_light_lut(path, **kw),
                                  jlight_lut.load_light_lut(path, **kw))
    absent = str(tmp_path / 'absent.npz')
    assert tlight_lut.load_light_lut(absent, **kw).shape == want.shape
    np.testing.assert_array_equal(tlight_lut.make_light_noise(96),
                                  jlight_lut.make_light_noise(96))
    np.testing.assert_array_equal(
        tlight_lut.make_light_noise(12, n_bins=40, amplitude=2.0, seed=3),
        jlight_lut.make_light_noise(12, n_bins=40, amplitude=2.0, seed=3))
