"""Multi-device dispatch of the port (``n_devices``) with module variation:
the small 2x2 tree (``torch_port_assets.write_tree_2x2``, QUIET, 24
optical channels, light with the LUT-smearing truth), on the CPU.

The port's CLI at ``n_devices`` 1, 4 and 8: every dataset equal bit for
bit (``tools.file_check``); at 4 the four modules run on threads of their
own, at 8 each module on two contexts.  The 2x2 at ``n_devices`` 4 against
the JAX CLI at ``n_devices`` 4 (its module threads on XLA's virtual CPU
devices, tests/conftest.py; its charge chain with the Pallas backend; the
port's light draws fed from JAX's key tree), contributor truth, with the
tolerances of tests/test_torch_mod2mod.py: data packets >= 99% matched,
each matched packet's fraction per segment id within atol 1e-4,
``light_trig`` equal, truth records equal (pe_current rtol 1e-4 / atol
1e-6), ``light_wvfm`` within one quantum (64 ADC) with >= 99.9% of samples
equal.  A module thread's error fails the run and leaves no output.
"""
from __future__ import annotations

import collections
import functools
import os
import threading

import h5py
import numpy as np
import pytest

from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.tools.file_check import differences

import torch_port_assets as tpa
from test_torch_cli import _data_packets, _truth
from test_torch_light_cli import _fed_light_draw
from test_torch_ndev import _runs, _spy_charge


def _paths_2x2(tmp_path, **light):
    paths = tpa.write_tree_2x2(
        tmp_path / 'tree', detector_overrides=tpa.QUIET,
        light=dict(n_op_channel=24, light_window=(0.0, 2.0), **light),
        sim_overrides=dict(max_light_truth_ids=16))
    geo = tpa.load_jax(dict(paths, pixel_layout=paths['pixel_layout'][0]))
    inp = str(tmp_path / 'in.h5')
    assert tpa.write_spills_2x2(inp, geo.tpc_borders, 2) > 0
    kw = dict(config='2x2', mod2mod_variation=True,
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=paths['response_file'],
              light_lut_filename=paths['light_lut_filename'],
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=4.0)
    return inp, kw


def test_2x2_same_datasets_for_any_n_devices(tmp_path, monkeypatch):
    """Module variation with light and the smearing truth: at 4 the four
    modules on threads of their own, at 8 each with two contexts."""
    inp, kw = _paths_2x2(tmp_path, enable_lut_smearing=True)
    runs = _runs(tmp_path, monkeypatch, inp, dict(kw, device='cpu'),
                 (1, 4, 8))
    for n in (4, 8):
        assert differences(runs[1][0], runs[n][0]) == [], n
    assert {c[0] for c in runs[4][1]} == {f'module-{m}' for m in range(1, 5)}
    assert {c[0].rpartition('_')[0] for c in runs[8][1]} == {
        f'module-{m}-ctx{k}' for m in range(1, 5) for k in range(2)}
    with h5py.File(runs[8][0], 'r') as f:
        assert f['light_wvfm'].shape[1] == 24
        assert sorted(f['light_dat'].keys()) == [
            f'light_dat_module{i}' for i in range(4)]


def test_2x2_at_4_devices_agrees_with_jax(tmp_path, monkeypatch):
    """Both CLIs at n_devices 4 (JAX on its virtual CPU devices, the port
    on four CPU contexts), contributor truth, the port's light draws fed
    from JAX's key tree."""
    inp, kw = _paths_2x2(tmp_path)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    jcli.run_simulation(inp, out_j, truth_compression='none', n_devices=4,
                        event_group_size=1, **kw)
    monkeypatch.setattr(tcli, 'light_draw', _fed_light_draw)
    calls = _spy_charge(monkeypatch)
    tcli.run_simulation(inp, out_t, device='cpu', n_devices=4, **kw)
    assert {c[0] for c in calls} == {f'module-{m}' for m in range(1, 5)}

    keys_j, assn_j = _data_packets(out_j)
    keys_t, assn_t = _data_packets(out_t)
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    assert {k[0] for k in keys_t} == set(range(1, 9))
    by_key_t = dict(zip(keys_t, map(_truth, assn_t)))
    for k, want in zip(keys_j, map(_truth, assn_j)):
        if k in by_key_t:
            got = by_key_t[k]
            for seg in set(got) | set(want):
                assert abs(got.get(seg, 0.0) - want.get(seg, 0.0)) <= 1e-4
    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        assert sorted(ft.keys()) == sorted(fj.keys())
        tj, tt = np.array(fj['light_trig']), np.array(ft['light_trig'])
        assert tt.dtype == tj.dtype and len(tt) == 2
        for name in tj.dtype.names:
            np.testing.assert_array_equal(tt[name], tj[name], err_msg=name)
        wj, wt = np.array(fj['light_wvfm']), np.array(ft['light_wvfm'])
        assert wt.shape == wj.shape == (2, 24, 256)
        d = np.abs(wt.astype(np.float64) - wj)
        assert d.max() <= 64 and (d == 0).mean() >= 0.999
        rj = np.array(fj['light_wvfm_mc_assn'])
        rt = np.array(ft['light_wvfm_mc_assn'])
    assert rt.dtype == rj.dtype and len(rj) > 0
    for name in ('trigger_id', 'op_channel_id', 'tick', 'event_id',
                 'segment_id'):
        np.testing.assert_array_equal(rt[name], rj[name], err_msg=name)
    np.testing.assert_allclose(rt['pe_current'], rj['pe_current'],
                               rtol=1e-4, atol=1e-6)


def test_module_thread_error_fails_the_run(tmp_path, monkeypatch):
    """Module 3's thread fails: the run raises its error once every module
    thread has ended, and leaves no output."""
    inp, kw = _paths_2x2(tmp_path)
    orig = tcli.load_detector

    def failing(*args, i_module=-1, **kwargs):
        if i_module == 3:
            raise RuntimeError('module 3 failed')
        return orig(*args, i_module=i_module, **kwargs)
    monkeypatch.setattr(tcli, 'load_detector', failing)
    out = tmp_path / 'out.h5'
    before = threading.active_count()
    with pytest.raises(RuntimeError, match='module 3 failed'):
        tcli.run_simulation(inp, str(out), device='cpu', n_devices=4, **kw)
    assert not out.exists()
    assert not [p for p in os.listdir(tmp_path) if p.startswith('out.h5')]
    assert threading.active_count() == before
