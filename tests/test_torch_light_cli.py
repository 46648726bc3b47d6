"""Port parity end to end with light on: both ``simulate_pixels`` CLIs.

Both run the small tree with deterministic charge (``QUIET``) and the
light keys of a 12-channel module in beam mode with a 2 us window; the
input's first spill has tracks inside the digitized window.  The port's
light draws are taken from the JAX CLI's key tree (``root_key =
PRNGKey(rand_seed)``, ``fold_in(root_key, max(i_mod, 0))``, ``fold_in(.,
event)``, then as in tests/test_torch_light.py) through the replaceable
factory ``cli.simulate_pixels.light_draw``.

Tolerances: data packets as in tests/test_torch_cli.py; ``light_trig``
field by field equal; ``light_dat`` segment ids equal, photons and t0 at
rtol 2e-6 / atol 1e-5; contributor-point truth records (trigger, channel,
tick, event, segment) equal with pe_current at rtol 1e-4 / atol 1e-6;
LUT-smearing truth records (each route against the JAX CLI's same route,
chosen there by ``LARNDSIM_TRUTH_PATH``) equal in those columns where
|pe| lies more than 1e-3 from the threshold, pe_current at rtol 1e-4 /
atol 1e-5 (``tools.light_check.records_agree``); ``light_wvfm`` within
one quantum (64 ADC), >= 99.9% of samples equal.
"""
from __future__ import annotations

import collections
import functools

import h5py
import jax
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.models import light as jlight
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.tools.light_check import records_agree

import torch_port_assets as tpa
from test_torch_cli import _assert_same_segments, _data_packets, _truth
from test_torch_light import jax_draw

LIGHT = dict(n_op_channel=12, light_window=(0.0, 2.0))


def _fed_light_draw(rand_seed, i_mod, event, i_subbatch, device):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(rand_seed), max(i_mod, 0)), int(event))
    return jax_draw(key, i_subbatch)


@pytest.mark.parametrize('route', ['contributor_truth', 'smearing',
                                   'smearing_truth_device',
                                   'smearing_truth_host'])
def test_clis_agree_with_light(tmp_path, monkeypatch, route):
    smear = route.startswith('smearing')
    truth_path = route.rpartition('_')[2] if route.startswith(
        'smearing_truth') else None
    paths = tpa.write_tree(
        tmp_path / 'tree', detector_overrides=tpa.QUIET,
        light=dict(LIGHT, enable_lut_smearing=smear),
        sim_overrides=dict(max_light_truth_ids=0 if route == 'smearing'
                           else 16))
    dm = tpa.load_jax(paths)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, dm.tpc_borders, n_events=2, tracks_per_event=3,
                       segments_per_track=6, segment_length=0.4, dEdx=8.0,
                       seed=7) > 0
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    if truth_path:
        monkeypatch.setenv('LARNDSIM_TRUTH_PATH', truth_path)
        monkeypatch.setattr(jlight, '_TRUTH_PATH_CACHE', [])
    jcli.run_simulation(inp, out_j, config='module0',
                        truth_compression='none', **kw)
    monkeypatch.setattr(tcli, 'light_draw', _fed_light_draw)
    tcli.run_simulation(inp, out_t, config='module0', device='cpu',
                        **kw, **(dict(truth_path=truth_path)
                                 if truth_path else {}))

    keys_j, assn_j = _data_packets(out_j)
    keys_t, assn_t = _data_packets(out_t)
    assert len(keys_j) > 0
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    by_key_t = dict(zip(keys_t, map(_truth, assn_t)))
    for k, want in zip(keys_j, map(_truth, assn_j)):
        if k in by_key_t:
            _assert_same_segments(by_key_t[k], want, k)

    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        tj, tt = np.array(fj['light_trig']), np.array(ft['light_trig'])
        assert tt.dtype == tj.dtype and len(tt) == len(tj) == 2
        assert tt['op_channel'].shape == (2, 12)
        for name in tj.dtype.names:
            np.testing.assert_array_equal(tt[name], tj[name], err_msg=name)

        dj = np.array(fj['light_dat/light_dat_allmodules'])
        dt = np.array(ft['light_dat/light_dat_allmodules'])
        assert dt.dtype == dj.dtype and dt.shape == dj.shape
        np.testing.assert_array_equal(dt['segment_id'], dj['segment_id'])
        for name in ('n_photons_det', 't0_det'):
            np.testing.assert_allclose(dt[name], dj[name], rtol=2e-6,
                                       atol=1e-5, err_msg=name)

        wj, wt = np.array(fj['light_wvfm']), np.array(ft['light_wvfm'])
        # one row per event, and a zero row for each empty (event, TPC)
        # batch (an event here has segments in one TPC only)
        assert wt.shape == wj.shape and wt.shape[1:] == (12, 256)
        assert wt.dtype == wj.dtype and len(wt) > 2
        assert np.abs(wj).max() > 64, 'test must produce a waveform'
        d = np.abs(wt.astype(np.float64) - wj)
        assert d.max() <= 64 and (d == 0).mean() >= 0.999, \
            (d.max(), (d == 0).mean())

        if route == 'smearing':
            assert 'light_wvfm_mc_assn' not in fj
            assert 'light_wvfm_mc_assn' not in ft
            return
        rj = np.array(fj['light_wvfm_mc_assn'])
        rt = np.array(ft['light_wvfm_mc_assn'])
    assert rt.dtype == rj.dtype and len(rj) > 0
    columns = ('trigger_id', 'op_channel_id', 'tick', 'event_id',
               'segment_id')
    if truth_path:
        rec = records_agree(rt, rj, 0.1, keys=columns)
        assert rec['records'] > 1000
        return
    for name in columns:
        np.testing.assert_array_equal(rt[name], rj[name], err_msg=name)
    np.testing.assert_allclose(rt['pe_current'], rj['pe_current'],
                               rtol=1e-4, atol=1e-6)


def test_light_check_on_the_cpu(tmp_path):
    """The card-against-CPU check of the light batch (``tools.light_check``,
    run by chip_smoke.py and tests/test_torch_gpu.py) rehearsed CPU against
    CPU: the CLI's first triggering batch, run again with CPU draws, both
    routes, agrees with itself bit for bit."""
    from larndsim_tpu_torch.assets.make_input import write_input as twrite
    from larndsim_tpu_torch.tools import light_check
    paths = tpa.write_tree(tmp_path / 'tree', light=LIGHT)
    inp = str(tmp_path / 'in.h5')
    twrite(inp, tpa.load_port(paths).tpc_borders, n_events=2,
           tracks_per_event=3, segments_per_track=6, segment_length=0.4,
           dEdx=8.0, seed=7)
    with light_check.first_batch() as seen:
        tcli.run_simulation(
            inp, str(tmp_path / 'out.h5'), config='module0',
            detector_properties=paths['detector_properties'],
            pixel_layout=paths['pixel_layout'],
            simulation_properties=paths['simulation_properties'],
            response_file=str(tmp_path / 'r.npy'), rand_seed=7,
            step_scale=4.0, device='cpu')
    assert len(seen) == 1
    args, kw = seen[0]
    light = args[1]
    runs = {}
    for smear, truth, route in ((True, 0, None), (False, 16, None),
                                (True, 16, 'device'), (True, 16, 'host')):
        opts = dict(smearing=smear, truth_ids=truth, truth_path=route)
        a = light_check.rerun(args, kw, 'cpu', 5, **opts)
        b = light_check.rerun(args, kw, 'cpu', 5, **opts)
        assert light_check.identical(a, b)
        rec = light_check.compare(a, b, light,
                                  smeared_at=0.1 if route else None)
        assert rec['max_abs_err'] == 0 and rec['peak'] > 64
        assert (rec['records'] > 0) == (truth > 0)
        runs[route] = a
    rec = light_check.compare(runs['device'], runs['host'], light,
                              smeared_at=0.1)
    assert rec['records'] > 0


def test_host_route_worker_error_fails_the_cli(tmp_path, monkeypatch):
    """A host-route worker's error surfaces from run_simulation (read from
    its future in batch order), and no output file is left."""
    from larndsim_tpu_torch.assets.make_input import write_input as twrite
    from larndsim_tpu_torch.models import light as tlight
    paths = tpa.write_tree(tmp_path / 'tree',
                           light=dict(LIGHT, enable_lut_smearing=True),
                           sim_overrides=dict(max_light_truth_ids=16))
    inp = str(tmp_path / 'in.h5')
    twrite(inp, tpa.load_port(paths).tpc_borders, n_events=2,
           tracks_per_event=3, segments_per_track=6, segment_length=0.4,
           dEdx=8.0, seed=7)
    calls = []

    def broken(*args, **kwargs):
        calls.append(kwargs)
        raise RuntimeError('worker failed')
    monkeypatch.setattr(tlight, '_host_smeared_truth_sparse', broken)
    out = tmp_path / 'out.h5'
    with pytest.raises(RuntimeError, match='worker failed'):
        tcli.run_simulation(
            inp, str(out), config='module0',
            detector_properties=paths['detector_properties'],
            pixel_layout=paths['pixel_layout'],
            simulation_properties=paths['simulation_properties'],
            response_file=str(tmp_path / 'r.npy'), rand_seed=7,
            step_scale=4.0, device='cpu', truth_path='host',
            truth_workers=2)
    assert calls and all(kw['as_records'] for kw in calls)
    assert not out.exists()
