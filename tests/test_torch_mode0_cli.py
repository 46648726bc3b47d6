"""Port parity end to end with the threshold light trigger (mode 0): both
``simulate_pixels`` CLIs.

Both run the small tree with deterministic charge (``QUIET``) and the
light keys of tests/test_torch_mode0.py (12 channels in mode 0, a [0, 2]
us light window), each event's tracks in one batch (``event_batch_size``
2: both TPCs), ungrouped and at ``event_group_size`` 3, so that a light
group holds one batch per event.  The port's light draws are taken from
the JAX CLI's key tree through ``cli.simulate_pixels.light_draw``
(tests/test_torch_light_cli.py).

Tolerances: data packets as in tests/test_torch_cli.py; the trigger and
timestamp packets per io group equal; ``light_trig`` field by field equal;
``light_wvfm`` within one quantum (64 ADC), >= 99.9% of samples equal;
contributor-point truth records equal with pe_current at rtol 1e-4 / atol
1e-6; LUT-smearing truth records on the host route by
``tools.light_check.records_agree`` against the JAX CLI's host route.
"""
from __future__ import annotations

import collections
import functools

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.models import light as jlight
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.tools.light_check import records_agree

import torch_port_assets as tpa
from test_torch_cli import _data_packets
from test_torch_light_cli import _fed_light_draw

LIGHT0 = dict(n_op_channel=12, light_window=(0.0, 2.0), light_trig_mode=0)
INPUT = dict(n_events=5, tracks_per_event=3, segments_per_track=6,
             segment_length=0.4, dEdx=8.0, seed=7)
COLUMNS = ('trigger_id', 'op_channel_id', 'tick', 'event_id', 'segment_id')


def _service_packets(path) -> dict:
    """Trigger (7) and timestamp (4) packets per io group, as multisets of
    (type, timestamp, trigger_type)."""
    with h5py.File(path, 'r') as f:
        pk = np.array(f['packets'])
    out = collections.defaultdict(collections.Counter)
    for p in pk[np.isin(pk['packet_type'], (4, 7))]:
        out[int(p['io_group'])][(int(p['packet_type']), int(p['timestamp']),
                                 int(p['trigger_type']))] += 1
    return out


@pytest.mark.parametrize('case', ['contributor_truth', 'grouped',
                                  'smearing_truth_host'])
def test_clis_agree_in_mode0(tmp_path, monkeypatch, case):
    smear = case.startswith('smearing')
    group = 3 if case == 'grouped' else 1
    paths = tpa.write_tree(
        tmp_path / 'tree', detector_overrides=tpa.QUIET,
        light=dict(LIGHT0, enable_lut_smearing=smear),
        sim_overrides=dict(max_light_truth_ids=16, event_batch_size=2))
    dm = tpa.load_jax(paths)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, dm.tpc_borders, **INPUT) > 0
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0, event_group_size=group)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    if smear:
        monkeypatch.setenv('LARNDSIM_TRUTH_PATH', 'host')
        monkeypatch.setattr(jlight, '_TRUTH_PATH_CACHE', [])
    groups = []
    orig = jlight.simulate_light_group_mode0

    def spy(segs_g, *args, **kwargs):
        groups.append(args[9])          # the group's event ids
        return orig(segs_g, *args, **kwargs)
    monkeypatch.setattr(jlight, 'simulate_light_group_mode0', spy)
    jcli.run_simulation(inp, out_j, config='module0',
                        truth_compression='none', **kw)
    monkeypatch.setattr(tcli, 'light_draw', _fed_light_draw)
    calls = []
    orig_t = tcli.light_model.simulate_light_group_mode0

    def spy_t(*args, **kwargs):
        if len(kwargs['event_ids']) > 1:    # not a solo call's group of one
            calls.append(kwargs['event_ids'])
        return orig_t(*args, **kwargs)
    monkeypatch.setattr(tcli.light_model, 'simulate_light_group_mode0',
                        spy_t)
    tcli.run_simulation(inp, out_t, config='module0', device='cpu',
                        **kw, **(dict(truth_path='host') if smear else {}))
    # the grouped runs hold a mode-0 group of several events, alike
    assert [[int(e) for e in g] for g in groups] == calls
    assert (len(calls) > 0) == (group > 1)

    keys_j, _ = _data_packets(out_j)
    keys_t, _ = _data_packets(out_t)
    assert len(keys_j) > 0
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    svc_j, svc_t = _service_packets(out_j), _service_packets(out_t)
    assert svc_t == svc_j
    # mode 0 forwards its triggers to every io group of the module
    assert all(any(k[0] == 7 for k in svc_j[g]) for g in (1, 2))

    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        tj, tt = np.array(fj['light_trig']), np.array(ft['light_trig'])
        assert tt.dtype == tj.dtype and len(tt) == len(tj)
        for name in tj.dtype.names:
            np.testing.assert_array_equal(tt[name], tj[name], err_msg=name)
        wj, wt = np.array(fj['light_wvfm']), np.array(ft['light_wvfm'])
        assert wt.shape == wj.shape and len(wt) == len(tj)
        # several triggers in some event
        assert len(wj) > INPUT['n_events']
        assert np.abs(wj).max() > 64, 'test must produce a waveform'
        d = np.abs(wt.astype(np.float64) - wj)
        assert d.max() <= 64 and (d == 0).mean() >= 0.999, \
            (d.max(), (d == 0).mean())
        rj = np.array(fj['light_wvfm_mc_assn'])
        rt = np.array(ft['light_wvfm_mc_assn'])
    assert rt.dtype == rj.dtype and len(rj) > 0
    assert len(np.unique(rj['trigger_id'])) > INPUT['n_events']
    if smear:
        assert records_agree(rt, rj, 0.1, keys=COLUMNS)['records'] > 1000
        return
    for name in COLUMNS:
        np.testing.assert_array_equal(rt[name], rj[name], err_msg=name)
    np.testing.assert_allclose(rt['pe_current'], rj['pe_current'],
                               rtol=1e-4, atol=1e-6)
