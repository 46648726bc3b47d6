"""Event grouping end to end: the ``simulate_pixels`` CLIs with
``event_group_size`` > 1.

On the QUIET tree (no diffusion, no noise) a run is deterministic, so:
the port's grouped run gives the data packets of its ungrouped run (equal
as multisets), and agrees with the JAX CLI's grouped run on >= 99% of
data packets (tolerance of tests/test_torch_cli.py).  With light on
(beam trigger, each smearing truth route) the grouped run also gives the
ungrouped run's ``light_wvfm`` (equal) and truth records (equal on the
host route; beyond 1e-3 of the threshold equal with pe_current at rtol
1e-4 / atol 1e-5 on the device route).  A group closes at
``sim.batch_size`` segments and at the ``unique_guard``.  The JAX CLI
triggers an event twice when two of its batches share a group (the port
triggers once, as both CLIs do ungrouped).  The phase table names the
JAX labels and counts the calls; ``save_memory`` writes the memory log.
"""
from __future__ import annotations

import collections
import functools
import os

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.tools.light_check import records_agree
from larndsim_tpu_torch.utils.memlog import read_memlog

import torch_port_assets as tpa
from test_torch_cli import _data_packets

LIGHT = dict(n_op_channel=12, light_window=(0.0, 2.0))
#: 4 events; two of them have segments in both TPCs (6 of the 8 (event,
#: TPC) batches hold segments)
INPUT = dict(n_events=4, tracks_per_event=3, segments_per_track=6,
             segment_length=0.4, dEdx=8.0, seed=7)


def _setup(tmp_path, light=False, **sim):
    paths = tpa.write_tree(
        tmp_path / 'tree', detector_overrides=tpa.QUIET,
        light=dict(LIGHT, enable_lut_smearing=True) if light else False,
        sim_overrides=dict(max_light_truth_ids=16) if light else sim)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, tpa.load_jax(paths).tpc_borders, **INPUT) > 0
    kw = dict(config='module0',
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0)
    return inp, kw


def _spy_calls(monkeypatch):
    """Each port charge call's (segments, events) as the CLI makes it."""
    calls = []
    orig = tcli.simulate_charge_batch

    def spy(segs, *args, event_slot=None, **kw):
        n = int(segs.valid.sum())
        calls.append((n, 1 if event_slot is None
                      else int(event_slot[:n].max()) + 1))
        return orig(segs, *args, event_slot=event_slot, **kw)
    monkeypatch.setattr(tcli, 'simulate_charge_batch', spy)
    return calls


def _run(inp, out, kw, **extra):
    tcli.run_simulation(inp, out, device='cpu', **dict(kw, **extra))


def _light(path):
    with h5py.File(path, 'r') as f:
        return {k: np.array(f[k]) for k in ('light_wvfm',
                                             'light_wvfm_mc_assn')}


def test_port_grouped_agrees_with_jax_grouped(tmp_path, monkeypatch):
    inp, kw = _setup(tmp_path)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    jcli.run_simulation(inp, out_j, light_simulated=False,
                        event_group_size=3, **kw)
    calls = _spy_calls(monkeypatch)
    _run(inp, out_t, kw, light_simulated=False, event_group_size=3)
    assert max(n_ev for _, n_ev in calls) == 3
    keys_j, _ = _data_packets(out_j)
    keys_t, _ = _data_packets(out_t)
    assert len(keys_j) > 0
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))


@pytest.mark.parametrize('route', ['charge', 'device', 'host'])
def test_grouped_run_equals_ungrouped(tmp_path, monkeypatch, capsys, route):
    light = route != 'charge'
    inp, kw = _setup(tmp_path, light=light)
    if light:
        kw['truth_path'] = route
    out1, out3 = str(tmp_path / 'g1.h5'), str(tmp_path / 'g3.h5')
    _run(inp, out1, kw)
    capsys.readouterr()
    calls = _spy_calls(monkeypatch)
    mem = str(tmp_path / 'mem.h5')
    _run(inp, out3, kw, event_group_size=3, save_memory=mem)
    table = capsys.readouterr().out.split('Phase breakdown:\n')[1]
    rows = {r.split()[0]: int(r.split()[-2]) for r in table.splitlines()}
    assert rows['charge_batch'] == rows['charge/current_pallas'] \
        == len(calls) < 6
    assert {'charge/get_pixels', 'charge/npix_sync', 'charge/prep',
            'charge/fee_stage', 'charge/pull', 'export/flush'} <= set(rows)
    # the truth drain opens where there is truth
    assert ('truth/drain' in rows) == light
    if light:
        assert rows['light_batch'] == len(calls)
        assert ('truth/pull' if route == 'device' else 'truth/worker') \
            in rows
    assert max(n_ev for _, n_ev in calls) > 1

    keys1, _ = _data_packets(out1)
    keys3, _ = _data_packets(out3)
    assert len(keys1) > 0
    assert collections.Counter(keys1) == collections.Counter(keys3)
    if light:
        l1, l3 = _light(out1), _light(out3)
        assert l1['light_wvfm'].shape == (6, 12, 256)
        np.testing.assert_array_equal(l3['light_wvfm'], l1['light_wvfm'])
        r1, r3 = l1['light_wvfm_mc_assn'], l3['light_wvfm_mc_assn']
        assert len(r1) > 1000
        if route == 'host':
            np.testing.assert_array_equal(r3, r1)
        else:
            records_agree(r3, r1, 0.1, keys=('trigger_id', 'op_channel_id',
                                             'tick', 'event_id',
                                             'segment_id'))
    tables = read_memlog(mem)
    assert set(tables) == {'loading', 'quench_drift_mod-1', 'loop_mod-1'}
    loop = tables['loop_mod-1']
    assert len(loop) == 6       # one snapshot per batch with segments
    assert (np.asarray(loop['gpu_mem_used']) == 0).all()   # the CPU
    assert sorted(os.listdir(tmp_path)) == sorted(
        ['tree', 'in.h5', 'g1.h5', 'g3.h5', 'mem.h5'])


def test_group_closes_on_batch_size(tmp_path, monkeypatch):
    """A group of up to 8 batches closes before it passes sim.batch_size
    segments."""
    inp, kw = _setup(tmp_path, batch_size=30)
    calls = _spy_calls(monkeypatch)
    _run(inp, str(tmp_path / 'o.h5'), kw, event_group_size=8)
    assert calls and all(n <= 30 for n, _ in calls)
    assert len(calls) > 1 and max(n_ev for _, n_ev in calls) > 1


def test_unique_guard_splits_groups(tmp_path, monkeypatch):
    """Once a call has measured its unique pixels per segment, a group
    closes before its estimate passes ``unique_guard``: with a guard of
    1 the first call groups, every later call holds one batch; with the
    guard off (0) every call groups."""
    inp, kw = _setup(tmp_path)
    calls = _spy_calls(monkeypatch)
    _run(inp, str(tmp_path / 'o.h5'), kw, event_group_size=3,
         unique_guard=1)
    assert calls[0][1] == 3 and all(n_ev == 1 for _, n_ev in calls[1:])
    assert len(calls) == 4
    calls.clear()
    _run(inp, str(tmp_path / 'o0.h5'), kw, event_group_size=3,
         unique_guard=0)
    assert [n_ev for _, n_ev in calls] == [3, 3]


def test_an_event_triggers_once_per_group(tmp_path, monkeypatch):
    """Two batches of one event in one group: the JAX CLI puts both into
    its grouped light call, so the event triggers twice (one light_wvfm
    row too many); the port triggers on the event's first batch only, as
    both CLIs do ungrouped, and writes the ungrouped run's rows."""
    inp, kw = _setup(tmp_path, light=True)
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    groups = []
    orig = jcli.simulate_light_group

    def spy(segs_g, det_model, light, sim, inc_g, vox_g, lut, noise,
            key_mod, ev_ids, *args, **kw_):
        groups.append([int(e) for e in ev_ids])
        return orig(segs_g, det_model, light, sim, inc_g, vox_g, lut, noise,
                    key_mod, ev_ids, *args, **kw_)
    monkeypatch.setattr(jcli, 'simulate_light_group', spy)
    out_j = str(tmp_path / 'jax.h5')
    jcli.run_simulation(inp, out_j, event_group_size=4,
                        truth_compression='none', **kw)
    assert any(len(set(g)) < len(g) for g in groups), groups
    out_t1, out_t4 = str(tmp_path / 't1.h5'), str(tmp_path / 't4.h5')
    _run(inp, out_t1, kw)
    _run(inp, out_t4, kw, event_group_size=4)
    wj = _light(out_j)['light_wvfm']
    w1, w4 = _light(out_t1)['light_wvfm'], _light(out_t4)['light_wvfm']
    np.testing.assert_array_equal(w4, w1)
    assert len(wj) > len(w1) == 6
