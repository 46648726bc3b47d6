"""Two branches of both ``simulate_pixels`` CLIs, held to JAX on the CPU.

Both CLIs run the small tree with deterministic charge (``QUIET``), JAX's
induced current on its Pallas backend (interpret mode), as in
tests/test_torch_cli.py:

* non-beam runs (``is_spill_sim: False``): 4 events at times drawn by
  ``gen_event_times``, charge only and with the threshold light trigger
  (mode 0: the light keys of tests/test_torch_mode0_cli.py, the port's
  light draws taken from the JAX CLI's key tree): ``packets`` equal in
  every field, ``vertices`` (``t_event`` included), ``segments`` and
  ``trajectories`` equal; with light, ``light_trig`` and ``light_dat``
  equal;
* the file flags: ``bad_channels`` (six channels that a plain run hits),
  per-pixel thresholds (x 0.7-1.3 of the default) and gains (x 0.8-1.2)
  over every pixel: ``packets`` equal in every field, none on a bad
  channel, and the files change the packets.
"""
from __future__ import annotations

import functools

import h5py
import numpy as np
import pytest
import yaml

from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.assets.make_input import write_input
from larndsim_tpu_torch.cli import simulate_pixels as tcli

import torch_port_assets as tpa
from test_torch_light_cli import _fed_light_draw
from test_torch_mode0_cli import LIGHT0

INPUT = dict(tracks_per_event=3, segments_per_track=6, segment_length=0.4,
             dEdx=8.0, seed=7)


def _arrays(path, names):
    with h5py.File(path, 'r') as f:
        return {n: np.array(f[n]) for n in names if n in f}


def _assert_same(got, want, name):
    assert got.dtype.names == want.dtype.names, name
    assert len(got) == len(want), (name, len(got), len(want))
    for field in want.dtype.names:
        np.testing.assert_array_equal(got[field], want[field],
                                      err_msg=f'{name}.{field}')


def _run_both(tmp_path, monkeypatch, paths, inp, **kw):
    kw = dict(config='module0',
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0, **kw)
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    monkeypatch.setattr(tcli, 'light_draw', _fed_light_draw)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    jcli.run_simulation(inp, out_j, **kw)
    tcli.run_simulation(inp, out_t, device='cpu', **kw)
    return out_j, out_t


@pytest.mark.parametrize('light', ['charge_only', 'mode0'])
def test_non_beam_clis_agree(tmp_path, monkeypatch, light):
    paths = tpa.write_tree(
        tmp_path / 'tree', detector_overrides=tpa.QUIET,
        light=LIGHT0 if light == 'mode0' else False,
        sim_overrides=dict(is_spill_sim=False))
    dm = tpa.load_port(paths)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, dm.tpc_borders, n_events=4, is_spill=False,
                       **INPUT) > 0
    out_j, out_t = _run_both(tmp_path, monkeypatch, paths, inp)
    names = ('packets', 'vertices', 'segments', 'trajectories',
             'light_trig', 'light_dat/light_dat_allmodules')
    got, want = _arrays(out_t, names), _arrays(out_j, names)
    assert sorted(got) == sorted(want)
    for name in want:
        _assert_same(got[name], want[name], name)
    pk = want['packets']
    assert (pk['packet_type'] == 0).sum() > 0, 'test must produce hits'
    # the events' own times, not the spill grid
    t_event = want['vertices']['t_event']
    assert len(t_event) == 4 and (np.diff(t_event) > 0).all()
    assert not np.allclose(t_event, np.arange(4) * 1.2e6)
    if light == 'mode0':
        assert len(want['light_trig']) >= 4
        assert len(want['light_dat/light_dat_allmodules']) > 0
    else:
        assert 'light_trig' not in want


def test_file_flags_clis_agree(tmp_path, monkeypatch):
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    dm = tpa.load_port(paths)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, dm.tpc_borders, n_events=3, **INPUT) > 0
    plain = str(tmp_path / 'plain.h5')
    tcli.run_simulation(
        inp, plain, config='module0',
        detector_properties=paths['detector_properties'],
        pixel_layout=paths['pixel_layout'],
        simulation_properties=paths['simulation_properties'],
        response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
        step_scale=2.0, device='cpu')
    data = _arrays(plain, ['packets'])['packets']
    data = data[data['packet_type'] == 0]
    chans = sorted({(int(p['io_group']), int(p['io_channel']),
                     int(p['chip_id']), int(p['channel_id'])) for p in data})
    bad = chans[::max(len(chans) // 6, 1)][:6]
    assert len(bad) == 6
    bad_file = str(tmp_path / 'bad.yaml')
    table = {}
    for g, c, chip, ch in bad:
        table.setdefault(f'{g}-{c}-{chip}', []).append(ch)
    with open(bad_file, 'w') as f:
        yaml.safe_dump(table, f)
    nx, ny = dm.params.n_pixels
    keys = np.arange(nx * ny * dm.params.n_tpcs)
    rng = np.random.default_rng(3)
    thr, gain = str(tmp_path / 'thr.npz'), str(tmp_path / 'gain.npz')
    np.savez(thr, keys=keys, default=7e3, values=(
        7e3 * rng.uniform(0.7, 1.3, len(keys))).astype(np.float32))
    np.savez(gain, keys=keys, default=4e-3, values=(
        4e-3 * rng.uniform(0.8, 1.2, len(keys))).astype(np.float32))
    out_j, out_t = _run_both(tmp_path, monkeypatch, paths, inp,
                             bad_channels=bad_file,
                             pixel_thresholds_file=thr,
                             pixel_gains_file=gain)
    got = _arrays(out_t, ['packets'])['packets']
    want = _arrays(out_j, ['packets'])['packets']
    _assert_same(got, want, 'packets')
    hits = got[got['packet_type'] == 0]
    assert len(hits) > 0
    on = {(int(p['io_group']), int(p['io_channel']), int(p['chip_id']),
           int(p['channel_id'])) for p in hits}
    assert not on & set(bad)
    assert sorted(hits['dataword'].tolist()) != sorted(
        data['dataword'].tolist())


def test_run_simulation_takes_jax_parameter_order(monkeypatch):
    """JAX's 27 parameters first, in JAX's order, then the port's
    ``device``, ``truth_path``, ``unique_guard`` and ``pipeline``; the
    argparse ``main`` takes every one of them as a flag."""
    import inspect
    names = list(inspect.signature(tcli.run_simulation).parameters)
    jnames = list(inspect.signature(jcli.run_simulation).parameters)
    assert len(jnames) == 27
    assert names[:27] == jnames
    assert names[27:] == ['device', 'truth_path', 'unique_guard',
                          'pipeline']
    seen = {}
    orig = tcli.run_simulation

    @functools.wraps(orig)
    def capture(*args, **kwargs):
        seen.update(kwargs)
    monkeypatch.setattr(tcli, 'run_simulation', capture)
    tcli.main(['in.h5', 'out.h5', '--n_devices', '2', '--truth_compression',
               'none', '--truth_workers', '3', '--device', '[cpu, cpu]',
               '--truth_path', 'host', '--unique_guard', '0',
               '--step_scale', '4', '--mod2mod_variation', 'true',
               '--pipeline', 'true'])
    assert sorted(seen) == sorted(names)
    assert (seen['n_devices'], seen['truth_compression'],
            seen['truth_workers'], seen['device'], seen['truth_path'],
            seen['unique_guard'], seen['step_scale'],
            seen['mod2mod_variation'], seen['pipeline']) == (
        2, 'none', 3, ['cpu', 'cpu'], 'host', 0, 4.0, True, True)
