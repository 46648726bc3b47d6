"""Port parity end to end: both ``simulate_pixels`` CLIs, charge only.

Both run on a tiny generated geometry with diffusion and every noise
charge set to 0, so each run is deterministic and the two packet streams
can be compared packet by packet.  The JAX run takes its production
induced-current backend (the Pallas kernel, interpret mode on CPU), whose
response-window edges the port follows.

Tolerance: data packets (``packet_type == 0``) agree on (io_group,
io_channel, chip_id, channel_id, timestamp, dataword) for >= 99% of
packets, and matched packets carry the same ``mc_packets_assn`` segment
ids with fractions within atol 1e-4 (tied fractions may sort either
way: a segment of zero fraction ties with the padding, so one side may
store it where the other stores padding; the count of stored segments of
nonzero fraction is equal).  Also: the port imports no JAX, and runs
where neither JAX, the JAX package nor h5py can be imported.
"""
from __future__ import annotations

import collections
import functools
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.cli import simulate_pixels as tcli

import torch_port_assets as tpa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: an unset id: -1 stored through the input's uint32 id columns
NO_ID = 0xFFFFFFFF
FIELDS = ('io_group', 'io_channel', 'chip_id', 'channel_id', 'timestamp',
          'dataword')


def _data_packets(path):
    with h5py.File(path, 'r') as f:
        pk = np.array(f['packets'])
        assn = np.array(f['mc_packets_assn'])
        assert len(assn) == len(pk)
        for name in ('segments', 'trajectories', 'vertices'):
            assert name in f, name
    data = pk['packet_type'] == 0
    keys = [tuple(int(p[k]) for k in FIELDS) for p in pk[data]]
    return keys, assn[data]


def _truth(assn_row):
    """{segment id: fraction} of one association row (padding dropped)."""
    return {int(s): float(f) for s, f in zip(assn_row['segment_ids'],
                                             assn_row['fraction'])
            if s not in (NO_ID, -1)}


def _assert_same_segments(got, want, key):
    """Two association rows ({segment id: fraction}) store as many
    segments of nonzero fraction, and the same segments but for those of
    fraction 0.0: these tie with the padding, which the port orders by
    slot and the JAX package by numpy's unstable sort, so one side may
    store one where the other stores padding."""
    assert (sum(f != 0 for f in got.values())
            == sum(f != 0 for f in want.values())), key
    for seg in set(got) ^ set(want):
        assert {**want, **got}[seg] == 0.0, (key, seg)


def test_clis_agree(tmp_path, monkeypatch):
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    dm = tpa.load_jax(paths)
    inp = str(tmp_path / 'in.h5')
    n = write_input(inp, dm.tpc_borders, n_events=2, tracks_per_event=3,
                    segments_per_track=6, segment_length=0.4, dEdx=8.0,
                    seed=2)
    assert n > 0
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_simulated=False, rand_seed=7, step_scale=2.0)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    jcli.run_simulation(inp, out_j, config='module0', **kw)
    tcli.run_simulation(inp, out_t, config='module0', device='cpu', **kw)

    keys_j, assn_j = _data_packets(out_j)
    keys_t, assn_t = _data_packets(out_t)
    assert len(keys_j) > 0, 'test must produce data packets'
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    by_key_j = dict(zip(keys_j, map(_truth, assn_j)))
    by_key_t = dict(zip(keys_t, map(_truth, assn_t)))
    for k in set(by_key_j) & set(by_key_t):
        want, got = by_key_j[k], by_key_t[k]
        _assert_same_segments(got, want, k)
        for seg in set(got) & set(want):
            assert got[seg] == pytest.approx(want[seg], abs=1e-4), (k, seg)
    with h5py.File(out_t, 'r') as f:
        adc = np.array(f['packets'])['dataword'][
            np.array(f['packets'])['packet_type'] == 0]
        assert ((adc >= 0) & (adc <= 255)).all()


@pytest.mark.parametrize('what', ['mode0', 'smearing_truth'])
def test_cli_refuses_what_it_does_not_run(tmp_path, what):
    """The threshold light trigger (mode 0) runs on the tiny tree
    (tests/test_torch_mode0_cli.py holds it to the JAX CLI), and a trigger
    mode the reference does not have is refused before the input is read;
    so is a route of the MC truth with LUT smearing other than its two
    (tests/test_torch_light_cli.py runs those)."""
    paths = tpa.write_tree(
        tmp_path / 'tree', light=dict(light_trig_mode=0, n_op_channel=12,
                                      light_window=(0.0, 2.0))
        if what == 'mode0' else True,
        sim_overrides=dict(max_light_truth_ids=3))
    inp = tmp_path / 'in.h5'
    inp.write_bytes(b'')
    error, kw = ((NotImplementedError, {}) if what == 'mode0'
                 else (ValueError, dict(truth_path='tunnel')))
    if what == 'mode0':
        from larndsim_tpu_torch.assets.make_input import write_input
        run = str(tmp_path / 'run.h5')
        write_input(run, tpa.load_port(paths).tpc_borders, n_events=2,
                    tracks_per_event=3, segments_per_track=6,
                    segment_length=0.4, dEdx=8.0, seed=7)
        tcli.run_simulation(
            run, str(tmp_path / 'out.h5'), config='module0',
            detector_properties=paths['detector_properties'],
            pixel_layout=paths['pixel_layout'],
            simulation_properties=paths['simulation_properties'],
            response_file=str(tmp_path / 'r.npy'), rand_seed=7,
            step_scale=4.0, device='cpu')
        with h5py.File(tmp_path / 'out.h5', 'r') as f:
            trig = np.array(f['light_trig'])
            assert len(trig) == len(f['light_wvfm']) > 2
            assert len(f['light_wvfm_mc_assn']) > 0
        with open(paths['detector_properties']) as f:
            text = f.read().replace('light_trig_mode: 0',
                                    'light_trig_mode: 2')
        with open(paths['detector_properties'], 'w') as f:
            f.write(text)
    with pytest.raises(error):
        tcli.run_simulation(
            str(inp), str(tmp_path / 'o.h5'), config='module0',
            detector_properties=paths['detector_properties'],
            pixel_layout=paths['pixel_layout'],
            simulation_properties=paths['simulation_properties'],
            light_simulated=True, device='cpu', **kw)


def test_port_runs_without_jax_or_h5py(tmp_path):
    """The port imports no JAX, and runs end to end, light on, where
    neither JAX, the JAX package nor h5py can be imported (as on a machine
    that has only PyTorch)."""
    paths = tpa.write_tree(tmp_path / 'tree', light=dict(
        n_op_channel=12, light_window=(0.0, 2.0)))
    code = (
        'import importlib, pkgutil, sys\n'
        'class Block:\n'
        '    def find_spec(self, name, path=None, target=None):\n'
        '        if name.split(".")[0] in ("jax", "jaxlib", "flax", "h5py",\n'
        '                                  "larndsim_tpu"):\n'
        '            raise ImportError(name)\n'
        'sys.meta_path.insert(0, Block())\n'
        'import larndsim_tpu_torch as p\n'
        'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
        '    importlib.import_module(m.name)\n'
        'from larndsim_tpu_torch.assets.make_input import write_input\n'
        'from larndsim_tpu_torch.cli.simulate_pixels import run_simulation\n'
        'from larndsim_tpu_torch.io.h5 import File\n'
        'from larndsim_tpu_torch.params import load_detector\n'
        f'det, lay, simp, d = {paths["detector_properties"]!r}, '
        f'{paths["pixel_layout"]!r}, {paths["simulation_properties"]!r}, '
        f'{str(tmp_path)!r}\n'
        'write_input(d + "/in.h5",\n'
        '            load_detector(det, lay, device="cpu").tpc_borders,\n'
        '            n_events=1, tracks_per_event=2, segments_per_track=4,\n'
        '            dEdx=8.0, seed=2)\n'
        'run_simulation(d + "/in.h5", d + "/out.h5", config="module0",\n'
        '               detector_properties=det, pixel_layout=lay,\n'
        '               simulation_properties=simp,\n'
        '               response_file=d + "/r.npy", rand_seed=7,\n'
        '               step_scale=4.0, device="cpu")\n'
        'with File(d + "/out.h5") as f:\n'
        '    assert len(f["packets"]) == len(f["mc_packets_assn"]) > 0\n'
        '    assert f["light_wvfm"].shape[1:] == (12, 256)\n'
        '    assert len(f["light_trig"]) == 1\n'
        'bad = [m for m in ("jax", "flax", "jaxlib", "h5py", "larndsim_tpu")\n'
        '       if m in sys.modules]\n'
        'assert not bad, bad\n'
        'print("ok")\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and 'ok' in proc.stdout, proc.stderr
    with h5py.File(str(tmp_path / 'out.h5'), 'r') as f:
        assert {'packets', 'mc_packets_assn', 'segments', 'light_wvfm',
                'light_trig', 'light_dat'} <= set(f.keys())


#: the charge chain's phases (``models/charge.py``): one each a charge call
CHARGE_PHASES = ('charge_batch', 'charge/get_pixels', 'charge/npix_sync',
                 'charge/prep', 'charge/current_pallas', 'charge/fee_stage',
                 'charge/pull')


@pytest.mark.parametrize('tree', ['module0', '2x2'])
def test_phase_table_names_the_cli_and_output_work(tmp_path, monkeypatch,
                                                   tree):
    """The CLI's own work and every file write sit in phases, with counts
    that follow from the run: the input once; the first layout's geometry
    and each module's detector model, and each module's quench and drift;
    the batcher's construction and each of its (event, TPC group) steps;
    the segments and the accumulation of each charge call; a timestamp
    write each event on the trigger module; the final exports once.  The
    charge chain's and the output's phases keep their counts: one a charge
    call, a flush a call (``write_batch_size`` 1), one final flush and
    truth drain a module."""
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.utils import trace
    batchers = []

    class Batcher(tcli.TPCBatcher):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.filled = sum(bool(mask.any()) for _, mask in
                              super().__iter__())
            batchers.append(self)
    monkeypatch.setattr(tcli, 'TPCBatcher', Batcher)
    if tree == '2x2':
        paths = tpa.write_tree_2x2(tmp_path / 'tree', light=False)
        borders = tpa.load_port(dict(
            paths, pixel_layout=paths['pixel_layout'][0])).tpc_borders
        inp = str(tmp_path / 'in.h5')
        assert tpa.write_spills_2x2(inp, borders, n_events=2) > 0
        kw = dict(config='2x2', mod2mod_variation=True,
                  response_file=paths['response_file'])
        n_modules = 4
    else:
        paths = tpa.write_tree(tmp_path / 'tree')
        inp = str(tmp_path / 'in.h5')
        assert write_input(inp, tpa.load_port(paths).tpc_borders, n_events=3,
                           tracks_per_event=3, segments_per_track=6,
                           segment_length=0.4, dEdx=8.0, seed=2) > 0
        kw = dict(config='module0',
                  response_file=str(tmp_path / '__missing__.npy'))
        n_modules = 1
    tcli.run_simulation(
        inp, str(tmp_path / 'out.h5'),
        detector_properties=paths['detector_properties'],
        pixel_layout=paths['pixel_layout'],
        simulation_properties=paths['simulation_properties'],
        light_simulated=False, rand_seed=7, step_scale=4.0, device='cpu',
        **kw)
    calls = {label: n for label, (_, n) in trace.summary().items()}
    assert len(batchers) == n_modules
    n_charge = sum(b.filled for b in batchers)
    assert n_charge > n_modules
    assert calls.pop('cli/input') == 1
    assert calls.pop('cli/detector') == 1 + n_modules
    assert calls.pop('cli/quench_drift') == n_modules
    assert calls.pop('cli/batching') == sum(len(b) + 1 for b in batchers)
    assert calls.pop('cli/segments') == calls.pop('cli/accumulate') \
        == n_charge
    # every module batches every event of the file
    assert calls.pop('export/timestamp') == len(batchers[0].events)
    assert calls.pop('export/sync') >= 1
    assert calls.pop('export/final') == 1
    # the charge chain's phases and the flushes; with no truth, no truth
    # drain
    assert calls == dict.fromkeys(CHARGE_PHASES + ('export',), n_charge) \
        | dict.fromkeys(('export/flush',), n_modules)
