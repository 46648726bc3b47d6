"""The one-worker compute pipeline of the port's CLI (``pipeline``, the
JAX CLI's ``LARNDSIM_PIPELINE=1``), on the CPU.

With ``pipeline=True`` a module with one dispatch context computes its
groups on that context's worker thread (``dispatch-ctx0`` without module
variation, ``module-{m}-ctx0`` with it) while its own thread plans,
accumulates and writes.  Every dataset is equal, bit for bit
(``tools.file_check``), to the inline run's, on the small Module-0 tree at
``event_group_size`` 2 (charge only; beam light with the LUT-smearing
truth by the host route; the threshold trigger, mode 0; a unique-pixel
guard that closes groups, at ``event_group_size`` 3) and on the small 2x2
tree (module variation, light with the smearing truth) at ``n_devices`` 1
and 4 (four module threads, each with its own worker); the charge calls
come in the same order with the same unique pixels.  The JAX CLI under
``LARNDSIM_PIPELINE=1`` and the port's with ``pipeline=True`` agree on the
packets of the noise-free tree with the tolerances of
tests/test_torch_cli.py: data packets >= 99% matched, matched packets'
fractions per segment id within atol 1e-4 (a segment of fraction 0.0
may be stored on one side only: it ties with the padding).
"""
from __future__ import annotations

import collections
import functools
import threading

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.tools.file_check import differences

import torch_port_assets as tpa
from test_torch_cli import _assert_same_segments, _data_packets, _truth
from test_torch_ndev import _module0, _spy_charge
from test_torch_ndev_2x2 import _paths_2x2


def _run(tmp_path, monkeypatch, inp, kw, name, **extra):
    """One CLI run: (output, charge calls as (thread, unique pixels,
    bound))."""
    calls = _spy_charge(monkeypatch)
    path = str(tmp_path / f'{name}.h5')
    tcli.run_simulation(inp, path, **kw, **extra)
    return path, calls


@pytest.mark.parametrize('case', ['charge', 'beam_host', 'mode0', 'guard'])
def test_pipeline_same_datasets(tmp_path, monkeypatch, case):
    inp, kw = _module0(tmp_path, 'charge' if case == 'guard' else case)
    if case == 'guard':
        kw.update(event_group_size=3, unique_guard=60)
    off, calls_off = _run(tmp_path, monkeypatch, inp, kw, 'off')
    on, calls_on = _run(tmp_path, monkeypatch, inp, kw, 'on', pipeline=True)
    assert differences(off, on) == []
    assert {c[0] for c in calls_off} == {'MainThread'}
    assert {c[0] for c in calls_on} == {'dispatch-ctx0_0'}
    assert [c[1] for c in calls_on] == [c[1] for c in calls_off]
    assert len(calls_on) >= 3
    with h5py.File(on, 'r') as f:
        assert (np.array(f['packets'])['packet_type'] == 0).sum() > 0
        if case in ('beam_host', 'mode0'):
            assert len(f['light_wvfm']) > 0
            assert len(f['light_wvfm_mc_assn']) > 0
    if case == 'guard':
        # the guard closed groups: more calls than without it
        free = _run(tmp_path, monkeypatch, inp, dict(kw, unique_guard=0),
                    'free', pipeline=True)[1]
        assert len(calls_on) > len(free)


@pytest.mark.parametrize('n_devices', [1, 4])
def test_pipeline_2x2(tmp_path, monkeypatch, n_devices):
    """The 2x2 with the smearing truth: at n_devices 1 the modules in turn,
    at 4 on threads of their own, each module's groups on its own worker."""
    inp, kw = _paths_2x2(tmp_path, enable_lut_smearing=True)
    kw = dict(kw, device='cpu')
    off, calls_off = _run(tmp_path, monkeypatch, inp, kw, 'off')
    on, calls_on = _run(tmp_path, monkeypatch, inp, kw, 'on',
                        n_devices=n_devices, pipeline=True)
    assert differences(off, on) == []
    assert {c[0] for c in calls_on} == {f'module-{m}-ctx0_0'
                                        for m in range(1, 5)}
    assert sorted(c[1] for c in calls_on) == sorted(c[1] for c in calls_off)
    with h5py.File(on, 'r') as f:
        assert f['light_wvfm'].shape[1] == 24
        assert len(f['light_wvfm_mc_assn']) > 0


def test_pipeline_agrees_with_jax(tmp_path, monkeypatch):
    """Both CLIs with their pipeline on, charge only, noise-free: the JAX
    CLI's groups on its worker thread, the port's on its context's."""
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, tpa.load_jax(paths).tpc_borders, n_events=3,
                       tracks_per_event=3, segments_per_track=6,
                       segment_length=0.4, dEdx=8.0, seed=2) > 0
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_simulated=False, rand_seed=7, step_scale=2.0,
              config='module0')
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    threads_j = []

    def jax_charge(*args, **kwargs):
        threads_j.append(threading.current_thread().name)
        return jcharge.simulate_charge_batch(*args, backend='pallas',
                                             **kwargs)
    monkeypatch.setattr(jcli, 'simulate_charge_batch', jax_charge)
    monkeypatch.setenv('LARNDSIM_PIPELINE', '1')
    jcli.run_simulation(inp, out_j, **kw)
    calls = _spy_charge(monkeypatch)
    tcli.run_simulation(inp, out_t, device='cpu', pipeline=True, **kw)
    assert threads_j and 'MainThread' not in threads_j
    assert {c[0] for c in calls} == {'dispatch-ctx0_0'}
    assert len(calls) == len(threads_j)

    keys_j, assn_j = _data_packets(out_j)
    keys_t, assn_t = _data_packets(out_t)
    assert len(keys_j) > 0, 'test must produce data packets'
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    by_key_t = dict(zip(keys_t, map(_truth, assn_t)))
    for k, want in zip(keys_j, map(_truth, assn_j)):
        if k in by_key_t:
            got = by_key_t[k]
            _assert_same_segments(got, want, k)
            for seg in set(got) & set(want):
                assert got[seg] == pytest.approx(want[seg], abs=1e-4), \
                    (k, seg)
