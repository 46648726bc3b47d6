"""One call's detector files, each read once (``params.detector.
DetectorFiles`` through ``cli.simulate_pixels.run_simulation``).

The small four-module tree (``torch_port_assets.write_tree_2x2``) with
module variation (``pixel_layout_id`` and ``response_id`` [0, 0, 1, 0]: two
layouts and two responses over four modules), and the small one-layout
tree ungrouped.  Counts are exact: each layout parsed once and each
response read (or, its file absent, made) once a call, spied on where the
loader calls them and tallied in the trace; a second call in the process
reads its files anew.  Every ``DetectorModel`` the CLI builds from the
table equals a fresh ``load_detector`` of the same module field by field
(leaves, statics, host values, the layout's arrays and maps, the TPC
borders and the module maps: tolerance 0).
"""
from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from larndsim_tpu_torch.assets.make_input import write_input
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.geometry import tiles
from larndsim_tpu_torch.params import detector as tdet
from larndsim_tpu_torch.utils import trace

import torch_port_assets as tpa

IDS = [0, 0, 1, 0]


def _kw_2x2(tmp_path):
    paths = tpa.write_tree_2x2(tmp_path / 'tree', light=False,
                               detector_overrides=tpa.QUIET)
    inp = str(tmp_path / 'in.h5')
    geo = tdet.load_detector(paths['detector_properties'],
                             paths['pixel_layout'][0], device='cpu')
    assert tpa.write_spills_2x2(inp, geo.tpc_borders, n_events=1) > 0
    return inp, dict(config='2x2', mod2mod_variation=True,
                     detector_properties=paths['detector_properties'],
                     pixel_layout=paths['pixel_layout'],
                     pixel_layout_id=IDS,
                     simulation_properties=paths['simulation_properties'],
                     response_file=paths['response_file'], response_id=IDS,
                     light_simulated=False, rand_seed=7, step_scale=4.0,
                     device='cpu')


def _kw_single(tmp_path):
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                       tracks_per_event=2, segments_per_track=6,
                       segment_length=0.4, dEdx=8.0, seed=7) > 0
    return inp, dict(config='module0',
                     detector_properties=paths['detector_properties'],
                     pixel_layout=paths['pixel_layout'],
                     simulation_properties=paths['simulation_properties'],
                     response_file=str(tmp_path / '__missing__.npy'),
                     light_simulated=False, rand_seed=7, step_scale=4.0,
                     device='cpu')


def _spy(monkeypatch):
    """Each parse of a layout and each response read, by path."""
    seen = dict(layout=collections.Counter(), response=collections.Counter())
    load_layout, load_response = tiles.load_tile_layout, tcli.load_response

    def layout(path, *args, **kw):
        seen['layout'][path] += 1
        return load_layout(path, *args, **kw)

    def response(path, **kw):
        seen['response'][path] += 1
        return load_response(path, **kw)
    monkeypatch.setattr(tiles, 'load_tile_layout', layout)
    monkeypatch.setattr(tcli, 'load_response', response)
    return seen


def _tallies(kind):
    t = trace.tallies()
    return (t.get(f'cli/detector_files_read/{kind}', 0),
            t.get(f'cli/detector_files_reused/{kind}', 0))


def _parses():
    """Layout reads by the layout grammar's reader and by PyYAML."""
    t = trace.tallies()
    return t.get('layout_parse/fast', 0), t.get('layout_parse/yaml', 0)


@pytest.mark.parametrize('n_devices', [1, 4])
def test_2x2_reads_each_file_once_a_call(tmp_path, monkeypatch, n_devices):
    """Five loads over two layouts: each layout parsed once (by the
    layout grammar's reader, none by PyYAML), each response read once, at
    one context and with the modules on four threads; a second call reads
    them all again."""
    inp, kw = _kw_2x2(tmp_path)
    seen = _spy(monkeypatch)
    for call in range(2):
        for counter in seen.values():
            counter.clear()
        tcli.run_simulation(inp, str(tmp_path / f'out{call}.h5'),
                            n_devices=n_devices, **kw)
        assert sorted(seen['layout'].values()) == [1, 1], call
        assert sorted(seen['layout']) == sorted(kw['pixel_layout'])
        assert sorted(seen['response'].values()) == [1, 1], call
        assert sorted(seen['response']) == sorted(kw['response_file'])
        assert _tallies('layout') == (2, 3), call
        assert _tallies('response') == (2, 2), call
        assert _tallies('detprop') == (1, 5), call
        assert _parses() == (2, 0), call


def test_single_layout_read_once_reused_once(tmp_path, monkeypatch):
    """Ungrouped, no module variation: the geometry's load reads the
    layout, the module's reuses it; the response is read once."""
    inp, kw = _kw_single(tmp_path)
    seen = _spy(monkeypatch)
    tcli.run_simulation(inp, str(tmp_path / 'out.h5'), **kw)
    assert seen['layout'] == {kw['pixel_layout']: 1}
    assert seen['response'] == {kw['response_file']: 1}
    assert _tallies('layout') == (1, 1)
    assert _tallies('response') == (1, 0)


def test_table_reads_once_under_threads():
    """32 threads ask for 4 keys at once, with the interpreter switching
    threads every microsecond: each key read once, each thread handed its
    key's one object, every other ask a reuse."""
    table = tdet.DetectorFiles('cli/detector_files')
    reads = collections.Counter()
    got = {}
    start = threading.Barrier(32)

    def read(key):
        reads[key] += 1
        time.sleep(0.01)
        return object()

    def ask(i):
        start.wait()
        key = f'{i % 4}.yaml'
        got[i] = (key, table.get('layout', key, lambda: read(key)))
    trace.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reads == {f'{k}.yaml': 1 for k in range(4)}
    assert len(got) == 32
    assert len({id(obj) for _, obj in got.values()}) == 4
    assert all(obj is got[k][1] for key, obj in got.values()
               for k in range(4) if got[k][0] == key)
    assert _tallies('layout') == (4, 28)


def test_tallies_stay_out_of_the_phase_tables():
    """A tally times nothing: the phase tables and the report are those of
    the phases alone; ``reset`` clears the tallies with them."""
    trace.reset()
    with trace.phase('cli/detector'):
        trace.tally('cli/detector_files_read/layout')
        trace.tally('cli/detector_files_read/layout')
    assert trace.tallies() == {'cli/detector_files_read/layout': 2}
    assert set(trace.summary()) == set(trace.summary_cpu()) \
        == {'cli/detector'}
    assert 'detector_files' not in trace.report()
    trace.reset()
    assert trace.tallies() == {} and trace.report() == ''


@pytest.fixture(scope='module')
def cli_models(tmp_path_factory):
    """The models the CLI builds in one 2x2 call, by ``i_module`` (-1 the
    geometry's load of module 1's layout), and the call's files."""
    tmp_path = tmp_path_factory.mktemp('models')
    inp, kw = _kw_2x2(tmp_path)
    models = {}
    orig = tcli.load_detector

    def spy(det, layout, i_module=-1, **kwargs):
        models[i_module] = (layout, orig(det, layout, i_module=i_module,
                                         **kwargs))
        return models[i_module][1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, 'load_detector', spy)
        tcli.run_simulation(inp, str(tmp_path / 'out.h5'), **kw)
    return models, kw


def _assert_same_model(got, want):
    for name in tdet.LEAVES:
        assert torch.equal(getattr(got.params, name),
                           getattr(want.params, name)), name
    for name in tdet.STATICS:
        assert getattr(got.params, name) == getattr(want.params, name), name
    assert got.params.host.keys() == want.params.host.keys()
    for name, value in want.params.host.items():
        np.testing.assert_array_equal(got.params.host[name], value,
                                      err_msg=name)
    for f in dataclasses.fields(tiles.TileLayout):
        a, b = getattr(got.layout, f.name), getattr(want.layout, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(got.tpc_borders, want.tpc_borders)
    for name in ('tile_map', 'module_to_io_groups', 'module_to_tpcs',
                 'tpc_to_module', 'mod_ids'):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize('i_module', [1, 2, 3, 4, -1])
def test_cli_models_equal_fresh_loads(cli_models, i_module):
    """Each model built from the table equals a fresh load of its
    module; module 3 keeps its own layout, lifetime and bin size."""
    models, kw = cli_models
    assert sorted(models) == [-1, 1, 2, 3, 4]
    layout, got = models[i_module]
    want = tdet.load_detector(kw['detector_properties'], layout,
                              i_module=i_module, device='cpu')
    _assert_same_model(got, want)
    one = models[1][1].params.host
    if i_module == 3:
        assert got.params.host['electron_lifetime'] == 2.0e3 \
            != one['electron_lifetime']
        assert got.params.host['response_bin_size'] \
            != one['response_bin_size']
        assert got.params.n_pixels != models[1][1].params.n_pixels
    else:
        assert got.params.host['electron_lifetime'] == 2.2e3
