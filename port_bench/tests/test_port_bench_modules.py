"""Configurations of several modules and comparisons named by the
configuration, on the CPU.

The small four-module 2x2 tree (``write_2x2`` with one tile of 14 x 14 or
16 x 16 pixels an anode, light on) goes through ``assets.prepare`` (two
pixel layouts with a response each, two light tables) and through
``harness.run_cell`` with module variation (the program's plain versions
on the CPU), whose charge comparison follows each module's layout,
response, constants and draws.  The mix puts one vertex in one TPC of
every module in each of its two spills, so that every module triggers its
light alike, and the sample takes every unit.  Comparisons are found by
the names a configuration lists, in the directory ``run_cell`` is given.
"""
import functools
import json
import os
import shutil
import time

import numpy as np
import pytest

from port_bench import assets, harness, traffic
from port_bench.reference import charge, detector
from port_bench.reference.frozen.assets.response import make_response

PREPARE = assets.prepare
SEED = 2**31 + 11
CONFIG = dict(
    name='twobytwo_small', reduced=[],
    assets=dict(writer='write_2x2', kwargs=dict(
        tiles=[1, 1], pixels_per_tile=[14, 16], chip_pixels=[7, 8],
        drift_length=3.0, time_interval=[0.0, 30.0], time_padding=10.0,
        time_window=8.9, light=True, lut_kw=dict(vox_div=[4, 6, 4]))),
    run=dict(config='2x2', mod2mod_variation=True,
             pixel_layout_id=[0, 0, 1, 0], response_id=[0, 0, 1, 0],
             light_lut_id=[0, 1, 1, 1], event_group_size=1, n_devices=1,
             pipeline=False, step_scale=1.0),
    check=dict(units=16),
    limits=dict(packets_differ=0.004, fraction_gap_median=1.2e-05,
                assn_rows_differ=0, misplaced=0))
MIX = dict(name='mix', spills_per_file=2, vertices_per_spill=4,
           tracks_per_vertex=3, segments_per_track=10,
           segment_length_cm=0.4, dEdx_MeV_per_cm=2.12,
           spill_period_us=1.2e6, pool_seed=8, files=1)
#: a comparison of a configuration's own: the number of pixel layouts it
#: was run with, and the kept call's packets
OWN = '''from port_bench.reference.frozen.io.h5 import File


def compare(kept, files, cfg, rng, device, log):
    with File(kept['output'], 'r') as f:
        n = len(f['packets'])
    log(f'[check] own: {n} packets')
    return dict(own_layouts=float(len(files['pixel_layout'])),
                own_packets=n)
'''


def _write(directory, config, name='cell'):
    """A BENCHMARK.json of one cell on ``config`` and the mix, in
    ``directory``; returns run_cell's keyword arguments."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f'{config["name"]}.json')
    with open(path, 'w') as f:
        json.dump(config, f)
    with open(os.path.join(directory, 'mix.json'), 'w') as f:
        json.dump(MIX, f)
    bench = harness.load_json(f'{harness.ROOT}/BENCHMARK.json')
    bench['configs'] = [dict(name=config['name'], source='a test size',
                             file=path, reduced=[], why='a test size')]
    bench['workloads'] = [dict(name=name, config=config['name'],
                               traffic='mix', chips=1, why='a test size')]
    with open(os.path.join(directory, 'bench.json'), 'w') as f:
        json.dump(bench, f)
    return dict(bench_path=os.path.join(directory, 'bench.json'),
                traffic_dir=str(directory))


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp('cache'))


@pytest.fixture(scope='module')
def cell(tmp_path_factory):
    return _write(str(tmp_path_factory.mktemp('cell')), CONFIG)


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch, cache):
    monkeypatch.setattr(harness, 'DEVICE', 'cpu')
    monkeypatch.setattr(harness, 'check_card', lambda cell: None)
    monkeypatch.setattr(assets, 'prepare',
                        functools.partial(PREPARE, cache=cache))


def _run(kw, **more):
    return harness.run_cell('cell', SEED, 0, False,
                            t_start=time.perf_counter(),
                            log=lambda msg: None, **kw, **more)


def _response(det):
    c = {k: float(np.float32(det.c[k])) for k in (
        'time_window', 'response_sampling', 'response_bin_size',
        'pixel_pitch')}
    return make_response(
        n_t=int(round(c['time_window'] / c['response_sampling'])),
        bin_size=c['response_bin_size'], sampling=c['response_sampling'],
        pixel_pitch=c['pixel_pitch'])


def test_assets_keep_the_lists_and_make_a_response_a_layout(cache):
    files, borders = assets.prepare(CONFIG)
    with open(os.path.join(cache, CONFIG['name'], assets.MANIFEST)) as f:
        manifest = json.load(f)
    for key in ('pixel_layout', 'response_file', 'light_lut_filename'):
        assert len(files[key]) == 2 and len(manifest[key]) == 2, key
        assert all(not os.path.isabs(p) for p in manifest[key])
        assert all(os.path.isfile(p) for p in files[key])
    det_yaml = files['detector_properties']
    sim_yaml = files['simulation_properties']
    # layout 0 serves modules 1, 2, 4 and layout 1 module 3, whose
    # response bins are a tenth of their own pitch (so that the two
    # synthetic tables come out equal)
    for i, module in ((0, 1), (1, 3)):
        det = detector.load(det_yaml, files['pixel_layout'][i], sim_yaml,
                            i_module=module)
        assert det.c['response_bin_size'] == pytest.approx(
            det.c['pixel_pitch'] / 10)
        np.testing.assert_array_equal(np.load(files['response_file'][i]),
                                      _response(det))
    whole = detector.load(det_yaml, files['pixel_layout'][0], sim_yaml)
    assert borders.shape == (8, 3, 2)
    np.testing.assert_array_equal(borders, whole.borders)


def test_a_single_layout_manifest_reads_as_it_stands(tmp_path, monkeypatch):
    config = dict(name='one_module', run={}, assets=dict(
        writer='write_module0', kwargs=dict(
            tiles=[1, 1], pixels_per_tile=14, drift_length=3.0,
            time_interval=[0.0, 30.0], time_padding=10.0, time_window=8.9)))
    files, borders = PREPARE(config, cache=str(tmp_path))
    directory = tmp_path / 'one_module'
    with open(directory / assets.MANIFEST) as f:
        assert json.load(f) == {
            'detector_properties': 'detector_properties.yaml',
            'pixel_layout': 'pixel_layout.yaml',
            'simulation_properties': 'simulation_properties.yaml',
            'response_file': 'response.npy'}
    det = detector.load(files['detector_properties'], files['pixel_layout'],
                        files['simulation_properties'])
    np.testing.assert_array_equal(np.load(files['response_file']),
                                  _response(det))
    np.testing.assert_array_equal(borders, det.borders)

    def rebuilt(*args):
        raise AssertionError('an existing cache is made again')
    monkeypatch.setattr(assets, '_write', rebuilt)
    again, borders_again = PREPARE(config, cache=str(tmp_path))
    assert again == files
    np.testing.assert_array_equal(borders_again, borders)


def test_a_2x2_run_is_correct(cell, monkeypatch):
    drawn = []
    choose = charge.choose_units

    def choose_units(calls, n, rng):
        drawn.extend(choose(calls, n, rng))
        return drawn
    monkeypatch.setattr(charge, 'choose_units', choose_units)
    r = _run(cell)
    assert r['correct'], r['checks']
    assert r['checks']['packets_differ']['value'] == 0
    # every module's units are compared: two TPC groups a module
    assert {g // 2 + 1 for _, g in drawn} == {1, 2, 3, 4}


def test_the_2x2_modules_plan_as_the_programs_batcher(tmp_path):
    from larndsim_tpu_torch.utils.batching import TPCBatcher
    files, borders = assets.prepare(CONFIG)
    made = traffic.make_inputs(MIX, borders, SEED, str(tmp_path))
    mods = charge.modules(files, CONFIG['run'])
    assert [m.i_mod for m in mods] == [1, 2, 3, 4]
    tracks = charge.read_segments(made['files'][0][0], mods[0].det)
    calls, groups = charge.plan(tracks, mods)
    for mod in mods:
        b = mod.det.borders[list(mod.tpcs)]
        batcher = TPCBatcher(tracks, tracks, 'event_id', 1, b)
        want, seq = [], 0
        for ev, mask in batcher:
            if mask.any():
                seq += 1
                want.append((int(ev), np.nonzero(mask)[0].tolist(), seq))
        got = [(ev, rows.tolist(), s) for ev, g, rows, s in calls
               if groups[g][0] is mod]
        assert got == want, mod.i_mod


def test_a_packet_moved_to_another_module_is_caught(cell, monkeypatch):
    from larndsim_tpu_torch.io import export
    real = export.pixel_readout_coords

    def moved(pixel_ids, det_model):
        group, *rest = real(pixel_ids, det_model)
        group = group.copy()
        group[:1] = (group[:1] + 3) % 8 + 1
        return (group, *rest)
    monkeypatch.setattr(export, 'pixel_readout_coords', moved)
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['misplaced']['value'] > 0


def test_draws_from_module_0s_stream_are_caught(cell, monkeypatch):
    from larndsim_tpu_torch.cli import simulate_pixels
    real = simulate_pixels.batch_generator

    def module_0(rand_seed, i_mod, event, seq, device):
        return real(rand_seed, 0, event, seq, device)
    monkeypatch.setattr(simulate_pixels, 'batch_generator', module_0)
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['packets_differ']['value'] > 0


def test_a_configuration_without_comparisons_runs_charge():
    cfg = harness.load_json(f'{harness.ROOT}/port_bench/configs/ndlar.json')
    assert 'comparisons' not in cfg['check']
    found = harness.comparisons(cfg)
    assert list(found) == ['charge']
    assert found['charge'].__code__.co_filename == os.path.join(
        harness.HERE, 'compare', 'charge.py')


def test_an_unknown_comparison_stops_the_run(tmp_path, monkeypatch):
    from larndsim_tpu_torch.cli import simulate_pixels

    def never(*args, **kw):
        raise AssertionError('the program ran')
    monkeypatch.setattr(simulate_pixels, 'run_simulation', never)
    config = dict(CONFIG, check=dict(units=16,
                                     comparisons=['charge', 'nowhere']))
    kw = _write(str(tmp_path), config)
    with pytest.raises(SystemExit, match=r"'nowhere'.*nowhere\.py"):
        _run(kw)


@pytest.mark.parametrize('limit,correct', [(2.0, True), (1.0, False)])
def test_a_comparison_of_its_own_is_found_by_its_name(tmp_path, limit,
                                                      correct):
    compare_dir = tmp_path / 'compare'
    compare_dir.mkdir()
    shutil.copy(os.path.join(harness.HERE, 'compare', 'charge.py'),
                compare_dir)
    (compare_dir / 'own.py').write_text(OWN)
    config = dict(CONFIG, check=dict(units=16, comparisons=['charge', 'own']),
                  limits=dict(CONFIG['limits'], own_layouts=limit))
    r = _run(_write(str(tmp_path), config), compare_dir=str(compare_dir))
    assert r['correct'] is correct
    assert r['checks']['own_layouts'] == dict(value=2.0, limit=limit)
    assert r['checks']['packets_differ']['value'] == 0
