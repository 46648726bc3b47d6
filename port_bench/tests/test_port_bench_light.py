"""The light comparison and its reference on the CPU.

The small four-module 2x2 tree (``write_2x2`` with one tile of 14 x 14 or
16 x 16 pixels an anode, light on: 96 channels a module over a [0, 16] us
beam window with LUT smearing, two small LUTs, the configuration's 1000
samples of 16 ns a trigger) with both TPCs of a module
a batch, as ``configs/2x2.json`` batches, goes through ``harness.run_cell``
with the comparisons ``charge`` and ``light`` and the light limits of
``configs/2x2.json``: a sound run is ``correct``; a sample altered by 40
quanta, two modules' waveforms swapped in the merge, a module's rows left
out of a file that was not merged, and the reference summing its arrival
series in bfloat16 (the control, ``compare/light.py``'s ``readings``) are
not.  The per-layer reader ``light.s_per_event`` sums its labels.
"""
import functools
import json
import os
import time

import numpy as np
import pytest

from port_bench import assets, harness
from port_bench.compare import light as compare_light

PREPARE = assets.prepare
SEED = 2**31 + 23
CONFIG_2X2 = harness.load_json(os.path.join(harness.HERE, 'configs',
                                            '2x2.json'))
CONFIG = dict(
    name='twobytwo_light', reduced=[],
    assets=dict(writer='write_2x2', kwargs=dict(
        tiles=[1, 1], pixels_per_tile=[14, 16], chip_pixels=[7, 8],
        drift_length=3.0, time_interval=[0.0, 30.0], time_padding=10.0,
        time_window=8.9, light=True, lut_kw=dict(vox_div=[4, 6, 4]),
        detector_overrides=CONFIG_2X2['assets']['kwargs'][
            'detector_overrides'],
        sim_overrides=dict(event_batch_size=2))),
    run=CONFIG_2X2['run'],
    check=dict(CONFIG_2X2['check'], units=16),
    # the light limits of configs/2x2.json; a few hundred packets hold
    # one or two float32 rounding cases of the charge chain (PERF.md,
    # section 2), more than its share limit at the cell's thousands
    limits=dict(CONFIG_2X2['limits'], packets_differ=0.01))
#: two spills of 8 vertices in random TPCs (their times drawn
#: in the spill's first 10 us, some inside the digitised window)
MIX = dict(name='mix', spills_per_file=2, vertices_per_spill=8,
           tracks_per_vertex=3, segments_per_track=10,
           segment_length_cm=0.4, dEdx_MeV_per_cm=2.12,
           spill_period_us=1.2e6, pool_seed=8, files=1)


@pytest.fixture(scope='module')
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp('cache'))


@pytest.fixture(scope='module')
def cell(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp('cell'))
    path = os.path.join(directory, 'config.json')
    with open(path, 'w') as f:
        json.dump(CONFIG, f)
    with open(os.path.join(directory, 'mix.json'), 'w') as f:
        json.dump(MIX, f)
    bench = harness.load_json(f'{harness.ROOT}/BENCHMARK.json')
    bench['configs'] = [dict(name=CONFIG['name'], source='a test size',
                             file=path, reduced=[], why='a test size')]
    bench['workloads'] = [dict(name='cell', config=CONFIG['name'],
                               traffic='mix', chips=1, why='a test size')]
    with open(os.path.join(directory, 'bench.json'), 'w') as f:
        json.dump(bench, f)
    return dict(bench_path=os.path.join(directory, 'bench.json'),
                traffic_dir=directory)


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch, cache):
    monkeypatch.setattr(harness, 'DEVICE', 'cpu')
    monkeypatch.setattr(harness, 'check_card', lambda cell: None)
    monkeypatch.setattr(assets, 'prepare',
                        functools.partial(PREPARE, cache=cache))


def _run(kw):
    return harness.run_cell('cell', SEED, 0, False,
                            t_start=time.perf_counter(),
                            log=lambda msg: None, **kw)


def test_a_sound_2x2_run_is_correct(cell):
    r = _run(cell)
    assert r['correct'], r['checks']
    for name in ('wvfm_samples_differ', 'wvfm_adc_gap_max',
                 'light_rows_differ'):
        assert r['checks'][name]['value'] == 0, name


def test_an_altered_sample_is_caught(cell, monkeypatch):
    from larndsim_tpu_torch.io import export
    real = export.export_light_wvfm_to_hdf5

    def altered(event_id, waveforms, f, sim, light, i_mod=-1):
        """One sample of module 1's first row in each of its writes (the
        warm-up call's and the window's)."""
        waveforms = np.array(waveforms)
        if i_mod == 1:
            waveforms[0, 5, 100] += 2560.0
        return real(event_id, waveforms, f, sim, light, i_mod=i_mod)
    monkeypatch.setattr(export, 'export_light_wvfm_to_hdf5', altered)
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['wvfm_adc_gap_max']['value'] == 2560.0


def test_two_modules_swapped_are_caught(cell, monkeypatch):
    from larndsim_tpu_torch.io import export
    real = export.merge_module_light_wvfm_same_trigger

    class Swapped:
        def __init__(self, det_model):
            ids = list(det_model.mod_ids)
            self.mod_ids = [ids[1], ids[0]] + ids[2:]

    monkeypatch.setattr(export, 'merge_module_light_wvfm_same_trigger',
                        lambda f, det_model: real(f, Swapped(det_model)))
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['wvfm_samples_differ']['value'] > 1e-3
    assert r['checks']['light_rows_differ']['value'] == 0


def test_a_modules_rows_left_out_are_caught(cell, monkeypatch):
    """Module 2 writes no waveform, in a file whose modules' rows are not
    merged (the program's merge would refuse it)."""
    from larndsim_tpu_torch.io import export
    real = export.export_light_wvfm_to_hdf5

    def without_module_2(event_id, waveforms, f, sim, light, i_mod=-1):
        if i_mod != 2:
            real(event_id, waveforms, f, sim, light, i_mod=i_mod)
    monkeypatch.setattr(export, 'export_light_wvfm_to_hdf5',
                        without_module_2)
    monkeypatch.setattr(export, 'merge_module_light_wvfm_same_trigger',
                        lambda f, det_model: None)
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['light_rows_differ']['value'] == 2


def test_the_bf16_control_fails_on_every_seed(cell):
    for seed in (SEED, 7):
        rec = compare_light.readings('cell', seed, **cell)
        assert not rec['passes_limits'], rec
        assert rec['numbers']['wvfm_samples_differ'] > 0


def _window(phases, events=4):
    return harness.Window([dict(wall_s=10.0, events=events, phases=phases)
                           for _ in range(2)])


def test_the_light_reader_sums_its_labels():
    read = harness.reader('light.s_per_event',
                          os.path.join(harness.HERE, 'metrics'))
    phases = {'light_batch': 0.5, 'light/incidence': 0.25,
              'light/signal': 1.0, 'light/digitize': 0.125,
              'light/pull': 0.0625, 'export/light': 2.0,
              'charge_batch': 4.0, 'cli/detector': 8.0}
    assert read(_window(phases)) == 2 * 1.9375 / 8
    # the parent's table: light_batch alone
    assert read(_window({'light_batch': 1.0, 'charge_batch': 2.0})) \
        == 2 * 1.0 / 8
    assert read(_window({'charge_batch': 2.0})) is None
    assert read(harness.Window([])) is None
