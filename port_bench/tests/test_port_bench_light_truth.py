"""The light-truth comparison and its reference on the CPU.

The small four-module 2x2 tree of ``test_port_bench_light.py`` with the
light truth on (a few contributors a channel) goes through
``harness.run_cell`` with the comparisons ``charge``, ``light`` and
``light_truth`` and the truth limits of ``configs/2x2_truth.json``: a
sound run is ``correct`` with no record differing; records scaled by
1e-3 are not; the reference summing each contributor's series
in bfloat16 (the control, ``compare/light_truth.py``'s ``readings``)
fails on every seed.  The per-layer reader ``truth.s_per_event`` sums
its labels and leaves ``truth/h5`` out.
"""
import functools
import json
import os
import time

import pytest

from port_bench import assets, harness
from port_bench.compare import light_truth as compare_truth

from .test_port_bench_light import CONFIG as LIGHT_CONFIG, MIX

PREPARE = assets.prepare
SEED = 2**31 + 29
CONFIG_TRUTH = harness.load_json(os.path.join(harness.HERE, 'configs',
                                              '2x2_truth.json'))
CONFIG = dict(
    LIGHT_CONFIG, name='twobytwo_truth',
    assets=dict(LIGHT_CONFIG['assets'], kwargs=dict(
        LIGHT_CONFIG['assets']['kwargs'],
        sim_overrides=dict(event_batch_size=2, max_light_truth_ids=4))),
    run=CONFIG_TRUTH['run'],
    check=dict(CONFIG_TRUTH['check'], units=16),
    limits=dict(CONFIG_TRUTH['limits'],
                packets_differ=LIGHT_CONFIG['limits']['packets_differ']))


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


def _run(kw, log=lambda msg: None):
    return harness.run_cell('cell', SEED, 0, False,
                            t_start=time.perf_counter(), log=log, **kw)


def test_a_sound_truth_run_is_correct(cell):
    lines = []
    r = _run(cell, lines.append)
    assert r['correct'], r['checks']
    assert r['checks']['truth_records_differ']['value'] == 0
    assert r['checks']['truth_rows_misplaced']['value'] == 0
    assert any('[check] light truth:' in line for line in lines)


def test_altered_records_are_caught(cell, monkeypatch):
    from larndsim_tpu_torch.io import export
    real = export.truth_sparse_to_records

    def altered(sparse, event_id, i_trig):
        """Every record's value made 1e-3 larger."""
        out = real(sparse, event_id, i_trig)
        out['pe_current'] *= 1.001
        return out
    monkeypatch.setattr(export, 'truth_sparse_to_records', altered)
    r = _run(cell)
    assert not r['correct']
    assert r['checks']['truth_pe_gap_rel_median']['value'] > 1e-4


def test_the_bf16_control_fails_on_every_seed(cell):
    for seed in (SEED, 7):
        rec = compare_truth.readings('cell', seed, **cell)
        assert not rec['passes_limits'], rec
        assert rec['numbers']['truth_pe_gap_rel_median'] \
            > CONFIG['limits']['truth_pe_gap_rel_median']


def _window(phases, events=4):
    return harness.Window([dict(wall_s=10.0, events=events, phases=phases)
                           for _ in range(2)])


def test_the_truth_reader_sums_its_labels():
    read = harness.reader('truth.s_per_event',
                          os.path.join(harness.HERE, 'metrics'))
    phases = {'truth/stage': 0.5, 'truth/pull': 0.25, 'truth/records': 1.0,
              'truth/drain': 0.125, 'truth/h5': 2.0, 'light_batch': 4.0,
              'cli/accumulate': 8.0}
    assert read(_window(phases)) == 2 * 1.875 / 8
    # the parent's table: the pull and the drain
    assert read(_window({'truth/pull': 1.0, 'truth/drain': 0.5,
                         'truth/h5': 3.0})) == 2 * 1.5 / 8
    assert read(_window({'truth/h5': 2.0, 'light_batch': 1.0})) is None
    assert read(harness.Window([])) is None
