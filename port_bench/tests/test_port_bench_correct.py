"""``correct`` comes out false when the timed path is broken, and the
control (the reference a precision lower) fails the comparison.

Each run goes through ``harness.run_cell`` with the program on the CPU
(``harness.DEVICE`` 'cpu', the look for a card replaced): the port runs
its plain versions, so a sound run agrees with the reference; the faults
are planted in the port underneath (a hit's ADC altered where the charge
chain produces it, half of a batch's segments left out, the FEE state
machine returning its state unchanged, a packet moved to another
module).  The
cell is the ND-LAr configuration of ``BENCHMARK.json`` on a one-spill mix
of two interactions (about a minute a run on the CPU: the plain FEE
machine at 6459 ticks).  There is one card to a cell, so no exchange
between cards to leave out.
"""
import json
import time

import numpy as np
import pytest

from port_bench import control, harness

TINY = dict(name='tiny', spills_per_file=1, vertices_per_spill=2,
            tracks_per_vertex=3, segments_per_track=10,
            segment_length_cm=0.4, dEdx_MeV_per_cm=2.12,
            spill_period_us=1.2e6, pool_seed=2, files=1)
SEED = 2**31 + 11


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp('tiny')
    bench = harness.load_json(f'{harness.ROOT}/BENCHMARK.json')
    bench['workloads'] = [dict(name='ndlar.tiny', config='ndlar',
                               traffic='tiny', chips=1, why='a test size')]
    with open(d / 'bench.json', 'w') as f:
        json.dump(bench, f)
    with open(d / 'tiny.json', 'w') as f:
        json.dump(TINY, f)
    return dict(bench_path=str(d / 'bench.json'), traffic_dir=str(d))


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(harness, 'DEVICE', 'cpu')
    monkeypatch.setattr(harness, 'check_card', lambda cell: None)


def _run(tiny):
    return harness.run_cell('ndlar.tiny', SEED, 0, False,
                            t_start=time.perf_counter(),
                            log=lambda msg: None, **tiny)


#: what the comparison of this run drew and read before it was named by
#: the configuration (``compare/charge.py``): its units and every number
PINNED_UNITS = [(0, 29), (0, 9)]
PINNED = dict(packets_differ=0.0, fraction_gap_median=1.771379413692542e-06,
              fraction_gap_max=1.0701758591136201e-05, n_packets=64,
              n_file_packets=64, assn_rows_differ=0, misplaced=0.0)


def test_a_sound_run_is_correct(tiny, monkeypatch):
    from port_bench import check
    from port_bench.reference import charge
    seen = {}
    choose, judge = charge.choose_units, check.judge

    def choose_units(*args):
        seen['units'] = choose(*args)
        return seen['units']

    def judged(numbers, limits):
        seen['numbers'] = numbers
        return judge(numbers, limits)
    monkeypatch.setattr(charge, 'choose_units', choose_units)
    monkeypatch.setattr(check, 'judge', judged)
    r = _run(tiny)
    assert r['correct'], r['checks']
    assert r['attempted'] == 1 and r['failed'] == 0
    assert set(r['metrics']) == {'events_per_s', 'peak_device_gib',
                                 'setup_s'}
    assert r['checks']['packets_differ']['value'] == 0
    # the configuration names no comparison: the charge comparison runs,
    # with the same draws and numbers as before it was a module of its own
    assert seen['units'] == PINNED_UNITS
    assert seen['numbers'].keys() == PINNED.keys()
    for name, value in PINNED.items():
        assert seen['numbers'][name] == pytest.approx(value, rel=1e-12,
                                                      abs=0), name


def _charge_fault(monkeypatch, alter):
    from larndsim_tpu_torch.cli import simulate_pixels
    real = simulate_pixels.simulate_charge_batch

    def broken(segs, det_model, sim, draw, response, **kw):
        return alter(real, segs, det_model, sim, draw, response, kw)
    monkeypatch.setattr(simulate_pixels, 'simulate_charge_batch', broken)


def test_an_altered_adc_is_caught(tiny, monkeypatch):
    def alter(real, *args):
        res = real(*args[:-1], **args[-1])
        if len(res.hit_adc):
            res.hit_adc = res.hit_adc.copy()
            res.hit_adc[len(res.hit_adc) // 2] += 1
        return res
    _charge_fault(monkeypatch, alter)
    r = _run(tiny)
    assert not r['correct']
    assert r['checks']['packets_differ']['value'] > 0


def test_half_of_a_batch_left_out_is_caught(tiny, monkeypatch):
    from larndsim_tpu_torch.segments import from_structured

    def alter(real, segs, det_model, sim, draw, response, kw):
        host = kw['host_segs']
        half = host[:max(len(host) // 2, 1)]
        kw = dict(kw, host_segs=half)
        return real(from_structured(half, pad_to=segs.size,
                                    device=segs.x.device),
                    det_model, sim, draw, response, **kw)
    _charge_fault(monkeypatch, alter)
    r = _run(tiny)
    assert not r['correct']
    assert r['checks']['packets_differ']['value'] > 0


def test_a_state_machine_that_leaves_its_state_is_caught(tiny, monkeypatch):
    import torch
    from larndsim_tpu_torch.ops import fee

    def unchanged(sig_rows, noise, q_init, thresholds, tick_times, s):
        U = sig_rows.shape[1]
        z = torch.zeros((U, s.max_adc), dtype=torch.float32)
        none = torch.full((U, s.max_adc), -1, dtype=torch.int32)
        return z, z.clone(), torch.zeros(U, dtype=torch.int32), none, \
            none.clone()
    monkeypatch.setattr(fee, 'fee_fsm', unchanged)
    r = _run(tiny)
    assert not r['correct']


def test_a_packet_moved_to_another_module_is_caught(tiny, monkeypatch):
    from larndsim_tpu_torch.io import export
    real = export.pixel_readout_coords

    def moved(pixel_ids, det_model):
        group, *rest = real(pixel_ids, det_model)
        group = group.copy()
        group[:1] = (group[:1] + 33) % 70 + 1
        return (group, *rest)
    monkeypatch.setattr(export, 'pixel_readout_coords', moved)
    r = _run(tiny)
    assert not r['correct']
    assert r['checks']['misplaced']['value'] > 0


def test_the_control_fails_the_comparison(tiny):
    rec = control.readings('ndlar.tiny', SEED, **tiny)
    assert not rec['passes_limits'], rec
    assert rec['numbers']['n_packets'] > 0
