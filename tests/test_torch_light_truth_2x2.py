"""The 2x2 with the light truth on through the port, and the benchmark's
plain light-truth reference (``port_bench/reference/light_truth.py``) and
its comparison (``port_bench/compare/light_truth.py``) held to it, on the
CPU.

The small four-module tree of ``test_torch_light_2x2.py`` (light on, 96
channels a module, the beam trigger over a [0, 16] us window at 1 ns with
LUT smearing, 1000 samples of 16 ns a trigger) with the light truth on at
a few contributors a channel runs through ``run_simulation`` with module
variation and both TPCs of a module a batch, as ``configs/2x2_truth.json``
runs, on seeded spills in which module 3 holds no segment in the second:

* the file's ``light_wvfm_mc_assn`` records are the reference's: every
  number of the comparison within the configuration's limits, records of
  all four modules, each on the first module's channel ids;
* the truth's spans open where the CLI opens them (``truth/stage`` and
  ``truth/pull`` in ``light_batch``, ``truth/records`` where the records
  are queued, ``truth/h5`` where they are written), and the tallies count
  the triggers and the records; with the truth off no ``truth/*`` span
  opens and nothing is counted;
* an altered ``pe_current``, a module's records left out and a module's
  records moved to another module's channels are each caught, and the
  reference summing each contributor's series in bfloat16 (the control)
  fails the limits;
* ``trace.tally(label, n)`` adds ``n``; the per-layer reader
  ``truth.s_per_event`` sums the truth's labels but ``truth/h5``.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.params import load_detector
from larndsim_tpu_torch.utils import trace
from port_bench import assets, check, harness
from port_bench.compare import light_truth as compare_truth
from port_bench.reference import charge as rcharge

import torch_port_assets as tpa
from test_torch_light_2x2 import IDS, LIGHT_KEYS, RAND_SEED, PhaseRecorder, \
    CountingClock, _write_spills

CONFIG = harness.load_json(os.path.join(harness.HERE, 'configs',
                                        '2x2_truth.json'))
LIMITS = {k: v for k, v in CONFIG['limits'].items() if k.startswith('truth')}
RUN = dict(mod2mod_variation=True, **IDS)
#: contributors a channel: the configuration's 50 would hold every
#: segment of the small tree's batches
K = 4


def _tree(tmp_path_factory, name, **sim):
    files, _ = assets.prepare(dict(
        name=name, run=IDS, assets=dict(writer='write_2x2', kwargs=dict(
            tpa.SMALL_2X2, detector_overrides=LIGHT_KEYS,
            sim_overrides=dict(event_batch_size=2, **sim)))),
        cache=str(tmp_path_factory.mktemp('cache')))
    return files


def _run(tree, inp, out, rec=None):
    mp = pytest.MonkeyPatch()
    if rec is not None:
        mp.setattr(trace, 'time', rec.clock)
        mp.setattr(trace, 'phase', rec.phase)
    try:
        tcli.run_simulation(
            inp, out, config='2x2',
            detector_properties=tree['detector_properties'],
            pixel_layout=tree['pixel_layout'],
            simulation_properties=tree['simulation_properties'],
            response_file=tree['response_file'],
            light_lut_filename=tree['light_lut_filename'],
            truth_path=CONFIG['run']['truth_path'],
            truth_compression=CONFIG['run']['truth_compression'],
            rand_seed=RAND_SEED, step_scale=4.0, device='cpu', **RUN)
        return trace.summary(), trace.tallies()
    finally:
        mp.undo()


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return _tree(tmp_path_factory, 'small_2x2_truth', max_light_truth_ids=K)


@pytest.fixture(scope='module')
def run_truth(tree, tmp_path_factory):
    """The CLI on the 2x2 with the truth on, its phases recorded."""
    d = tmp_path_factory.mktemp('run')
    inp, out = str(d / 'in.h5'), str(d / 'out.h5')
    borders = load_detector(tree['detector_properties'],
                            tree['pixel_layout'][0], device='cpu').tpc_borders
    _write_spills(inp, np.asarray(borders))
    rec = PhaseRecorder(CountingClock())
    table, tallies = _run(tree, inp, out, rec)
    return dict(input=inp, output=out, rec=rec, table=table, tallies=tallies,
                records=compare_truth.program_records(out))


@pytest.fixture(scope='module')
def reference(tree, run_truth):
    return compare_truth.reference_records(run_truth['input'], tree, RUN,
                                           'cpu')


def _judge(numbers):
    return check.judge(dict(numbers, n_packets=numbers['n_truth_records']),
                       LIMITS)


def _numbers(records, tree, reference):
    ref, tracks, mods, _ = reference
    return compare_truth.file_numbers(records, ref, tracks, mods, tree, RUN)


def _module_of(records, reference) -> np.ndarray:
    """Each record's module: its segment's (the records of every module
    carry the first module's channel ids)."""
    _, tracks, mods, _ = reference
    calls, groups = rcharge.plan(tracks, mods)
    seg, mod = [], []
    for _, g, rows, _ in calls:
        seg.append(tracks['segment_id'][rows])
        mod.append(np.full(len(rows), groups[g][0].i_mod))
    seg, mod = np.concatenate(seg), np.concatenate(mod)
    order = np.argsort(seg)
    return mod[order][np.searchsorted(seg[order], records['segment_id'])]


def test_the_files_truth_equals_the_reference(run_truth, tree, reference):
    records = run_truth['records']
    numbers = _numbers(records, tree, reference)
    ok, checks = _judge(numbers)
    assert ok, checks
    assert numbers['n_truth_records'] == len(records) > 1000
    assert numbers['truth_records_differ'] == 0
    assert numbers['truth_rows_misplaced'] == 0
    assert numbers['truth_pe_gap_rel_median'] < 1e-6
    # every module's records, on the first module's 96 channel ids; the
    # trigger ids counted in each module's pass: module 3 triggers once
    modules = _module_of(records, reference)
    assert set(modules.tolist()) == {1, 2, 3, 4}
    assert 0 <= records['op_channel_id'].min() \
        and records['op_channel_id'].max() < 96
    for m in (1, 2, 4):
        assert set(records['trigger_id'][modules == m].tolist()) == {0, 1}
    assert set(records['trigger_id'][modules == 3].tolist()) == {0}
    assert np.all(np.abs(records['pe_current']) > 0.1)


def test_the_truth_spans_and_tallies(run_truth):
    opened = run_truth['rec'].opened
    parents = {}
    for label, parent in opened:
        parents.setdefault(label, set()).add(parent)
    assert parents['truth/stage'] == parents['truth/pull'] \
        == {'light_batch'}
    assert parents['truth/records'] <= {'cli/accumulate', 'truth/drain'}
    assert 'truth/h5' in parents and 'truth/drain' in parents
    # a truth product a triggering (spill, module): two spills, four
    # modules, one spill of module 3 without segments
    assert sum(label == 'truth/stage' for label, _ in opened) == 7
    assert run_truth['tallies']['truth/triggers'] == 7
    assert run_truth['tallies']['truth/records'] == len(run_truth['records'])
    assert sum(s for s, _ in run_truth['table'].values()) \
        == run_truth['rec'].outer > 0


def _altered(records, modules):
    out = records.copy()
    out['pe_current'] *= 1 + 1e-4
    return out


def _left_out(records, modules):
    return records[modules != 2]


def _swapped(records, modules):
    """One contributor of one channel of one trigger of module 2 replaced
    by a segment of the same module that the channel does not follow."""
    out = records.copy()
    first = np.nonzero(modules == 2)[0][0]
    r = records[first]
    same = (records['trigger_id'] == r['trigger_id']) \
        & (records['event_id'] == r['event_id']) & (modules == 2)
    here = same & (records['op_channel_id'] == r['op_channel_id'])
    other = np.setdiff1d(records['segment_id'][same],
                         records['segment_id'][here])[0]
    out['segment_id'][here & (records['segment_id'] == r['segment_id'])] \
        = other
    return out


def _moved(records, modules):
    out = records.copy()
    out['op_channel_id'][modules == 2] += 96
    return out


@pytest.mark.parametrize('fault, number', [
    (_altered, 'truth_pe_gap_rel_median'),
    (_left_out, 'truth_records_differ'),
    (_swapped, 'truth_records_differ'),
    (_moved, 'truth_rows_misplaced')],
    ids=['altered', 'left_out', 'swapped', 'moved'])
def test_a_fault_is_caught(run_truth, tree, reference, fault, number):
    records = run_truth['records']
    numbers = _numbers(fault(records, _module_of(records, reference)), tree,
                       reference)
    ok, checks = _judge(numbers)
    assert not ok
    assert checks[number]['value'] > checks[number]['limit']


def test_the_bf16_control_fails_the_limits(run_truth, tree, reference):
    control, *_ = compare_truth.reference_records(
        run_truth['input'], tree, RUN, 'cpu', precision='bf16')
    numbers = compare_truth.record_numbers(control, reference[0], 0.1)
    ok, checks = _judge(numbers)
    assert not ok
    assert checks['truth_pe_gap_rel_median']['value'] \
        > 10 * LIMITS['truth_pe_gap_rel_median']


def test_with_the_truth_off_no_truth_span_opens(tmp_path_factory):
    tree = _tree(tmp_path_factory, 'small_2x2_light')
    d = tmp_path_factory.mktemp('off')
    inp, out = str(d / 'in.h5'), str(d / 'out.h5')
    borders = load_detector(tree['detector_properties'],
                            tree['pixel_layout'][0], device='cpu').tpc_borders
    _write_spills(inp, np.asarray(borders))
    rec = PhaseRecorder(CountingClock())
    table, tallies = _run(tree, inp, out, rec)
    assert 'light_batch' in table
    assert not [label for label, _ in rec.opened
                if label.startswith('truth/')]
    assert not [label for label in tallies if label.startswith('truth/')]
    assert compare_truth.program_records(out).size == 0


def test_a_tally_adds_its_count():
    trace.reset()
    trace.tally('truth/records', 5)
    trace.tally('truth/records')
    trace.tally('truth/records', 0)
    trace.tally('truth/triggers', 2)
    assert trace.tallies() == {'truth/records': 6, 'truth/triggers': 2}
    assert trace.summary() == {}
    trace.reset()


def test_the_truth_reader_leaves_the_writes_out():
    read = harness.reader('truth.s_per_event',
                          os.path.join(harness.HERE, 'metrics'))
    calls = [dict(wall_s=4.0, events=4, phases={
        'truth/stage': 0.5, 'truth/pull': 0.25, 'truth/records': 0.125,
        'truth/drain': 0.0625, 'truth/h5': 1.0, 'light_batch': 2.0})] * 2
    assert read(harness.Window(calls)) == 2 * 0.9375 / 8
    assert read(harness.Window([dict(wall_s=1.0, events=4, phases={
        'truth/h5': 1.0, 'light_batch': 2.0})])) is None
