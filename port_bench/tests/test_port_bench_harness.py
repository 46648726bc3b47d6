"""The harness's arithmetic and plumbing on the CPU: rates and self times
from phase tables, the idle share and the gaps from a synthetic profiler
trace, rooflines from counts, the names and units of BENCHMARK.json, a new
traffic mix found by its name, and a run that finds no card."""
import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from port_bench import costs, harness, trace_read, traffic

ROOT = harness.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def _metric(name):
    return harness.reader(name, os.path.join(harness.HERE, 'metrics'))


def test_rates_and_self_times_from_phase_tables():
    # each call's table is its own: run_simulation resets the trace at
    # its start, and the harness reads the table after every call
    calls = [dict(wall_s=2.0, events=16,
                  phases={'charge_batch': 0.25, 'charge/get_pixels': 0.25,
                          'charge/npix_sync': 0.125, 'export': 0.25,
                          'truth/h5': 0.125}),
             dict(wall_s=2.0, events=16,
                  phases={'charge_batch': 0.5, 'export/flush': 0.25})]
    win = harness.Window(calls)
    assert win.events == 32 and win.wall_s == 4.0
    assert _metric('charge.host_s_per_event')(win) == 1.125 / 32
    assert _metric('io.s_per_event')(win) == 0.625 / 32
    assert _metric('cli.self_s_per_event')(win) == (4.0 - 1.75) / 32
    # a window without an export phase has nothing to read there
    quiet = harness.Window([dict(wall_s=1.0, events=8,
                                 phases={'charge_batch': 0.5})])
    assert _metric('io.s_per_event')(quiet) is None


def test_per_call_tables_reset(tmp_path):
    from larndsim_tpu_torch.utils import trace
    trace.reset()
    with trace.phase('export'):
        pass
    first = trace.summary()
    trace.reset()
    with trace.phase('charge_batch'):
        pass
    assert set(first) == {'export'} and set(trace.summary()) == {
        'charge_batch'}


class _Ev:
    def __init__(self, name, start, dur, device=False, annotation=False,
                 thread=1, stream=7):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._ann, self._t = device, annotation, thread
        self._stream = stream

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return 'DeviceType.CUDA' if self._dev else 'DeviceType.CPU'

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return self._t

    def device_resource_id(self):
        return self._stream


def test_idle_share_and_gaps_from_a_synthetic_trace():
    ms = 1_000_000
    # the card's clock runs 7 s ahead of the host's: the marker, launched
    # at host time 0, starts at 7 s on the card
    off = 7000 * ms
    events = [
        _Ev(trace_read.MARKER, off + 5, 1000, device=True),
        # the second marker names the harness's stream, whose counting
        # kernels the trace leaves out
        _Ev(trace_read.MARKER, off + 2 * ms, 1000, device=True, stream=9),
        _Ev('count', off + 40 * ms, 8 * ms, device=True, stream=9),
        _Ev('k_a', off + 20 * ms, 10 * ms, device=True),
        _Ev('k_b', off + 25 * ms, 10 * ms, device=True),   # overlaps k_a
        _Ev('k_a', off + 75 * ms, 5 * ms, device=True),
        _Ev('k_c', off + 95 * ms, 20 * ms, device=True),   # past the window
        _Ev('phase', off + 50 * ms, 40 * ms, device=True,
            annotation=True),                      # an annotation, no work
    ]
    ranges = [(10 * ms, 40 * ms, 'light_batch'),
              (50 * ms, 90 * ms, 'charge_batch'),
              (60 * ms, 70 * ms, 'charge/get_pixels')]
    r = trace_read.reduce(events, (0, 100 * ms), ranges, 0)
    assert r['window_s'] == pytest.approx(0.1)
    assert r['busy_s'] == pytest.approx(0.015 + 0.005 + 0.005)
    idle = 1 - r['busy_s'] / r['window_s']
    assert harness.reader('device.idle_pct', os.path.join(
        harness.HERE, 'metrics'))(harness.Window([], trace=r)) == \
        pytest.approx(100 * idle)
    gaps = dict(r['idle_gaps'])
    assert gaps['cli'] == pytest.approx(0.010 + 0.010 + 0.005)
    assert gaps['light_batch'] == pytest.approx(0.010 + 0.005)
    assert gaps['charge/get_pixels'] == pytest.approx(0.010)
    assert gaps['charge_batch'] == pytest.approx(0.010 + 0.005 + 0.010)
    assert sum(gaps.values()) == pytest.approx(r['window_s'] - r['busy_s'])
    assert dict(r['device_ops'])['k_a'] == pytest.approx(0.015)
    assert r['device_ops'][0][0] == 'k_a'
    assert trace_read.MARKER not in dict(r['device_ops'])
    assert 'count' not in dict(r['device_ops'])


def _k1_args(seed=0, S=6, n_steps=9, P=5, t_sig=40, ntp=12):
    g = torch.Generator().manual_seed(seed)
    lut = SimpleNamespace(nx_r=4, ny_r=4, ratio=2, inv_bin=10.0, lim_x=0.5,
                          lim_y=0.5, max_x=0.4, max_y=0.4, zero_row=32)
    i32 = torch.int32
    return (torch.rand(S, n_steps, generator=g),
            torch.rand(S, n_steps, generator=g),
            torch.randint(-5, t_sig, (S, n_steps), generator=g, dtype=i32),
            torch.randint(0, 2, (S, n_steps), generator=g, dtype=i32),
            torch.rand(S, P, generator=g), torch.rand(S, P, generator=g),
            torch.randint(0, n_steps + 1, (S,), generator=g, dtype=i32),
            torch.randint(0, 10, (S,), generator=g, dtype=i32),
            torch.full((S,), t_sig, dtype=i32),
            torch.rand(S, t_sig, generator=g),
            torch.rand(33, ntp, generator=g), lut)


@pytest.mark.parametrize('seed', [0, 1])
def test_k1_count_is_the_work_of_the_inputs(seed):
    """The adds counted are those a loop over the inputs makes: one per
    (live step, pixel with a response row, tick the shifted row covers)."""
    args = _k1_args(seed)
    xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, _, scale, resp, lut = \
        args
    rows = costs.row_table(xs, ys, phase, pxc, pyc, lut)
    adds = 0
    S, n_steps = xs.shape
    for s in range(S):
        for i in range(int(nstep[s])):
            for p in range(pxc.shape[1]):
                if int(rows[s, p, i]) == lut.zero_row:
                    continue
                for t in range(scale.shape[1]):
                    k = t - int(shift[s, i])
                    adds += (0 <= k < resp.shape[1]
                             and t >= int(tick_lo[s]))
    valid = (pxc.abs() < costs.FAR / 10).sum(dim=1)
    muls = int((valid * (scale.shape[1] - tick_lo.long())).sum())
    lookups = int(((rows != lut.zero_row)
                   & (torch.arange(n_steps)[None, None, :]
                      < nstep[:, None, None].long())).sum())
    assert costs.k1_costs(args)['ops'] == adds + muls \
        + costs.ROW_OPS * lookups


def test_roofline_from_counts():
    b = costs.bound_s(3.35e9, 6.7e9)          # 1 ms of bytes, 0.1 of ops
    assert b == pytest.approx(1e-3)
    assert costs.bound_s(3.35e8, 6.7e10) == pytest.approx(1e-3)
    k1, k2 = _metric('k1.roofline_pct'), _metric('k2.roofline_pct')
    trace = dict(kernel_s={'induced_current_kernel(float*)': 4e-3,
                           'fee_fsm_kernel': 2e-3, 'other': 1.0})
    win = harness.Window([], trace=trace, bound_s=dict(
        k1=1e-3, k2=1.5e-3, k1_launches=3, k2_launches=3))
    assert k1(win) == pytest.approx(25.0)
    assert k2(win) == pytest.approx(75.0)
    # the share of valid counts against a kernel that takes at least its
    # bound never passes 100%; nothing is clamped
    for bound in (1e-3, 2e-3, 4e-3):
        win.bound_s['k1'] = bound
        assert k1(win) == pytest.approx(100 * bound / 4e-3)
        assert k1(win) <= 100.0
    assert k1(harness.Window([], trace=trace, bound_s=dict(
        k1=0.0, k2=0.0, k1_launches=0, k2_launches=0))) is None


def test_benchmark_names_and_units():
    bench = harness.load_json(os.path.join(ROOT, 'BENCHMARK.json'))
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    metrics = bench['end_to_end'] + bench['per_layer']
    names = ([c['name'] for c in bench['configs']]
             + [w['name'] for w in bench['workloads']]
             + [m['name'] for m in metrics]
             + [w['traffic'] for w in bench['workloads']])
    for name in names:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    assert len({m['name'] for m in metrics}) == len(metrics)
    e2e = {m['name'] for m in bench['end_to_end']}
    for m in bench['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in bench['per_layer']:
        assert m['moves'] in e2e
        assert len(m['layer']) <= 200 and '\n' not in m['layer']
        assert os.path.isfile(os.path.join(harness.HERE, 'metrics',
                                           f'{m["name"]}.py'))
    for w in bench['workloads']:
        cell_pl = harness.metrics_of(bench, w, 'per_layer')
        cell_e2e = {m['name'] for m in harness.metrics_of(bench, w,
                                                          'end_to_end')}
        assert 'setup_s' in cell_e2e and len(cell_e2e) > 1 and cell_pl
        assert len(w['why']) <= 200
        traffic.load(w['traffic'])
    for c in bench['configs']:
        cfg = harness.load_json(os.path.join(ROOT, c['file']))
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
        # every limit is a number of the comparison
        assert set(cfg['limits']) <= {'packets_differ', 'fraction_gap_median',
                                      'assn_rows_differ', 'misplaced'}
        assert harness.comparisons(cfg)


def test_a_new_traffic_mix_is_found_by_name(tmp_path):
    spec = dict(traffic.load('lbnf'), name='sparse', vertices_per_spill=2,
                tracks_per_vertex=3, spills_per_file=2, files=2)
    with open(tmp_path / 'sparse.json', 'w') as f:
        json.dump(spec, f)
    got = traffic.load('sparse', str(tmp_path))
    borders = np.array([[[-60, 60], [-60, 60], [-30, 30]]] * 2, float)
    made = traffic.make_inputs(got, borders, 2**31 + 9, str(tmp_path / 'in'))
    assert len(made['files']) == 2 and os.path.isfile(made['warmup'])
    with pytest.raises(KeyError):
        bad = dict(spec)
        del bad['files']
        with open(tmp_path / 'bad.json', 'w') as f:
            json.dump(bad, f)
        traffic.load('bad', str(tmp_path))


def test_seeds_reorder_the_same_spills():
    spec = dict(traffic.load('lbnf'), vertices_per_spill=3,
                tracks_per_vertex=4, segments_per_track=60, spills_per_file=3)
    borders = np.array([[[-60, 60], [-60, 60], [-30, 30]],
                        [[70, 130], [-60, 60], [-30, 30]]], float)
    seg, trj, vtx = traffic.pool(spec, borders)
    assert np.bincount(vtx['event_id']).tolist() == [3, 3, 3]
    assert len(trj) == 36 and seg['file_traj_id'].max() < 36
    # every segment inside a TPC (the drift axis is written to x)
    for end in ('_start', '_end'):
        p = np.stack([seg['z' + end], seg['y' + end], seg['x' + end]], 1)
        inside = ((p[:, None] >= borders[None, :, :, 0] - 1e-4)
                  & (p[:, None] <= borders[None, :, :, 1] + 1e-4)).all(axis=2)
        assert inside.any(axis=1).all()
    for order in ([2, 0, 1], [1, 2, 0]):
        s2, t2, v2 = traffic.reorder_spills(seg, trj, vtx, order, 1.2e6)
        # the same segments in another order, spill k of the file being
        # spill order[k] of the pool
        for k, old in enumerate(order):
            a, b = s2[s2['event_id'] == k], seg[seg['event_id'] == old]
            np.testing.assert_array_equal(a['x_start'], b['x_start'])
            np.testing.assert_allclose(a['t0'] - k * 1.2e6,
                                       b['t0'] - old * 1.2e6, atol=1e-3)
        assert (np.diff(s2['event_id'].astype(int)) >= 0).all()
        assert s2['segment_id'].tolist() == list(range(len(s2)))
        assert (v2['event_id'][s2['vertex_id']] == s2['event_id']).all()
        assert (t2['event_id'][s2['file_traj_id']] == s2['event_id']).all()


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload', 'ndlar.lbnf',
         '--seed', str(2**31 + 3), '--seconds', '1', '--trace', '0'],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert 'correct' not in proc.stdout
    assert 'no CUDA device' in proc.stderr
