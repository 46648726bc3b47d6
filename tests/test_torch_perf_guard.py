"""The per-op guard (``larndsim_tpu_torch.tools.perf_guard``) on the CPU:
its staging at a tiny input, its byte and operation counts against hand
counts, its regression check on a temporary log, and its refusal to run
without a card.  Its times exist only on the card, and so does K1's count
of its tile choice (``kernels.binding.induced_current_tiling``): that test
is marked ``gpu`` and skipped without a CUDA device."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import current
from larndsim_tpu_torch.tools import perf_guard as pg

import torch_port_assets as tpa

TINY = dict(n_events=1, tracks_per_event=3, segments_per_track=6,
            segment_length=0.4, dEdx=8.0, seed=2)


@pytest.fixture(scope='module')
def workload(tmp_path_factory):
    return pg.build_workload('cpu', str(tmp_path_factory.mktemp('guard')),
                             workload=TINY, pad_n=32, geometry=tpa.SMALL)


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def test_staging_gives_the_logged_keys(workload):
    shapes = workload['shapes']
    assert set(shapes) == set(pg.LOGGED_SHAPES)
    assert shapes['pad_n'] == 32 and 0 < workload['n_segments'] <= 32
    assert _pow2(shapes['n_steps']) and shapes['n_steps'] >= 8
    assert _pow2(shapes['t_sig']) and shapes['t_sig'] >= 64
    assert _pow2(shapes['n_unique_cap']) and shapes['n_unique_cap'] >= 32
    assert _pow2(shapes['max_nb']) and shapes['max_nb'] >= 16
    assert (shapes['max_adc'], shapes['max_tracks']) == (30, 50)
    xs, scale = workload['k1_args'][0], workload['k1_args'][9]
    assert tuple(xs.shape) == (32, shapes['n_steps'])
    assert tuple(scale.shape) == (32, shapes['t_sig'])


def test_every_op_runs_and_has_a_bound(workload):
    calls = pg.op_calls(workload)
    costs = pg.op_costs(workload, calls)
    assert set(calls) == set(costs) == {
        'induced_current', 'sum_pixel_signals_with_csr',
        'sum_pixel_signals_kernel', 'fee_fsm', 'get_adc_values_rows',
        'current_fractions_4_with_csr', 'current_fractions_4_kernel',
        'digitize'}
    for name, (fn, args, kw) in calls.items():
        fn(*args, **kw)
        assert costs[name]['bytes'] > 0 and costs[name]['ops'] > 0, name
    signals = calls['sum_pixel_signals_with_csr'][1][0]
    S, P, T = signals.shape
    assert costs['induced_current']['bytes'] > S * P * T * 4
    assert costs['induced_current']['ops'] > 0


def test_k1_count_matches_a_hand_count():
    """One segment, one pixel at the sample points' position, two live
    steps of shift 0 and 3, tick_lo 1, t_sig 8, a 10-tick response: step 0
    covers ticks 1..7 (7 adds), step 1 ticks 3..7 (5 adds); 7 multiplies
    (ticks 1..7); 2 row lookups."""
    lut = current.LutGeometry(0.04434, 45, 45, 1)
    f32, i32 = torch.float32, torch.int32
    args = (torch.zeros((1, 2), dtype=f32), torch.zeros((1, 2), dtype=f32),
            torch.tensor([[0, 3]], dtype=i32), torch.zeros((1, 2), dtype=i32),
            torch.zeros((1, 1), dtype=f32), torch.zeros((1, 1), dtype=f32),
            torch.tensor([2], dtype=i32), torch.tensor([1], dtype=i32),
            torch.tensor([3], dtype=i32), torch.ones((1, 8), dtype=f32),
            torch.zeros((lut.zero_row + 1, 10), dtype=f32), lut)
    c = pg.k1_costs(args)
    assert c['ops'] == 7 + 5 + 7 + pg.ROW_OPS * 2
    in_bytes = 4 * (2 + 2 + 2 + 2 + 1 + 1 + 1 + 1 + 1 + 8
                    + (lut.zero_row + 1) * 10)
    assert c['bytes'] == in_bytes + 8 * 4


def test_other_counts_match_hand_counts():
    # two segments of three pixels (one padding), windows at ticks 2 and
    # -1 of 4 ticks each, 5 output ticks: 2 x 3 + 2 x 3 adds, each reading
    # one signal value (the padding's and the outside ticks' are not read)
    signals = torch.zeros((2, 3, 4))
    pix_idx = torch.tensor([[0, 1, -1], [1, 2, -1]], dtype=torch.int32)
    starts = torch.tensor([0.2, -0.1])
    c = pg.sum_costs(signals, pix_idx, starts, 8, 5, 0.1)
    assert c['ops'] == 2 * 3 + 2 * 3
    assert c['bytes'] == (12 + 6 + 2) * 4 + 8 * 5 * 4
    c = pg.fsm_costs(100, 64, 30, 11, drawn=False)
    assert c['ops'] == pg.FSM_OPS * 100 * 64
    assert c['bytes'] == (100 * 6 * 64 + 2 * 64 + 11) * 4 + 64 * 121 * 4
    c = pg.fsm_costs(100, 64, 30, 11, drawn=True)
    assert c['bytes'] == (64 * 100 + 64 + 11) * 4 + 64 * 121 * 4
    # three entries with a slot (pixels 0 and 1 at row start 2, pixels 1
    # and 2 at -1); slot 0: pixel 0's window [0, 3] holds its entry's ticks
    # 0-1, pixel 1's [0, 10] ticks 1-3; slot 1: pixel 0's r > e and pixel
    # 1's [20, 30] hold none, pixel 2's [0, 0] tick 1; the rest unlatched
    slot = torch.tensor([[0, -1, -1], [0, 0, -1]], dtype=torch.int32)
    r = torch.full((8, 30), -1, dtype=torch.int32)
    e = torch.full((8, 30), -1, dtype=torch.int32)
    r[:3, 0], e[:3, 0] = torch.tensor([0, 0, 0]), torch.tensor([3, 10, -1])
    r[:3, 1], e[:3, 1] = torch.tensor([5, 20, 0]), torch.tensor([4, 30, 0])
    c = pg.fraction_costs(signals, pix_idx, slot, starts, r, e, 50, 4, 0.1)
    assert c['ops'] == pg.FRACTION_OPS * (2 + 3 + 1)
    assert c['bytes'] == (6 + 6 + 6 + 2) * 4 + 2 * 8 * 4 * 4 + 8 * 30 * 50 * 4


def test_sum_costs_count_the_rows_d1_writes():
    """D1's output term is the (rows, U) tick-major rows it writes for
    the FSM: with rows 7 > n_ticks 5, 8 x 7 words and the adds of ticks
    below 5 (as without rows); with rows 3 < 5, 8 x 3 words and only the
    adds of ticks below 3: segment 0's window [2, 6) keeps tick 2 (1 a
    pixel, 2 pixels), segment 1's [-1, 3) ticks 0-2 (3 a pixel)."""
    signals = torch.zeros((2, 3, 4))
    pix_idx = torch.tensor([[0, 1, -1], [1, 2, -1]], dtype=torch.int32)
    starts = torch.tensor([0.2, -0.1])
    maps = (6 + 2) * 4
    c = pg.sum_costs(signals, pix_idx, starts, 8, 5, 0.1, rows=7)
    assert c['ops'] == 2 * 3 + 2 * 3
    assert c['bytes'] == 12 * 4 + maps + 8 * 7 * 4
    c = pg.sum_costs(signals, pix_idx, starts, 8, 5, 0.1, rows=3)
    assert c['ops'] == 2 * 1 + 2 * 3
    assert c['bytes'] == 8 * 4 + maps + 8 * 3 * 4
    # the yardstick's entries are the adds, addressed g * U + u
    addr, vals = pg.aligned_entries(signals, pix_idx, starts, 8,
                                    n_ticks=5, time_sampling=0.1, rows=3)
    assert sorted(addr.tolist()) == sorted(
        [2 * 8 + 0, 2 * 8 + 1] + [g * 8 + u for g in range(3)
                                  for u in (1, 2)])


def test_pixel_sum_yardstick_computes_the_sum(workload):
    """D1's yardstick (``index_put_`` of the aligned entries, timed only on
    the card) computes the waveform sum: atol 1e-6 x peak against the
    plain version (its adds run in another order), one address per valid
    entry's tick inside the readout."""
    from larndsim_tpu_torch.ops import accumulate
    _, args, kw = pg.op_calls(workload)['sum_pixel_signals_with_csr']
    call, out = pg.pixel_sum_library(args, kw)
    call()
    want = accumulate.sum_pixel_signals_plain(*args, **kw)
    peak = float(want.abs().max())
    assert peak > 0
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6 * peak)
    assert out.shape == (kw['rows'], args[3])
    addr, vals = pg.aligned_entries(*args, **kw)
    assert len(addr) == len(vals) == pg.sum_costs(
        *args, kw['n_ticks'], kw['time_sampling'], rows=kw['rows'])['ops']
    assert set(pg.CHAIN_ROWS) <= set(pg.LIBRARY)


def test_bound_takes_the_larger_time():
    b = pg.bound(pg.HBM_BYTES_PER_S / 1e3, 0, 2.0)
    assert (b['bound_ms'], b['bound_by'], b['share']) == (1.0, 'bytes', 0.5)
    b = pg.bound(1, 2 * pg.F32_OPS_PER_S / 1e3)
    assert (b['bound_ms'], b['bound_by']) == (2.0, 'operations')
    assert 'share' not in b


def test_regression_check_on_a_temporary_log(tmp_path):
    log = tmp_path / 'guard.jsonl'
    shapes = dict(pg.LOGGED_SHAPES)

    def entry(ms, card='NVIDIA H100 80GB HBM3', sh=shapes):
        return dict(card=card, shapes=sh,
                    ops_ms={'fee_fsm': dict(min_ms=ms, mean_ms=ms)})

    with open(log, 'w') as f:
        for ms in (1.0, 2.0, 1.5):
            f.write(json.dumps(entry(ms)) + '\n')
        f.write('not json\n')
        f.write(json.dumps(entry(0.1, card='another card')) + '\n')
    assert pg.regressions(entry(2.2), str(log)) == []    # median 1.5 x 1.5
    warn = pg.regressions(entry(2.3), str(log))
    assert len(warn) == 1 and 'fee_fsm regressed' in warn[0]
    assert pg.regressions(entry(9.0, card='a third card'), str(log)) == []
    assert pg.regressions(entry(9.0, sh=dict(shapes, t_sig=4096)),
                          str(log)) == []
    assert pg.regressions(entry(9.0), str(tmp_path / 'absent.jsonl')) == []


def test_timing_needs_no_card_to_be_imported_but_main_needs_one(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        pg.main(['--log', str(tmp_path / 'guard.jsonl')])
    assert not (tmp_path / 'guard.jsonl').exists()
    assert pg.LOG_PATH.endswith('larndsim_tpu_torch/build/perf_guard.jsonl')
    assert np.isclose(pg.HBM_BYTES_PER_S, 3.35e12)
    # single float32 operations issue at half the FMA-counted FLOP peak
    assert np.isclose(pg.F32_OPS_PER_S, 33.5e12)


def test_light_ops_run_and_have_a_bound(workload):
    """The light ops on the guard's batch (tiny here): each runs, has its
    byte count, and the shapes are the chain's (96 channels, 16 us); the
    trigger scan's tables are those of the host walk."""
    lw = pg.build_light_workload(workload)
    assert lw['shapes'] == dict(pad_n=32, n_op_channel=96, n_ticks=16384,
                                conv_ticks=16000, fft_len=32768, nprof=100,
                                pad_front=900, digit_samples=256)
    calls, costs = pg.light_op_calls(lw), pg.light_op_costs(lw)
    f64 = ('light_scintillation', 'light_sipm', 'light_noise')
    assert set(calls) == set(costs) == {
        'light_sum_t0avg', 'light_sum_smearing', 'light_stat',
        'light_digitize', 'light_trigger_scan', *f64,
        *(n + '_f32' for n in f64)}
    outs = {}
    for name, (fn, args, kw) in calls.items():
        if name.startswith('light_noise'):   # the same phases for both
            lw['generator'].manual_seed(5)
        outs[name] = out = fn(*args, **kw)
        if name == 'light_trigger_scan':
            from larndsim_tpu_torch.ops import light as lo
            resp, thr, _, light = args
            t2m = {t: m for m, tpcs in lw['module_to_tpcs'].items()
                   for t in tpcs}
            walk = lo.get_triggers(resp, thr, np.arange(96), 0,
                                   light.replace(light_trig_mode=0),
                                   lw['module_to_tpcs'], t2m,
                                   device_scan=False)[0]
            idx, counts = out
            assert idx.shape == (1, 16384 // 2560 + 1)
            np.testing.assert_array_equal(idx[0, :counts[0]], walk)
            continue
        assert torch.isfinite(out).all(), name
        assert costs[name]['bytes'] > 0 and costs[name]['ops'] == 0, name
    # the float32 variants: the JAX ops' arithmetic, within the JAX
    # package's float32 FFT tolerance (tests/test_truth_staging.py:266-269)
    for name in f64[:2]:
        want = outs[name]
        np.testing.assert_allclose(outs[name + '_f32'], want, rtol=2e-4,
                                   atol=1e-5 * float(want.abs().max()))
        assert costs[name + '_f32'] == costs[name]
    d = (outs['light_noise_f32'] - outs['light_noise']).abs()
    assert d.max() <= 64 and (d == 0).double().mean() >= 0.999
    series = 96 * 16384 * 4
    assert costs['light_scintillation']['bytes'] == 2 * series
    assert costs['light_sum_smearing']['bytes'] == \
        costs['light_sum_t0avg']['bytes'] + 32 * 96 * 99 * 4
    assert costs['light_digitize']['bytes'] == 3 * 96 * 256 * 4
    # the response, 16 thresholds and masks, 7 ticks and a count
    assert costs['light_trigger_scan']['bytes'] == \
        series + 16 * 4 + 16 + (7 + 1) * 4


def test_light_truth_rows_run_and_have_a_bound(workload):
    """The smearing-truth rows on the guard's batch (tiny here, 4
    contributors): each stage runs, the product's bound is its
    multiply-adds, and the rows' records are the device route's (the host
    rows' with either emitter)."""
    import dataclasses
    from larndsim_tpu_torch.tools import light_check
    lw = pg.build_light_workload(workload)
    # the tiny batch's light arrives at ~1.9 us, past the digitized
    # window's 1.66: a microsecond earlier
    lw['segs'] = dataclasses.replace(lw['segs'], t0=lw['segs'].t0 - 1.0)
    calls, host_calls, shapes = pg.light_truth_calls(lw, k_truth=4)
    assert shapes == dict(pad_n=32, n_op_channel=96, k_truth=4,
                          n_ticks=16384, digit_samples=256, threshold=0.1)
    assert set(calls) == {'light_truth_series', 'light_truth_product',
                          'light_truth_pull'}
    outs = {name: fn(*args, **kw) for name, (fn, args, kw) in calls.items()}
    # the host route's recompute, its records by the native emitter and by
    # the numpy one: the same bytes
    assert set(host_calls) == {'light_truth_host', 'light_truth_host_plain'}
    rec, plain = (fn(*args, **kw) for fn, args, kw in (
        host_calls['light_truth_host'], host_calls['light_truth_host_plain']))
    assert len(rec) > 0 and plain.tobytes() == rec.tobytes()
    dev = outs['light_truth_pull']
    assert len(dev['tick']) > 0
    light_check.records_agree(
        {k: rec[f] for k, f in (('trig', 'trigger_id'),
                                ('op_channel', 'op_channel_id'),
                                ('tick', 'tick'), ('segment_id', 'segment_id'),
                                ('pe_current', 'pe_current'))}, dev, 0.1)
    costs = pg.light_truth_costs(calls, len(dev['tick']))
    rows = 96 * 4
    series = rows * 16384 * 4
    assert costs['light_truth_series'] == dict(
        bytes=series + rows * 100 * 4, ops=0)
    assert costs['light_truth_product'] == dict(
        bytes=series + 16384 * 256 * 4 + rows * 256 * 4,
        ops=rows * 16384 * 256)
    assert costs['light_truth_pull']['bytes'] == \
        rows * 4 + rows * 256 * 4 + 12 * len(dev['tick'])
    # at production shapes (C 96, K 50) the product is bound by its
    # multiply-adds: 40.3 GFLOP at 67 TFLOP/s
    b = pg.bound(0, 96 * 50 * 16384 * 256)
    assert b['bound_by'] == 'operations'
    assert np.isclose(b['bound_ms'], 0.601, atol=1e-3)


def test_grouped_beam_rows_run_and_have_a_bound(workload):
    """The beam stage of the guard's batch cut into 4 events (8 segments
    each here): the group call's waveforms equal the 4 solo calls' with
    generators seeded alike (bit for bit), and both rows have the bytes of
    4 events' light ops."""
    lw = pg.build_light_workload(workload)
    (group, _, _), _ = pg.light_group_calls(lw, workload['sim']).values()
    _, (solo, _, _) = pg.light_group_calls(lw, workload['sim']).values()
    got, want = group(), solo()
    assert len(got) == len(want) == pg.N_GROUP
    for g, w in zip(got, want):
        assert g.waveforms.shape == (1, 96, 256)
        assert torch.equal(g.waveforms, w.waveforms)
    costs = pg.light_group_costs(lw)
    assert costs['light_group_beam'] == costs['light_solo_beam_x4']
    per_event = pg.light_op_costs(dict(lw, shapes=dict(lw['shapes'],
                                                       pad_n=8)))
    assert costs['light_group_beam']['bytes'] == 4 * sum(
        per_event[k]['bytes'] for k in (
            'light_sum_smearing', 'light_scintillation', 'light_stat',
            'light_sipm', 'light_noise', 'light_digitize'))


def test_ndlar_workload_stages_and_runs(tmp_path):
    """``config='ndlar'``: the guard's batch on the ND-LAr-shaped tree (70
    TPCs, 50 ns sampling, 6401 ticks), at a tiny input: the charge ops run
    and have a bound."""
    w = pg.build_workload('cpu', str(tmp_path), pad_n=8, config='ndlar',
                          workload=dict(TINY, tracks_per_event=1,
                                        segments_per_track=3))
    det = w['det']
    assert det.n_tpcs == 70 and det.time_ticks == 6401
    assert det.time_sampling == 0.05
    assert set(w['shapes']) == set(pg.LOGGED_SHAPES)
    # 50 ns ticks: a signal window of ~191 us spans 4096 of them
    assert w['shapes']['t_sig'] == 4096
    calls = pg.op_calls(w)          # runs K1, the sum and the FSM once
    costs = pg.op_costs(w, calls)
    for name, (fn, args, kw) in calls.items():
        if name not in ('induced_current', 'sum_pixel_signals_with_csr',
                        'fee_fsm'):
            fn(*args, **kw)
        assert costs[name]['bytes'] > 0 and costs[name]['ops'] > 0, name
    assert set(pg.CONFIGS) == {'module0', 'ndlar'}
    assert pg.NDLAR_WORKLOAD['tracks_per_event'] == 82


def _k1_case(steps_xy, shifts, t_sig=8, ntp=10, device='cpu'):
    """K1's inputs for one segment and one pixel at the origin, sample
    points at ``steps_xy`` (cm) with ``shifts``, ratio 1, 45 x 45 bins of
    0.04 cm, a response of ones (its zero row zeros), ticks 1.. scaled by
    one (K1 takes the scale as 0 below ``tick_lo``)."""
    lut = current.LutGeometry(0.04, 45, 45, 1)
    n = len(shifts)
    f32, i32 = torch.float32, torch.int32
    xy = torch.tensor(steps_xy, dtype=f32)
    resp = torch.ones((lut.zero_row + 1, ntp), dtype=f32)
    resp[-1] = 0.0
    scale = torch.ones((1, t_sig), dtype=f32)
    scale[:, 0] = 0.0
    args = (xy[None, :, 0], xy[None, :, 1],
            torch.tensor([shifts], dtype=i32), torch.zeros((1, n), dtype=i32),
            torch.zeros((1, 1), dtype=f32), torch.zeros((1, 1), dtype=f32),
            torch.tensor([n], dtype=i32), torch.tensor([1], dtype=i32),
            torch.tensor([max(shifts)], dtype=i32),
            scale, resp)
    return tuple(a.contiguous().to(device) for a in args) + (lut,)


def test_k1_tiling_follows_the_kernel():
    """K1 counts its own tile choice, in a launch that equals its plain
    version.  Two steps in two bins, shifts 0 and 3, ticks 1..7: one chunk
    of two slots, span 3, at R 1 (one thread's tick covers the 7 ticks).
    A hundred steps in a hundred bins over 300 ticks: 100 x (256 + 0)
    floats overfill the windows at R 2 and 100 x 128 at R 1, so the chunk
    halves once, to two chunks of 50, each at R 1 (50 x 256 overfills
    them).  The windows: 56 KiB less the tables of 512 steps and the
    bitmap of 2026 rows (8784 bytes)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel counts its tiling')
    win = (56 * 1024 - 8784) // 4
    case = _k1_case([(0.01, 0.01), (0.05, 0.01)], [0, 3], device='cuda')
    out, t = binding.induced_current_tiling(*case)
    assert torch.equal(out, current.current_plain(*case))
    assert float(out.abs().max()) > 0
    assert t == dict(pairs=1, r2_chunks=0, r1_chunks=1, halvings=0,
                     max_slots=2, max_span=3, window_floats=win)
    pts = [(0.04 * i + 0.01, 0.04 * j + 0.01) for i in range(10)
           for j in range(10)]
    case = _k1_case(pts, [0] * 100, t_sig=300, ntp=400, device='cuda')
    out, t = binding.induced_current_tiling(*case)
    assert torch.equal(out, current.current_plain(*case))
    assert 100 * 128 > win >= 50 * 128 and 50 * 256 > win
    assert t == dict(pairs=1, r2_chunks=0, r1_chunks=2, halvings=1,
                     max_slots=100, max_span=0, window_floats=win)


def test_k1_tiling_needs_the_card():
    """The tile count exists only where the kernel runs: on CPU tensors
    the wrapper raises, as every kernel wrapper does."""
    with pytest.raises(ValueError, match='CUDA'):
        binding.induced_current_tiling(*_k1_case([(0.01, 0.01)], [0]))
