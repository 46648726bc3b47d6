"""The port's packet-stream assembly (``io/export.py``) against the JAX
package's.

``export_to_hdf5`` builds a flush's associations from the touched track
slots alone and places its service packets by counts;
``export_sync_to_hdf5`` makes every io group's sync packets in one array.
The reference is ``larndsim_tpu.io.export`` run on the CPU on the same
rows: a K-wide descending sort of every hit's track slots, one-row
service packets per io group, and a (hit, priority) lexsort over
concatenated parts.  Both files are read back through the port's HDF5
module and compared.  Tolerance: ``packets`` equal byte for byte;
``mc_packets_assn`` byte for byte where no two distinct slots of a hit
share a fraction, and otherwise the stored entries of nonzero fraction,
in order, with the trajectory columns byte for byte (the reference orders
ties by numpy's unstable sort, the port by slot).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import yaml

from larndsim_tpu.io import export as jexport
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.params.sim import SimParams as JSimParams
from larndsim_tpu_torch.io import export
from larndsim_tpu_torch.io import h5
from larndsim_tpu_torch.io import larpix_packets as lp
from larndsim_tpu_torch.io.export import pixel_readout_coords
from larndsim_tpu_torch.params import load_detector
from larndsim_tpu_torch.params.sim import SimParams

import torch_port_assets as tpa


# --------------------------------------------------------------------------
# fixtures
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def detectors(tmp_path_factory):
    """The small Module-0 tree as written (io groups 1, 2), and the same
    with ND-LAr's 35 modules of two io groups each (70 io groups): the
    port's detector model under each name, the JAX package's under
    ``jax_<name>``, and its light parameters as ``jax_light``."""
    paths = tpa.write_tree(tmp_path_factory.mktemp('tree'), light=True)
    io_70 = {m: [2 * m - 1, 2 * m] for m in range(1, 36)}
    out = {}
    for prefix, det in (('', load_detector(paths['detector_properties'],
                                           paths['pixel_layout'],
                                           device='cpu')),
                        ('jax_', tpa.load_jax(paths))):
        out[prefix + 'module0'] = det
        out[prefix + 'ndlar'] = dataclasses.replace(
            det, module_to_io_groups=io_70)
    out['jax_light'] = jload_light(paths['detector_properties'])
    return out


def _flush(det, seed, *, n_rows=60, n_events=3, K=50, fractions='random',
           max_valid=12, rollover=False, unmapped=False, ids=np.int64):
    """A flush's rows: ``n_rows`` pixel rows over ``n_events`` events in
    stream order, 0-4 ADC hits a row, ``K`` track slots a row with a valid
    prefix of 0 to ``max_valid`` slots, padded with -1 in ``ids`` (the CLI
    passes the input's uint32 segment ids: 4294967295).  ``fractions``:
    'random' (nonzero and distinct, a few negative), 'negative' (more than
    K - 20 negative slots in some rows), 'ties' (quantized, zeros among
    the valid slots; at most 20 nonzero a row)."""
    rng = np.random.default_rng(seed)
    nx, ny = det.layout.n_pixels
    events = np.sort(rng.integers(0, n_events, n_rows)) + 5
    unique_pix = rng.integers(0, nx * ny * 2, n_rows)
    if unmapped:
        unique_pix[rng.integers(0, n_rows, 2)] = nx * ny * 100
    n_valid = rng.integers(0, max_valid + 1, n_rows)
    n_valid[rng.integers(0, n_rows, 3)] = 0
    valid = np.arange(K)[None, :] < n_valid[:, None]
    track_ids = np.where(valid, rng.integers(0, 10_000, (n_rows, K)),
                         -1).astype(ids)
    traj_ids = np.where(valid, rng.integers(0, 6, (n_rows, K)),
                        -1).astype(ids)

    per_row = rng.integers(0, 5, n_rows)
    hit_row = np.repeat(np.arange(n_rows), per_row).astype(np.int32)
    n_h = len(hit_row)
    hit_adc = rng.integers(60, 120, n_h).astype(np.float32)
    hit_ticks = np.sort(rng.uniform(0.0, 30.0, n_h)).astype(np.float32)
    v = valid[hit_row]
    if fractions == 'ties':
        fr = rng.integers(-2, 5, (n_h, K)) / 8.0
        fr[:, 20:] = 0.0
    else:
        fr = rng.uniform(0.001, 1.0, (n_h, K))
        fr[rng.random((n_h, K)) < 0.1] *= -1
        if fractions == 'negative':
            neg_rows = rng.random(n_h) < 0.5
            fr[neg_rows] = -np.abs(fr[neg_rows])
            fr[neg_rows, :5] = np.abs(fr[neg_rows, :5])
    hit_fractions = np.where(v, fr, 0.0).astype(np.float32)

    uniq_events = np.unique(events)
    t0 = 999_990.0 if rollover else 1000.0
    event_times = t0 + 7.0 * np.arange(len(uniq_events))
    return dict(event_pix=events, hit_row=hit_row, hit_adc=hit_adc,
                hit_ticks=hit_ticks, hit_fractions=hit_fractions,
                unique_pix=unique_pix, track_ids=track_ids,
                traj_ids=traj_ids, event_start_times=event_times)


def _bad_channels(tmp_path, det, rows):
    """A bad-channels YAML naming the channels of a few of the flush's
    pixels."""
    g, c, chip, ch, ok = pixel_readout_coords(rows['unique_pix'][:6], det)
    bad = {}
    for i in np.nonzero(ok)[0][:4]:
        bad.setdefault(f'{g[i]}-{c[i]}-{chip[i]}', []).append(int(ch[i]))
    path = tmp_path / 'bad_channels.yaml'
    path.write_text(yaml.safe_dump(bad))
    return str(path)


def _write(tmp_path, name, fn, *args, **kw):
    """``fn`` writes the flush into a new file: the port's export into an
    open ``h5.File``, the JAX package's by its path.  Returns its packets
    and associations as the port's HDF5 module reads them."""
    path = str(tmp_path / f'{name}.h5')
    if fn is jexport.export_to_hdf5:
        fn(*args[:8], path, *args[8:], **kw)
    else:
        with h5.File(path, 'w') as f:
            fn(*args[:8], f, *args[8:], **kw)
    with h5.File(path, 'r') as f:
        return {k: np.asarray(f[k]) for k in ('packets', 'mc_packets_assn')
                if k in f}


def _light(rows, modules, n_per_event=2, seed=0):
    rng = np.random.default_rng(seed)
    ev = np.repeat(np.unique(rows['event_pix']), n_per_event)
    rng.shuffle(ev)
    return dict(light_trigger_times=rng.uniform(0.0, 20.0, len(ev)),
                light_trigger_event_id=ev,
                light_trigger_modules=rng.choice(modules, len(ev)))


CASES = {
    'random': dict(),
    'wide_rows': dict(rows=dict(max_valid=50)),
    'negative_stored': dict(rows=dict(max_valid=50, fractions='negative')),
    'narrow_k': dict(rows=dict(K=8, max_valid=8)),
    'ties': dict(rows=dict(max_valid=50, fractions='ties'), ties=True),
    'uint32_ids': dict(rows=dict(ids=np.uint32, max_valid=50)),
    'uint32_ids_negative': dict(rows=dict(ids=np.uint32, max_valid=50,
                                          fractions='negative')),
    'uint32_ids_narrow_k': dict(rows=dict(ids=np.uint32, K=8, max_valid=8)),
    'uint32_ids_ties': dict(rows=dict(ids=np.uint32, max_valid=50,
                                      fractions='ties'), ties=True),
    'one_event': dict(rows=dict(n_events=1)),
    'many_events_rollover': dict(rows=dict(n_events=12, n_rows=150,
                                           rollover=True)),
    'mode1_light': dict(mode=1, light=True),
    'mode0_light': dict(mode=0, light=True),
    'mode0_light_ndlar': dict(det='ndlar', mode=0, light=True),
    'ndlar_i_mod': dict(det='ndlar', i_mod=1),
    'ndlar_i_mod2_light': dict(det='ndlar', i_mod=2, light=True),
    'bad_channels': dict(bad=True),
    'unmapped': dict(rows=dict(unmapped=True)),
    'no_valid_slots': dict(rows=dict(max_valid=0)),
    'uint32_ids_no_valid_slots': dict(rows=dict(ids=np.uint32,
                                                max_valid=0)),
    'ndlar_everything': dict(det='ndlar', mode=0, light=True, bad=True,
                             rows=dict(n_events=6, max_valid=50,
                                       fractions='negative', rollover=True,
                                       unmapped=True)),
}


def _run_both(tmp_path, detectors, case, seed):
    name = case.get('det', 'module0')
    det, jdet = detectors[name], detectors['jax_' + name]
    rows = _flush(det, seed, **case.get('rows', {}))
    kw = dict(i_mod=case.get('i_mod', -1))
    mode = case.get('mode', 0)
    if case.get('light'):
        kw.update(_light(rows, sorted(det.module_to_io_groups)[:3],
                         seed=seed))
    else:
        # the charge-only flush as the CLI makes it: one trigger an event
        # at time 0 on module 1
        uniq = np.unique(rows['event_pix'])
        kw.update(light_trigger_times=np.zeros(len(uniq)),
                  light_trigger_event_id=uniq,
                  light_trigger_modules=np.ones(len(uniq)))
    if case.get('bad'):
        kw['bad_channels'] = _bad_channels(tmp_path, det, rows)
    K = rows['track_ids'].shape[1]
    args = (rows['event_pix'], rows['hit_row'], rows['hit_adc'],
            rows['hit_ticks'], rows['hit_fractions'], rows['unique_pix'],
            rows['track_ids'], rows['traj_ids'], rows['event_start_times'])
    want = _write(tmp_path, 'jax', jexport.export_to_hdf5, *args, jdet,
                  detectors['jax_light'].replace(light_trig_mode=mode),
                  JSimParams(max_tracks_per_pixel=K), **kw)
    got = _write(tmp_path, 'port', export.export_to_hdf5, *args, det, mode,
                 SimParams(max_tracks_per_pixel=K), **kw)
    return rows, want, got


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('name', list(CASES))
def test_export_equals_oracle(tmp_path, detectors, name, seed):
    case = CASES[name]
    rows, want, got = _run_both(tmp_path, detectors, case, seed)
    assert want['packets'].dtype == got['packets'].dtype
    assert want['packets'].tobytes() == got['packets'].tobytes()
    w, g = want['mc_packets_assn'], got['mc_packets_assn']
    assert w.dtype == g.dtype and w.shape == g.shape
    if not case.get('ties'):
        assert w.tobytes() == g.tobytes()
        return
    for k in ('event_ids', 'file_traj_ids', 'fraction_traj'):
        assert w[k].tobytes() == g[k].tobytes(), k
    # at most 20 nonzero fractions a hit: every one is stored
    np.testing.assert_array_equal(w['fraction'], g['fraction'])
    for wr, gr in zip(w, g):
        nz = wr['fraction'] != 0
        assert np.array_equal(nz, gr['fraction'] != 0)
        pw = sorted(zip(wr['fraction'][nz], wr['segment_ids'][nz]))
        pg = sorted(zip(gr['fraction'][nz], gr['segment_ids'][nz]))
        assert pw == pg


def test_fixtures_reach_every_branch(tmp_path, detectors):
    """The cases hold what they are named for: rows with more than 20
    touched slots and rows with none, stored negative fractions, ties,
    dropped hits and a rollover."""
    rows, want, _ = _run_both(tmp_path, detectors,
                              CASES['ndlar_everything'], 0)
    n_valid = (rows['track_ids'] != -1).sum(axis=1)
    assert n_valid.max() > 20 and n_valid.min() == 0
    det = detectors['ndlar']
    pk = want['packets']
    data = pk['packet_type'] == lp.DATA_PACKET
    assert (want['mc_packets_assn']['fraction'][data] < 0).any()
    above = rows['hit_adc'] > export._digitize_zero(det.params)
    assert 0 < data.sum() < above.sum()                 # dropped hits
    assert (pk['packet_type'] == lp.TRIGGER_PACKET).any()
    period = det.params.clock_reset_period
    ticks = pk['timestamp'][data]
    assert ticks.min() < period // 2 < ticks.max()      # a rollover
    rows = _flush(detectors['module0'], 0, max_valid=50, fractions='ties')
    fr = rows['hit_fractions']
    assert (fr < 0).any() and ((fr == 0) & (rows['track_ids'][
        rows['hit_row']] != -1)).any()


def test_tied_fractions_keep_slot_order():
    """One hit, hand-made: equal fractions (0.0 and -0.0 alike) keep slot
    order, the padding follows the touched zeros, negative fractions come
    last."""
    fr = np.array([[0.25, -0.5, -0.0, 0.5, 0.25, -0.25, 0.0, 0.0]],
                  np.float32)
    tid = np.array([[10, 11, 12, 13, 14, 15, 16, -1]])
    trj = np.array([[3, 1, 2, 3, 1, 2, 2, -1]])
    a = export._association_rows(fr, np.array([0]), tid, trj,
                                 np.array([7]), 6)[0]
    assert a['event_ids'].tolist() == [7]
    assert a['segment_ids'].tolist() == [13, 10, 14, 12, 16, -1]
    assert a['fraction'].tolist() == [0.5, 0.25, 0.25, 0.0, 0.0, 0.0]
    assert np.signbit(a['fraction']).tolist() == [False] * 3 + [True] + [
        False] * 2
    assert a['file_traj_ids'].tolist() == [1, 2, 3, -1, -1, -1]
    assert a['fraction_traj'].tolist() == [-0.25, -0.25, 0.75, 0, 0, 0]


def test_association_rows_take_float32():
    """The fractions' bits are the sort key: other dtypes are refused."""
    ids = np.full((1, 4), -1)
    with pytest.raises(TypeError):
        export._association_rows(np.zeros((1, 4)), np.array([0]), ids, ids,
                                 np.array([0]), 6)


@pytest.mark.parametrize('i_mod', [-1, 3])
def test_sync_equals_oracle(tmp_path, detectors, i_mod):
    det, jdet = detectors['ndlar'], detectors['jax_ndlar']
    period = det.params.clock_cycle * det.params.clock_reset_period
    times = period * np.arange(1, 41, dtype=np.float64)
    want_path, got_path = str(tmp_path / 'jax.h5'), str(tmp_path / 'p.h5')
    jexport.export_sync_to_hdf5(want_path, times, jdet, JSimParams(), i_mod)
    with h5.File(got_path, 'w') as f:
        export.export_sync_to_hdf5(f, times, det, SimParams(), i_mod)
    with h5.File(want_path) as fw, h5.File(got_path) as fg:
        for k in ('packets', 'mc_packets_assn'):
            w, g = np.asarray(fw[k]), np.asarray(fg[k])
            assert len(w) == 40 * (70 if i_mod < 0 else 2)
            assert w.dtype == g.dtype, k
            assert w.tobytes() == g.tobytes(), k


def test_service_packets_made_in_one_array(tmp_path, detectors,
                                           monkeypatch):
    """A flush of one event on 70 io groups, and 40 sync times, make
    their timestamp and sync packets in a few calls, not one an io
    group."""
    calls = {'make_timestamp_packets': 0, 'make_sync_packets': 0}
    for name in calls:
        real = getattr(lp, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(lp, name, counted)
    det = detectors['ndlar']
    rows = _flush(det, 3, n_events=1)
    uniq = np.unique(rows['event_pix'])
    with h5.File(str(tmp_path / 'p.h5'), 'w') as f:
        export.export_to_hdf5(
            rows['event_pix'], rows['hit_row'], rows['hit_adc'],
            rows['hit_ticks'], rows['hit_fractions'], rows['unique_pix'],
            rows['track_ids'], rows['traj_ids'], f,
            rows['event_start_times'], det, 0, SimParams(),
            light_trigger_times=np.zeros(1), light_trigger_event_id=uniq,
            light_trigger_modules=np.ones(1))
        n_sync = np.asarray(f['packets'])['packet_type'] == lp.SYNC_PACKET
        assert n_sync.sum() == 70
        period = det.params.clock_cycle * det.params.clock_reset_period
        export.export_sync_to_hdf5(f, period * np.arange(1, 41), det,
                                   SimParams())
    assert calls['make_timestamp_packets'] <= 3
    assert calls['make_sync_packets'] <= 3
