"""Event grouping in the port: several independent events in one call.

Charge: ``segments.from_structured_group`` equal to JAX's field for field;
``simulate_charge_batch(event_slot=)`` against JAX's with the JAX draws fed
in (integer outputs equal, ``hit_adc`` equal for >= 99% of hits and within
1, as tests/test_torch_charge.py); two copies of one event separate
exactly (JAX tests/test_event_grouping.py:35); per-pixel thresholds and
gains follow the pixel, not its key (where the JAX package looks the key
up: its events past a group's first get the default).

Light: ``simulate_light_group`` against G solo ``simulate_light_batch``
calls with the same draws: waveforms and contributor / host-route truth
records bit for bit; the device route's records beyond 1e-3 of the
threshold equal, pe_current at rtol 1e-4 / atol 1e-5 (its product sums
another number of rows, ``tools.light_check.records_agree``).  Against
JAX's ``simulate_light_group`` with JAX's draws fed through ``LightDraw``:
waveforms within one quantum (64 ADC), >= 99.9% of samples equal; truth
records as tests/test_torch_light.py.
"""
from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets.light_lut import make_light_lut, make_light_noise
from larndsim_tpu.assets.response import make_response
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.models import light as jmodel
from larndsim_tpu.ops import light as jops
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu.params import physics
from larndsim_tpu.utils.pixel_lut import PixelLUT as JLUT
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.models import charge as tcharge
from larndsim_tpu_torch.models import light as tmodel
from larndsim_tpu_torch.ops import light as tops
from larndsim_tpu_torch.params import load_sim as tload_sim
from larndsim_tpu_torch.tools.light_check import records_agree
from larndsim_tpu_torch.utils.pixel_lut import PixelLUT as TLUT

import torch_port_assets as tpa
from test_torch_charge import jax_draw as jax_charge_draw
from test_torch_light import LIGHT, QUANT, _same_records, _waveforms_agree
from test_torch_light import jax_draw as jax_light_draw

# ---------------------------------------------------------------------------
# charge
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    paths = tpa.write_tree(tmp_path_factory.mktemp('tree'))
    jm = tpa.load_jax(paths)
    det = jm.params
    n_t = int(round(float(det.time_window) / float(det.response_sampling)))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=float(det.response_bin_size),
                             pixel_pitch=float(det.pixel_pitch))
    nx, ny = det.n_pixels
    return dict(paths=paths, jm=jm, tm=tpa.load_port(paths),
                js=jload_sim(paths['simulation_properties']),
                ts=tload_sim(paths['simulation_properties']),
                response=response, n_pix_total=nx * ny * det.n_tpcs)


def _two_events(tree, seeds=(13, 17)):
    """Two events' tracks, their concatenation and its slots at pad 64."""
    a, b = (tpa.detector_tracks(tree['jm'].tpc_borders, seed=s,
                                tracks_per_event=3) for s in seeds)
    tracks = np.concatenate([a, b])
    slot = np.zeros(64, np.int32)
    slot[len(a):len(tracks)] = 1
    return a, b, tracks, slot


def test_from_structured_group_equals_jax(tree):
    a, b, _, _ = _two_events(tree)
    a = a[[n for n in a.dtype.names if n != 'traj_id']]   # file_traj_id
    want = jseg.from_structured_group([a, b], 48)
    got = tseg.from_structured_group([a, b], 48, device='cpu')
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
        assert getattr(got, f.name).shape == (2, 48)
    assert got.size == 48
    np.testing.assert_array_equal(
        tseg.stack([got.event(0), got.event(1)]).x.numpy(), got.x.numpy())


def test_event_slot_matches_jax(tree):
    """The grouped charge call against JAX's with the same draws."""
    _, _, tracks, slot = _two_events(tree)
    key = jax.random.PRNGKey(5)
    want = jcharge.simulate_charge_batch(
        jseg.from_structured(tracks, pad_to=64), tree['jm'], tree['js'], key,
        jnp.asarray(tree['response']), step_scale=2.0, backend='pallas',
        event_slot=slot)
    got = tcharge.simulate_charge_batch(
        tseg.from_structured(tracks, pad_to=64, device='cpu'), tree['tm'],
        tree['ts'], jax_charge_draw(key), torch.from_numpy(tree['response']),
        step_scale=2.0, event_slot=slot)
    assert want.n_unique == got.n_unique > 0
    for name in ('unique_pix', 'n_adc', 'track_pixel_map', 'hit_row',
                 'hit_slot', 'hit_ticks'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    valid = got.unique_pix >= 0
    assert set((got.unique_pix[valid] // tree['n_pix_total']).tolist()) \
        == {0, 1}, 'both events must reach the readout'
    diff = np.abs(got.hit_adc.astype(np.int64)
                  - want.hit_adc.astype(np.int64))
    assert len(diff) > 0 and diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_grouped_events_separate_exactly(tree):
    """One event twice in one call (slots 0 and 1): each copy's pixel set
    is the solo call's, and the unique count doubles."""
    tr = tpa.detector_tracks(tree['jm'].tpc_borders, seed=13,
                             tracks_per_event=3)
    n = len(tr)

    def run(tracks, pad, slot=None):
        return tcharge.simulate_charge_batch(
            tseg.from_structured(tracks, pad_to=pad, device='cpu'),
            tree['tm'], tree['ts'], tcharge.generator_draw(
                torch.Generator().manual_seed(3), 'cpu'),
            torch.from_numpy(tree['response']), step_scale=16.0,
            event_slot=slot)
    solo = run(tr, 32)
    solo_pix = set(solo.unique_pix[solo.unique_pix >= 0].tolist())
    slot = np.zeros(64, np.int32)
    slot[n:2 * n] = 1
    grp = run(np.concatenate([tr, tr]), 64, slot)
    uniq = grp.unique_pix[grp.unique_pix >= 0]
    ev, pid = uniq // tree['n_pix_total'], uniq % tree['n_pix_total']
    assert set(ev.tolist()) == {0, 1}
    assert set(pid[ev == 0].tolist()) == set(pid[ev == 1].tolist()) \
        == solo_pix
    assert grp.n_unique == 2 * solo.n_unique


def test_grouped_thresholds_follow_the_pixel(tree):
    """A threshold map that silences every pixel: a solo call of either
    event and the port's grouped call give no hit.  The JAX package looks
    the *key* up, so its second event gets the default threshold and
    fires (the fault the port departs from, ROADMAP queue 3); gains are
    looked up by pixel id too."""
    a, b, tracks, slot = _two_events(tree)
    keys = np.arange(tree['n_pix_total'])
    quiet = np.full(len(keys), 1e9, np.float32)
    default = float(tree['jm'].params.discrimination_threshold)
    key = jax.random.PRNGKey(5)
    jax_hits = jcharge.simulate_charge_batch(
        jseg.from_structured(tracks, pad_to=64), tree['jm'], tree['js'], key,
        jnp.asarray(tree['response']), step_scale=2.0, backend='pallas',
        event_slot=slot, pixel_thresholds=JLUT(keys, quiet, default))
    ev = jax_hits.unique_pix[jax_hits.hit_row] // tree['n_pix_total']
    assert len(ev) > 0 and (ev == 1).all()

    def port(tr, pad, slot=None):
        return tcharge.simulate_charge_batch(
            tseg.from_structured(tr, pad_to=pad, device='cpu'), tree['tm'],
            tree['ts'], jax_charge_draw(key),
            torch.from_numpy(tree['response']), step_scale=2.0,
            event_slot=slot, pixel_thresholds=TLUT(keys, quiet, default))
    for res in (port(a, 32), port(b, 32), port(tracks, 64, slot)):
        assert len(res.hit_row) == 0 and res.n_unique > 0
    gains = np.linspace(3e-3, 5e-3, len(keys)).astype(np.float32)
    st = tcharge.stage_batch(
        tseg.from_structured(tracks, pad_to=64, device='cpu'), tree['tm'],
        tree['ts'], pixel_gains=TLUT(keys, gains, 4e-3), event_slot=slot,
        step_scale=2.0)
    u = st.uniq[:int(st.n_unique)].numpy()
    np.testing.assert_array_equal(st.gains[:len(u), 0].numpy(),
                                  gains[u % tree['n_pix_total']])


def test_event_slot_refuses_int32_overflow(tree):
    _, _, tracks, _ = _two_events(tree)
    slot = np.full(64, 2 ** 31 // tree['n_pix_total'], np.int32)
    with pytest.raises(ValueError, match='overflow int32'):
        tcharge.stage_batch(
            tseg.from_structured(tracks, pad_to=64, device='cpu'),
            tree['tm'], tree['ts'], event_slot=slot)


# ---------------------------------------------------------------------------
# light
# ---------------------------------------------------------------------------

#: three events of other sizes (so other solo pads); event ids
EVENTS = (3, 8, 11)


@pytest.fixture(scope='module')
def light_setup(tmp_path_factory):
    paths = tpa.write_tree(tmp_path_factory.mktemp('light'), light=LIGHT)
    dm = tpa.load_jax(paths)
    jl = jload_light(paths['detector_properties'])
    lut_arr = make_light_lut((14, 26, 8), n_det_tpc=6, n_prof=100)
    jlut = jops.LightLUT.from_structured(lut_arr)
    events = []
    for i, ev in enumerate(EVENTS):
        tracks = tpa.detector_tracks(dm.tpc_borders, seed=5 + i,
                                     tracks_per_event=2 + 3 * i)
        rng = np.random.default_rng(6 + i)
        tracks['t0'] = rng.uniform(0.02, 1.6, len(tracks))
        pad = tcharge.bucket(len(tracks), lo=32)
        js = jdrift(jquench(jseg.from_structured(tracks, pad_to=pad),
                            dm.params, physics.BIRKS), dm.params)
        n_ph, _, vox = jops.calculate_light_incidence(
            js, dm.params, jl, jlut.vis, jlut.t0, n_channels=jl.n_op_channel)
        events.append(dict(ev=ev, n=len(tracks), pad=pad, js=js,
                           drifted=jseg.to_structured(js, tracks.dtype),
                           n_ph=np.asarray(n_ph), vox=np.asarray(vox)))
    pads = {e['pad'] for e in events}
    assert len(pads) > 1, 'the events must differ in their solo pads'
    G, pad = len(events), max(pads)
    n_ph_g = np.zeros((G, pad, jl.n_op_channel), np.float32)
    vox_g = np.zeros((G, pad, 3), events[0]['vox'].dtype)
    for g, e in enumerate(events):
        n_ph_g[g, :e['n']] = e['n_ph'][:e['n']]
        vox_g[g, :e['n']] = e['vox'][:e['n']]
    return dict(paths=paths, dm=dm, jl=jl, tl=tpa.port_light(jl),
                jlut=jlut, tlut=tops.LightLUT.from_structured(lut_arr, 'cpu'),
                events=events, pad=pad, n_ph_g=n_ph_g, vox_g=vox_g,
                noise=make_light_noise(LIGHT['n_op_channel']))


def _light_case(s, case):
    smear = case.startswith('smearing')
    k = 0 if case == 'smearing' else 4
    route = case.rpartition('_')[2] if case.startswith('smearing_truth') \
        else 'device'
    tl = s['tl'].replace(enable_lut_smearing=smear)
    ts = dataclasses.replace(tpa.load_port_sim(s['paths']),
                             max_mc_truth_ids=k, mc_truth_threshold=0.1)
    return tl, ts, route


def _gen_draws():
    return [tmodel.generator_draw(torch.Generator().manual_seed(100 + e),
                                  'cpu') for e in EVENTS]


def _solo_and_group(s, case, executor=None):
    tl, ts, route = _light_case(s, case)
    common = dict(truth_path=route, truth_executor=executor)
    solos = [tmodel.simulate_light_batch(
        tseg.from_structured(e['drifted'], pad_to=e['pad'], device='cpu'),
        tl, ts, torch.from_numpy(e['n_ph']),
        torch.from_numpy(e['vox']), s['tlut'], s['noise'], draw,
        event_id=e['ev'], **common)
        for e, draw in zip(s['events'], _gen_draws())]
    group = tmodel.simulate_light_group(
        tseg.from_structured_group([e['drifted'] for e in s['events']],
                                   s['pad'], device='cpu'),
        tl, ts, torch.from_numpy(s['n_ph_g']), torch.from_numpy(s['vox_g']),
        s['tlut'], s['noise'], _gen_draws(),
        event_ids=[e['ev'] for e in s['events']], **common)
    return solos, group


@pytest.mark.parametrize('case', ['contributor_truth', 'smearing',
                                  'smearing_truth_device',
                                  'smearing_truth_host'])
def test_group_equals_solo_calls(light_setup, case):
    solos, group = _solo_and_group(light_setup, case)
    assert len(group) == len(solos) == len(EVENTS)
    n_records = 0
    for solo, grp in zip(solos, group):
        for name in ('trigger_idx', 'trigger_type', 'op_channel_idx'):
            np.testing.assert_array_equal(getattr(grp, name),
                                          getattr(solo, name))
        assert (grp.start_time, grp.n_ticks) == (solo.start_time,
                                                 solo.n_ticks)
        assert grp.waveforms.shape == solo.waveforms.shape == (1, 12, 256)
        assert torch.equal(grp.waveforms, solo.waveforms)
        if case == 'smearing':
            assert grp.truth_sparse is solo.truth_sparse is None
            continue
        if case == 'smearing_truth_device':
            n_records += records_agree(grp.truth_sparse, solo.truth_sparse,
                                       0.1)['records']
            continue
        for k in solo.truth_sparse:
            np.testing.assert_array_equal(grp.truth_sparse[k],
                                          solo.truth_sparse[k], err_msg=k)
        n_records += len(solo.truth_sparse['tick'])
    assert any(np.abs(s.waveforms.numpy()).max() > QUANT for s in solos)
    if case != 'smearing':
        assert n_records > 0, 'test must produce truth records'


def test_group_host_route_on_workers(light_setup):
    """The host route's records from per-event worker futures, in event
    order, equal to the solo calls' (trigger ids from 0, event ids
    stamped)."""
    with ThreadPoolExecutor(2) as pool:
        solos, group = _solo_and_group(light_setup, 'smearing_truth_host',
                                       pool)
        got = [g.truth_future.result() for g in group]
        want = [s.truth_future.result() for s in solos]
    assert sum(len(w) for w in want) > 0
    for g, w, e in zip(got, want, light_setup['events']):
        np.testing.assert_array_equal(g, w)
        assert (g['event_id'] == e['ev']).all()


@pytest.mark.parametrize('case', ['contributor_truth', 'smearing',
                                  'smearing_truth_host'])
def test_group_matches_jax(light_setup, case):
    """JAX's grouped beam stage against the port's with JAX's per-event
    draws (``fold_in(key_mod, ievd)``, then ``fold_in(., 0)`` as the solo
    call)."""
    s = light_setup
    tl, ts, route = _light_case(s, case)
    jl = dataclasses.replace(s['jl'],
                             enable_lut_smearing=tl.enable_lut_smearing)
    js_sim = dataclasses.replace(
        jload_sim(s['paths']['simulation_properties']),
        max_mc_truth_ids=ts.max_mc_truth_ids, mc_truth_threshold=0.1)
    key_mod = jax.random.PRNGKey(31)
    segs_g = jseg.from_structured_group([e['drifted'] for e in s['events']],
                                        s['pad'])
    op_channel = np.asarray(jl.tpc_to_op_channel).ravel()
    want = jmodel.simulate_light_group(
        segs_g, s['dm'], jl, js_sim, s['n_ph_g'], s['vox_g'], s['jlut'],
        s['noise'], key_mod, np.array(EVENTS), op_channel, truth_path=route)
    got = tmodel.simulate_light_group(
        tseg.from_structured_group([e['drifted'] for e in s['events']],
                                   s['pad'], device='cpu'),
        tl, ts, torch.from_numpy(s['n_ph_g']), torch.from_numpy(s['vox_g']),
        s['tlut'], s['noise'],
        [jax_light_draw(jax.random.fold_in(key_mod, ev), 0)
         for ev in EVENTS], truth_path=route)
    for w, g in zip(want, got):
        _waveforms_agree(g.waveforms.numpy(), np.asarray(w.waveforms))
        if case == 'smearing':
            assert g.truth_sparse is None and w.truth_sparse is None
        elif w.truth_sparse['tick'].size:
            _same_records(g.truth_sparse, w.truth_sparse)
    if case != 'smearing':
        assert sum(w.truth_sparse['tick'].size for w in want) > 0


def test_group_draw_takes_each_events_draws_in_solo_order():
    calls = collections.defaultdict(list)

    def draw(g):
        def rec(kind, shape):
            calls[g].append((kind, tuple(shape)))
            return torch.full(tuple(shape), float(g))
        return tops.LightDraw(poisson=lambda r: rec('poisson', r.shape),
                              normal=lambda sh: rec('normal', sh),
                              uniform=lambda sh: rec('uniform', sh))
    gd = tmodel.group_draw([draw(0), draw(1)])
    assert gd.poisson(torch.zeros(2, 3, 4))[1].eq(1).all()
    assert gd.normal((2, 3, 4)).shape == (2, 3, 4)
    assert gd.uniform((2, 3, 5))[0].eq(0).all()
    for g in (0, 1):
        assert calls[g] == [('poisson', (3, 4)), ('normal', (3, 4)),
                            ('uniform', (3, 5))]
