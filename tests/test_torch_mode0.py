"""Port parity: the threshold light trigger (mode 0).

Both packages get the same inputs, made from seeds with numpy: JAX's
quenched and drifted segments of a small Module-0-shaped tree whose light
keys are those of tests/test_torch_light.py in mode 0 (12 channels in two
groups of 6, a [0, 2] us light window, the default [0.9, 1.66] us trigger
window: 2560 dead-time ticks, 256 ADC samples of 10 ticks), tracks at
their own times over ~4 us (several triggers a batch), the same synthetic
LUT and noise, and the same random draws (JAX's key tree through
``LightDraw``, tests/test_torch_light.py; JAX draws its noise after its
trigger scan, at the padded shape the triggers set, and so does the port).

Tolerances: windows, trigger tables (ticks, types, channels) and the
threshold groups' flags equal (the groups' sums and block means equal bit
for bit: probed with thresholds at and beside a numpy sequential-sum
reference); the dead-time scan equal to JAX's scan and to JAX's host walk;
waveforms within one quantum (64 ADC) with >= 99.9% of samples equal;
contributor-point truth records equal with pe_current at rtol 1e-4 / atol
1e-6; LUT-smearing truth: the host route's records equal to JAX's (the
same numpy), every other comparison by ``tools.light_check.records_agree``
(records beyond 1e-3 of the threshold equal, pe_current at rtol 1e-4 /
atol 1e-5), with subnormals flushed as XLA's CPU does.  Grouped mode 0:
each event equal to its solo call bit for bit, and to JAX's
``simulate_light_group_mode0`` at the tolerances above.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets.light_lut import make_light_lut, make_light_noise
from larndsim_tpu.io import export as jexport
from larndsim_tpu.models import light as jmodel
from larndsim_tpu.ops import light as jops
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu.params import physics
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.io import export as texport
from larndsim_tpu_torch.models import light as tmodel
from larndsim_tpu_torch.ops import light as tops
from larndsim_tpu_torch.tools.light_check import records_agree

import torch_port_assets as tpa
from test_torch_light import QUANT, _same_records, _waveforms_agree, jax_draw
from test_torch_light_truth import flush_subnormals

LIGHT0 = dict(n_op_channel=12, light_window=(0.0, 2.0), light_trig_mode=0)
#: track start times [us] of the batch: some within a dead time of each
#: other, some past it
TRACK_T0 = (0.05, 0.4, 1.9, 2.8, 3.3, 4.1)
#: the grouped events' track times: their windows share one bucket
EVENTS = (3, 8, 11)
EVENT_T0 = ((0.05, 3.9), (0.3, 4.0, 2.2), (0.1, 1.0, 3.7, 4.05))


def _segments(dm, jl, jlut, t0s, seed):
    """JAX's drifted segments of one track per entry of ``t0s`` (the
    segments 1 ns apart) and their incidence."""
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=seed,
                                 tracks_per_event=len(t0s))
    tracks['t0'] = (np.asarray(t0s)[tracks['traj_id']]
                    + 1e-3 * np.arange(len(tracks)))
    js = jdrift(jquench(jseg.from_structured(tracks, pad_to=64), dm.params,
                        physics.BIRKS), dm.params)
    n_ph, t0_det, vox = jops.calculate_light_incidence(
        js, dm.params, jl, jlut.vis, jlut.t0, n_channels=jl.n_op_channel)
    return dict(js=js, ts=tpa.port_segments(js), n_ph=np.asarray(n_ph),
                t0_det=np.asarray(t0_det), vox=np.asarray(vox),
                drifted=jseg.to_structured(js, tracks.dtype), n=len(tracks))


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    paths = tpa.write_tree(tmp_path_factory.mktemp('mode0'), light=LIGHT0)
    dm = tpa.load_jax(paths)
    jl = jload_light(paths['detector_properties'])
    lut_arr = make_light_lut((14, 26, 8), n_det_tpc=6, n_prof=100)
    jlut = jops.LightLUT.from_structured(lut_arr)
    events = [dict(_segments(dm, jl, jlut, t0s, seed=21 + i), ev=ev)
              for i, (ev, t0s) in enumerate(zip(EVENTS, EVENT_T0))]
    return dict(paths=paths, dm=dm, jl=jl, tl=tpa.port_light(jl),
                jlut=jlut, tlut=tops.LightLUT.from_structured(lut_arr, 'cpu'),
                noise=make_light_noise(12), events=events,
                **_segments(dm, jl, jlut, TRACK_T0, seed=5))


def _lights(s, **changes):
    """The JAX and port light params with ``changes`` (a threshold given
    as one float for every group)."""
    jl, tl = s['jl'], s['tl']
    thr = changes.pop('light_trig_threshold', None)
    if thr is not None:
        n = tl.light_trig_threshold.numel()
        jl = dataclasses.replace(jl, light_trig_threshold=jnp.full(n, thr))
        tl = tl.replace(light_trig_threshold=torch.full((n,), thr))
    return dataclasses.replace(jl, **changes), tl.replace(**changes)


# --------------------------------------------------------------------------
# window
# --------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['lit', 'dark', 'beam', 'capped'])
def test_get_nticks_and_window(setup, case):
    s = setup
    n_ph, t0 = s['n_ph'].copy(), s['t0_det'].copy()
    jl, tl = _lights(s, light_trig_mode=1 if case == 'beam' else 0)
    if case == 'dark':
        n_ph[:] = 0.0
    if case == 'capped':
        t0[np.nonzero(n_ph > 0)[0][0]] += 60.0     # > MAX_TICKS ticks wide
    want = jops.get_nticks(n_ph, t0, jl)
    assert tops.get_nticks(n_ph, t0, tl) == want
    assert tops.get_nticks(torch.from_numpy(n_ph), torch.from_numpy(t0),
                           tl) == want
    want_w = jmodel.mode0_window(n_ph, t0, jl)
    assert tmodel.mode0_window(n_ph, t0, tl) == want_w
    assert want_w[0] == {'lit': 8192, 'dark': 2048, 'beam': 2048,
                         'capped': 65536}[case], want_w


# --------------------------------------------------------------------------
# threshold groups, scan, triggers
# --------------------------------------------------------------------------

def _block_means(sig: np.ndarray, per_trig: int, factor: int) -> np.ndarray:
    """The reference the probes below hold both packages to: the groups'
    sums added channel after channel in float32, each block's ticks over 8
    lanes (lane L: ticks L, L + 8, ... in turn), the lanes added by
    halves, times the float32 reciprocal of the block length: the JAX
    op's arithmetic on the CPU."""
    C, T = sig.shape
    g = sig.reshape(C // per_trig, per_trig, T)
    s = g[:, 0]
    for j in range(1, per_trig):
        s = s + g[:, j]
    s = np.pad(s, ((0, 0), (0, (-T) % factor)))
    b = s.reshape(s.shape[0], -1, factor)
    lanes = [np.zeros(b.shape[:2], np.float32) for _ in range(8)]
    for t in range(factor):
        lanes[t % 8] = b[..., t] if t < 8 else lanes[t % 8] + b[..., t]
    while len(lanes) > 1:
        h = len(lanes) // 2
        lanes = [lanes[i] + lanes[i + h] for i in range(h)]
    return lanes[0] * (np.float32(1) / np.float32(factor))


@pytest.mark.parametrize('C,T,factor', [(12, 4099, 10), (96, 16384, 10),
                                        (12, 4000, 4), (12, 4000, 16)])
def test_group_above_threshold(C, T, factor):
    """Thresholds at each probed block's mean and one float32 step on
    either side: both packages give the flags of the reference (so their
    sums and means are its bits), and equal flags everywhere."""
    rng = np.random.default_rng(C + T + factor)
    sig = (rng.standard_normal((C, T)) * 3000.0).astype(np.float32)
    m = _block_means(sig, 6, factor)
    kw = dict(per_trig=6, sample_factor=factor)
    for b in rng.integers(0, m.shape[1], 6):
        for step, flag in ((-np.inf, False), (0, False), (np.inf, True)):
            thr = m[:, b] if step == 0 else np.nextafter(
                m[:, b], np.float32(step))
            want = np.asarray(jops.group_above_threshold(
                jnp.asarray(sig), jnp.asarray(thr), **kw))
            got = tops.group_above_threshold(
                torch.from_numpy(sig), torch.from_numpy(thr), **kw).numpy()
            np.testing.assert_array_equal(got, want)
            assert (got[:, b * factor] == flag).all()
    # a stacked group: each event's flags
    thr = np.full(C // 6, -1500.0, np.float32)
    sig2 = np.stack([sig, sig[::-1].copy()])
    got = tops.group_above_threshold(torch.from_numpy(sig2),
                                     torch.from_numpy(thr), **kw)
    for g in range(2):
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(
            jops.group_above_threshold(jnp.asarray(sig2[g]),
                                       jnp.asarray(thr), **kw)))


@pytest.mark.parametrize('density', [0.0, 3e-4, 0.01, 0.5])
def test_dead_time_trigger_scan(density):
    rng = np.random.default_rng(int(density * 1e4) + 1)
    above = rng.random((3, 6000)) < density
    above[1, 700:900] = density > 0     # a pulse longer than nothing
    kw = dict(digit_ticks=700, max_trig=6000 // 700 + 1)
    want = jops.dead_time_trigger_scan(jnp.asarray(above), **kw)
    got = tops.dead_time_trigger_scan(torch.from_numpy(above), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[1].sum() > 0) == (density > 0)
    # a stacked group: each event's tables
    grp = tops.dead_time_trigger_scan(torch.from_numpy(
        np.stack([above, above[::-1].copy()])), **kw)
    np.testing.assert_array_equal(grp[0][0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(grp[1][1].numpy(), np.asarray(
        jops.dead_time_trigger_scan(jnp.asarray(above[::-1].copy()),
                                    **kw)[1]))


@pytest.fixture(scope='module')
def light96(tmp_path_factory):
    """A 96-channel module in mode 0 (16 groups), as the JAX tests'."""
    paths = tpa.write_tree(tmp_path_factory.mktemp('l96'), light=dict(
        n_op_channel=96, light_trig_mode=0))
    jl = jload_light(paths['detector_properties'])
    return dict(jl=jl, tl=tpa.port_light(jl), dm=tpa.load_jax(paths))


def _pulses(rng, T, n=10):
    sig = np.zeros((96, T), np.float32)
    for _ in range(n):
        g = int(rng.integers(0, 16))
        t = int(rng.integers(0, T - 120))
        sig[g * 6:(g + 1) * 6, t:t + 100] = -400.0
    return sig


@pytest.mark.parametrize('case', ['pulse', 'random', 'random_two_modules',
                                  'beam', 'beam_later'])
def test_get_triggers(light96, case):
    """The port's scan against JAX's scan and against JAX's host walk, and
    the port's own host walk (tests/test_light.py:124-189): one pulse, the
    JAX test's four random multi-pulse trials (pulses within and just past
    the dead time), the same with each TPC a module of its own, and the
    beam trigger."""
    jl, tl = light96['jl'], light96['tl']
    if case.startswith('beam'):
        jl = dataclasses.replace(jl, light_trig_mode=1)
        tl = tl.replace(light_trig_mode=1)
    modules = ({1: [0], 2: [1]} if case.endswith('two_modules')
               else light96['dm'].module_to_tpcs)
    tpc_to_module = {t: m for m, tpcs in modules.items() for t in tpcs}
    dt = tops.digit_ticks(tl)
    T = 4 * dt + 500
    rng = np.random.default_rng(9)
    sigs = ([_pulses(rng, T) for _ in range(4)] if case.startswith('random')
            else [np.zeros((96, 4000), np.float32)])
    if case == 'pulse':
        sigs[0][0:6, 1000:1100] = -400.0
    thr = np.full(16, -1500.0)
    i_sub = 1 if case == 'beam_later' else 0
    n_trig = 0
    for sig in sigs:
        jargs = (sig, thr, np.arange(96), i_sub, jl, modules, tpc_to_module,
                 np.asarray(jl.tpc_to_op_channel))
        targs = (torch.from_numpy(sig), thr, np.arange(96), i_sub, tl,
                 modules, tpc_to_module)
        want = jops.get_triggers(*jargs, device_scan=True)
        walk = jops.get_triggers(*jargs, device_scan=False)
        for got in (tops.get_triggers(*targs),
                    tops.get_triggers(*targs, device_scan=False)):
            for g, w, h in zip(got, want, walk):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, h)
        n_trig += len(want[0])
    expected = dict(pulse=1, beam=1, beam_later=0)
    if case in expected:
        assert n_trig == expected[case]
    else:
        assert n_trig > 8 and (want[2] == 0).all()
    if case == 'pulse':
        assert 900 <= want[0][0] <= 1100


def test_module_masks_and_thresholds(light96):
    jl, tl = light96['jl'], light96['tl']
    thr = np.linspace(-3000.0, -1500.0, 16)
    jl = dataclasses.replace(jl, light_trig_threshold=jnp.asarray(thr))
    tl = tl.replace(light_trig_threshold=torch.tensor(thr,
                                                      dtype=torch.float32))
    modules = {1: [0], 2: [1]}
    t2m = {0: 1, 1: 2}
    for op in (np.arange(96), np.arange(48, 96)):
        want = jops.mode0_module_masks(op, jl, modules, t2m,
                                       np.asarray(jl.tpc_to_op_channel))
        got = tops.mode0_module_masks(op, tl, modules, t2m)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1], want[1]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tops.mode0_group_threshold(op, tl),
                                      jops.mode0_group_threshold(op, jl))


@pytest.mark.parametrize('ref_exact', [False, True])
def test_digitize_several_triggers(setup, ref_exact):
    """tests/test_light.py:191-215: a pulse at the second trigger; the
    intended windows see it at that trigger only, the reference's active
    line samples tick 0 for every trigger."""
    tl, jl = setup['tl'], setup['jl']
    pre = int(np.ceil(tl.light_trig_window[0] / tl.light_tick_size))
    sig = np.zeros((4, 4000 + pre), np.float32)
    sig[:, pre + 2000:pre + 2100] = -700.0
    trig = np.array([pre, pre + 2000, pre + 3500])
    kw = dict(digit_samples=256, ref_exact=ref_exact)
    want = np.asarray(jops.digitize_signal(jnp.asarray(sig),
                                           jnp.asarray(trig), jl, **kw))
    got = tops.digitize_signal(torch.from_numpy(sig), torch.from_numpy(trig),
                               tl, **kw).numpy()
    assert got.shape == (3, 4, 256)
    np.testing.assert_array_equal(got, want)
    if ref_exact:
        assert (got[0] == got[1]).all() and (got[1] == got[2]).all()
    else:
        assert np.abs(got[1]).max() > 100 > np.abs(got[0]).max()


# --------------------------------------------------------------------------
# the mode-0 batch
# --------------------------------------------------------------------------

BATCH_CASES = ['quiet', 'noise', 'noise-truth', 'smearing', 'ref_exact',
               'isub1', 'forced']


def _sims(s, truth: int, **changes):
    jsim = dataclasses.replace(jload_sim(s['paths']['simulation_properties']),
                               max_mc_truth_ids=truth, **changes)
    tsim = dataclasses.replace(tpa.load_port_sim(s['paths']),
                               max_mc_truth_ids=truth, **changes)
    return jsim, tsim


def _batches(s, jl, tl, jsim, tsim, key, i_sub=0, noise=True,
             truth_path='device', jax_path=None):
    ev = s
    want = jmodel.simulate_light_batch(
        ev['js'], s['dm'], jl, jsim, ev['n_ph'], ev['vox'], s['jlut'],
        s['noise'], key, i_subbatch=i_sub, t0_det=ev['t0_det'],
        add_noise=noise, truth_path=jax_path or truth_path)
    got = tmodel.simulate_light_batch(
        ev['ts'], tl, tsim, torch.from_numpy(ev['n_ph']),
        torch.from_numpy(ev['vox']), s['tlut'], s['noise'],
        jax_draw(key, i_sub), i_subbatch=i_sub, add_noise=noise,
        truth_path=truth_path, t0_det=torch.from_numpy(ev['t0_det']),
        module_to_tpcs=s['dm'].module_to_tpcs)
    return want, got


def _same_triggers(got, want):
    for name in ('trigger_idx', 'trigger_type', 'op_channel_idx'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.start_time, got.n_ticks) == (want.start_time, want.n_ticks)


@pytest.mark.parametrize('case', BATCH_CASES)
def test_simulate_light_batch_mode0(setup, case):
    s = setup
    jl, tl = _lights(s, enable_lut_smearing=case == 'smearing',
                     **(dict(light_trig_threshold=1e30) if case == 'forced'
                        else {}))
    jsim, tsim = _sims(s, 4 if case == 'noise-truth' else 0,
                       ref_exact_light_digitize=case == 'ref_exact')
    key = jax.random.PRNGKey(11)
    want, got = _batches(s, jl, tl, jsim, tsim, key,
                         i_sub=1 if case == 'isub1' else 0,
                         noise=case != 'quiet')
    _same_triggers(got, want)
    n_trig = len(want.trigger_idx)
    assert n_trig >= (4 if case == 'forced' else 2), want.trigger_idx
    assert (want.trigger_type == 0).all()
    w = np.asarray(want.waveforms)
    assert w.shape == (n_trig, 12, 256)
    _waveforms_agree(got.waveforms.numpy(), w)
    assert np.abs(w).max() > QUANT
    if case == 'noise-truth':
        _same_records(got.truth_sparse, want.truth_sparse)
        assert len(np.unique(want.truth_sparse['trig'])) > 1
    else:
        assert got.truth_sparse is None and want.truth_sparse is None


# --------------------------------------------------------------------------
# LUT-smearing truth with several triggers
# --------------------------------------------------------------------------

#: the window of the truth-route tests (tests/test_light_truth.py:459-493)
TRUTH_WINDOW = dict(conv_ticks=2048, n_ticks=4096, digit_samples=128,
                    pad_front=64, pad_back=512)
TRIGGERS = np.array([0, 129, 1500])


def _host_args(s, light):
    w = TRUTH_WINDOW
    return (s['tlut'].time_dist_host, np.arange(12), light, 1e-3,
            w['conv_ticks'], w['n_ticks'], w['digit_samples'],
            w['pad_front'], w['pad_back'], 0.0)


def test_host_route_several_triggers(setup):
    """JAX's _host_smeared_truth_sparse(trigger_idx=) against the port's:
    records trigger-major, equal; the records path equal to the dict
    path with trigger ids counted from 0 (tests/test_light_truth.py:
    459-515)."""
    s = setup
    jl, tl = _lights(s, enable_lut_smearing=True)
    sel = [np.asarray(a) for a in jops.light_truth_select(
        s['js'], jnp.asarray(s['vox']), jnp.asarray(s['n_ph']), k_truth=4)]
    want = jmodel._host_smeared_truth_sparse(*sel, *_host_args(s, jl),
                                             trigger_idx=TRIGGERS)
    got = tmodel._host_smeared_truth_sparse(*sel, *_host_args(s, tl),
                                            trigger_idx=TRIGGERS)
    assert set(np.unique(want['trig']).tolist()) == {0, 1, 2}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rec = tmodel._host_smeared_truth_sparse(
        *sel, *_host_args(s, tl), trigger_idx=TRIGGERS, as_records=True,
        event_id=3)
    ref = texport.truth_sparse_to_records(got, 3, 0)
    np.testing.assert_array_equal(rec, ref)
    np.testing.assert_array_equal(ref, jexport.truth_sparse_to_records(
        want, 3, 0))
    with pytest.raises(NotImplementedError):
        tmodel._host_smeared_truth_sparse(*sel, *_host_args(s, tl),
                                          trigger_idx=TRIGGERS, staged=True)


def test_device_route_several_triggers(setup):
    """One product with the triggers' tables side by side against the host
    route (records beyond 1e-3 of the threshold equal, pe_current at rtol
    1e-4 / atol 1e-5)."""
    s = setup
    _, tl = _lights(s, enable_lut_smearing=True)
    w = TRUTH_WINDOW
    n_padded = w['n_ticks'] + w['pad_front'] + w['pad_back']
    with flush_subnormals():
        table = tmodel._trigger_table(
            tl, w['conv_ticks'], w['n_ticks'], w['digit_samples'],
            w['pad_front'], n_padded, TRIGGERS, 'cpu')
        assert table.shape == (w['n_ticks'], 3 * w['digit_samples'])
        ids, tw = tmodel._smeared_truth_stage(
            s['ts'], torch.from_numpy(s['vox']), torch.from_numpy(s['n_ph']),
            torch.arange(12), s['tlut'].time_dist, 0.0, tl, table,
            n_ticks=w['n_ticks'], k_truth=4, ntrig=3)
        assert tw.shape == (3, 12, w['digit_samples'], 4)
        dev = tmodel._pull_dense_truth(ids, tw, np.arange(12), 1e-3)
        sel = [t.numpy() for t in tops.light_truth_select(
            s['ts'], torch.from_numpy(s['vox']), torch.from_numpy(s['n_ph']),
            k_truth=4)]
        host = tmodel._host_smeared_truth_sparse(*sel, *_host_args(s, tl),
                                                 trigger_idx=TRIGGERS)
    assert set(np.unique(dev['trig']).tolist()) == {0, 1, 2}
    assert records_agree(dev, host, 1e-3)['records'] > 100


@pytest.mark.parametrize('route', ['device', 'host'])
def test_batch_smearing_truth(setup, route):
    """The mode-0 batch with the LUT-smearing truth, each route against
    the JAX package's host route (its device route builds its tables from
    a float32 FFT, ~1e-6 of the peak off the host's float64 tables)."""
    s = setup
    jl, tl = _lights(s, enable_lut_smearing=True)
    jsim, tsim = _sims(s, 4, mc_truth_threshold=0.1)
    with flush_subnormals():
        want, got = _batches(s, jl, tl, jsim, tsim, jax.random.PRNGKey(12),
                             truth_path=route, jax_path='host')
    _same_triggers(got, want)
    _waveforms_agree(got.waveforms.numpy(), np.asarray(want.waveforms))
    assert len(np.unique(want.truth_sparse['trig'])) > 1
    if route == 'host':
        for k in want.truth_sparse:
            np.testing.assert_array_equal(got.truth_sparse[k],
                                          want.truth_sparse[k], err_msg=k)
    else:
        assert records_agree(got.truth_sparse, want.truth_sparse,
                             0.1)['records'] > 100


# --------------------------------------------------------------------------
# grouped mode 0
# --------------------------------------------------------------------------

def _group_inputs(s):
    evs = s['events']
    pad = 64
    stack = lambda k: np.stack([e[k] for e in evs])
    return (tseg.from_structured_group([e['drifted'] for e in evs], pad,
                                       device='cpu'),
            stack('n_ph'), stack('vox'), stack('t0_det'))


GROUP_CASES = ['contributor_truth', 'smearing', 'smearing_truth_host',
               'smearing_truth_device']


def _group_case(s, case):
    smear = case.startswith('smearing')
    jl, tl = _lights(s, enable_lut_smearing=smear)
    jsim, tsim = _sims(s, 0 if case == 'smearing' else 4,
                       mc_truth_threshold=0.1)
    route = case.rpartition('_')[2] if case.startswith('smearing_truth') \
        else 'device'
    return jl, tl, jsim, tsim, route


@pytest.mark.parametrize('case', GROUP_CASES)
def test_group_mode0(setup, case):
    """simulate_light_group_mode0 against the port's solo calls (bit for
    bit) and against JAX's simulate_light_group_mode0 with its draws (the
    smearing truth by JAX's host route; the port's device route by
    records_agree)."""
    s = setup
    jl, tl, jsim, tsim, route = _group_case(s, case)
    segs_g, n_ph_g, vox_g, t0_g = _group_inputs(s)
    windows = [tmodel.mode0_window(n, t, tl) for n, t in zip(n_ph_g, t0_g)]
    assert len({w[0] for w in windows}) == 1 and \
        len({w[1] for w in windows}) == 3, windows
    key_mod = jax.random.PRNGKey(31)
    draws = lambda: [jax_draw(jax.random.fold_in(key_mod, ev), 0)
                     for ev in EVENTS]
    with flush_subnormals():
        group = tmodel.simulate_light_group_mode0(
            segs_g, tl, tsim, torch.from_numpy(n_ph_g),
            torch.from_numpy(vox_g), s['tlut'], s['noise'], draws(),
            windows=windows, module_to_tpcs=s['dm'].module_to_tpcs,
            truth_path=route, event_ids=list(EVENTS))
        solos = [tmodel.simulate_light_batch(
            tseg.from_structured(e['drifted'], pad_to=64, device='cpu'),
            tl, tsim, torch.from_numpy(e['n_ph']),
            torch.from_numpy(e['vox']), s['tlut'], s['noise'], d,
            truth_path=route, t0_det=torch.from_numpy(e['t0_det']),
            module_to_tpcs=s['dm'].module_to_tpcs)
            for e, d in zip(s['events'], draws())]
        jsegs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                       *[e['js'] for e in s['events']])
        want = jmodel.simulate_light_group_mode0(
            jsegs, s['dm'], jl, jsim, n_ph_g, vox_g, t0_g, s['jlut'],
            s['noise'], key_mod, np.array(EVENTS),
            np.asarray(jl.tpc_to_op_channel).ravel(), truth_path='host')
    n_records = 0
    for grp, solo, w in zip(group, solos, want):
        _same_triggers(grp, solo)
        _same_triggers(grp, w)
        assert torch.equal(grp.waveforms, solo.waveforms)
        _waveforms_agree(grp.waveforms.numpy(), np.asarray(w.waveforms))
        if case == 'smearing':
            assert grp.truth_sparse is solo.truth_sparse is None
            continue
        if route == 'device' and case != 'contributor_truth':
            n_records += records_agree(grp.truth_sparse, w.truth_sparse,
                                       0.1)['records']
        else:
            _same_records(grp.truth_sparse, w.truth_sparse)
            n_records += len(w.truth_sparse['tick'])
        for k in solo.truth_sparse:
            np.testing.assert_array_equal(grp.truth_sparse[k],
                                          solo.truth_sparse[k], err_msg=k)
    assert sum(len(g.trigger_idx) for g in group) >= 4
    assert case == 'smearing' or n_records > 0


def test_group_mode0_refuses_mixed_buckets(setup):
    s = setup
    segs_g, n_ph_g, vox_g, t0_g = _group_inputs(s)
    with pytest.raises(ValueError, match='bucket'):
        tmodel.simulate_light_group_mode0(
            segs_g, s['tl'], tpa.load_port_sim(s['paths']),
            torch.from_numpy(n_ph_g), torch.from_numpy(vox_g), s['tlut'],
            s['noise'], [None] * 3,
            windows=[(8192, 0.0), (8192, 0.1), (16384, 0.0)],
            module_to_tpcs=s['dm'].module_to_tpcs)
