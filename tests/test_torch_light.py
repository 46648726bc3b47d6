"""Port parity: the light chain's params, ops and beam-mode batch.

Both sides get the same inputs: JAX's quenched and drifted segments, the
same synthetic light LUT and noise spectra, and the same random draws
(``LightDraw`` fed from JAX's key tree: ``k_poisson, k_noise =
split(fold_in(key, i_subbatch))``, ``k1, k2 = split(k_poisson)``, then
``poisson(k1, rate)``, ``normal(k2, shape)``, ``uniform(k_noise, shape)``).

Tolerances (no looser than the JAX package's own): params equal;
incidence voxels equal, photons and t0 at rtol 2e-6 / atol 1e-5
(tests/test_golden_parity.py:757); photon series at atol 3e-6 of the
scale (:837); kernels at rtol 1e-6; convolutions at rtol 2e-4, atol 1e-5 x
peak (tests/test_truth_staging.py:266-269); statistics on the same input
equal except <= 1e-4 of ticks one count apart (XLA may contract the
Gaussian branch's multiply-add); noise equal except <= 1e-3 of samples one
quantum apart; truth records (trigger, channel, tick, segment) equal with
pe_current at rtol 1e-4 / atol 1e-6 (tests/test_light_truth.py:179);
digitized waveforms within one quantum (64 ADC) with >= 99.9% equal.
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
from larndsim_tpu.models import light as jmodel
from larndsim_tpu.ops import light as jops
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu.params import physics
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.models import light as tmodel
from larndsim_tpu_torch.ops import light as tops
from larndsim_tpu_torch.params import light as tparams

import torch_port_assets as tpa

#: 12 channels (6 per TPC), a 2 us beam window: 2048 ticks, FFTs of 4096
LIGHT = dict(n_op_channel=12, light_window=(0.0, 2.0))
QUANT = 64.0


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    paths = tpa.write_tree(tmp_path_factory.mktemp('light'), light=LIGHT)
    dm = tpa.load_jax(paths)
    jl = jload_light(paths['detector_properties'])
    tl = tpa.port_light(jl)
    lut_arr = make_light_lut((14, 26, 8), n_det_tpc=6, n_prof=100)
    jlut = jops.LightLUT.from_structured(lut_arr)
    tlut = tops.LightLUT.from_structured(lut_arr, 'cpu')
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=5, tracks_per_event=5)
    rng = np.random.default_rng(6)
    tracks['t0'] = rng.uniform(0.02, 1.6, len(tracks))
    js = jdrift(jquench(jseg.from_structured(tracks, pad_to=64), dm.params,
                        physics.BIRKS), dm.params)
    ts = tpa.port_segments(js)
    n_ph, t0_det, vox = jops.calculate_light_incidence(
        js, dm.params, jl, jlut.vis, jlut.t0, n_channels=jl.n_op_channel)
    return dict(paths=paths, dm=dm, det=tpa.port_params(dm.params), jl=jl,
                tl=tl, jlut=jlut, tlut=tlut, js=js, ts=ts,
                n_ph=np.asarray(n_ph), t0_det=np.asarray(t0_det),
                vox=np.asarray(vox), noise=make_light_noise(12))


def jax_draw(key, i_subbatch: int = 0) -> tops.LightDraw:
    """The port's draws, taken from the JAX package's key tree."""
    k_poisson, k_noise = jax.random.split(jax.random.fold_in(key, i_subbatch))
    k1, k2 = jax.random.split(k_poisson)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt)
    return tops.LightDraw(
        poisson=lambda rate: t(jax.random.poisson(
            k1, jnp.asarray(rate.numpy()))),
        normal=lambda shape: t(jax.random.normal(k2, shape)),
        uniform=lambda shape: t(jax.random.uniform(k_noise, shape)))


def smearing(s, on: bool):
    return (dataclasses.replace(s['jl'], enable_lut_smearing=on),
            s['tl'].replace(enable_lut_smearing=on))


def _close_to_scale(got, want, atol):
    scale = np.abs(want).max()
    assert scale > 0, 'test must produce a nonzero series'
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _one_count_apart(got, want, frac: float, unit: float):
    """Equal, except at most ``frac`` of entries one ``unit`` apart."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= unit * 1.0001, d.max()
    assert (d > 0).mean() <= frac, (d > 0).mean()


# --------------------------------------------------------------------------
# params, host assets
# --------------------------------------------------------------------------

@pytest.mark.parametrize('keys', ['light', 'no_light'])
def test_light_params_equal(tmp_path, keys):
    paths = tpa.write_tree(tmp_path, light=LIGHT if keys == 'light' else False)
    jl = jload_light(paths['detector_properties'])
    tl = tparams.load_light(paths['detector_properties'], device='cpu')
    for name, dt in tparams.LEAVES.items():
        got = getattr(tl, name)
        assert got.dtype == dt, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jl, name)),
                                      err_msg=name)
    for name in tparams.STATICS:
        assert getattr(tl, name) == getattr(jl, name), name
    assert tl.light_simulated == (keys == 'light')
    if keys == 'light':
        carried = tpa.port_light(jl)
        for name in tparams.LEAVES:
            assert torch.equal(getattr(carried, name), getattr(tl, name)), name
        for name in tparams.HOST_SCALARS:
            assert tl.host[name] == float(jmodel.light_params.host_scalars(
                jl)[name])
            assert carried.host[name] == float(np.asarray(getattr(jl, name)))
        assert (tl.n_op_channel, tl.light_trig_mode, tl.light_window) == \
            (12, 1, (0.0, 2.0))


def test_light_defaults_to_the_card(monkeypatch, setup):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tparams.load_light(setup['paths']['detector_properties'])
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tops.LightLUT.from_structured(make_light_lut((2, 2, 2), 2, n_prof=4))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tseg.from_structured(np.zeros(2, tpa.detector_tracks(
            setup['dm'].tpc_borders).dtype))


# --------------------------------------------------------------------------
# ops
# --------------------------------------------------------------------------

def test_incidence(setup):
    s = setup
    n_ph, t0_det, vox = tops.calculate_light_incidence(
        s['ts'], s['det'], s['tl'], s['tlut'].vis, s['tlut'].t0,
        n_channels=s['tl'].n_op_channel)
    np.testing.assert_array_equal(vox.numpy(), s['vox'])
    assert s['n_ph'].max() > 0 and (s['n_ph'] > 0).sum() > 20
    np.testing.assert_allclose(n_ph.numpy(), s['n_ph'], rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(t0_det.numpy(), s['t0_det'], rtol=2e-6,
                               atol=1e-5)
    assert n_ph.dtype == t0_det.dtype == torch.float32


@pytest.mark.parametrize('smear', [False, True], ids=['t0_avg', 'smearing'])
def test_sum_light_signals(setup, smear):
    s = setup
    jl, tl = smearing(s, smear)
    op = np.arange(12)
    want = np.asarray(jops.sum_light_signals(
        s['js'], jnp.asarray(s['vox']), jnp.asarray(s['n_ph']),
        jnp.asarray(op), s['jlut'].time_dist, s['jlut'].t0_avg,
        jnp.float32(0.0), jl, n_ticks=2048, lut_smearing=smear))
    got = tops.sum_light_signals(
        s['ts'], torch.from_numpy(s['vox']), torch.from_numpy(s['n_ph']),
        torch.from_numpy(op), s['tlut'].time_dist, s['tlut'].t0_avg, 0.0,
        tl, n_ticks=2048, lut_smearing=smear)
    assert got.shape == (12, 2048) and got.dtype == torch.float32
    _close_to_scale(got.numpy(), want, 3e-6)


def test_ordered_sum_adds_in_index_order():
    """Sums in ascending row order, keys past n_out dropped."""
    keys = torch.tensor([2, 0, 2, 5, 0, 2])
    vals = torch.tensor([[1e8], [1.0], [-1e8], [7.0], [2.0], [1.0]])
    out = tops.ordered_sum(keys, vals, 4)
    assert out[:, 0].tolist() == [3.0, 0.0, 1.0, 0.0]


def _sipm1(light):
    imp = np.sin(np.linspace(0.0, 3.0, 40)) * np.exp(-np.linspace(0, 4, 40))
    if isinstance(light, tparams.LightParams):
        # host values as the JAX package reads them for a replaced
        # LightParams: the float32 leaves
        host = {k: float(np.float32(light.host[k]))
                for k in tparams.HOST_SCALARS}
        host['impulse_model'] = imp.astype(np.float32).astype(np.float64)
        return light.replace(sipm_response_model=1, impulse_tick_size=0.0025,
                             impulse_model=torch.tensor(imp,
                                                        dtype=torch.float32),
                             host=host)
    return dataclasses.replace(light, sipm_response_model=1,
                               impulse_tick_size=0.0025,
                               impulse_model=jnp.asarray(imp, jnp.float32))


@pytest.mark.parametrize('kernel', ['scintillation', 'sipm0', 'sipm1'])
def test_kernels(setup, kernel):
    jl, tl = setup['jl'], setup['tl']
    if kernel == 'sipm1':
        jl, tl = _sipm1(jl), _sipm1(tl)
    else:   # the loader's float64 host values on both sides
        tl = tparams.load_light(setup['paths']['detector_properties'],
                                device='cpu')
    name = 'scintillation_kernel' if kernel == 'scintillation' \
        else 'sipm_kernel'
    # as the chain calls it: inside a jitted function
    want = np.asarray(jax.jit(lambda p: getattr(jops, name)(p, 2000))(jl))
    got = getattr(tops, name)(tl, 2000).numpy()
    assert got.shape == (2001,) and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # the float64 host kernels of the truth path: the same numpy
    for k in (600, 2000):
        np.testing.assert_array_equal(tmodel._combined_kernel_host(tl, k),
                                      jmodel._combined_kernel_host(jl, k))


@pytest.mark.parametrize('stage', ['scintillation', 'sipm'])
def test_convolutions(setup, stage):
    jl, tl = setup['jl'], setup['tl']
    rng = np.random.default_rng(7)
    sig = np.zeros((12, 2048), np.float32)
    sig[:, 100:900] = rng.exponential(2e3, (12, 800))
    gains = np.asarray(jl.light_gain)
    if stage == 'scintillation':
        want = np.asarray(jops.calc_scintillation_effect(
            jnp.asarray(sig), jl, conv_ticks=2000))
        got = tops.calc_scintillation_effect(torch.from_numpy(sig), tl,
                                             conv_ticks=2000).numpy()
    else:
        want = np.asarray(jops.calc_light_detector_response(
            jnp.asarray(sig), jnp.asarray(gains), jl, conv_ticks=2000))
        got = tops.calc_light_detector_response(
            torch.from_numpy(sig), torch.from_numpy(gains), tl,
            conv_ticks=2000).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=1e-5 * np.abs(want).max())


def test_stat_fluctuations(setup):
    jl, tl = setup['jl'], setup['tl']
    rng = np.random.default_rng(8)
    # rates from 0 to 60 PE per tick: both the Poisson and Gaussian branch
    inc = rng.uniform(0.0, 6e4, (12, 2048)).astype(np.float32)
    inc[:, ::5] = 0.0
    key = jax.random.PRNGKey(3)
    draw = jax_draw(key, 0)
    k_poisson, _ = jax.random.split(jax.random.fold_in(key, 0))
    want = np.asarray(jops.calc_stat_fluctuations(jnp.asarray(inc),
                                                  k_poisson, jl))
    got = tops.calc_stat_fluctuations(torch.from_numpy(inc), draw, tl).numpy()
    mean = inc * np.float32(1e-3)
    assert (mean >= 30).mean() > 0.3
    assert ((mean > 0) & (mean < 30)).mean() > 0.3
    # counts: got and want are (count / tick)
    _one_count_apart(got * 1e-3, want * 1e-3, 1e-4, 1.0)


@pytest.mark.parametrize('n', [2948, 2949, 1], ids=['even', 'odd', 'one'])
def test_noise(setup, n):
    jl, tl = setup['jl'], setup['tl']
    # spectra large enough that the noise spans several quanta
    rows = (setup['noise'] * 40.0).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_noise = jax.random.split(jax.random.fold_in(key, 0))[1]
    # as the chain calls it: inside a jitted function
    want = np.asarray(jax.jit(lambda r, k, p: jops.gen_light_detector_noise(
        (12, n), r, k, p))(jnp.asarray(rows), k_noise, jl))
    got = tops.gen_light_detector_noise(
        (12, n), torch.from_numpy(rows), jax_draw(key, 0), tl).numpy()
    assert got.shape == want.shape == (12, n)
    if n == 1:   # no bin spacing: both sides give NaN
        np.testing.assert_array_equal(got, want)
        return
    assert np.abs(want).max() >= QUANT
    _one_count_apart(got, want, 1e-3, QUANT)


@pytest.mark.parametrize('ref_exact', [False, True])
def test_digitize(setup, ref_exact):
    jl, tl = setup['jl'], setup['tl']
    rng = np.random.default_rng(9)
    sig = (rng.standard_normal((12, 2948)) * 3000.0).astype(np.float32)
    trig = np.array([900, 1500, 2800])
    kw = dict(digit_samples=256, ref_exact=ref_exact)
    want = np.asarray(jops.digitize_signal(
        jnp.asarray(sig), jnp.asarray(trig), jl, **kw))
    got = tops.digitize_signal(torch.from_numpy(sig), torch.from_numpy(trig),
                               tl, **kw).numpy()
    assert got.shape == want.shape == (3, 12, 256)
    _one_count_apart(got, want, 1e-3, QUANT)
    # the last trigger runs past the signal's end: zeros there
    assert not ref_exact or (got[0] == got[2]).all()


def test_truth_points_and_records(setup):
    s = setup
    jl, tl = s['jl'], s['tl']
    op = np.arange(12)
    want = jops.light_truth_points(
        s['js'], jnp.asarray(s['vox']), jnp.asarray(s['n_ph']),
        jnp.asarray(op), s['jlut'].t0_avg, jnp.float32(0.0), jl, k_truth=5)
    got = tops.light_truth_points(
        s['ts'], torch.from_numpy(s['vox']), torch.from_numpy(s['n_ph']),
        torch.from_numpy(op), s['tlut'].t0_avg, 0.0, tl, k_truth=5)
    ids_w, amp_w, it_w = (np.asarray(a) for a in want)
    ids_g, amp_g, it_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(ids_g, ids_w)
    np.testing.assert_array_equal(it_g, it_w)
    np.testing.assert_allclose(amp_g, amp_w, rtol=1e-6)
    assert (ids_w >= 0).sum() > 12
    kernel = jmodel._combined_kernel_host(jl, 2000)
    rec_w = jmodel._host_truth_sparse(ids_w, amp_w, it_w, kernel,
                                      np.zeros(1, int), jl, 256, op, 0.1)
    rec_g = tmodel._host_truth_sparse(ids_g, amp_g, it_g,
                                      tmodel._combined_kernel_host(tl, 2000),
                                      np.zeros(1, int), tl, 256, op, 0.1)
    _same_records(rec_g, rec_w)


def _same_records(got: dict, want: dict):
    assert len(want['tick']) > 0, 'test must produce truth records'
    for k in ('trig', 'op_channel', 'tick', 'segment_id'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['pe_current'], want['pe_current'],
                               rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# the beam-mode batch
# --------------------------------------------------------------------------

def _waveforms_agree(got, want):
    """Within one quantum, >= 99.9% of samples equal."""
    assert got.shape == want.shape
    if not want.size:
        return
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= QUANT, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


CASES = [(i_sub, noise, smear, truth)
         for i_sub in (0, 1) for noise in (False, True)
         for smear in (False, True) for truth in (False, True)
         if not (smear and truth)]


@pytest.mark.parametrize('i_sub,noise,smear,truth', CASES, ids=[
    f'isub{c[0]}-{"noise" if c[1] else "quiet"}-'
    f'{"smear" if c[2] else "t0avg"}-{"truth" if c[3] else "notruth"}'
    for c in CASES])
def test_simulate_light_batch(setup, i_sub, noise, smear, truth):
    s = setup
    jl, tl = smearing(s, smear)
    js_sim = dataclasses.replace(
        jload_sim(s['paths']['simulation_properties']),
        max_mc_truth_ids=4 if truth else 0)
    key = jax.random.PRNGKey(11)
    want = jmodel.simulate_light_batch(
        s['js'], s['dm'], jl, js_sim, s['n_ph'], s['vox'], s['jlut'],
        s['noise'], key, i_subbatch=i_sub, add_noise=noise)
    ts_sim = dataclasses.replace(
        tpa.load_port_sim(s['paths']), max_mc_truth_ids=4 if truth else 0)
    got = tmodel.simulate_light_batch(
        s['ts'], tl, ts_sim, torch.from_numpy(s['n_ph']),
        torch.from_numpy(s['vox']), s['tlut'], s['noise'],
        jax_draw(key, i_sub), i_subbatch=i_sub, add_noise=noise)
    for name in ('trigger_idx', 'trigger_type', 'op_channel_idx'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert (got.start_time, got.n_ticks) == (want.start_time, want.n_ticks)
    w = np.asarray(want.waveforms)
    assert w.shape == (1 - i_sub, 12, 256)
    _waveforms_agree(got.waveforms.numpy(), w)
    if i_sub == 0:
        assert np.abs(w).max() > QUANT, 'test must produce a waveform'
    if truth and i_sub == 0:
        _same_records(got.truth_sparse, want.truth_sparse)
    else:
        assert got.truth_sparse is None and want.truth_sparse is None


@pytest.mark.parametrize('what', ['mode0', 'smearing_truth'])
def test_refuses_what_it_does_not_run(setup, what):
    """Mode 0 runs on the tiny tree (tests/test_torch_mode0.py holds it to
    JAX), given the arrivals that size its window and the module map; a
    mode-0 call without the arrivals, and a trigger mode the reference
    does not have, are refused.  The truth with LUT smearing runs by its
    two routes (tests/test_torch_light_truth.py), and another route is
    refused."""
    s = setup
    sim = tpa.load_port_sim(s['paths'])
    tl = s['tl']
    if what == 'mode0':
        tl = tl.replace(light_trig_mode=0)
        args = (s['ts'], tl, sim, torch.from_numpy(s['n_ph']),
                torch.from_numpy(s['vox']), s['tlut'], s['noise'],
                jax_draw(jax.random.PRNGKey(0)))
        res = tmodel.simulate_light_batch(
            *args, t0_det=torch.from_numpy(s['t0_det']),
            module_to_tpcs=s['dm'].module_to_tpcs)
        assert len(res.trigger_idx) > 0 and (res.trigger_type == 0).all()
        assert res.waveforms.shape == (len(res.trigger_idx), 12, 256)
        with pytest.raises(ValueError, match='t0_det'):
            tmodel.simulate_light_batch(*args)
        with pytest.raises(NotImplementedError):
            tmodel.simulate_light_batch(
                *args[:1], tl.replace(light_trig_mode=2), *args[2:])
        return
    else:
        tl = tl.replace(enable_lut_smearing=True)
        sim = dataclasses.replace(sim, max_mc_truth_ids=3)
        error, kw = ValueError, dict(truth_path='tunnel')
    with pytest.raises(error):
        tmodel.simulate_light_batch(
            s['ts'], tl, sim, torch.from_numpy(s['n_ph']),
            torch.from_numpy(s['vox']), s['tlut'], s['noise'],
            jax_draw(jax.random.PRNGKey(0)), **kw)
