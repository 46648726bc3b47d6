"""Port parity: FEE self-trigger FSM, current fractions and digitization.

The port's FSM (on CPU its plain version ``fee_fsm_plain``) takes the
draws the JAX scan makes (``k_init, k_scan = split(key)``) and is held
against ``get_adc_values`` (the scan) and ``fee_fsm_pallas`` in interpret
mode, at the shapes of tests/test_fee_pallas.py.

Tolerance: FSM integers exactly equal, floats rtol 1e-5 / atol 1e-2
(tests/test_fee_pallas.py); current fractions rtol 1e-5 / atol 1e-6;
digitized ADC counts equal.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets.response import make_response
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.ops import accumulate as jacc
from larndsim_tpu.ops import current as jcur
from larndsim_tpu.ops import fee as jfee
from larndsim_tpu.ops import pixelize as jpix
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.fee_pallas import fee_fsm_pallas
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import physics
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import fee as tfee

import torch_port_assets as tpa

NAMES = ('integrals', 'ticks', 'n_adc', 'reset_start', 'latch_end')


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def det(tmp_path_factory):
    return tpa.load_jax(tpa.write_tree(tmp_path_factory.mktemp('tree'))).params


def _assert_fsm_equal(want, got, label):
    for name, a, b in zip(NAMES, want, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (label, name)
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=f'{label} {name}')
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-2,
                                       err_msg=f'{label} {name}')


@pytest.mark.parametrize('shape', [
    (600, 500, 10, 520),
    (1100, 300, 5, 512),
    (2048, 700, 3, 777),
    (600, 150, 1, 180),
    (700, 240, 2, 256),
])
def test_fsm_matches_scan_and_pallas(det, shape):
    U, T, max_adc, n_scan = shape
    key = jax.random.PRNGKey(42)
    ksig, kfee = jax.random.split(key)
    sig = jax.random.uniform(ksig, (U, T)) * 30000.0
    sig = jnp.where(
        jax.random.uniform(jax.random.PRNGKey(7), (U, T)) > 0.97, sig, 0.0)
    tick_times = jnp.linspace(0., 190., T + 1).astype(jnp.float32)
    thr = jnp.full((U,), det.discrimination_threshold, jnp.float32)
    kw = dict(max_adc=max_adc, n_scan=n_scan, time_padding=10.0)
    scan = jfee.get_adc_values(sig, tick_times, thr, det, kfee, **kw)
    pallas = fee_fsm_pallas(sig, tick_times, thr, det, kfee,
                            interpret=True, **kw)
    # the draws of the scan (ops/fee.py: k_init, k_scan = split(key))
    k_init, k_scan = jax.random.split(kfee)
    noise = jax.random.normal(k_scan, (n_scan, 5, U))
    q_init = jax.random.normal(k_init, (U,)) * det.reset_noise_charge
    got = tfee.get_adc_values(
        _t(sig), _t(tick_times), _t(thr), tpa.port_params(det),
        noise=_t(noise), q_init=_t(q_init), **kw)
    assert int(np.asarray(scan.n_adc).sum()) > 0, 'fixture drew no hits'
    if max_adc > 1:
        assert int(np.asarray(scan.n_adc).max()) >= 2
    _assert_fsm_equal(scan, got, 'scan')
    _assert_fsm_equal(pallas, got, 'pallas')


def test_fsm_wrapper_has_no_fallback(det):
    before = binding.launches['fee_fsm']
    s = tfee.fsm_scalars(tpa.port_params(det), max_adc=2)
    meta = lambda *shape: torch.empty(shape, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        tfee.fee_fsm(meta(8, 4), meta(8, 5, 4), meta(4), meta(4), meta(9), s)
    assert binding.launches['fee_fsm'] == before


@pytest.fixture(scope='module')
def chain(det):
    """A small charge chain run by the JAX package up to the FSM."""
    tracks = tpa.detector_tracks(np.asarray(det.tpc_borders), seed=21,
                                 tracks_per_event=4)
    segs = jdrift(jquench(jseg.from_structured(tracks, pad_to=32), det,
                          physics.BIRKS), det)
    pixels, dists, _ = jpix.get_pixels(segs, det, max_active=8, radius=1,
                                       max_neighboring=64)
    cap, max_tracks, max_adc = 256, 8, 6
    uniq, _ = jacc.unique_pixels(pixels, cap)
    pix_idx = jacc.pixel_index_map(pixels, uniq)
    _, slot, _ = jacc.track_pixel_map(pix_idx, dists, cap,
                                      max_tracks=max_tracks)
    px, py = jcharge.pixel_centers(jnp.maximum(pixels, 0), det)
    n_t = int(round(float(det.time_window) / float(det.response_sampling)))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=float(det.response_bin_size),
                             pixel_pitch=float(det.pixel_pitch))
    signals = jcur.current(segs, px, py, pixels >= 0, jnp.asarray(response),
                           det, jax.random.PRNGKey(0), n_steps=256,
                           t_sig=512, mc_smear=True)
    track_starts, _ = jpix.time_intervals(segs, det)
    wave = jacc.sum_pixel_signals(signals, pix_idx, track_starts, cap,
                                  n_ticks=det.time_ticks,
                                  time_sampling=det.time_sampling)
    tick_times = jnp.linspace(0, det.time_interval[1], det.time_ticks + 1)
    thr = jnp.full((cap,), det.discrimination_threshold)
    fee_res = jfee.get_adc_values(
        wave, tick_times, thr, det, jax.random.PRNGKey(5), max_adc=max_adc,
        n_scan=det.time_ticks + det.integrate_ticks + det.busy_ticks + 4)
    assert int(np.asarray(fee_res.n_adc).sum()) > 0
    return dict(signals=signals, pix_idx=pix_idx, slot=slot,
                track_starts=track_starts, fee=fee_res, max_adc=max_adc,
                max_tracks=max_tracks, tick_times=tick_times)


def test_tick_times(det, chain):
    np.testing.assert_array_equal(
        tfee.tick_times(tpa.port_params(det)).numpy(),
        np.asarray(chain['tick_times']))


def test_current_fractions(det, chain):
    c = chain
    want = np.asarray(jfee.current_fractions(
        c['signals'], c['pix_idx'], c['slot'], c['track_starts'], c['fee'],
        det, max_adc=c['max_adc'], max_tracks=c['max_tracks']))
    fee_t = tfee.FeeResult(*(_t(a) for a in c['fee']))
    got = tfee.current_fractions(
        _t(c['signals']), _t(c['pix_idx']), _t(c['slot']),
        _t(c['track_starts']), fee_t, tpa.port_params(det),
        max_adc=c['max_adc'], max_tracks=c['max_tracks'],
        n_adc_scan=int(np.asarray(c['fee'].n_adc).max())).numpy()
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_digitize(det, chain):
    integrals = chain['fee'].integrals
    tdet = tpa.port_params(det)
    np.testing.assert_array_equal(
        tfee.digitize(_t(integrals), tdet).numpy(),
        np.asarray(jfee.digitize(integrals, det)))
    gains = jnp.linspace(3e-3, 5e-3, integrals.shape[0],
                         dtype=jnp.float32)[:, None]
    np.testing.assert_array_equal(
        tfee.digitize(_t(integrals), tdet, gain=_t(gains)).numpy(),
        np.asarray(jfee.digitize(integrals, det, gain=gains)))
