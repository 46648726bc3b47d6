"""Port parity: the whole charge chain, ``simulate_charge_batch``.

The JAX chain runs with its production backend (the Pallas induced-current
kernel, in interpret mode on CPU); the port takes the JAX draws
(``k_cur, k_fee = split(key)``, then ``k_init, k_scan = split(k_fee)``).

Tolerance: ``unique_pix``, ``n_adc``, ``track_pixel_map``, ``hit_row``,
``hit_slot`` and ``hit_ticks`` equal; ``hit_adc`` equal for >= 99% of hits
and within +-1 for all (the current sums add in different orders).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets.response import make_response
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu.utils.pixel_lut import PixelLUT as JLUT
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.models import charge as tcharge
from larndsim_tpu_torch.params import load_sim as tload_sim
from larndsim_tpu_torch.utils.pixel_lut import PixelLUT as TLUT

import torch_port_assets as tpa


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return tpa.write_tree(tmp_path_factory.mktemp('tree'))


def jax_draw(key):
    """The port's draw source, giving the draws the JAX chain makes."""
    k_cur, k_fee = jax.random.split(key)
    k_init, k_scan = jax.random.split(k_fee)
    keys = dict(smear=k_cur, fee_noise=k_scan, q_init=k_init)
    return lambda name, shape: torch.from_numpy(
        np.array(jax.random.normal(keys[name], shape)))


@pytest.mark.parametrize('seed,step_scale,with_luts', [
    (13, 1.0, False), (31, 2.0, True)])
def test_simulate_charge_batch(tree, seed, step_scale, with_luts):
    jm, tm = tpa.load_jax(tree), tpa.load_port(tree)
    det = jm.params
    js_sim = jload_sim(tree['simulation_properties'])
    ts_sim = tload_sim(tree['simulation_properties'])
    tracks = tpa.detector_tracks(jm.tpc_borders, seed=seed,
                                 tracks_per_event=4)
    n_t = int(round(float(det.time_window) / float(det.response_sampling)))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=float(det.response_bin_size),
                             pixel_pitch=float(det.pixel_pitch))
    luts = {}
    if with_luts:
        nx, ny = det.n_pixels
        keys = np.arange(0, nx * ny * det.n_tpcs, 3)
        rng = np.random.default_rng(seed)
        thr = rng.uniform(5e3, 9e3, len(keys)).astype(np.float32)
        gain = rng.uniform(3.5e-3, 4.5e-3, len(keys)).astype(np.float32)
        luts = dict(
            j=dict(pixel_thresholds=JLUT(keys, thr, 7e3),
                   pixel_gains=JLUT(keys, gain, 4e-3)),
            t=dict(pixel_thresholds=TLUT(keys, thr, 7e3),
                   pixel_gains=TLUT(keys, gain, 4e-3)))
    key = jax.random.PRNGKey(seed)
    want = jcharge.simulate_charge_batch(
        jseg.from_structured(tracks, pad_to=32), jm, js_sim, key,
        jax.numpy.asarray(response), step_scale=step_scale,
        backend='pallas', **luts.get('j', {}))
    got = tcharge.simulate_charge_batch(
        tseg.from_structured(tracks, pad_to=32, device='cpu'), tm, ts_sim, jax_draw(key),
        torch.from_numpy(response), step_scale=step_scale,
        **luts.get('t', {}))

    assert want.n_unique == got.n_unique > 0
    for name in ('unique_pix', 'n_adc', 'track_pixel_map', 'hit_row',
                 'hit_slot', 'hit_ticks'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.overflow == want.overflow
    n_hits = len(want.hit_adc)
    assert n_hits > 0, 'test must produce hits'
    diff = np.abs(got.hit_adc.astype(np.int64)
                  - want.hit_adc.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99
    np.testing.assert_allclose(got.hit_integrals, want.hit_integrals,
                               rtol=1e-4, atol=1.0)
