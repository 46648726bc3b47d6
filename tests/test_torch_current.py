"""Port parity: induced current (the CUDA kernel's plain version on CPU).

The port's ``ops.current.current`` is held against the JAX XLA op
(``current.current``) and the Pallas kernel run in interpret mode
(``current_pallas(..., interpret=True)``), without and with the diffusion
smear, at response/readout sampling ratios 1 and 2.  Both sides take the
same smear draws and the same shift band.

Tolerance: atol 2e-5 x peak (tests/test_current_pallas.py: accumulation
order plus the k-rounding edge sliver); charge closure rel 0.05.
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
from larndsim_tpu.ops import current as jcur
from larndsim_tpu.ops import current_pallas as jpal
from larndsim_tpu.ops import pixelize as jpix
from larndsim_tpu.ops.drift import drift as jdrift
from larndsim_tpu.ops.quench import quench as jquench
from larndsim_tpu.params import physics
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.ops import current as tcur

import torch_port_assets as tpa


@pytest.fixture(scope='module', params=[1, 2], ids=['ratio1', 'ratio2'])
def setup(request, tmp_path_factory):
    ratio = request.param
    det = tpa.load_jax(tpa.write_tree(tmp_path_factory.mktemp('tree'))).params
    resp_dt = 0.1 / ratio
    n_t = 256 * ratio  # a short response keeps the test fast
    w = n_t * resp_dt
    det = det.replace(response_sampling=jnp.float32(resp_dt),
                      time_window=jnp.float32(w),
                      time_padding=jnp.float32(w + 1.0))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=float(det.response_bin_size),
                             sampling=resp_dt,
                             pixel_pitch=float(det.pixel_pitch))
    tracks = tpa.detector_tracks(np.asarray(det.tpc_borders), seed=9,
                                 tracks_per_event=2, segments_per_track=4)
    # drift of ~0.1-2 cm so that the short response covers collection
    rng = np.random.default_rng(9)
    borders = np.asarray(det.tpc_borders)
    plane = np.where(tracks['z'] > 0, 0, 1)
    z_anode = borders[plane, 2, 0]
    sign = np.sign(borders[plane, 2, 1] - z_anode)
    n = len(tracks)
    tracks['z_start'] = z_anode + sign * rng.uniform(0.1, 2.0, n)
    tracks['z_end'] = z_anode + sign * rng.uniform(0.1, 2.0, n)
    tracks['z'] = 0.5 * (tracks['z_start'] + tracks['z_end'])
    segs = jdrift(jquench(jseg.from_structured(tracks, pad_to=8), det,
                          physics.BOX), det)
    # the shapes of tests/test_current_pallas.py
    pixels, _, _ = jpix.get_pixels(segs, det, max_active=32, radius=1,
                                   max_neighboring=128)
    px, py = jcharge.pixel_centers(jnp.maximum(pixels, 0), det)
    valid = np.asarray(segs.valid)
    band = jpal.host_shift_band(
        {k: np.asarray(getattr(segs, k))[valid] for k in
         ('z_start', 'z_end', 'pixel_plane', 'long_diff', 't_start',
          't0_start')}, det, mc_smear=True)
    return det, segs, response, px, py, pixels >= 0, band


def _port(setup, smear, n_steps, t_sig):
    det, segs, response, px, py, pv, band = setup
    t = lambda a: torch.from_numpy(np.array(a))
    return tcur.current(
        tpa.port_segments(segs), t(px), t(py), t(pv), t(response),
        tpa.port_params(det), None if smear is None else t(smear),
        n_steps=n_steps, t_sig=t_sig, shift_band=band).numpy()


@pytest.mark.parametrize('mc_smear', [False, True], ids=['midpoints', 'smear'])
def test_matches_jax(setup, mc_smear):
    det, segs, response, px, py, pv, band = setup
    n_steps, t_sig = 64, 1024
    key = jax.random.PRNGKey(3)
    smear = (np.asarray(jax.random.normal(key, (3, segs.size, n_steps)))
             if mc_smear else None)
    got = _port(setup, smear, n_steps, t_sig)
    xla = np.asarray(jcur.current(segs, px, py, pv, jnp.asarray(response),
                                  det, key, n_steps=n_steps, t_sig=t_sig,
                                  mc_smear=mc_smear))
    pallas = np.asarray(jpal.current_pallas(
        segs, px, py, pv, response, det, key, n_steps=n_steps, t_sig=t_sig,
        mc_smear=mc_smear, s_blk=4, t_blk=256, interpret=True,
        shift_band=band))
    peak = np.abs(xla).max()
    assert peak > 0, 'test must exercise nonzero current'
    for name, want in (('xla', xla), ('pallas', pallas)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got / peak, want / peak, rtol=0,
                                   atol=2e-5, err_msg=name)


def test_charge_closure(setup):
    det, segs, *_ = setup
    n_steps = 128
    smear = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                         (3, segs.size, n_steps)))
    out = _port(setup, smear, n_steps, 2048)
    total = float(out.sum()) * float(det.time_sampling)
    expected = float(np.asarray(segs.n_electrons).sum())
    assert total == pytest.approx(expected, rel=0.05)


def test_phase_split_response():
    rng = np.random.default_rng(0)
    resp = rng.normal(size=(3, 4, 11)).astype(np.float32)
    for ratio in (1, 2, 3):
        np.testing.assert_array_equal(
            tcur.phase_split_response(torch.from_numpy(resp), ratio).numpy(),
            jpal.phase_split_response(resp, ratio))


def test_kernel_wrapper_has_no_fallback():
    """A tensor on neither the CPU nor a card is refused, not computed."""
    before = binding.launches['induced_current']
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device='meta')
    i32 = torch.int32
    lut = tcur.LutGeometry(0.04434, 2, 2, 1)
    with pytest.raises(ValueError, match='CUDA'):
        tcur.induced_current(
            meta(1, 4), meta(1, 4), meta(1, 4, dtype=i32),
            meta(1, 4, dtype=i32), meta(1, 2), meta(1, 2),
            meta(1, dtype=i32), meta(1, dtype=i32), meta(1, dtype=i32),
            meta(1, 8), meta(5, 8), lut)
    assert binding.launches['induced_current'] == before
