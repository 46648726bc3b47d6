"""Port parity: the light MC truth with LUT smearing, both routes.

The inputs are tests/test_torch_light.py's (12 channels, a 2 us beam
window: 2048 ticks, 256 ADC samples, a synthetic LUT of 100 profile bins),
made from seeds with numpy; both packages get the same segments, photons
and voxels.  The JAX package runs on the CPU; its light truth has no Pallas
kernel.

Tolerances: the contributor selection equal; the truth series bit-equal
with subnormals flushed to zero, as XLA's CPU backend computes (the LUT's
profile tails hold subnormal floats, which PyTorch's CPU ops keep); the
host transfer table equal, its product with a series within rtol 1e-4 /
atol 1e-6 of the peak of the product with the JAX package's device-built
table (its kernel in float32, the port's in float64); the host route's
records equal to the JAX host route's (the same numpy); the device route's
and every route-against-route comparison by
``tools.light_check.records_agree``: records whose |pe| lies more than 1e-3
from the threshold equal in (trigger, channel, tick, segment), pe_current
at rtol 1e-4 / atol 1e-5 (tests/test_end_to_end.py:262-273); waveforms as
in tests/test_torch_light.py.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larndsim_tpu.io import export as jexport
from larndsim_tpu.models import light as jmodel
from larndsim_tpu.ops import light as jops
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu_torch.io import export as texport
from larndsim_tpu_torch.models import light as tmodel
from larndsim_tpu_torch.ops import light as tops
from larndsim_tpu_torch.tools.light_check import records_agree

import torch_port_assets as tpa
from test_torch_light import (_waveforms_agree, jax_draw, setup,  # noqa: F401
                              smearing)

#: the batch's window: 2048 ticks, 256 samples, 900 pre-trigger ticks
N_TICKS, CONV_TICKS, SAMPLES, PAD_FRONT, PAD_BACK = 2048, 2000, 256, 900, 0
THRESHOLD = 0.1
OP = np.arange(12)


@contextlib.contextmanager
def flush_subnormals():
    """PyTorch's CPU ops flush subnormal floats to zero, as XLA's do."""
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _inputs(s):
    """The batch's segments, voxels and photons for each package."""
    return ((s['js'], jnp.asarray(s['vox']), jnp.asarray(s['n_ph'])),
            (s['ts'], torch.from_numpy(s['vox']),
             torch.from_numpy(s['n_ph'])))


def _jax_select(s, k):
    return jops.light_truth_select(*_inputs(s)[0], k_truth=k)


def _host_args(s, light, lut_host):
    return (lut_host, OP, light, THRESHOLD, CONV_TICKS, N_TICKS, SAMPLES,
            PAD_FRONT, PAD_BACK, 0.0)


def test_ordered_sum_with_far_more_keys_than_rows():
    """``ordered_sum`` where the keys far outnumber the rows (the truth
    series; tests/test_torch_light.py holds the other regime): rows in
    ascending order, keys past n_out dropped."""
    n_out = 1 << 20
    keys = torch.tensor([2, 0, 2, n_out + 1, 0, 2, 3])
    vals = torch.tensor([[1e8], [1.0], [-1e8], [7.0], [2.0], [1.0], [5.0]])
    out = tops.ordered_sum(keys, vals, n_out)
    assert out.shape == (n_out, 1)
    assert out[:4, 0].tolist() == [3.0, 0.0, 1.0, 5.0]
    assert int((out != 0).sum()) == 3
    empty = tops.ordered_sum(keys[:0], vals[:0], n_out)
    assert empty.shape == (n_out, 1) and not empty.any()


@pytest.mark.parametrize('k', [5, 100], ids=['k5', 'k_past_S'])
def test_truth_select(setup, k):
    want = [np.asarray(a) for a in _jax_select(setup, k)]
    got = tops.light_truth_select(*_inputs(setup)[1], k_truth=k)
    assert want[0].shape == (12, min(k, setup['ts'].size))
    assert (want[0] >= 0).sum() > 12
    for name, w, g in zip(('ids', 'contrib', 't0', 'voxels'), want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_truth_series(setup):
    s = setup
    jl, tl = smearing(s, True)
    (js, jv, jn), (ts, tv, tn) = _inputs(s)
    ids_w, want = jops.light_truth_series(
        js, jv, jn, jnp.asarray(OP), s['jlut'].time_dist, s['jlut'].t0_avg,
        jnp.float32(0.0), jl, n_ticks=N_TICKS, k_truth=5, lut_smearing=True)
    with flush_subnormals():
        ids_g, got = tops.light_truth_series(
            ts, tv, tn, torch.from_numpy(OP), s['tlut'].time_dist, 0.0, tl,
            n_ticks=N_TICKS, k_truth=5)
    np.testing.assert_array_equal(ids_g.numpy(), np.asarray(ids_w))
    want = np.asarray(want)
    assert got.shape == want.shape == (12, 5, N_TICKS)
    assert got.dtype == torch.float32 and np.abs(want).max() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('pads', [(PAD_FRONT, PAD_BACK), (37, 512)],
                         ids=['beam', 'padded_back'])
def test_transfer_table(setup, pads):
    s = setup
    jl, tl = smearing(s, True)
    pad_front, pad_back = pads
    n_padded = N_TICKS + pad_front + pad_back
    want = jmodel._transfer_table_host(jl, CONV_TICKS, N_TICKS, SAMPLES,
                                       pad_front, n_padded)
    got = tmodel._transfer_table_host(tl, CONV_TICKS, N_TICKS, SAMPLES,
                                      pad_front, n_padded)
    assert got.shape == (N_TICKS, SAMPLES) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for g, w in zip(tmodel._transfer_col_bounds(got),
                    jmodel._transfer_col_bounds(want)):
        np.testing.assert_array_equal(g, w)
    # the product with the JAX device route's table (built by jnp)
    scint = jnp.pad(jops.scintillation_kernel(jl, CONV_TICKS),
                    (0, CONV_TICKS))
    combined = jops.causal_convolve(
        scint[None, :], jops.sipm_kernel(jl, CONV_TICKS))[0]
    table = jops.truth_transfer_table(
        combined, jnp.zeros(1, jnp.int32), jl, n_ticks=N_TICKS,
        digit_samples=SAMPLES, pad_front=pad_front, n_padded=n_padded)
    _, series = jops.light_truth_series(
        *_inputs(s)[0], jnp.asarray(OP), s['jlut'].time_dist,
        s['jlut'].t0_avg, jnp.float32(0.0), jl, n_ticks=N_TICKS, k_truth=5,
        lut_smearing=True)
    rows = series.reshape(-1, N_TICKS)
    want_p = np.asarray(jnp.dot(rows, table,
                                precision=jax.lax.Precision.HIGHEST))
    got_p = tmodel.f32.matmul(torch.from_numpy(np.asarray(rows)),
                              torch.from_numpy(got)).numpy()
    peak = np.abs(want_p).max()
    assert peak > 0
    np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-6 * peak)


def test_device_route(setup):
    """_smeared_truth_stage + _pull_dense_truth against the JAX device
    route's stage and packed pull."""
    s = setup
    jl, tl = smearing(s, True)
    (js, jv, jn), (ts, tv, tn) = _inputs(s)
    n_padded = N_TICKS + PAD_FRONT + PAD_BACK
    ids_w, tw_w = jmodel._smeared_truth_stage(
        js, jv, jn, jnp.asarray(OP), s['jlut'].time_dist, s['jlut'].t0_avg,
        jnp.float32(0.0), jnp.asarray([PAD_FRONT]), jl, n_ticks=N_TICKS,
        conv_ticks=CONV_TICKS, k_truth=5, digit_samples=SAMPLES,
        pad_front=PAD_FRONT, pad_back=PAD_BACK)
    want = jmodel._pull_dense_truth_sparse(ids_w, tw_w, OP, THRESHOLD)
    table = torch.from_numpy(tmodel._transfer_table_host(
        tl, CONV_TICKS, N_TICKS, SAMPLES, PAD_FRONT, n_padded))
    ids_g, tw_g = tmodel._smeared_truth_stage(
        ts, tv, tn, torch.from_numpy(OP), s['tlut'].time_dist, 0.0, tl,
        table, n_ticks=N_TICKS, k_truth=5)
    got = tmodel._pull_dense_truth(ids_g, tw_g, OP, THRESHOLD)
    np.testing.assert_array_equal(ids_g.numpy(), np.asarray(ids_w))
    tw_w = np.asarray(tw_w)
    assert tw_g.shape == tw_w.shape == (1, 12, SAMPLES, 5)
    np.testing.assert_allclose(tw_g.numpy(), tw_w, rtol=1e-4,
                               atol=1e-6 * np.abs(tw_w).max())
    assert records_agree(got, want, THRESHOLD)['records'] > 1000
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k


def test_host_route(setup):
    """_host_smeared_truth_sparse (dict path) against the JAX host route;
    its records path against its dict path."""
    s = setup
    jl, tl = smearing(s, True)
    sel = _jax_select(s, 5)
    want = jmodel._host_smeared_truth_sparse(
        *sel, *_host_args(s, jl, s['jlut'].time_dist_host))
    args = ([np.asarray(a) for a in sel]
            + list(_host_args(s, tl, s['tlut'].time_dist_host)))
    got = tmodel._host_smeared_truth_sparse(*args)
    assert len(want['tick']) > 1000
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rec = tmodel._host_smeared_truth_sparse(*args, as_records=True,
                                            event_id=3)
    rec['trigger_id'] += 7
    ref = texport.truth_sparse_to_records(got, 3, 7)
    assert rec.dtype == ref.dtype == jexport.TRUTH_DTYPE
    for name in ref.dtype.names:
        np.testing.assert_array_equal(rec[name], ref[name], err_msg=name)


def test_host_route_without_photons(setup):
    """No contributor with photons in the window: no record, both
    paths."""
    s = setup
    _, tl = smearing(s, True)
    ids, contrib, t0, vox = [np.asarray(a) for a in _jax_select(s, 5)]
    args = ([ids, np.zeros_like(contrib), t0, vox]
            + list(_host_args(s, tl, s['tlut'].time_dist_host)))
    out = tmodel._host_smeared_truth_sparse(*args)
    assert all(len(v) == 0 for v in out.values())
    assert len(tmodel._host_smeared_truth_sparse(*args,
                                                 as_records=True)) == 0


def test_staged_route(setup):
    """The reference's staged chain (ref_exact_truth_staging) against the
    JAX package's, at a shorter kernel (its cost is rows x ticks x
    kernel)."""
    s = setup
    jl, tl = smearing(s, True)
    sel = _jax_select(s, 2)
    conv = 300
    args = lambda light, lut: (lut, OP, light, THRESHOLD, conv, N_TICKS,
                               SAMPLES, PAD_FRONT, PAD_BACK, 0.0)
    want = jmodel._host_smeared_truth_sparse(
        *sel, *args(jl, s['jlut'].time_dist_host), staged=True)
    got = tmodel._host_smeared_truth_sparse(
        *[np.asarray(a) for a in sel], *args(tl, s['tlut'].time_dist_host),
        staged=True)
    linear = tmodel._host_smeared_truth_sparse(
        *[np.asarray(a) for a in sel], *args(tl, s['tlut'].time_dist_host))
    assert len(want['tick']) > 100
    assert len(linear['tick']) != len(want['tick'])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _sims(s, k=4):
    jsim = dataclasses.replace(
        jload_sim(s['paths']['simulation_properties']), max_mc_truth_ids=k)
    tsim = dataclasses.replace(tpa.load_port_sim(s['paths']),
                               max_mc_truth_ids=k)
    assert jsim.mc_truth_threshold == tsim.mc_truth_threshold == THRESHOLD
    return jsim, tsim


def _port_batch(s, tl, tsim, route, key, **kw):
    return tmodel.simulate_light_batch(
        s['ts'], tl, tsim, torch.from_numpy(s['n_ph']),
        torch.from_numpy(s['vox']), s['tlut'], s['noise'], jax_draw(key, 0),
        truth_path=route, **kw)


@pytest.mark.parametrize('route', ['device', 'host'])
def test_simulate_light_batch(setup, route):
    s = setup
    jl, tl = smearing(s, True)
    jsim, tsim = _sims(s)
    key = jax.random.PRNGKey(11)
    want = jmodel.simulate_light_batch(
        s['js'], s['dm'], jl, jsim, s['n_ph'], s['vox'], s['jlut'],
        s['noise'], key, truth_path=route)
    got = _port_batch(s, tl, tsim, route, key)
    _waveforms_agree(got.waveforms.numpy(), np.asarray(want.waveforms))
    assert got.truth_future is None and want.truth_future is None
    rec = records_agree(got.truth_sparse, want.truth_sparse, THRESHOLD)
    assert rec['records'] > 1000


def test_routes_agree(setup):
    """The port's device route against its host route on one batch."""
    s = setup
    _, tl = smearing(s, True)
    _, tsim = _sims(s, k=8)
    key = jax.random.PRNGKey(12)
    dev = _port_batch(s, tl, tsim, 'device', key)
    host = _port_batch(s, tl, tsim, 'host', key)
    np.testing.assert_array_equal(dev.waveforms.numpy(),
                                  host.waveforms.numpy())
    assert records_agree(dev.truth_sparse, host.truth_sparse,
                         THRESHOLD)['records'] > 1000


def test_host_route_on_a_worker(setup):
    """With an executor the host route's records come from a worker, with
    the batch's event id; a later batch starts no worker."""
    s = setup
    _, tl = smearing(s, True)
    _, tsim = _sims(s)
    key = jax.random.PRNGKey(11)
    inline = _port_batch(s, tl, tsim, 'host', key)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        res = _port_batch(s, tl, tsim, 'host', key, truth_executor=pool,
                          event_id=5)
        later = tmodel.simulate_light_batch(
            s['ts'], tl, tsim, torch.from_numpy(s['n_ph']),
            torch.from_numpy(s['vox']), s['tlut'], s['noise'],
            jax_draw(key, 1), i_subbatch=1, truth_path='host',
            truth_executor=pool)
        rec = res.truth_future.result(timeout=120)
    assert res.truth_sparse is None
    assert later.truth_future is None and later.truth_sparse is None
    ref = texport.truth_sparse_to_records(inline.truth_sparse, 5, 0)
    assert len(ref) > 1000
    for name in ref.dtype.names:
        np.testing.assert_array_equal(rec[name], ref[name], err_msg=name)


def test_device_route_product_is_float32(setup):
    """The device route's product is float32 and leaves the caller's TF32
    setting as it was (tests/test_torch_gpu.py holds it on the card with
    TF32 on)."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        gen = torch.Generator().manual_seed(3)
        a = torch.randn((64, 512), generator=gen)
        b = torch.randn((512, 32), generator=gen)
        got = tmodel.f32.matmul(a, b)
        assert flags.allow_tf32
    finally:
        flags.allow_tf32 = prev
    want = (a.double() @ b.double()).float()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
