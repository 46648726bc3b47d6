"""The sharded simulation step (``parallel.mesh.make_sharded_sim_step``)
and the dry run (``graft_entry``), on the CPU.

A 2 x 2 grid of CPU cells: two module rows (electron lifetimes 2.2 ms and
20 us, each its own light LUT row) by two event columns, one drifted batch
of the small tree a cell (tracks at times inside a 6 us light window of 12
channels: 8192 ticks, a dead time of 2560), the beam trigger with noise
and the top-8 truth, and the threshold trigger (mode 0, up to 4 triggers):

* every cell equals the port's solo chain on the same draws, bit for bit:
  ``charge_step``, the light incidence, ``models.light._signal_stage``,
  the trigger, the pad, noise and digitization written out here;
* against JAX's ``make_sharded_sim_step`` on a virtual 2 x 2 CPU mesh
  (tests/conftest.py gives 8 host devices), the port's draws taken from
  JAX's key splits (each cell's key split in three: the charge draws as
  tests/test_torch_charge.py takes them, then Poisson and normal from the
  second, the noise phases from the third): ``adc``, ``trigger_idx``,
  ``n_triggers``, ``truth_ids`` and ``n_hits_total`` equal, waveforms
  within one quantum (64 ADC) with >= 99.9% of samples equal
  (tests/test_torch_light.py), ``truth_contrib`` at rtol 1e-5;
* ``graft_entry.dryrun_multichip`` at 4 and 8 CPU contexts with JAX's
  checks, and ``graft_entry.entry``, as JAX tests/test_parallel.py:9-20;
  both run on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import inspect

import numpy as np
import pytest
import torch

from larndsim_tpu.assets.light_lut import make_light_lut, make_light_noise
from larndsim_tpu.assets.response import make_response
from larndsim_tpu.ops import light as jops
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.parallel import mesh as jmesh
from larndsim_tpu_torch import graft_entry as ge
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.models import charge as tcharge
from larndsim_tpu_torch.models import light as tmodel
from larndsim_tpu_torch.ops import current
from larndsim_tpu_torch.ops import light as tops
from larndsim_tpu_torch.ops.drift import drift
from larndsim_tpu_torch.ops.quench import quench
from larndsim_tpu_torch.parallel import mesh as tmesh
from larndsim_tpu_torch.params import physics

import torch_port_assets as tpa
from test_torch_charge import jax_draw as jax_charge_draw

#: 12 channels (6 a TPC, two trigger groups), a 6 us beam window
LIGHT = dict(n_op_channel=12, light_window=(0.0, 6.0))
C = LIGHT['n_op_channel']
SHAPES = dict(max_active=16, radius=2, max_nb=64, t_sig=256, n_steps=32,
              n_unique_cap=128, max_adc=10, max_tracks=8)
LIFETIMES = (2.2e3, 20.0)
K_TRUTH, MAX_TRIG = 8, 4
#: the threshold trigger's group thresholds [ADC]
GROUP_THRESHOLD = (-400.0, -400.0)
QUANT = 64.0


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    tree = tpa.write_tree(tmp_path_factory.mktemp('mesh'), light=LIGHT)
    jm, tm = tpa.load_jax(tree), tpa.load_port(tree)
    det = tm.params
    batches = []
    for seed in range(4):
        tracks = tpa.detector_tracks(jm.tpc_borders, seed=seed + 5,
                                     tracks_per_event=3)
        tracks['t0'] = np.random.default_rng(seed).uniform(
            0.05, 5.0, 3)[tracks['traj_id']] + 1e-3 * np.arange(len(tracks))
        segs = drift(quench(tseg.from_structured(tracks, pad_to=32,
                                                 device='cpu'),
                            det, physics.BIRKS), det)
        batches.append(tseg.to_structured(segs, dtype=tracks.dtype))
    cat = np.concatenate(batches)
    band = current.host_shift_band({k: cat[k] for k in cat.dtype.names},
                                   det, mc_smear=True)
    n_t = int(round(det.f32('time_window') / det.f32('response_sampling')))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=det.f32('response_bin_size'),
                             pixel_pitch=det.f32('pixel_pitch'))
    jl = jload_light(tree['detector_properties'])
    luts = [make_light_lut((4, 6, 4), n_det_tpc=C // 2, n_prof=100,
                           tpc_size=size, seed=i)
            for i, size in enumerate(((30.0, 60.0, 30.0),
                                      (31.0, 62.0, 31.0)))]
    lut_t = [tops.LightLUT.from_structured(a, 'cpu') for a in luts]
    stack = lambda name: torch.stack([getattr(t, name) for t in lut_t])
    return dict(
        tree=tree, jm=jm, tm=tm, batches=batches, band=band,
        response=response, jl=jl, tl=tpa.port_light(jl), luts=luts,
        lut=[stack(k) for k in ('vis', 't0', 'time_dist', 't0_avg')],
        noise=np.stack([make_light_noise(C, seed=1 + m) for m in range(2)]),
        dets=[det.replace(electron_lifetime=t) for t in LIFETIMES],
        jdets=[jm.params.replace(electron_lifetime=jnp.float32(t))
               for t in LIFETIMES],
        statics=dict(SHAPES, **ge.light_shapes(tpa.port_light(jl))))


def _cell_draws(key):
    """A cell's charge draws and light draws from JAX's key of the cell
    (JAX mesh.py:175-176)."""
    k_charge, k_light, k_noise = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_light)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(torch.float32)
    return (jax_charge_draw(k_charge), tops.LightDraw(
        poisson=lambda rate: t(jax.random.poisson(k1, jnp.asarray(
            rate.numpy()))),
        normal=lambda shape: t(jax.random.normal(k2, shape)),
        uniform=lambda shape: t(jax.random.uniform(k_noise, shape))))


def _keys():
    return jax.random.key_data(jax.random.split(jax.random.PRNGKey(0), 4)
                               ).reshape(2, 2, 2).astype(jnp.uint32)


def _case(mode: str) -> dict:
    if mode == 'beam':
        return dict(add_noise=True, k_truth=K_TRUTH, trig_mode=1,
                    max_trig=MAX_TRIG)
    return dict(add_noise=False, k_truth=0, trig_mode=0, max_trig=MAX_TRIG,
                group_threshold=GROUP_THRESHOLD)


def _port_step(s, mode, mesh):
    step = tmesh.make_sharded_sim_step(
        mesh, s['tl'], torch.arange(C), shift_band=s['band'],
        **s['statics'], **_case(mode))
    grid = tmesh.shard_segments(s['batches'], mesh, pad_to=32)
    keys = _keys()
    draws = [[_cell_draws(keys[m, e]) for e in range(2)] for m in range(2)]
    return step(grid, tmesh.stack_module_params(s['dets']),
                torch.from_numpy(s['response']), *s['lut'], draws,
                noise_rows=torch.from_numpy(s['noise']).float())


def _solo(s, mode, m, e):
    """The chain of cell (m, e), written out from the port's pieces."""
    case = _case(mode)
    st = s['statics']
    charge_draw, light_draw = _cell_draws(_keys()[m, e])
    tl, det = s['tl'], s['dets'][m]
    vis, t0, time_dist, t0_avg = (a[m] for a in s['lut'])
    segs = tseg.from_structured(s['batches'][2 * m + e], pad_to=32,
                                device='cpu')
    _, _, adc, fee_res, _, _, _ = tcharge.charge_step(
        segs, det, torch.from_numpy(s['response']), charge_draw,
        shift_band=s['band'], **SHAPES)
    n_det, _, vox = tops.calculate_light_incidence(segs, det, tl, vis, t0,
                                                   n_channels=C)
    ch = torch.arange(C)
    sig = tmodel._signal_stage(
        segs, vox, n_det, ch, time_dist, t0_avg, 0.0, tl.light_gain[ch],
        light_draw, tl, n_ticks=st['n_ticks'], conv_ticks=st['conv_ticks'],
        lut_smearing=tl.enable_lut_smearing)
    if case['trig_mode'] == 0:
        above = tops.group_above_threshold(
            sig, torch.tensor(GROUP_THRESHOLD), per_trig=6,
            sample_factor=tops.sample_factor(tl))
        idx, counts = tops.dead_time_trigger_scan(
            above.any(0, keepdim=True), digit_ticks=tops.digit_ticks(tl),
            max_trig=MAX_TRIG)
        trig, n_trig = idx[0], counts[0]
    else:
        trig = torch.tensor([0] + [-1] * (MAX_TRIG - 1), dtype=torch.int32)
        n_trig = torch.tensor(1, dtype=torch.int32)
    signal = torch.nn.functional.pad(sig, (st['pad_front'],
                                           st['pad_back']))
    if case['add_noise']:
        signal = signal + tops.gen_light_detector_noise(
            tuple(signal.shape), torch.from_numpy(s['noise'][m]).float(),
            light_draw, tl)
    wv = tops.digitize_signal(signal, trig.clamp(min=0) + st['pad_front'],
                              tl, digit_samples=st['digit_samples'])
    wv = wv * (trig >= 0).float()[:, None, None]
    ids = torch.full((C, 1), -1, dtype=torch.int32)
    contrib = torch.zeros((C, 1))
    if case['k_truth']:
        ids, contrib, _, _ = tops.light_truth_select(segs, vox, n_det,
                                                     k_truth=K_TRUTH)
    return dict(adc=adc, waveforms=wv, trigger_idx=trig, n_triggers=n_trig,
                truth_ids=ids, truth_contrib=contrib,
                hits=int((fee_res.n_adc > 0).sum()))


@pytest.fixture(scope='module')
def port_runs(setup):
    mesh = tmesh.make_mesh(4, 2, devices=['cpu'] * 4)
    return {mode: _port_step(setup, mode, mesh) for mode in ('beam',
                                                             'mode0')}


@pytest.mark.parametrize('mode', ['beam', 'mode0'])
def test_each_cell_equals_the_solo_chain(setup, port_runs, mode):
    out = port_runs[mode]
    total = 0
    for m in range(2):
        for e in range(2):
            want = _solo(setup, mode, m, e)
            for k in ('adc', 'waveforms', 'trigger_idx', 'n_triggers',
                      'truth_ids', 'truth_contrib'):
                assert torch.equal(out[k][m][e], want[k]), (mode, k, m, e)
            total += want['hits']
    assert out['n_hits_total'] == total > 0
    n_trig = [int(out['n_triggers'][m][e]) for m in range(2)
              for e in range(2)]
    if mode == 'mode0':
        assert max(n_trig) >= 2 and min(n_trig) >= 1, n_trig
    else:
        assert n_trig == [1] * 4
        assert all(int(out['truth_ids'][m][e].max()) >= 0
                   for m in range(2) for e in range(2))
    # the two module rows: other lifetimes, other LUTs
    assert not torch.equal(out['waveforms'][0][0], out['waveforms'][1][0])


@pytest.mark.parametrize('mode', ['beam', 'mode0'])
def test_sim_step_agrees_with_jax(setup, port_runs, mode):
    s = setup
    mesh = jmesh.make_mesh(4, n_modules=2, devices=jax.devices()[:4])
    case = _case(mode)
    jl = s['jl']
    step = jmesh.make_sharded_sim_step(
        mesh, jl, jnp.arange(C), **SHAPES,
        **{k: v for k, v in s['statics'].items() if k not in SHAPES},
        **case)
    luts = [jops.LightLUT.from_structured(a) for a in s['luts']]
    stack = lambda name: jnp.stack([getattr(t, name) for t in luts])
    want = step(jmesh.shard_segments(s['batches'], mesh, pad_to=32),
                jmesh.stack_module_params(s['jdets']),
                jnp.asarray(s['response']), stack('vis'), stack('t0'),
                stack('time_dist'), stack('t0_avg'), _keys(),
                noise_rows=jnp.asarray(s['noise'], jnp.float32))
    got = port_runs[mode]
    assert int(want['n_hits_total']) == got['n_hits_total'] > 0
    for m in range(2):
        for e in range(2):
            for k in ('adc', 'trigger_idx', 'n_triggers', 'truth_ids'):
                np.testing.assert_array_equal(
                    got[k][m][e].numpy(), np.asarray(want[k][m, e]),
                    err_msg=f'{mode} {k} {m} {e}')
            np.testing.assert_allclose(
                got['truth_contrib'][m][e].numpy(),
                np.asarray(want['truth_contrib'][m, e]), rtol=1e-5)
            wg = got['waveforms'][m][e].numpy()
            ww = np.asarray(want['waveforms'][m, e])
            assert np.abs(ww).max() > 0, (mode, m, e)
            d = np.abs(wg - ww)
            assert d.max() <= QUANT, (mode, m, e, d.max())
            assert (d == 0).mean() >= 0.999, (mode, m, e, (d == 0).mean())


def test_sim_step_refuses_mode0_without_thresholds(setup):
    mesh = tmesh.make_mesh(1, devices=['cpu'])
    with pytest.raises(ValueError, match='thresholds'):
        tmesh.make_sharded_sim_step(
            mesh, setup['tl'], torch.arange(C), shift_band=setup['band'],
            **setup['statics'], trig_mode=0)


def test_entry_points_default_to_the_card():
    for fn in (ge.entry, ge.dryrun_multichip, ge._example_setup):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'


def test_entry_runs():
    fn, args = ge.entry('cpu')
    adc, uniq, fractions = fn(*args)
    assert adc.shape[0] == ge.STATICS['n_unique_cap']
    assert torch.isfinite(fractions).all()
    assert int((adc > 0).sum()) > 0


@pytest.mark.parametrize('n', [4, 8])
def test_dryrun_multichip(n):
    """JAX's checks (__graft_entry__.py:204-213, :255-256) inside; each
    module row's parameters differ in the tensor and its float64 copy
    alike."""
    out = ge.dryrun_multichip(n, 'cpu')
    mesh = out['mesh']
    assert mesh.shape == {'modules': 2, 'events': n // 2}
    assert out['n_packets'] > 0
    rows = [tmesh.module_params(out['det_stack'], m, 'cpu') for m in (0, 1)]
    for row in rows:
        assert float(row.e_field) == row.f32('e_field')
    assert rows[1].host['e_field'] == pytest.approx(
        rows[0].host['e_field'] * 1.01, rel=1e-12)
    assert float(rows[1].e_field) != float(rows[0].e_field)
