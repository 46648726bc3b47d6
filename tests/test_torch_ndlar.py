"""The port on ND-LAr, held to the JAX package on the CPU.

Both packages read the same generated ND-LAr-shaped tree
(``assets.geometry.write_ndlar``: 35 modules, 70 TPCs, 80 x 80-pixel tiles
at 3.87975 mm, 20 an anode, 8.96 M pixel ids, 50 ns sampling, 6401 ticks,
no light keys), as JAX's own ``tests/test_ndlar.py`` reads the real
``ndlar-module.yaml`` (absent here):

* the geometry: TPC borders at rtol 1e-12 / atol 1e-9, pixel counts, 70
  TPCs, 35 modules, light off on both sides; the pixel-id codecs on random
  ids at ND-LAr's pixel count;
* a 16-track charge batch over several modules, JAX's
  ``simulate_charge_batch`` on its Pallas backend (interpret mode) with
  JAX's draws given to the port: unique pixels, hit counts, ticks, track
  map and ADC equal; current fractions at rtol 1e-5 / atol 1e-6 for >= 99%
  of entries and within 1e-3 for all (the two induced currents agree at
  atol 2e-5 x peak, tests/test_torch_current.py, and a fraction divides
  such currents);
* both CLIs end to end with ``config='ndlar'`` and no noise, at the YAML's
  batching (2500 segments, two TPCs a batch) and at bench.py's (10000 at
  ``event_group_size`` 32): ``packets`` equal in every field, ``segments``,
  ``vertices`` and ``trajectories`` equal;
* the grouped pixel keys at bench's group of 32 on the full-size tree: it
  runs, and one slot more than int32 keys allow raises;
* ``assets.response.main`` writes ND-LAr's response (45 x 45 x 3782).
"""
from __future__ import annotations

import functools

import h5py
import jax
import numpy as np
import pytest
import torch

from larndsim_tpu import segments as jseg
from larndsim_tpu.assets.response import make_response
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.geometry import pixels as jpixels
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.params import load_light as jload_light
from larndsim_tpu.params import load_sim as jload_sim
from larndsim_tpu_torch import segments as tseg
from larndsim_tpu_torch.assets import response as tresponse
from larndsim_tpu_torch.assets.geometry import write_ndlar
from larndsim_tpu_torch.assets.make_input import write_input
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.geometry import pixels as tpixels
from larndsim_tpu_torch.models import charge as tcharge
from larndsim_tpu_torch.params import load_light as tload_light
from larndsim_tpu_torch.params import load_sim as tload_sim

import torch_port_assets as tpa
from test_torch_charge import jax_draw

#: ND-LAr's pixel ids: 160 x 800 pixels an anode, 70 anodes
N_PIX_TOTAL = 8_960_000
#: the CLI test's input: one spill of five tracks, each in its own module
CLI_INPUT = dict(n_events=1, tracks_per_event=5, segments_per_track=6,
                 segment_length=0.4, dEdx=8.0, seed=3)
#: and one of a track in every TPC, for bench's groups of 32 batches
CLI_INPUT_DENSE = dict(n_events=1, tracks_per_event=70, segments_per_track=2,
                       segment_length=0.4, dEdx=8.0, seed=3, every_tpc=True)


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    return write_ndlar(str(tmp_path_factory.mktemp('ndlar')))


@pytest.fixture(scope='module')
def models(tree):
    return tpa.load_jax(tree), tpa.load_port(tree)


def test_geometry_matches_jax(tree, models):
    jm, tm = models
    np.testing.assert_allclose(tm.tpc_borders, jm.tpc_borders, rtol=1e-12,
                               atol=1e-9)
    jd, td = jm.params, tm.params
    assert td.n_pixels == tuple(jd.n_pixels) == (160, 800)
    assert td.n_tpcs == jd.n_tpcs == 70
    assert tm.mod_ids == jm.mod_ids == list(range(1, 36))
    assert td.n_pixels[0] * td.n_pixels[1] * td.n_tpcs == N_PIX_TOTAL
    assert td.time_ticks == jd.time_ticks == 6401
    assert td.time_sampling == jd.time_sampling == 0.05
    assert td.f32('response_sampling') == float(jd.response_sampling)
    assert tm.module_to_io_groups == jm.module_to_io_groups
    for name in ('chip_id_map', 'channel_id_map', 'io_group_map',
                 'io_channel_map'):
        np.testing.assert_array_equal(getattr(tm.layout, name),
                                      getattr(jm.layout, name), err_msg=name)
    # every pixel of a tile has its own (io channel, chip, channel)
    lay = tm.layout
    ids = (lay.io_channel_map * 1000 + lay.chip_id_map) * 100 \
        + lay.channel_id_map
    anode0 = [t for row in lay.tile_map[0] for t in row]
    assert len(np.unique(ids[anode0])) == ids[anode0].size
    # the ND-LAr YAML has no light keys: light off on both sides
    assert not jload_light(tree['detector_properties']).light_simulated
    assert not tload_light(tree['detector_properties'],
                           device='cpu').light_simulated


def test_pixel_codecs_match_jax():
    rng = np.random.default_rng(5)
    n_pixels = (160, 800)
    pid = rng.integers(0, N_PIX_TOTAL, 4096)
    want = jpixels.id2pixel(pid, n_pixels)
    got = tpixels.id2pixel(torch.from_numpy(pid), n_pixels)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tpixels.pixel2id(*got, n_pixels).numpy(),
                                  jpixels.pixel2id(*want, n_pixels))
    np.testing.assert_array_equal(jpixels.pixel2id(*want, n_pixels), pid)


def _module_tracks(borders, n: int, seed: int) -> np.ndarray:
    """``n`` short tracks of one segment each in random TPCs (JAX
    tests/test_ndlar.py:54-77)."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype([(f, 'f8') for f in jseg.FLOAT_FIELDS]
                     + [(f, 'i8') for f in jseg.INT_FIELDS])
    tr = np.zeros(n, dtype=dtype)
    tpcs = rng.integers(0, len(borders), n)
    for i in range(n):
        b = np.sort(borders[tpcs[i]], axis=-1)
        start = b[:, 0] + rng.uniform(0.2, 0.8, 3) * (b[:, 1] - b[:, 0])
        end = start + 0.4
        for a, name in enumerate('xyz'):
            tr[f'{name}_start'][i] = start[a]
            tr[f'{name}_end'][i] = min(end[a], b[a, 1] - 0.01)
            tr[name][i] = 0.5 * (tr[f'{name}_start'][i]
                                 + tr[f'{name}_end'][i])
    tr['dx'] = 0.5
    tr['dEdx'] = 15.0
    tr['dE'] = tr['dEdx'] * tr['dx']
    tr['segment_id'] = np.arange(n)
    return tr, tpcs


def _response(det) -> np.ndarray:
    n_t = int(round(float(det.time_window) / float(det.response_sampling)))
    return make_response(n_xy=45, n_t=n_t,
                         bin_size=float(det.response_bin_size),
                         sampling=float(det.response_sampling),
                         pixel_pitch=float(det.pixel_pitch))


def test_charge_batch_matches_jax(tree, models):
    jm, tm = models
    tracks, tpcs = _module_tracks(jm.tpc_borders, 16, seed=2)
    assert len(set(tpcs // 2)) >= 5, 'tracks in several modules'
    response = _response(jm.params)
    assert response.shape == (45, 45, 3782)
    key = jax.random.PRNGKey(4)
    want = jcharge.simulate_charge_batch(
        jseg.from_structured(tracks, pad_to=16), jm,
        jload_sim(tree['simulation_properties']), key,
        jax.numpy.asarray(response), step_scale=32.0, backend='pallas')
    got = tcharge.simulate_charge_batch(
        tseg.from_structured(tracks, pad_to=16, device='cpu'), tm,
        tload_sim(tree['simulation_properties']), jax_draw(key),
        torch.from_numpy(response), step_scale=32.0)
    planes = got.segments.pixel_plane.numpy()
    assert (planes < 70).all() and len(set(planes // 2)) >= 5
    assert want.n_unique == got.n_unique > 0
    for name in ('unique_pix', 'n_adc', 'track_pixel_map', 'hit_row',
                 'hit_slot', 'hit_ticks', 'hit_adc'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.overflow == want.overflow
    assert len(want.hit_adc) > 0, 'test must produce hits'
    # hits in several modules
    assert len(set((got.unique_pix[got.n_adc > 0]
                    // (N_PIX_TOTAL // 35)).tolist())) >= 3
    f, fw = got.hit_fractions, want.hit_fractions
    assert np.isclose(f, fw, rtol=1e-5, atol=1e-6).mean() >= 0.99
    np.testing.assert_allclose(f, fw, atol=1e-3)


def _structured(path, name):
    with h5py.File(path, 'r') as f:
        return np.array(f[name])


@pytest.mark.parametrize('batching', ['yaml', 'bench'])
def test_clis_agree(tmp_path, monkeypatch, batching):
    """No noise, step_scale 32: a spill over five modules at the YAML's
    batching (2500 segments, two TPCs a batch: one call a module), and a
    spill with a track in every TPC at bench.py's (10000 segments at
    event_group_size 32: two calls, of 32 and 3 modules' batches, the first
    with pixel keys up to 32 x 8.96 M)."""
    paths = write_ndlar(str(tmp_path / 'tree'), detector_overrides=tpa.QUIET,
                        sim_overrides=dict(batch_size=10000)
                        if batching == 'bench' else None)
    dm = tpa.load_jax(paths)
    inp = str(tmp_path / 'in.h5')
    write_input(inp, dm.tpc_borders, **(CLI_INPUT if batching == 'yaml'
                                        else CLI_INPUT_DENSE))
    kw = dict(config='ndlar', detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
              step_scale=32.0,
              event_group_size=32 if batching == 'bench' else 1)
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    calls = []
    orig = tcli.simulate_charge_batch

    def spy(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)
    monkeypatch.setattr(tcli, 'simulate_charge_batch', spy)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    jcli.run_simulation(inp, out_j, **kw)
    tcli.run_simulation(inp, out_t, device='cpu', **kw)

    pk_j, pk_t = (_structured(p, 'packets') for p in (out_j, out_t))
    data = pk_t[pk_t['packet_type'] == 0]
    assert len(data) > 0, 'test must produce data packets'
    assert len({(g - 1) // 2 for g in data['io_group']}) >= 5, \
        'hits in at least five modules'
    assert sorted(set(pk_t['io_group'].tolist())) == list(range(1, 71))
    for name in pk_j.dtype.names:
        np.testing.assert_array_equal(pk_t[name], pk_j[name], err_msg=name)
    for name in ('segments', 'vertices', 'trajectories'):
        a, b = _structured(out_t, name), _structured(out_j, name)
        assert a.dtype.names == b.dtype.names, name
        for field in b.dtype.names:
            np.testing.assert_array_equal(a[field], b[field],
                                          err_msg=f'{name}.{field}')
    # one charge call a module with tracks at the YAML's batching (two TPCs
    # a batch); at bench's, the 35 modules' batches in groups of 32 (an
    # empty batch would close a group, as in the JAX CLI)
    planes = _structured(out_t, 'segments')['pixel_plane']
    n_mod = len(set((planes // 2).tolist()))
    assert len(calls) == (n_mod if batching == 'yaml' else 2)
    assert n_mod == (5 if batching == 'yaml' else 35)


def test_grouped_keys_at_bench_group(tree, models):
    """bench.py's group of 32 events keys 8.96 M pixel ids x 32 slots =
    2.87e8 < 2^31: it runs, and so does the last slot that fits (238); one
    slot more raises before any key is made."""
    _, tm = models
    sim = tload_sim(tree['simulation_properties'])
    tracks, _ = _module_tracks(tm.tpc_borders, 32, seed=3)
    segs = tseg.from_structured(tracks, pad_to=32, device='cpu')
    bound = (2 ** 31 - 1) // N_PIX_TOTAL - 1
    assert N_PIX_TOTAL * 32 < 2 ** 31 and bound == 238
    slots = np.arange(32)
    for last in (31, bound):
        st = tcharge.stage_batch(segs, tm, sim, step_scale=32.0,
                                 event_slot=np.where(slots == 31, last,
                                                     slots))
        keys = st.uniq[:int(st.n_unique)]
        assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 31
        assert int(keys.max()) // N_PIX_TOTAL == last
    with pytest.raises(ValueError, match='overflow int32'):
        tcharge.stage_batch(segs, tm, sim, step_scale=32.0,
                            event_slot=np.where(slots == 31, bound + 1,
                                                slots))


def test_response_main_writes_ndlar_response(tmp_path):
    out = str(tmp_path / 'response_38.npy')
    assert tresponse.main(['--output', out, '--n_t', '3782', '--bin_size',
                           '0.0387975', '--sampling', '0.05',
                           '--pixel_pitch', '0.387975']) == out
    want = make_response(n_t=3782, bin_size=0.0387975, sampling=0.05,
                         pixel_pitch=0.387975)
    assert want.shape == (45, 45, 3782)
    np.testing.assert_array_equal(np.load(out), want)
