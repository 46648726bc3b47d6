"""Port parity of module-to-module variation: the 2x2 configuration's four
modules with their own layouts, responses, light LUTs and channels.

Both packages run the small four-module tree (``torch_port_assets.
write_tree_2x2``: 1 x 1 tiles of 14 x 14 pixels at 4.434 mm on modules 1, 2
and 4 and of 16 x 16 pixels at 3.87975 mm on module 3, a per-module
``response_bin_size`` and ``lifetime``, 24 optical channels, 6 a module,
two light LUTs spread by the configuration's ``LIGHT_LUT_ID``), with
deterministic charge (``QUIET``) and a 2 us beam window.  The input has
tracks in every TPC of every event, their times within the digitized
window.  The port's light draws come from the JAX CLI's key tree through
``cli.simulate_pixels.light_draw`` (tests/test_torch_light_cli.py), with
each module's id.

Tolerances: ``_as_list``'s results equal and its exceptions of the same
type and message, as the CLIs' resolution errors; ``load_detector``'s
leaves, statics, host values and maps equal; the light incidence at every
module's channel offset at rtol 2e-6 / atol 1e-5 (photons and t0), voxels
equal; the merged ``light_wvfm`` equal bit for bit; end to end, those of
tests/test_torch_light_cli.py: data packets as in tests/test_torch_cli.py
(each matched packet's fraction per segment id within atol 1e-4, an id
absent on one side counting as 0),
``light_trig`` equal field by field, each ``light_dat_module{i}``'s segment
ids equal and its photons and t0 at rtol 2e-6 / atol 1e-5, truth records
(contributor points equal, pe_current at rtol 1e-4 / atol 1e-6; LUT
smearing by ``tools.light_check.records_agree``), ``light_wvfm`` within one
quantum (64 ADC), >= 99.9% of samples equal.
"""
from __future__ import annotations

import collections
import functools

import h5py
import numpy as np
import pytest

from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.io import export as jexport
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu.models import light as jlight
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.config import get_config
from larndsim_tpu_torch.io import export as texport
from larndsim_tpu_torch.io.h5 import File, Group
from larndsim_tpu_torch.tools.light_check import records_agree

import torch_port_assets as tpa
from test_torch_cli import _data_packets, _truth
from test_torch_light_cli import _fed_light_draw

#: 24 channels: 6 a module, 3 a TPC; a 2 us beam window
LIGHT = dict(n_op_channel=24, light_window=(0.0, 2.0))
QUANT = 64.0


def _paths(tmp_path, **kw):
    return tpa.write_tree_2x2(tmp_path / 'tree', detector_overrides=tpa.QUIET,
                              **kw)


def _geo(paths):
    from larndsim_tpu.params import load_detector
    return load_detector(paths['detector_properties'],
                         paths['pixel_layout'][0])


# --------------------------------------------------------------------------
# flag resolution
# --------------------------------------------------------------------------

_LISTS = [
    (['a', 'b'], {'X_ID': [0, 0, 1, 0]}, None),
    (['a', 'b'], {}, [1, 0, 0, 1]),
    (['a', 'b'], {'X_ID': [0, 0, 1, 0]}, [1, 1, 1, 0]),
    (['a', 'b'], {'X_ID': [0, 0, 2, 0]}, None),       # an id past the list
    (['a', 'b'], {'X_ID': [0, 0, 1]}, None),          # too few ids
    (['a', 'b', 'c', 'd'], {}, None),
    (['a', 'b'], {}, None),                           # no ids, 2 of 4
    ('a', {'X_ID': [0, 0, 1, 0]}, None),
    (None, {}, [0, 0, 0, 0]),
]


def _outcome(fn, *args, **kw):
    try:
        return 'ok', fn(*args, **kw)
    except Exception as exc:     # noqa: BLE001 -- compared below
        return type(exc), str(exc)


@pytest.mark.parametrize('case', range(len(_LISTS)))
def test_as_list_resolves_as_jax(case):
    val, cfg, ids = _LISTS[case]
    got = _outcome(tcli._as_list, val, 4, cfg, 'X_ID', ids=ids)
    want = _outcome(jcli._as_list, val, 4, cfg, 'X_ID', ids=ids)
    assert got == want
    assert (got[0] == 'ok') == (case not in (3, 4, 6))


def test_resolution_errors_as_jax(tmp_path):
    """Several files without module variation raise JAX's KeyError; one
    module with variation warns and turns it off (then, the 2x2
    configuration's two LUTs raise the same KeyError)."""
    paths = _paths(tmp_path, light=LIGHT)
    one = tpa.write_tree(tmp_path / 'one', light=LIGHT)
    inp = tmp_path / 'in.h5'
    inp.write_bytes(b'')
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=paths['response_file'][0])
    runs = {}
    for name, cli, extra in (('jax', jcli, {}),
                             ('port', tcli, dict(device='cpu'))):
        with pytest.raises(KeyError) as several:
            cli.run_simulation(str(inp), str(tmp_path / f'{name}.h5'),
                               config='2x2', mod2mod_variation=False,
                               **kw, **extra)
        with pytest.warns(UserWarning, match='Single module with module '
                          'variation: deactivating'), \
                pytest.raises(KeyError) as single:
            cli.run_simulation(
                str(inp), str(tmp_path / f'{name}_one.h5'), config='2x2',
                mod2mod_variation=True,
                detector_properties=one['detector_properties'],
                pixel_layout=one['pixel_layout'],
                simulation_properties=one['simulation_properties'],
                response_file=str(tmp_path / 'r.npy'), **extra)
        runs[name] = (str(several.value), str(single.value))
    assert runs['port'] == runs['jax']
    assert 'Multiple config files provided without module variation' \
        in runs['port'][0] == runs['port'][1]


def test_2x2_configuration_resolves_per_module():
    """The 2x2 keyword's lists spread over its four modules as JAX's."""
    cfg = get_config('2x2')
    for key, id_name in (('PIXEL_LAYOUT', 'PIXEL_LAYOUT_ID'),
                         ('RESPONSE', 'RESPONSE_ID'),
                         ('LIGHT_LUT', 'LIGHT_LUT_ID')):
        got = tcli._as_list(cfg[key], 4, cfg, id_name)
        assert got == jcli._as_list(cfg[key], 4, cfg, id_name)
        assert got[2] != got[0] or key == 'LIGHT_LUT'
        assert len(set(got)) == 2, got


# --------------------------------------------------------------------------
# per-module detector parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize('i_module', [1, 2, 3, 4])
def test_load_detector_per_module(tmp_path, i_module):
    from larndsim_tpu.params import detector as jdet
    from larndsim_tpu_torch.params import detector as tdet
    # every per-module key JAX's loader picks, module 3 apart
    paths = tpa.write_tree_2x2(tmp_path / 'tree', light=False,
                               detector_overrides=dict(
                                   e_field=[0.5, 0.5, 0.45, 0.5],
                                   response_sampling=[0.1, 0.1, 0.05, 0.1],
                                   discrimination_threshold=[7e3, 7e3, 6e3,
                                                             7e3]))
    cfg = get_config('2x2')
    layouts = tcli._as_list(paths['pixel_layout'], 4, cfg, 'PIXEL_LAYOUT_ID')
    dj = jdet.load_detector(paths['detector_properties'], layouts,
                            i_module=i_module)
    dt = tdet.load_detector(paths['detector_properties'], layouts,
                            i_module=i_module, device='cpu')
    tpa.assert_same_leaves(dj.params, dt.params,
                           tdet.LEAVES + tdet.STATICS)
    host = jdet.host_scalars(dj.params)
    for name, value in dt.params.host.items():
        np.testing.assert_array_equal(value, host[name], err_msg=name)
    np.testing.assert_array_equal(dt.tpc_borders, dj.tpc_borders)
    for name in ('module_to_io_groups', 'module_to_tpcs', 'tpc_to_module',
                 'mod_ids'):
        assert getattr(dt, name) == getattr(dj, name), name
    for name in ('chip_id_map', 'channel_id_map', 'io_group_map',
                 'io_channel_map'):
        np.testing.assert_array_equal(getattr(dt.layout, name),
                                      getattr(dj.layout, name))
    # module 3: the 80-pixel tiles' pitch, bin size and lifetime
    pitch = 0.387975 if i_module == 3 else 0.4434
    assert dt.params.host['pixel_pitch'] == pytest.approx(pitch)
    assert dt.params.host['response_bin_size'] == pytest.approx(pitch / 10)
    assert dt.params.host['electron_lifetime'] == (2.0e3 if i_module == 3
                                                    else 2.2e3)
    assert dt.params.host['e_field'] == (0.45 if i_module == 3 else 0.5)
    assert dt.params.host['discrimination_threshold'] == (
        6e3 if i_module == 3 else 7e3)
    assert dt.params.n_pixels == ((16, 16) if i_module == 3 else (14, 14))
    assert dt.params.n_tpcs == 8


# --------------------------------------------------------------------------
# light incidence on each module's channels
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def incidence(tmp_path_factory):
    from larndsim_tpu import segments as jseg
    from larndsim_tpu.assets.light_lut import make_light_lut
    from larndsim_tpu.ops import light as jops
    from larndsim_tpu.ops.drift import drift as jdrift
    from larndsim_tpu.ops.quench import quench as jquench
    from larndsim_tpu.params import load_light, physics
    from larndsim_tpu_torch.ops import light as tops
    paths = _paths(tmp_path_factory.mktemp('incidence'), light=LIGHT)
    dm = _geo(paths)
    jl = load_light(paths['detector_properties'])
    lut = make_light_lut((4, 6, 4), n_det_tpc=3, n_prof=100)
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=5, tracks_per_event=16,
                                 every_tpc=True)
    tracks['t0'] = np.random.default_rng(6).uniform(0.02, 1.6, len(tracks))
    js = jdrift(jquench(jseg.from_structured(tracks, pad_to=128), dm.params,
                        physics.BIRKS), dm.params)
    return dict(jops=jops, tops=tops, dm=dm, jl=jl, tl=tpa.port_light(jl),
                jlut=jops.LightLUT.from_structured(lut),
                tlut=tops.LightLUT.from_structured(lut, 'cpu'), js=js,
                ts=tpa.port_segments(js), det=tpa.port_params(dm.params))


@pytest.mark.parametrize('i_module', [1, 2, 3, 4])
def test_incidence_at_channel_offset(incidence, i_module):
    s = incidence
    n = s['jl'].n_op_channel // 4
    offset = n * (i_module - 1)
    want = s['jops'].calculate_light_incidence(
        s['js'], s['dm'].params, s['jl'], s['jlut'].vis, s['jlut'].t0,
        n_channels=n, channel_offset=offset)
    got = s['tops'].calculate_light_incidence(
        s['ts'], s['det'], s['tl'], s['tlut'].vis, s['tlut'].t0,
        n_channels=n, channel_offset=offset)
    n_ph, t0_det, vox = (np.asarray(w) for w in want)
    # photons only on the module's own TPCs
    plane = np.asarray(s['js'].pixel_plane)
    lit = (n_ph > 0).any(axis=1)
    assert lit.sum() > 10
    assert set(plane[lit] // 2) == {i_module - 1}
    np.testing.assert_array_equal(got[2].numpy(), vox)
    np.testing.assert_allclose(got[0].numpy(), n_ph, rtol=2e-6, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), t0_det, rtol=2e-6, atol=1e-5)


# --------------------------------------------------------------------------
# the per-module waveforms merged
# --------------------------------------------------------------------------

@pytest.mark.parametrize('rows', [2, 3000], ids=['in_memory', 'on_disk'])
def test_merge_module_light_wvfm(tmp_path, rows):
    """Per-module datasets written by each package's exporter, merged by
    each package's merge: the same light_wvfm, read by h5py and by the
    port's reader, with no per-module dataset left.  3000 rows commit a
    chunk of each module's dataset to the file before the merge."""
    from larndsim_tpu.params import load_light as jload_light
    from larndsim_tpu.params import load_sim as jload_sim
    from larndsim_tpu_torch.params import load_sim as tload_sim
    import dataclasses
    paths = _paths(tmp_path, light=LIGHT)
    dm = _geo(paths)
    jl = jload_light(paths['detector_properties'])
    tl = tpa.port_light(jl)
    jsim = dataclasses.replace(jload_sim(paths['simulation_properties']),
                               mod2mod_variation=True)
    tsim = dataclasses.replace(tload_sim(paths['simulation_properties']),
                               mod2mod_variation=True)
    rng = np.random.default_rng(3)
    wv = {m: rng.normal(size=(rows, 6, 8)) for m in (1, 2, 3, 4)}
    ev = np.arange(rows)
    fj, ft = str(tmp_path / 'jax.h5'), str(tmp_path / 'port.h5')
    for m in (1, 2, 3, 4):
        jexport.export_light_wvfm_to_hdf5(ev, wv[m], fj, jsim, jl, i_mod=m)
    jexport.merge_module_light_wvfm_same_trigger(fj, dm)
    with File(ft, 'w') as f:
        for m in (1, 2, 3, 4):
            texport.export_light_wvfm_to_hdf5(ev, wv[m], f, tsim, tl,
                                              i_mod=m)
        committed = f['light_wvfm/light_wvfm_mod2']._done
        texport.merge_module_light_wvfm_same_trigger(f, dm)
    assert (committed > 0) == (rows > 2)
    want = np.concatenate([wv[m] for m in (1, 2, 3, 4)], axis=1)
    with h5py.File(fj, 'r') as a, h5py.File(ft, 'r') as b:
        assert isinstance(b['light_wvfm'], h5py.Dataset)
        np.testing.assert_array_equal(b['light_wvfm'][:], a['light_wvfm'][:])
        np.testing.assert_array_equal(b['light_wvfm'][:], want)
        assert b['light_wvfm'].maxshape == (None, None, None)
        assert sorted(b.keys()) == sorted(a.keys()) == ['light_wvfm']
    with File(ft, 'r') as f:
        assert not isinstance(f['light_wvfm'], Group)
        np.testing.assert_array_equal(np.asarray(f['light_wvfm']), want)


def test_merge_refuses_unequal_triggers(tmp_path):
    from larndsim_tpu.params import load_light as jload_light
    from larndsim_tpu.params import load_sim as jload_sim
    import dataclasses
    paths = _paths(tmp_path, light=LIGHT)
    dm = _geo(paths)
    jl = jload_light(paths['detector_properties'])
    sim = dataclasses.replace(jload_sim(paths['simulation_properties']),
                              mod2mod_variation=True)
    fj = str(tmp_path / 'jax.h5')
    errors = []
    with File(str(tmp_path / 'port.h5'), 'w') as f:
        for m in (1, 2, 3, 4):
            n = 3 if m == 2 else 2
            wv = np.ones((n, 6, 8))
            jexport.export_light_wvfm_to_hdf5(np.arange(n), wv, fj, sim, jl,
                                              i_mod=m)
            texport.export_light_wvfm_to_hdf5(np.arange(n), wv, f, sim,
                                              tpa.port_light(jl), i_mod=m)
        for merge, where in ((jexport.merge_module_light_wvfm_same_trigger,
                              fj),
                             (texport.merge_module_light_wvfm_same_trigger,
                              f)):
            with pytest.raises(ValueError) as exc:
                merge(where, dm)
            errors.append(str(exc.value))
    assert errors[0] == errors[1]
    assert 'number of triggers' in errors[0]


# --------------------------------------------------------------------------
# both CLIs end to end
# --------------------------------------------------------------------------

def _datasets(g, prefix=''):
    out = {}
    for name, obj in g.members.items():
        if isinstance(obj, Group):
            out.update(_datasets(obj, prefix + name + '/'))
        else:
            out[prefix + name] = obj
    return out


@pytest.mark.parametrize('route', [
    'charge', 'contributor_truth', 'smearing_truth_device',
    'smearing_truth_host', 'charge_grouped', 'smearing_truth_device_grouped'])
def test_clis_agree_with_mod2mod(tmp_path, monkeypatch, route):
    grouped = route.endswith('_grouped')
    route = route.removesuffix('_grouped')
    light = route != 'charge'
    smear = route.startswith('smearing')
    truth_path = route.rpartition('_')[2] if smear else None
    sim = dict(max_light_truth_ids=16 if light else 0)
    if grouped:
        # one batch an event in each module (its two TPCs together), so
        # that a group never holds two batches of one event
        sim['event_batch_size'] = 2
    paths = _paths(tmp_path, light=dict(LIGHT, enable_lut_smearing=smear),
                   sim_overrides=sim)
    n_events = 4 if grouped else 2
    inp = str(tmp_path / 'in.h5')
    assert tpa.write_spills_2x2(inp, _geo(paths).tpc_borders, n_events) > 0
    kw = dict(config='2x2', mod2mod_variation=True,
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=paths['response_file'],
              light_simulated=light,
              light_lut_filename=paths['light_lut_filename'],
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0,
              event_group_size=3 if grouped else 1)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    monkeypatch.setattr(jcli, 'simulate_charge_batch', functools.partial(
        jcharge.simulate_charge_batch, backend='pallas'))
    if truth_path:
        monkeypatch.setenv('LARNDSIM_TRUTH_PATH', truth_path)
        monkeypatch.setattr(jlight, '_TRUTH_PATH_CACHE', [])
    jcli.run_simulation(inp, out_j, truth_compression='none', **kw)
    seen = []

    def fed(rand_seed, i_mod, event, i_subbatch, device):
        seen.append(i_mod)
        return _fed_light_draw(rand_seed, i_mod, event, i_subbatch, device)
    monkeypatch.setattr(tcli, 'light_draw', fed)
    tcli.run_simulation(inp, out_t, device='cpu', **kw,
                        **(dict(truth_path=truth_path) if truth_path else {}))
    assert set(seen) == ({1, 2, 3, 4} if light else set())

    keys_j, assn_j = _data_packets(out_j)
    keys_t, assn_t = _data_packets(out_t)
    matched = sum((collections.Counter(keys_j)
                   & collections.Counter(keys_t)).values())
    assert matched >= 0.99 * max(len(keys_j), len(keys_t))
    by_key_t = dict(zip(keys_t, map(_truth, assn_t)))
    for k, want in zip(keys_j, map(_truth, assn_j)):
        if k in by_key_t:
            got = by_key_t[k]
            # a segment far from the pixel may carry ~1e-11 on one side
            # and nothing on the other
            for seg in set(got) | set(want):
                assert abs(got.get(seg, 0.0) - want.get(seg, 0.0)) <= 1e-4, \
                    (k, got, want)
    # data packets on every module's io groups; module 3 on its own pitch
    assert {k[0] for k in keys_t} == set(range(1, 9))

    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        assert sorted(ft.keys()) == sorted(fj.keys())
        if not light:
            assert 'light_wvfm' not in ft and 'light_dat' not in ft
            return
        tj, tt = np.array(fj['light_trig']), np.array(ft['light_trig'])
        assert tt.dtype == tj.dtype and len(tt) == n_events
        assert tt['op_channel'].shape == (n_events, 24)
        for name in tj.dtype.names:
            np.testing.assert_array_equal(tt[name], tj[name], err_msg=name)

        assert sorted(ft['light_dat'].keys()) == [
            f'light_dat_module{i}' for i in range(4)]
        for i in range(4):
            dj = np.array(fj[f'light_dat/light_dat_module{i}'])
            dt = np.array(ft[f'light_dat/light_dat_module{i}'])
            assert dt.dtype == dj.dtype and dt.shape == dj.shape
            assert dt.shape[1] == 6 and (dt['n_photons_det'] > 0).any()
            np.testing.assert_array_equal(dt['segment_id'],
                                          dj['segment_id'])
            for name in ('n_photons_det', 't0_det'):
                np.testing.assert_allclose(dt[name], dj[name], rtol=2e-6,
                                           atol=1e-5, err_msg=name)

        assert isinstance(ft['light_wvfm'], h5py.Dataset)
        wj, wt = np.array(fj['light_wvfm']), np.array(ft['light_wvfm'])
        assert wt.shape == wj.shape == (n_events, 24, 256)
        assert wt.dtype == wj.dtype
        # every module's channels see light
        assert all(np.abs(wj[:, 6 * m:6 * m + 6]).max() > QUANT
                   for m in range(4))
        d = np.abs(wt.astype(np.float64) - wj)
        assert d.max() <= QUANT and (d == 0).mean() >= 0.999, \
            (d.max(), (d == 0).mean())
        rj = np.array(fj['light_wvfm_mc_assn'])
        rt = np.array(ft['light_wvfm_mc_assn'])
    with File(out_t, 'r') as f:
        names = _datasets(f)
        assert not any('light_wvfm_mod' in n for n in names)
        np.testing.assert_array_equal(np.asarray(names['light_wvfm']), wt)
    assert rt.dtype == rj.dtype and len(rj) > 0
    columns = ('trigger_id', 'op_channel_id', 'tick', 'event_id',
               'segment_id')
    if truth_path:
        assert records_agree(rt, rj, 0.1, keys=columns)['records'] > 100
        return
    for name in columns:
        np.testing.assert_array_equal(rt[name], rj[name], err_msg=name)
    np.testing.assert_allclose(rt['pe_current'], rj['pe_current'],
                               rtol=1e-4, atol=1e-6)


def test_unequal_module_triggers_fail_the_cli(tmp_path):
    """An event that lights one TPC of a module and both of another gives
    the modules unequal trigger counts: the merge refuses them, as JAX's,
    and no output is left."""
    from larndsim_tpu_torch.assets.make_input import write_input
    paths = _paths(tmp_path, light=LIGHT)
    inp = str(tmp_path / 'in.h5')
    # tracks in TPCs 0, 1 and 2: module 1 triggers once, module 2 once
    # and adds a zero row for its empty TPC
    write_input(inp, _geo(paths).tpc_borders, n_events=1,
                tracks_per_event=3, segments_per_track=6,
                segment_length=0.4, dEdx=8.0, seed=2, every_tpc=True)
    out = tmp_path / 'out.h5'
    with pytest.raises(ValueError, match='number of triggers'):
        tcli.run_simulation(
            inp, str(out), config='2x2',
            detector_properties=paths['detector_properties'],
            pixel_layout=paths['pixel_layout'],
            simulation_properties=paths['simulation_properties'],
            response_file=paths['response_file'],
            light_lut_filename=paths['light_lut_filename'],
            light_det_noise_filename=str(tmp_path / 'n.npy'), rand_seed=7,
            step_scale=4.0, device='cpu')
    assert not out.exists()
    assert not any(p.name.endswith('.part') for p in tmp_path.iterdir())


def test_lists_through_the_command_line(tmp_path):
    """The argparse entry point takes the per-module lists and ids as YAML
    lists."""
    paths = _paths(tmp_path, light=False)
    inp = str(tmp_path / 'in.h5')
    tpa.write_spills_2x2(inp, _geo(paths).tpc_borders, n_events=1)
    seen = {}
    orig = tcli.load_detector

    def spy(det, layout, i_module=-1, device='cuda', **kw):
        seen[i_module] = layout if isinstance(layout, str) \
            else layout[i_module - 1]
        return orig(det, layout, i_module=i_module, device=device, **kw)
    lay = paths['pixel_layout']
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcli, 'load_detector', spy)
        tcli.main([inp, str(tmp_path / 'out.h5'), '--device', 'cpu',
                   '--detector_properties', paths['detector_properties'],
                   '--pixel_layout', f'[{lay[0]}, {lay[1]}]',
                   '--pixel_layout_id', '[1, 0, 0, 0]',
                   '--simulation_properties',
                   paths['simulation_properties'],
                   '--response_file', f'[{paths["response_file"][0]}]',
                   '--response_id', '[0, 0, 0, 0]',
                   '--light_simulated', 'false', '--rand_seed', '7',
                   '--step_scale', '4.0'])
    assert seen == {1: lay[1], 2: lay[0], 3: lay[0], 4: lay[0],
                    -1: lay[1]}
    with h5py.File(tmp_path / 'out.h5', 'r') as f:
        assert len(f['packets']) > 0
        # the resolved list, as a fixed-length string
        assert np.bytes_(f['configs'].attrs['pixel_layout']).decode() == \
            str([lay[1], lay[0], lay[0], lay[0]])
