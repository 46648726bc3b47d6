"""The port's HDF5 module (``larndsim_tpu_torch.io.h5``) and its copies of
the JAX package's h5py-based I/O.

The port reads and writes HDF5 with its own numpy implementation, on every
machine.  Here h5py reads what it writes, it reads what h5py writes
(chunked datasets too; tests/test_torch_h5_chunked.py has the filters),
and the CLI's output copied through h5py reads back equal.  Tolerance:
every array and attribute equal.
"""
from __future__ import annotations

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets import make_input as jinput
from larndsim_tpu.io import edep as jedep
from larndsim_tpu.io import larpix_packets as jlp
from larndsim_tpu_torch.assets import make_input as tinput
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.io import edep as tedep
from larndsim_tpu_torch.io import h5
from larndsim_tpu_torch.io import larpix_packets as tlp

import torch_port_assets as tpa

ASSN = np.dtype([('event_ids', '(1,)i8'), ('segment_ids', '(20,)i8'),
                 ('fraction', '(20,)f8')])


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    seg = np.zeros(37, jinput.SEGMENTS_DTYPE)
    for name in seg.dtype.names:
        seg[name] = rng.integers(0, 100, len(seg))
    traj = np.zeros(5, jinput.TRAJECTORIES_DTYPE)
    traj['primary'] = [True, False, True, True, False]
    traj['pxyz_start'] = rng.normal(size=(5, 3))
    assn = np.zeros(7, ASSN)
    assn['segment_ids'] = rng.integers(-1, 9, (7, 20))
    assn['fraction'] = rng.random((7, 20))
    pk = tlp.make_data_packets([1] * 11, [2] * 11, [11] * 11, range(11),
                               rng.integers(0, 2 ** 31, 11), [77] * 11)
    return dict(segments=seg, trajectories=traj, mc_packets_assn=assn,
                packets=pk)


def test_written_file_reads_in_h5py(tmp_path):
    tables = _tables()
    path = str(tmp_path / 'lite.h5')
    with h5.File(path, 'w') as f:
        for name, data in tables.items():
            f.create_dataset(name, data=data[:4], maxshape=(None,))
            f[name].resize(len(data), axis=0)
            f[name][4:] = data[4:]
        f['segments'].attrs['zbeam'] = True
        f.create_group('_header').attrs['version'] = '2.4'
        f['_header'].attrs['created'] = 0.0
        f.create_dataset('light_dat/grid', data=np.arange(12.0).reshape(3, 4))
        f.create_dataset('empty', data=np.zeros(0, tlp.PACKET_DTYPE))
        for i in range(40):                  # many members in one group
            f.create_dataset(f'n{i:02d}', data=np.arange(i, dtype='i2'))
        f.attrs['vector'] = np.arange(3, dtype='u4')
    with h5py.File(path, 'r') as f:
        for name, data in tables.items():
            got = np.array(f[name])
            assert got.dtype == data.dtype, name
            np.testing.assert_array_equal(got, data, err_msg=name)
        assert f['segments'].attrs['zbeam'] == True  # noqa: E712
        assert f['_header'].attrs['version'] == b'2.4'
        assert f['_header'].attrs['created'] == 0.0
        np.testing.assert_array_equal(f['light_dat/grid'],
                                      np.arange(12.0).reshape(3, 4))
        assert f['empty'].shape == (0,)
        for i in range(40):
            np.testing.assert_array_equal(f[f'n{i:02d}'], np.arange(i))
        np.testing.assert_array_equal(f.attrs['vector'], np.arange(3))
    # and reads back through itself, also after h5py has appended to it
    with h5py.File(path, 'a') as f:
        f.create_dataset('added', data=np.arange(4))
        f.create_group('configs').attrs['vdrift'] = 0.16
    back = h5.File(path, 'r')
    for name, data in tables.items():
        np.testing.assert_array_equal(np.array(back[name]), data)
    np.testing.assert_array_equal(np.array(back['added']), np.arange(4))
    assert back['configs'].attrs['vdrift'] == 0.16
    assert back['_header'].attrs['version'] == '2.4'
    back['packets'].resize(len(tables['packets']) + 2, axis=0)
    np.testing.assert_array_equal(np.array(back['packets'])[-2:],
                                  np.zeros(2, tlp.PACKET_DTYPE))


def test_reads_h5py_file(tmp_path):
    tables = _tables(1)
    path = str(tmp_path / 'ref.h5')
    with h5py.File(path, 'w') as f:
        for name, data in tables.items():
            f.create_dataset(name, data=data)
        f.create_group('configs').attrs['drift'] = 30.27
    got = h5.File(path, 'r')
    for name, data in tables.items():
        np.testing.assert_array_equal(np.array(got[name]), data)
        assert got[name].dtype == data.dtype
    assert got['configs'].attrs['drift'] == 30.27
    with h5py.File(str(tmp_path / 'chunked.h5'), 'w') as f:
        f.create_dataset('packets', data=tables['packets'], maxshape=(None,))
    got = h5.File(str(tmp_path / 'chunked.h5'), 'r')
    np.testing.assert_array_equal(np.array(got['packets']), tables['packets'])
    assert got['packets'].maxshape == (None,)
    # a layout this reader does not take still raises
    with h5py.File(str(tmp_path / 'latest.h5'), 'w', libver='latest') as f:
        f.create_dataset('packets', data=tables['packets'], maxshape=(None,))
    with pytest.raises(NotImplementedError):
        h5.File(str(tmp_path / 'latest.h5'), 'r')


def test_packet_makers_equal():
    rng = np.random.default_rng(2)
    cols = [rng.integers(0, 250, 50) for _ in range(4)]
    ts, adc = rng.integers(0, 2 ** 40, 50), rng.integers(0, 256, 50)
    np.testing.assert_array_equal(tlp.make_data_packets(*cols, ts, adc),
                                  jlp.make_data_packets(*cols, ts, adc))
    for fn in ('make_timestamp_packets', 'make_sync_packets',
               'make_trigger_packets'):
        args = (ts,) if fn == 'make_timestamp_packets' else (ts, 2)
        np.testing.assert_array_equal(getattr(tlp, fn)(*args),
                                      getattr(jlp, fn)(*args), err_msg=fn)


def test_input_writer_and_loader_equal(tmp_path):
    borders = tpa.load_jax(tpa.write_tree(tmp_path / 'tree')).tpc_borders
    kw = dict(n_events=3, tracks_per_event=4, segments_per_track=5, seed=8,
              is_spill=False)
    for a, b in zip(tinput.make_tracks(borders, **kw),
                    jinput.make_tracks(borders, **kw)):
        np.testing.assert_array_equal(a, b)
    tinput.write_input(str(tmp_path / 'lite.h5'), borders, **kw)
    jinput.write_input(str(tmp_path / 'ref.h5'), borders, **kw)
    for name in ('segments', 'trajectories', 'vertices'):
        with h5py.File(str(tmp_path / 'lite.h5'), 'r') as a, \
                h5py.File(str(tmp_path / 'ref.h5'), 'r') as b:
            np.testing.assert_array_equal(np.array(a[name]),
                                          np.array(b[name]), err_msg=name)
    load_kw = dict(n_events=2, is_spill_sim=False)
    got = tedep.load_edep(str(tmp_path / 'lite.h5'), **load_kw)
    want = jedep.load_edep(str(tmp_path / 'ref.h5'), **load_kw)
    for name in ('tracks', 'segment_ids', 'trajectory_ids', 'trajectories',
                 'vertices'):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def _copy_through_h5py(src, dst):
    """Every group, dataset and attribute of ``src`` into ``dst`` (h5py)."""
    dst.attrs.update(src.attrs)
    for name, obj in src.items():
        if isinstance(obj, h5py.Dataset):
            dst.create_dataset(name, data=np.array(obj))
            dst[name].attrs.update(obj.attrs)
        else:
            _copy_through_h5py(obj, dst.create_group(name))


def _assert_same_attrs(a, b, where):
    assert sorted(a.attrs) == sorted(b.attrs), where
    for key in a.attrs:
        np.testing.assert_array_equal(a.attrs[key], b.attrs[key],
                                      err_msg=f'{where}.{key}')


def _assert_same_tree(a, b, where='/'):
    assert sorted(a.keys()) == sorted(b.keys()), where
    _assert_same_attrs(a, b, where)
    for name in a.keys():
        x, y = a[name], b[name]
        if isinstance(x, h5.Dataset):
            assert x.dtype == y.dtype, where + name
            np.testing.assert_array_equal(x.data, y.data,
                                          err_msg=where + name)
            _assert_same_attrs(x, y, where + name)
        else:
            _assert_same_tree(x, y, where + name + '/')


def test_cli_files_equal_through_either_writer(tmp_path):
    """The CLI's output file (this module's writer), copied object by
    object through h5py's writer, reads back equal; h5py reads the CLI's
    file as this module does."""
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    inp = str(tmp_path / 'in.h5')
    tinput.write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                       tracks_per_event=3, segments_per_track=6,
                       segment_length=0.4, dEdx=8.0, seed=2)
    tcli.run_simulation(
        inp, str(tmp_path / 'lite.h5'), config='module0',
        detector_properties=paths['detector_properties'],
        pixel_layout=paths['pixel_layout'],
        simulation_properties=paths['simulation_properties'],
        response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
        step_scale=4.0, device='cpu')
    with h5py.File(str(tmp_path / 'lite.h5'), 'r') as a, \
            h5py.File(str(tmp_path / 'h5py.h5'), 'w') as b:
        _copy_through_h5py(a, b)
    lite = h5.File(str(tmp_path / 'lite.h5'), 'r')
    _assert_same_tree(lite, h5.File(str(tmp_path / 'h5py.h5'), 'r'))
    assert len(lite['packets']) == len(lite['mc_packets_assn']) > 0
    assert 'pixel_layout' in lite['configs'].attrs
    with h5py.File(str(tmp_path / 'lite.h5'), 'r') as f:
        for name in lite.keys():
            if isinstance(lite[name], h5.Dataset):
                np.testing.assert_array_equal(np.array(f[name]),
                                              lite[name].data, err_msg=name)


def test_light_exports_equal_and_read_in_h5py(tmp_path):
    """The light writers against the JAX package's (light_trig with its
    (96,) op_channel member array, waveforms appended over two flushes,
    truth records): h5py reads the port's file back equal."""
    from larndsim_tpu.io import export as jexport
    from larndsim_tpu.params import load_light as jload_light
    from larndsim_tpu.params import load_sim as jload_sim
    from larndsim_tpu_torch.io import export as texport
    from larndsim_tpu_torch.params import load_light, load_sim
    paths = tpa.write_tree(tmp_path / 'tree', light=True)
    jdm, tdm = tpa.load_jax(paths), tpa.load_port(paths)
    jl = jload_light(paths['detector_properties'])
    tl = load_light(paths['detector_properties'], device='cpu')
    js = jload_sim(paths['simulation_properties'])
    ts = load_sim(paths['simulation_properties'])
    rng = np.random.default_rng(5)
    ev = np.array([0, 1, 3])
    times = np.array([0.0, 1.2e6, 3.6e6])
    op = np.arange(96)
    wv = [rng.normal(size=(2, 96, 256)).astype('f4'), np.zeros((1, 96, 256))]
    sparse = dict(trig=np.array([0, 0, 1], np.int32),
                  op_channel=np.array([3, 50, 95], np.int32),
                  tick=np.array([100, 101, 7], np.int32),
                  segment_id=np.array([11, 12, 40]), pe_current=rng.random(3))
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'torch.h5')
    jexport.export_light_trig_to_hdf5(ev, np.zeros(3), np.zeros(3, int), op,
                                      out_j, times, jdm, jl)
    for rows, w in zip((ev[:2], ev[2:]), wv):
        jexport.export_light_wvfm_to_hdf5(rows, w, out_j, js, jl)
    jexport.export_light_truth_to_hdf5(
        out_j, jexport.truth_sparse_to_records(sparse, 3, 5),
        compression='none')
    with h5.File(out_t, 'w') as f:
        texport.export_light_trig_to_hdf5(ev, np.zeros(3), np.zeros(3, int),
                                          op, f, times, tdm, tl)
        for rows, w in zip((ev[:2], ev[2:]), wv):
            texport.export_light_wvfm_to_hdf5(rows, w, f, ts, tl)
        texport.export_light_truth_to_hdf5(
            f, texport.truth_sparse_to_records(sparse, 3, 5))
    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        for name in ('light_trig', 'light_wvfm', 'light_wvfm_mc_assn'):
            want, got = np.array(fj[name]), np.array(ft[name])
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert ft['light_trig'].dtype['op_channel'].shape == (96,)
        np.testing.assert_array_equal(ft['light_trig']['op_channel'][2], op)
        assert ft['light_wvfm'].dtype == np.float32


def test_appends_grow_in_place(tmp_path):
    """A dataset appended to in many pieces (the truth records of a run)
    holds the pieces in order, new rows zero, shrinks and regrows with
    zeros, and its buffer at least doubles, so each append copies a
    bounded share of the rows; h5py reads what was written."""
    rng = np.random.default_rng(3)
    pieces = [rng.integers(0, 100, (int(n), 3)).astype(np.int32)
              for n in rng.integers(1, 50, 40)]
    f = h5.File(tmp_path / 'a.h5', 'w')
    ds = f.create_dataset('x', data=pieces[0], maxshape=(None, 3))
    grows = 0
    for p in pieces[1:]:
        n0, buf = len(ds), ds._buf
        ds.resize(n0 + len(p), axis=0)
        assert (ds[n0:] == 0).all()
        ds[n0:] = p
        grows += ds._buf is not buf
    assert grows <= 8
    want = np.concatenate(pieces)
    np.testing.assert_array_equal(np.asarray(ds), want)
    ds.resize(5)
    ds.resize(9)
    np.testing.assert_array_equal(ds[:5], want[:5])
    assert (ds[5:] == 0).all()
    f.close()
    with h5py.File(tmp_path / 'a.h5', 'r') as g:
        np.testing.assert_array_equal(g['x'][:5], want[:5])
        assert g['x'].shape == (9, 3)
