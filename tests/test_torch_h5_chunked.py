"""Chunked, filtered and streamed HDF5 in the port (``io/h5.py``,
``io/lzf.py``): files h5py writes read back equal through the port's
reader, files the port writes read back equal through h5py, the light
truth's chunks agree with the JAX package's writers, and both CLIs'
outputs read back through the port.

Tolerance: every dataset equal bit for bit (dtype, shape and bytes).
"""
from __future__ import annotations

import ctypes

import h5py
import numpy as np
import pytest

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.io import export as jexport
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.io import export as texport
from larndsim_tpu_torch.io import h5, lzf

import torch_port_assets as tpa

TRUTH = texport.TRUTH_DTYPE
LIGHT = dict(n_op_channel=12, light_window=(0.0, 2.0))


def _records(n: int, seed: int = 0) -> np.ndarray:
    """Truth-shaped records: small integer columns, pe_current float32
    values held as float64."""
    rng = np.random.default_rng(seed)
    rec = np.zeros(n, TRUTH)
    rec['trigger_id'] = np.sort(rng.integers(0, 4, n))
    rec['op_channel_id'] = rng.integers(0, 96, n)
    rec['tick'] = rng.integers(0, 1000, n)
    rec['event_id'] = 3
    rec['segment_id'] = rng.integers(0, 5000, n)
    rec['pe_current'] = rng.exponential(2.0, n).astype(np.float32)
    return rec


def _waveforms(n: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.round(rng.normal(0, 300, (n, 12, 50)) / 64).astype(
        np.float32) * 64


def _same(got, want, what=''):
    """Equal dtype, shape and bits (field by field: the padding between a
    compound's fields holds no data)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    for name in got.dtype.names or ():
        _same(got[name], want[name], f'{what}.{name}')
    if got.dtype.names is None:
        assert got.tobytes() == want.tobytes(), what


#: name -> (data, create_dataset keywords); each is written by h5py and by
#: the port, and read by the other
CASES = {
    'compound_1d': (_records(1000), dict(chunks=(64,), maxshape=(None,))),
    'float_3d': (_waveforms(9), dict(chunks=(2, 12, 50),
                                     maxshape=(None, 12, 50))),
    'float_3d_edges': (_waveforms(9), dict(chunks=(4, 5, 16))),
    'gzip': (_records(1000), dict(chunks=(100,), compression='gzip')),
    'gzip_shuffle_3d': (_waveforms(9), dict(chunks=(3, 12, 50),
                                            compression=9, shuffle=True)),
    'lzf': (_records(1000), dict(chunks=(128,), compression='lzf')),
    'shuffle_lzf': (_records(5000), dict(chunks=(256,), compression='lzf',
                                         shuffle=True, maxshape=(None,))),
    'shuffle_lzf_3d': (_waveforms(9), dict(chunks=(2, 12, 50),
                                           compression='lzf', shuffle=True)),
    'incompressible_lzf': (np.random.default_rng(5).integers(
        0, 2 ** 63, 700, dtype=np.int64), dict(chunks=(64,),
                                               compression='lzf',
                                               shuffle=True)),
    'partial_last_chunk': (_records(1001), dict(chunks=(300,),
                                                maxshape=(None,))),
    'empty': (np.zeros(0, TRUTH), dict(chunks=(16,), maxshape=(None,))),
    # 4100 chunks: a chunk index of three B-tree levels (64 a node)
    'deep_index': (np.arange(8200, dtype=np.int64), dict(
        chunks=(2,), maxshape=(None,), compression='gzip')),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_port_reads_what_h5py_writes(tmp_path, case):
    data, kw = CASES[case]
    path = str(tmp_path / 'h5py.h5')
    with h5py.File(path, 'w') as f:
        f.create_dataset('x', data=data, **kw)
        f['x'].attrs['n'] = len(data)
        want = f['x'][()]
        n_chunks = f['x'].id.get_num_chunks()
        compression = f['x'].compression
    if case == 'deep_index':
        assert n_chunks == 4100
    ds = h5.File(path, 'r')['x']
    assert ds.chunks == kw['chunks']
    assert ds.compression == compression
    assert ds.shuffle == bool(kw.get('shuffle'))
    assert ds.attrs['n'] == len(data)
    _same(ds, want, case)
    _same(want, data, case)


@pytest.mark.parametrize('case', sorted(CASES))
def test_h5py_reads_what_the_port_writes(tmp_path, case):
    """Written as a first block and appends of uneven sizes (all at once
    where the dataset has no maxshape)."""
    data, kw = CASES[case]
    path = str(tmp_path / 'port.h5')
    rng = np.random.default_rng(len(data))
    with h5.File(path, 'w') as f:
        if 'maxshape' in kw:
            ds = f.create_dataset('x', data=data[:3], **kw)
            i = 3
            while i < len(data):
                n = int(rng.integers(1, max(len(data) // 5, 2)))
                ds.append(data[i:i + n])
                i += n
        else:
            ds = f.create_dataset('x', data=data, **kw)
        ds.attrs['n'] = len(data)
    with h5py.File(path, 'r') as g:
        x = g['x']
        assert x.chunks == kw['chunks']
        assert x.maxshape == kw.get('maxshape', data.shape)
        assert x.shuffle == bool(kw.get('shuffle'))
        assert x.compression == {9: 'gzip'}.get(kw.get('compression'),
                                                  kw.get('compression'))
        assert x.attrs['n'] == len(data)
        full = -(-np.array(data.shape) // np.array(kw['chunks']))
        assert x.id.get_num_chunks() == (int(np.prod(full)) if len(data)
                                         else 0)
        if case == 'incompressible_lzf':
            masks = {x.id.get_chunk_info(i).filter_mask
                     for i in range(x.id.get_num_chunks())}
            assert 2 in masks               # stored shuffled, LZF skipped
        _same(x[()], data, case)
    _same(h5.File(path, 'r')['x'], data, case)


@pytest.mark.parametrize('pipeline', ['native', 'h5py'])
def test_truth_agrees_with_jax_writer(tmp_path, monkeypatch, pipeline):
    """The JAX package's truth writer (its native direct-chunk path, or
    h5py's filter pipeline) and the port's, fed the same appends, give the
    same records in the same layout; each reads back through the other's
    reader."""
    monkeypatch.setattr(jexport, '_H5LZF', None)
    if pipeline == 'h5py':
        monkeypatch.setenv('LARNDSIM_NATIVE_H5LZF', '0')
        assert jexport._native_h5lzf() is None
    else:
        assert jexport._native_h5lzf() is not None
    rec = _records(3 * texport.TRUTH_CHUNK + 1234, seed=2)
    cuts = [0, 10, 40000, 40005, 2 * texport.TRUTH_CHUNK + 40005, len(rec)]
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'port.h5')
    with h5.File(out_t, 'w') as f:
        for a, b in zip(cuts[:-1], cuts[1:]):
            jexport.export_light_truth_to_hdf5(out_j, rec[a:b])
            texport.export_light_truth_to_hdf5(f, rec[a:b])
    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        j, t = fj['light_wvfm_mc_assn'], ft['light_wvfm_mc_assn']
        for attr in ('chunks', 'compression', 'shuffle', 'maxshape'):
            assert getattr(t, attr) == getattr(j, attr), attr
        assert t.chunks == (texport.TRUTH_CHUNK,) and t.compression == 'lzf'
        _same(t[()], j[()])
        _same(j[()], rec)
    _same(h5.File(out_j, 'r')['light_wvfm_mc_assn'], rec)


def test_codec_equals_jax_native_encoder():
    """The port's copy of the encoder writes the JAX native library's
    streams byte for byte; its decoder inverts them."""
    jlib = jexport._native_h5lzf()
    assert jlib is not None
    rec = _records(2 * texport.TRUTH_CHUNK, seed=4)
    cb = texport.TRUTH_CHUNK * TRUTH.itemsize
    raw = rec.view(np.uint8).reshape(2, cb)
    streams, sizes, skipped = lzf.encode_chunks(raw, TRUTH.itemsize)
    j_out = np.empty_like(raw)
    j_sizes = (ctypes.c_int32 * 2)()
    j_flags = (ctypes.c_uint8 * 2)()
    scratch = np.empty(cb, np.uint8)
    jlib.shuffle_lzf_chunks(raw.ctypes.data, 2, cb, TRUTH.itemsize,
                            scratch.ctypes.data, j_out.ctypes.data,
                            j_sizes, j_flags)
    for i in range(2):
        assert sizes[i] == j_sizes[i] and skipped[i] == j_flags[i] == 0
        assert streams[i, :sizes[i]].tobytes() == \
            j_out[i, :sizes[i]].tobytes()
        _same(lzf.decode(streams[i, :sizes[i]], cb, TRUTH.itemsize), raw[i])
    with pytest.raises(OSError, match='corrupt'):
        lzf.decode(streams[0, :sizes[0] - 7], cb, TRUTH.itemsize)


@pytest.mark.parametrize('rec,n', [(32, 300), (32, 1024), (4, 777),
                                   (12, 50), (1, 64)])
def test_shuffles_agree(rec, n):
    """The C++ shuffle of the LZF pipeline (``lzf_core.h``; its AVX-512
    path for 32-byte records where the host has it) and the numpy shuffle
    of the other pipelines give the same bytes, and so do their inverses,
    bytes after the last whole record included."""
    raw = np.random.default_rng(rec * n).integers(0, 256, (1, rec * n),
                                                  dtype=np.uint8)
    streams, sizes, skipped = lzf.encode_chunks(raw, rec)
    assert skipped[0] == 1 and sizes[0] == raw.size   # stored shuffled only
    _same(streams[0], h5._shuffle(raw[0], rec))
    _same(streams[0], raw[0].reshape(n, rec).T.reshape(-1))
    tail = np.concatenate([streams[0], raw[0, :rec - 1]])
    _same(lzf.decode(tail, tail.size, rec, skip_lzf=True),
          h5._unshuffle(tail, rec))
    _same(h5._unshuffle(streams[0], rec), raw[0])


def test_streamed_tail_stays_under_two_chunks(tmp_path):
    """Appends of less than a chunk each, through ``append`` and through
    resize + write: the rows kept in memory (and their buffer) stay under
    two chunks while dozens of chunks go to the file."""
    chunk = 1000
    rec = _records(60 * chunk + 17, seed=6)
    path = str(tmp_path / 'tail.h5')
    rng = np.random.default_rng(6)
    with h5.File(path, 'w') as f:
        a = f.create_dataset('a', shape=(0,), dtype=TRUTH, maxshape=(None,),
                             chunks=(chunk,), compression='lzf',
                             shuffle=True)
        b = f.create_dataset('b', shape=(0,), dtype=TRUTH, maxshape=(None,),
                             chunks=(chunk,))
        i = 0
        while i < len(rec):
            n = int(rng.integers(1, chunk))
            a.append(rec[i:i + n])
            n0 = len(b)
            b.resize(n0 + len(rec[i:i + n]))
            b[n0:] = rec[i:i + n]
            i += n
            for ds in (a, b):
                assert len(ds._tail) < chunk
                assert len(ds._buf) <= 2 * chunk
                assert ds._done == len(ds) // chunk * chunk
        assert len(a._index) == len(b._index) == len(rec) // chunk
        # one block of many chunks goes to the file without the buffer
        a.append(rec[:10 * chunk])
        assert len(a._buf) <= 2 * chunk
        _same(a[-5:], rec[10 * chunk - 5:10 * chunk])
    with h5py.File(path, 'r') as g:
        _same(g['a'][()], np.concatenate([rec, rec[:10 * chunk]]))
        _same(g['b'][()], rec)


def test_rows_on_disk_cannot_change(tmp_path):
    """Writing into, or shrinking below, committed chunks raises and leaves
    the file whole; rows after them are written and read as usual."""
    x = np.arange(25, dtype=np.int32)
    path = str(tmp_path / 'c.h5')
    with h5.File(path, 'w') as f:
        ds = f.create_dataset('x', data=x, maxshape=(None,), chunks=(10,),
                              compression='gzip')
        assert ds._done == 20
        with pytest.raises(ValueError, match='already written'):
            ds[5] = -1
        with pytest.raises(ValueError, match='already written'):
            ds[15:22] = -1
        with pytest.raises(ValueError, match='cannot shrink'):
            ds.resize(15)
        ds[20:] = -x[20:]
        ds.resize(23)
        ds.resize(27)
        assert ds[3] == 3 and ds[12] == 12      # read back from the file
        _same(ds[20:], np.r_[-x[20:23], [0] * 4].astype(np.int32))
        want = np.asarray(ds).copy()
    with h5py.File(path, 'r') as g:
        _same(g['x'][()], want)


def test_file_modes_and_group_size(tmp_path):
    """Modes other than 'r' and 'w' are refused; a group of more members
    than the writer puts in one raises with its name."""
    with pytest.raises(ValueError, match="mode 'a' is not supported"):
        h5.File(str(tmp_path / 'a.h5'), 'a')
    f = h5.File(str(tmp_path / 'big.h5'), 'w')
    for i in range(65):
        f.create_dataset(f'runs/r{i}', data=np.arange(3))
    with pytest.raises(NotImplementedError, match="group '/runs' has 65"):
        f.close()


def test_rewriting_a_file_being_read(tmp_path):
    """A file opened for writing replaces the path: a File still reading
    the old one decodes its datasets after that (the memory log's
    update)."""
    path = str(tmp_path / 'm.h5')
    rec = _records(500, seed=8)
    with h5.File(path, 'w') as f:
        f.create_dataset('old', data=rec, maxshape=(None,), chunks=(64,),
                         compression='lzf', shuffle=True)
    old = h5.File(path, 'r')
    f = h5.File(path, 'w')
    f.members, f.attrs = old.members, old.attrs
    f.create_dataset('new', data=np.arange(4))
    f.close()
    with h5py.File(path, 'r') as g:
        _same(g['old'][()], rec)
        _same(g['new'][()], np.arange(4))


def test_failed_write_keeps_the_earlier_file(tmp_path):
    """A write that fails (in its ``with`` block, or at close) removes its
    partial file and leaves the file already at the path whole; one never
    closed stays at its partial path, and the path still holds the old
    file."""
    path = str(tmp_path / 'o.h5')
    rec = _records(700, seed=9)
    with h5.File(path, 'w') as f:
        f.create_dataset('old', data=rec, maxshape=(None,), chunks=(64,),
                         compression='lzf', shuffle=True)
    before = open(path, 'rb').read()
    with pytest.raises(RuntimeError, match='a failing run'):
        with h5.File(path, 'w') as f:
            ds = f.create_dataset('x', data=rec[:10], maxshape=(None,),
                                  chunks=(64,), compression='lzf',
                                  shuffle=True)
            ds.append(rec)                      # chunks streamed to disk
            raise RuntimeError('a failing run')
    f = h5.File(path, 'w')
    for i in range(65):
        f.create_dataset(f'runs/r{i}', data=np.arange(3))
    with pytest.raises(NotImplementedError, match="group '/runs' has 65"):
        f.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == ['o.h5']
    f = h5.File(path, 'w')
    f.create_dataset('x', data=rec, maxshape=(None,), chunks=(64,))
    assert (tmp_path / h5.partial_path('o.h5')).exists()
    assert open(path, 'rb').read() == before
    f.discard()
    assert sorted(p.name for p in tmp_path.iterdir()) == ['o.h5']
    with h5py.File(path, 'r') as g:
        assert list(g) == ['old']
        _same(g['old'][()], rec)


def test_failed_cli_run_leaves_no_output(tmp_path, monkeypatch):
    """A port CLI run that fails after it began its output leaves no file,
    partial or not; a run onto an existing output refuses it and leaves it
    as it was."""
    paths, inp, kw = _light_run(tmp_path)
    out = tmp_path / 'cli.h5'

    def fail(*args, **kwargs):
        raise RuntimeError('a failing truth write')
    monkeypatch.setattr(texport, 'export_light_truth_to_hdf5', fail)
    with pytest.raises(RuntimeError, match='a failing truth write'):
        tcli.run_simulation(inp, str(out), config='module0', device='cpu',
                            **kw)
    assert not out.exists()
    assert not [p for p in tmp_path.iterdir() if p.suffix == '.part']
    out.write_bytes(b'an earlier output')
    with pytest.raises(FileExistsError):
        tcli.run_simulation(inp, str(out), config='module0', device='cpu',
                            **kw)
    assert out.read_bytes() == b'an earlier output'


def test_lzf_build_failure_raises(tmp_path, monkeypatch):
    """No LZF without its codec: a codec that does not build fails the
    truth write and the CLI up front; 'none' still writes."""
    broken = tmp_path / 'h5lzf.cpp'
    broken.write_text('this is not C++\n')
    monkeypatch.setattr(lzf, '_LIB', None)
    monkeypatch.setattr(lzf, 'SOURCES', [str(broken)])
    monkeypatch.setattr(lzf, 'BUILD_DIR', str(tmp_path / 'build'))
    rec = _records(100)
    with h5.File(str(tmp_path / 't.h5'), 'w') as f:
        with pytest.raises(RuntimeError, match='failed to build'):
            texport.export_light_truth_to_hdf5(f, rec)
        assert 'light_wvfm_mc_assn' not in f
        texport.export_light_truth_to_hdf5(f, rec, compression='none')
    _same(h5py.File(str(tmp_path / 't.h5'))['light_wvfm_mc_assn'][()], rec)
    paths, inp, kw = _light_run(tmp_path)
    out = tmp_path / 'cli.h5'
    with pytest.raises(RuntimeError, match='failed to build'):
        tcli.run_simulation(inp, str(out), config='module0', device='cpu',
                            **kw)
    assert not out.exists()


def _light_run(tmp_path):
    """The small tree with beam light and contributor truth (K 16), and an
    input with tracks in the light window."""
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET,
                           light=dict(LIGHT, enable_lut_smearing=False),
                           sim_overrides=dict(max_light_truth_ids=16))
    dm = tpa.load_jax(paths)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, dm.tpc_borders, n_events=2, tracks_per_event=3,
                       segments_per_track=6, segment_length=0.4, dEdx=8.0,
                       seed=7) > 0
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0)
    return paths, inp, kw


def _datasets(g, prefix=''):
    """name -> h5py dataset, every dataset under ``g``."""
    out = {}
    for name, obj in g.items():
        if isinstance(obj, h5py.Dataset):
            out[prefix + name] = obj
        else:
            out.update(_datasets(obj, prefix + name + '/'))
    return out


def test_jax_cli_output_reads_through_the_port(tmp_path):
    """The JAX CLI's output (appended datasets chunked, truth shuffle+LZF)
    reads through the port's reader equal to h5py's reading."""
    paths, inp, kw = _light_run(tmp_path)
    out = str(tmp_path / 'jax.h5')
    jcli.run_simulation(inp, out, config='module0', truth_compression='lzf',
                        **kw)
    port = h5.File(out, 'r')
    with h5py.File(out, 'r') as g:
        sets = _datasets(g)
        assert g['light_wvfm_mc_assn'].compression == 'lzf'
        assert len(g['light_wvfm_mc_assn']) > 0
        assert g['packets'].chunks is not None
        for name, ds in sets.items():
            _same(port[name], ds[()], name)


def test_port_cli_truth_lzf_equals_none(tmp_path):
    """The port CLI with truth_compression 'lzf' and 'none' writes equal
    datasets (h5py's reading and the port's); only the truth's storage
    differs."""
    paths, inp, kw = _light_run(tmp_path)
    outs = {}
    for comp in ('lzf', 'none'):
        outs[comp] = str(tmp_path / f'{comp}.h5')
        tcli.run_simulation(inp, outs[comp], config='module0', device='cpu',
                            truth_compression=comp, **kw)
    with h5py.File(outs['lzf'], 'r') as a, h5py.File(outs['none'], 'r') as b:
        sa, sb = _datasets(a), _datasets(b)
        assert sorted(sa) == sorted(sb)
        assert a['light_wvfm_mc_assn'].compression == 'lzf'
        assert b['light_wvfm_mc_assn'].compression is None
        assert len(a['light_wvfm_mc_assn']) > 0
        for name in sa:
            _same(sa[name][()], sb[name][()], name)
            _same(h5.File(outs['lzf'], 'r')[name], sb[name][()], name)


def test_slice_run_in_its_own_process(tmp_path):
    """``tools/slice_run.py`` runs the CLI in a process of its own (after a
    warm-up of the first event) and reports the run; its output equals the
    same run in this process."""
    from larndsim_tpu_torch.tools import slice_run
    paths, inp, kw = _light_run(tmp_path)
    kw = dict(kw, config='module0', device='cpu')
    res = slice_run.run(slice_run._ROOT, inp, str(tmp_path / 'sub.h5'), kw)
    assert res['wall'] > 0 and res['phases']['truth/h5'] > 0
    assert res["peak_rss_gib"] >= res["rss_before_gib"] > 0
    assert res["process_peak_rss_gib"] >= res["peak_rss_gib"]
    assert res['file_bytes'] == (tmp_path / 'sub.h5').stat().st_size
    assert res['calls'] == []               # beam light: no mode-0 call
    tcli.run_simulation(inp, str(tmp_path / 'here.h5'), **kw)
    with h5py.File(tmp_path / 'sub.h5') as a, \
            h5py.File(tmp_path / 'here.h5') as b:
        sa, sb = _datasets(a), _datasets(b)
        assert sorted(sa) == sorted(sb)
        for name in sa:
            _same(sa[name][()], sb[name][()], name)
