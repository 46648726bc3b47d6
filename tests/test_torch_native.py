"""The port's host libraries (``csrc/host``, ``utils/host_build.py``) on
the CPU: the light truth's record emitter and the batch assigner.

The emitter (``models/truth_emit.records``): its records equal, byte for
byte, the port's numpy version (``records_plain``) and both emitters of
the JAX package (``_emit_truth_native`` and its numpy path), on seeded
values with values at the threshold and one float32 ULP either side,
empty channels, no record at all, two triggers, and four threads emitting
at once.  The record layout is ``io.export.TRUTH_DTYPE``, packed in 32
bytes.

The assigner (``utils/batching.assign_groups``): equal to the port's
numpy version (``assign_groups_plain``) and to JAX's ``assign_groups``
and ``_assign_groups_numpy`` on seeded segments, with points on the TPC
borders and one ULP inside, segments outside every TPC, and ND-LAr's 70
TPCs at ``tpc_batch_size`` 1, 2 and 4.

A library that does not build raises, in a direct call and on the CLI's
production path; eight threads that load a library at once build it once.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import pytest

from larndsim_tpu.io import export as jexport
from larndsim_tpu.models import light as jlight
from larndsim_tpu.utils import batching_native as jbatching
from larndsim_tpu_torch.assets.geometry import write_ndlar
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.io.export import TRUTH_DTYPE
from larndsim_tpu_torch.models import truth_emit
from larndsim_tpu_torch.params import load_detector
from larndsim_tpu_torch.utils import batching, host_build

import torch_port_assets as tpa
from test_torch_ndev import _module0, _together

THRESHOLD = 0.1


# --------------------------------------------------------------------------
# the truth emitter
# --------------------------------------------------------------------------

def _truth_case(case: str, seed: int = 7):
    """(res, rows, ids, op_channel, C, K) of one trigger: C channels of K
    contributors, ``rows`` the active ones (c * K + k, ascending)."""
    rng = np.random.default_rng(seed)
    C, K, S = 6, 8, 96
    if case == 'empty_channels':
        # channels 0, 2 and 5 have no active row
        pool = [c * K + k for c in (1, 3, 4) for k in range(K)]
        rows = np.sort(rng.choice(pool, size=14, replace=False))
    else:
        rows = np.sort(rng.choice(C * K, size=25, replace=False))
    res = rng.normal(0, 0.3, (rows.size, S)).astype(np.float32)
    res[rng.random(res.shape) < 0.5] *= 1e-3          # many below threshold
    if case == 'threshold_ulp':
        thr = np.float32(THRESHOLD)
        edge = np.array([thr, np.nextafter(thr, np.float32(1)),
                         np.nextafter(thr, np.float32(0))], np.float32)
        n = res.size // 2
        res.reshape(-1)[:n] = np.resize(np.concatenate([edge, -edge]), n)
    if case == 'suppressed':
        res *= np.float32(1e-6)
    ids = rng.integers(0, 10 ** 9, (C, K)).astype(np.int64)
    op_channel = (np.arange(C) * 5 + 2).astype(np.int64)
    return res, rows, ids, op_channel, C, K


def _port_args(res, rows, ids, op_channel, C, K):
    rows_k = (rows % K).astype(np.int32)
    c_starts = np.searchsorted(rows // K, np.arange(C + 1))
    return res, rows_k, c_starts, op_channel, ids, THRESHOLD


def _jax_records(res, rows, ids, op_channel, C, K, event_id, trigger_id,
                 native: bool):
    """JAX's emitter: its native library, or its numpy path."""
    with pytest.MonkeyPatch.context() as mp:
        if native:
            assert jlight._truth_emit_lib() is not None
        else:
            mp.setattr(jlight, '_TRUTH_EMIT_LIB', (None,))
        out = jlight._emit_truth(res, rows, ids, op_channel, C, K,
                                 THRESHOLD, True, res.shape[1],
                                 lambda n: None, None, event_id=event_id,
                                 trigger_id=trigger_id)
    return np.array(out)


def test_truth_dtype_is_the_emitters_layout():
    """The C emitter writes packed 32-byte records at these offsets, as
    the JAX package's TRUTH_DTYPE holds them."""
    assert TRUTH_DTYPE.itemsize == 32
    assert {k: TRUTH_DTYPE.fields[k][1] for k in TRUTH_DTYPE.names} == dict(
        trigger_id=0, op_channel_id=4, tick=8, event_id=12, segment_id=16,
        pe_current=24)
    assert TRUTH_DTYPE == jexport.TRUTH_DTYPE


@pytest.mark.parametrize('case', ['random', 'threshold_ulp',
                                  'empty_channels', 'suppressed',
                                  'two_triggers'])
def test_emitter_equals_plain_and_jax(case):
    args = _truth_case(case)
    res = args[0]
    triggers = (0, 1) if case == 'two_triggers' else (3,)
    got, plain, jnat, jnum = [], [], [], []
    for i, t in enumerate(triggers):
        # a second trigger's values differ from the first's
        a = (res * np.float32(1 + i),) + args[1:]
        got.append(truth_emit.records(*_port_args(*a), event_id=11,
                                      trigger_id=t))
        plain.append(truth_emit.records_plain(*_port_args(*a), event_id=11,
                                              trigger_id=t))
        for native, out in ((True, jnat), (False, jnum)):
            out.append(_jax_records(*a, event_id=11, trigger_id=t,
                                    native=native))
    got, plain, jnat, jnum = (np.concatenate(x) for x in
                              (got, plain, jnat, jnum))
    assert got.dtype == TRUTH_DTYPE
    for other in (plain, jnat, jnum):
        assert other.dtype == got.dtype
        assert other.tobytes() == got.tobytes()
    if case == 'suppressed':
        assert len(got) == 0
        return
    assert len(got) > 0
    assert (got['event_id'] == 11).all()
    assert sorted(set(got['trigger_id'].tolist())) == list(triggers)
    assert (np.abs(got['pe_current']) > np.float32(THRESHOLD)).all()
    if case == 'threshold_ulp':
        # the value at the threshold is dropped, one ULP above it kept
        thr = np.float32(THRESHOLD)
        kept = set(np.abs(got['pe_current']).astype(np.float32).tolist())
        assert float(np.nextafter(thr, np.float32(1))) in kept
        assert float(thr) not in kept
        # in float64, the float32 threshold is above 0.1: numpy's weak
        # Python float compares in float32
        assert float(thr) > THRESHOLD
    if case == 'empty_channels':
        ch = set(got['op_channel_id'].tolist())
        assert ch <= {7, 17, 22} and len(ch) > 1


def test_emitter_from_four_threads():
    """Four threads emit at once (the call releases the GIL): each one's
    records equal the numpy version's of its own values."""
    cases = [_truth_case('random', seed=s) for s in range(4)]
    want = [truth_emit.records_plain(*_port_args(*c), event_id=i)
            for i, c in enumerate(cases)]
    barrier = threading.Barrier(4)
    got = [None] * 4

    def emit(i):
        barrier.wait()
        for _ in range(20):
            got[i] = truth_emit.records(*_port_args(*cases[i]), event_id=i)
    threads = [threading.Thread(target=emit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes() and len(g) > 0


def test_emitter_checks_its_inputs():
    res, rows, ids, op_channel, C, K = _truth_case('random')
    args = list(_port_args(res, rows, ids, op_channel, C, K))
    with pytest.raises(TypeError, match='float32'):
        truth_emit.records(res.astype(np.float64), *args[1:])
    bad = args[1].copy()
    bad[0] = K
    with pytest.raises(ValueError, match='inconsistent'):
        truth_emit.records(res, bad, *args[2:])
    with pytest.raises(ValueError, match='inconsistent'):
        truth_emit.records(res[:-1], *args[1:])


# --------------------------------------------------------------------------
# the batch assigner
# --------------------------------------------------------------------------

COORDS = ('x_start', 'y_start', 'z_start', 'x_end', 'y_end', 'z_end')


def _tracks(borders, n, seed, dtype='f4'):
    rng = np.random.default_rng(seed)
    tr = np.zeros(n, [(f, dtype) for f in COORDS] + [('event_id', 'i8')])
    lo = borders.min(axis=(0, 2)) - 5
    hi = borders.max(axis=(0, 2)) + 5
    for i, ax in enumerate('xyz'):
        tr[f'{ax}_start'] = rng.uniform(lo[i], hi[i], n)
        tr[f'{ax}_end'] = rng.uniform(lo[i], hi[i], n)
    tr['event_id'] = rng.integers(0, 4, n)
    return tr


def _on_borders(tracks, borders, seed):
    """Every other segment's start and end put on a TPC's border (each
    coordinate: the border, or one float32 ULP inside or outside it), the
    other coordinates inside that TPC."""
    rng = np.random.default_rng(seed)
    b = np.sort(borders, axis=-1)
    for i in range(0, len(tracks), 2):
        t = rng.integers(len(b))
        for sfx in ('_start', '_end'):
            for a, ax in enumerate('xyz'):
                lo, hi = b[t, a].astype(np.float32)
                v = rng.choice([lo, hi, (lo + hi) / 2])
                v = rng.choice([v, np.nextafter(v, np.float32(np.inf)),
                                np.nextafter(v, np.float32(-np.inf))])
                tracks[ax + sfx][i] = v
    return tracks


def _small_borders(tmp_path):
    return tpa.load_port(tpa.write_tree(tmp_path)).tpc_borders


@pytest.fixture(scope='module')
def ndlar_borders(tmp_path_factory):
    paths = write_ndlar(str(tmp_path_factory.mktemp('ndlar')))
    return load_detector(paths['detector_properties'], paths['pixel_layout'],
                         device='cpu').tpc_borders


@pytest.mark.parametrize('case', ['random', 'on_borders', 'outside',
                                  'float32_borders'])
@pytest.mark.parametrize('tpc_batch_size', [1, 2])
def test_assigner_equals_plain_and_jax(tmp_path, case, tpc_batch_size):
    borders = _small_borders(tmp_path)
    if case == 'float32_borders':
        # borders a float32 point can lie exactly on
        borders = borders.astype(np.float32).astype(np.float64)
    tracks = _tracks(borders, 600, seed=3)
    if case in ('on_borders', 'float32_borders'):
        tracks = _on_borders(tracks, borders, seed=4)
    if case == 'outside':
        tracks['x_start'][::3] = tracks['x_end'][::3] = 1e4
    _assert_assigners_agree(tracks, borders, tpc_batch_size)


@pytest.mark.parametrize('tpc_batch_size', [1, 2, 4])
def test_assigner_on_ndlar(ndlar_borders, tpc_batch_size):
    """ND-LAr's 70 TPCs: segments over the whole detector, a third of them
    on borders."""
    tracks = _tracks(ndlar_borders, 3000, seed=5)
    tracks[:1000] = _on_borders(tracks[:1000], ndlar_borders, seed=6)
    groups = _assert_assigners_agree(tracks, ndlar_borders, tpc_batch_size)
    n_groups = -(-70 // tpc_batch_size)
    assert len(set(groups[groups >= 0].tolist())) > n_groups // 2


def _assert_assigners_agree(tracks, borders, tpc_batch_size):
    got = batching.assign_groups(tracks, borders, tpc_batch_size)
    assert got.dtype == np.int32
    plain = batching.assign_groups_plain(tracks, borders, tpc_batch_size)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(
        got, jbatching.assign_groups(tracks, borders, tpc_batch_size))
    b = np.sort(np.asarray(borders, np.float64), axis=-1)
    gop = (np.arange(len(b)) // tpc_batch_size).astype(np.int32)
    np.testing.assert_array_equal(
        got, jbatching._assign_groups_numpy(tracks, b, gop, gop.max() + 1))
    # inside some TPC, and outside every TPC, both occur
    assert (got >= 0).any() and (got == -1).any()
    return got


def test_assigner_on_float64_fields(tmp_path):
    """float64 coordinates compare as numpy compares them (the library
    takes float64, which float32 fields widen to exactly)."""
    borders = _small_borders(tmp_path)
    tracks = _on_borders(_tracks(borders, 600, seed=8, dtype='f8'), borders,
                         seed=9)
    for sfx in ('_start', '_end'):
        tracks['x' + sfx][1::4] = np.sort(borders, axis=-1)[0, 0, 1]
    got = batching.assign_groups(tracks, borders, 1)
    np.testing.assert_array_equal(
        got, batching.assign_groups_plain(tracks, borders, 1))
    b = np.sort(borders, axis=-1)
    gop = np.arange(len(b)).astype(np.int32)
    np.testing.assert_array_equal(
        got, jbatching._assign_groups_numpy(tracks, b, gop, len(b)))
    with pytest.raises(ValueError, match='tpc_batch_size 0'):
        batching.assign_groups(tracks, borders, 0)


# --------------------------------------------------------------------------
# the builds
# --------------------------------------------------------------------------

LIBRARIES = {'truth_emit': truth_emit, 'batcher': batching}


@pytest.mark.parametrize('name', sorted(LIBRARIES))
def test_failed_build_raises(tmp_path, monkeypatch, name):
    """A library that does not build raises, and the CLI fails with it up
    front (no numpy fallback): the host truth route needs the emitter,
    every run the assigner."""
    mod = LIBRARIES[name]
    broken = tmp_path / os.path.basename(mod.SOURCES[0])
    broken.write_text('this is not C++\n')
    monkeypatch.setattr(mod, '_LIB', None)
    monkeypatch.setattr(mod, 'SOURCES', [str(broken)])
    monkeypatch.setattr(mod, 'BUILD_DIR', str(tmp_path / 'build'))
    with pytest.raises(RuntimeError, match='failed to build'):
        mod.library()
    inp, kw = _module0(tmp_path, 'beam_host')
    out = tmp_path / 'out.h5'
    with pytest.raises(RuntimeError, match='failed to build'):
        tcli.run_simulation(inp, str(out), **kw)
    assert not out.exists()
    assert not [p for p in os.listdir(tmp_path / 'build')
                if p.endswith('.tmp')]


@pytest.mark.parametrize('name', sorted(LIBRARIES))
def test_library_builds_once_under_threads(tmp_path, monkeypatch, name):
    """Eight threads load a library at once from an empty build directory:
    one build, one library, no temporary file left."""
    mod = LIBRARIES[name]
    monkeypatch.setattr(mod, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(mod, '_LIB', None)
    libs = _together(8, mod.library)
    assert all(lib is libs[0] for lib in libs)
    assert os.listdir(tmp_path / 'build') == [os.path.basename(
        host_build.library_path(name, mod.SOURCES, mod.BUILD_DIR,
                                host_build.compiler()))]
