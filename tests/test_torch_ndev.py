"""Multi-device dispatch of the port (``n_devices``), on the CPU.

Several dispatch contexts share the CPU device here, as the JAX tests give
the JAX CLI XLA's 8 virtual host devices (tests/conftest.py).  The port's
CLI at ``n_devices`` 1 and 3 on the small Module-0 tree at
``event_group_size`` 2 (charge only; beam light with the LUT-smearing
truth by its device and its host route; the threshold trigger, mode 0),
also with a ``unique_guard`` that closes groups: every dataset equal bit
for bit (``tools.file_check``), and the groups computed on the contexts'
threads (the 2x2 tree: tests/test_torch_ndev_2x2.py); a context's error
fails the run.  Also: the write gate's order under concurrent submits,
device resolution and its clamp, the thread-safety repairs (the two
libraries' builds, the launch counts, the memory log), and
``parallel.mesh``: the grid's charge step equals each cell's
``charge_step`` bit for bit, and ``charge_step`` agrees with JAX's on the
CPU (unique pixels, track map, hit counts, ticks and ADC equal; current
fractions at rtol 1e-5 / atol 1e-6 for >= 99% of entries and within 1e-3
for all: the two chains' induced currents are two implementations that
agree at atol 2e-5 x peak, tests/test_torch_current.py, and a fraction
divides such currents; JAX's ``charge_step`` takes its XLA current).
"""
from __future__ import annotations

import functools
import os
import random
import sys
import threading
import time

import h5py
import numpy as np
import pytest
import torch

from larndsim_tpu.assets.make_input import write_input
from larndsim_tpu.cli import simulate_pixels as jcli
from larndsim_tpu.models import charge as jcharge
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.cli.simulate_pixels import unique_pixel_bound
from larndsim_tpu_torch.io import lzf
from larndsim_tpu_torch.kernels import binding, build
from larndsim_tpu_torch.models import charge as tcharge
from larndsim_tpu_torch.parallel import devices as pdev
from larndsim_tpu_torch.parallel import mesh as tmesh
from larndsim_tpu_torch.tools.file_check import differences
from larndsim_tpu_torch.utils.memlog import MemoryLogger

import torch_port_assets as tpa
from test_torch_charge import jax_draw

LIGHT = dict(n_op_channel=12, light_window=(0.0, 2.0))
INPUT = dict(n_events=5, tracks_per_event=3, segments_per_track=6,
             segment_length=0.4, dEdx=8.0, seed=7)


# --------------------------------------------------------------------------
# the write gate and device resolution
# --------------------------------------------------------------------------

def test_write_gate_keeps_module_order():
    """Three modules submit at once, each from several threads in turn;
    the gates open in module order as each module's writers end: the
    writes land module by module, each module's in its own order."""
    landed, n = [], 200
    gates = [tcli._WriteGate(open_now=p == 0) for p in range(3)]

    def module(p):
        rng = random.Random(p)
        for i in range(n):
            gates[p].submit(functools.partial(landed.append, (p, i)))
            if rng.random() < 0.05:
                time.sleep(0.001)

    threads = [threading.Thread(target=module, args=(p,)) for p in range(3)]
    for t in threads:
        t.start()
    for p, t in enumerate(threads):
        t.join()
        if p + 1 < 3:
            gates[p + 1].open()
    assert landed == [(p, i) for p in range(3) for i in range(n)]


def test_write_gate_open_drains_before_later_submits():
    """A submit racing with open() lands after every queued write."""
    gate, landed = tcli._WriteGate(), []
    for i in range(100):
        gate.submit(functools.partial(landed.append, i))
    late = threading.Thread(target=lambda: [gate.submit(
        functools.partial(landed.append, 100 + i)) for i in range(100)])
    late.start()
    gate.open()
    late.join()
    assert landed[:100] == list(range(100))
    assert sorted(landed) == list(range(200))
    assert landed[100:] == list(range(100, 200))


def _fake_cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: count > 0)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: count)


def test_resolve_devices(monkeypatch):
    cpu = torch.device('cpu')
    assert pdev.resolve_devices('cpu', 3) == [cpu] * 3
    assert pdev.resolve_devices('cpu', 0) == [cpu]
    _fake_cards(monkeypatch, 2)
    cards = [torch.device('cuda', 0), torch.device('cuda', 1)]
    assert pdev.resolve_devices('cuda', 2) == cards
    assert pdev.resolve_devices('cuda', 1) == cards[:1]
    with pytest.warns(UserWarning) as rec:
        assert pdev.resolve_devices('cuda', 4) == cards
    assert [str(w.message) for w in rec] == [
        'n_devices=4 > available 2; clamping']
    # a list as given, repeats allowed, its first n_devices
    assert pdev.resolve_devices(['cuda:0'] * 4, 2) == [cards[0]] * 2
    assert pdev.resolve_devices(['cuda', 'cuda:1', 'cuda:0'], 3) == [
        cards[0], cards[1], cards[0]]
    with pytest.warns(UserWarning, match='n_devices=6 > available 4'):
        assert pdev.resolve_devices(['cuda:0'] * 4, 6) == [cards[0]] * 4
    with pytest.warns(UserWarning, match='n_devices=2 > available 1'):
        assert pdev.resolve_devices('cuda:1', 2) == [cards[1]]
    assert pdev.module_devices(list(range(8)), 4) == [[0, 1], [2, 3],
                                                      [4, 5], [6, 7]]
    assert pdev.module_devices(list(range(3)), 4) == [[0], [1], [2], [0]]
    assert pdev.module_devices(list(range(6)), 4) == [[0], [1, 2], [3],
                                                      [4, 5]]


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    _fake_cards(monkeypatch, 0)
    for device in ('cuda', 'cuda:0', ['cuda:0', 'cuda:0']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pdev.resolve_devices(device, 2)
    inp = tmp_path / 'in.h5'
    inp.write_bytes(b'')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tcli.run_simulation(str(inp), str(tmp_path / 'out.h5'),
                            device='cuda', n_devices=2)


def test_n_devices_follows_event_group_size():
    """JAX's flag name and place in the signature (and the CLI's)."""
    import inspect
    names = list(inspect.signature(tcli.run_simulation).parameters)
    jnames = list(inspect.signature(jcli.run_simulation).parameters)
    assert names.index('n_devices') == names.index('event_group_size') + 1
    assert jnames.index('n_devices') == jnames.index('event_group_size') + 1


# --------------------------------------------------------------------------
# the port's CLI at several n_devices
# --------------------------------------------------------------------------

def _module0(tmp_path, case):
    light, sim, kw = False, {}, {}
    if case.startswith('beam'):
        light = dict(LIGHT, enable_lut_smearing=True)
        sim = dict(max_light_truth_ids=16)
        kw['truth_path'] = case.rpartition('_')[2]
    elif case == 'mode0':
        light = dict(LIGHT, light_trig_mode=0)
        sim = dict(max_light_truth_ids=16, event_batch_size=2)
    paths = tpa.write_tree(tmp_path / 'tree', light=light,
                           sim_overrides=sim)
    inp = str(tmp_path / 'in.h5')
    assert write_input(inp, tpa.load_jax(paths).tpc_borders, **INPUT) > 0
    kw.update(config='module0',
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'),
              light_lut_filename=str(tmp_path / '__missing__.npz'),
              light_det_noise_filename=str(tmp_path / '__missing__.npy'),
              rand_seed=7, step_scale=2.0, event_group_size=2,
              device='cpu')
    return inp, kw


def _spy_charge(monkeypatch):
    """Each charge call's thread name and unique-pixel count, and its
    rows' bound (``unique_pixel_bound``)."""
    calls = []

    def spy(segs, det_model, *args, host_segs=None, event_slot=None,
            **kwargs):
        res = tcharge.simulate_charge_batch(
            segs, det_model, *args, host_segs=host_segs,
            event_slot=event_slot, **kwargs)
        calls.append((threading.current_thread().name, res.n_unique,
                      unique_pixel_bound(host_segs, event_slot, det_model)))
        return res
    monkeypatch.setattr(tcli, 'simulate_charge_batch', spy)
    return calls


def _runs(tmp_path, monkeypatch, inp, kw, ns):
    """The CLI at each n_devices of ``ns``: {n: (output, charge calls)}."""
    out = {}
    for n in ns:
        calls = _spy_charge(monkeypatch)
        path = str(tmp_path / f'n{n}.h5')
        tcli.run_simulation(inp, path, n_devices=n, **kw)
        out[n] = (path, calls)
    return out


@pytest.mark.parametrize('case', ['charge', 'beam_device', 'beam_host',
                                  'mode0'])
def test_cli_same_datasets_for_any_n_devices(tmp_path, monkeypatch, case):
    inp, kw = _module0(tmp_path, case)
    runs = _runs(tmp_path, monkeypatch, inp, kw, (1, 3))
    assert differences(runs[1][0], runs[3][0]) == []
    names = [c[0] for c in runs[3][1]]
    # round-robin over three contexts, each on its own thread
    assert sorted(set(names)) == [f'dispatch-ctx{k}_0' for k in range(3)]
    assert len(names) == len(runs[1][1]) >= 3
    assert all(c[0] == 'MainThread' for c in runs[1][1])
    with h5py.File(runs[3][0], 'r') as f:
        assert (np.array(f['packets'])['packet_type'] == 0).sum() > 0
        if case != 'charge':
            assert len(f['light_wvfm']) > 0
            assert len(f['light_wvfm_mc_assn']) > 0


def test_unique_guard_binds_alike_for_any_n_devices(tmp_path, monkeypatch):
    """A guard small enough to close groups: the same groups, and the same
    file, with one context and with three (where the outstanding groups'
    bounds make the guard wait for them); every call's bound holds its
    unique pixels."""
    inp, kw = _module0(tmp_path, 'charge')
    kw['event_group_size'] = 3
    (tmp_path / 'free').mkdir()
    free = _runs(tmp_path / 'free', monkeypatch, inp,
                 dict(kw, unique_guard=0), (1,))[1][1]
    waits = []
    orig = tcli.unique_pixel_bound
    monkeypatch.setattr(tcli, 'unique_pixel_bound',
                        lambda *a: waits.append(1) or orig(*a))
    runs = _runs(tmp_path, monkeypatch, inp, dict(kw, unique_guard=60),
                 (1, 3))
    assert differences(runs[1][0], runs[3][0]) == []
    guarded = runs[1][1]
    # the guard closed groups: more, smaller calls than without it
    assert len(guarded) > len(free)
    assert sorted(c[1] for c in runs[3][1]) == sorted(c[1] for c in guarded)
    assert waits, 'the outstanding groups were never bounded'
    for _, n_unique, bound in guarded + free:
        assert 0 < n_unique <= bound


def test_context_error_fails_the_run(tmp_path, monkeypatch):
    """A group's charge call fails on its context's thread: the run raises
    that error on the module's thread, ends its contexts' threads and
    leaves no output."""
    inp, kw = _module0(tmp_path, 'charge')
    calls = []

    def failing(*args, **kwargs):
        calls.append(threading.current_thread().name)
        if len(calls) == 2:
            raise RuntimeError('group 2 failed')
        return tcharge.simulate_charge_batch(*args, **kwargs)
    monkeypatch.setattr(tcli, 'simulate_charge_batch', failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match='group 2 failed'):
        tcli.run_simulation(inp, str(tmp_path / 'out.h5'), n_devices=3,
                            **kw)
    assert calls[1].startswith('dispatch-ctx1')
    assert not [p for p in os.listdir(tmp_path) if p.startswith('out.h5')]
    assert threading.active_count() == before


# --------------------------------------------------------------------------
# the thread-safety repairs
# --------------------------------------------------------------------------

def _together(n, fn):
    """``fn()`` on ``n`` threads released at once, switching among them
    as often as the interpreter lets them: their results."""
    barrier = threading.Barrier(n)
    out, errors = [None] * n, []

    def run(i):
        barrier.wait()
        try:
            out[i] = fn()
        except BaseException as exc:
            errors.append(exc)
    threads = [threading.Thread(target=run, args=(i,), name=f'worker-{i}')
               for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    return out


def test_lzf_library_builds_once_under_threads(tmp_path, monkeypatch):
    """Eight threads load the LZF codec at once from an empty build
    directory: one build, one library, no temporary file left."""
    monkeypatch.setattr(lzf, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(lzf, '_LIB', None)
    libs = _together(8, lzf.library)
    assert all(lib is libs[0] for lib in libs)
    assert [p for p in os.listdir(tmp_path / 'build')] == [
        os.path.basename(lzf.library_path(lzf._compiler()))]
    raw = np.tile(np.arange(64, dtype=np.uint8), (2, 64))
    streams, sizes, skipped = lzf.encode_chunks(raw, 4)
    assert sizes.shape == (2,) and not skipped.all()


def test_kernel_library_builds_once_under_threads(tmp_path, monkeypatch):
    """Eight threads load the kernels' library at once from an empty build
    directory, with a stand-in nvcc (the host C++ compiler, slowed): one
    build, one library, no object or temporary file left."""
    fake = tmp_path / 'nvcc'
    fake.write_text(
        '#!/bin/sh\n'
        'sleep 0.2\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo "int k(void){return 7;}" | c++ -x c -fPIC -shared - -o "$2"\n')
    fake.chmod(0o755)
    runs = []
    monkeypatch.setattr(build, '_nvcc', lambda: runs.append(1) or str(fake))
    monkeypatch.setattr(build, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(build, '_LIB', None)
    libs = _together(8, build.load)
    assert all(lib is libs[0] for lib in libs) and len(runs) == 1
    assert os.listdir(tmp_path / 'build') == [
        os.path.basename(build.library_path())]
    assert libs[0].k() == 7


def test_launch_counts_under_threads(monkeypatch):
    monkeypatch.setattr(binding, 'launches', dict(binding.launches))
    binding.reset_launches()

    def count():
        for _ in range(20000):
            binding._count('fee_fsm')
    _together(8, count)
    assert binding.launches['fee_fsm'] == 8 * 20000


def test_memlog_snapshots_under_threads():
    """Six threads take snapshots while a seventh archives phases: every
    snapshot lands in exactly one phase."""
    log = MemoryLogger()
    done = threading.Event()
    archived = []

    def work():
        if threading.current_thread().name.endswith('-0'):
            while not done.is_set() or log.log:
                archived.append(f'phase{len(archived)}')
                log.archive(archived[-1])
        else:
            for _ in range(20000):
                log.take_snapshot()
            finished.append(1)
            if len(finished) == 6:
                done.set()

    finished = []
    _together(7, work)
    assert sum(len(log.archive_log[p]) for p in archived) == 6 * 20000


# --------------------------------------------------------------------------
# parallel.mesh
# --------------------------------------------------------------------------

@pytest.fixture(scope='module')
def step_batch(tmp_path_factory):
    """Drifted segment batches of the small tree, four of them, the
    shapes of one charge step for all, and modules 1 and 2 of the 2x2
    tree (their own lifetimes and response bins, one layout)."""
    from larndsim_tpu_torch.ops import current
    from larndsim_tpu_torch.ops.drift import drift
    from larndsim_tpu_torch.ops.quench import quench
    from larndsim_tpu_torch.params import load_detector, physics
    from larndsim_tpu_torch.segments import from_structured, to_structured
    from larndsim_tpu.assets.response import make_response
    tmp = tmp_path_factory.mktemp('mesh')
    tree = tpa.write_tree(tmp / 'tree')
    jm, tm = tpa.load_jax(tree), tpa.load_port(tree)
    det = tm.params
    batches = []
    for seed in range(4):
        tracks = tpa.detector_tracks(jm.tpc_borders, seed=seed + 5,
                                     tracks_per_event=2)
        segs = drift(quench(from_structured(tracks, pad_to=32,
                                            device='cpu'),
                            det, physics.BIRKS), det)
        batches.append(to_structured(segs, dtype=tracks.dtype))
    cat = np.concatenate(batches)
    band = current.host_shift_band({k: cat[k] for k in cat.dtype.names},
                                   det, mc_smear=True)
    n_t = int(round(det.f32('time_window') / det.f32('response_sampling')))
    response = make_response(n_xy=45, n_t=n_t,
                             bin_size=det.f32('response_bin_size'),
                             pixel_pitch=det.f32('pixel_pitch'))
    paths = tpa.write_tree_2x2(tmp / 'tree_2x2')
    layouts = [paths['pixel_layout'][i] for i in (0, 0, 1, 0)]
    mods = [load_detector(paths['detector_properties'], layouts,
                          i_module=m, device='cpu').params
            for m in (1, 2, 3)]
    shapes = dict(max_active=16, radius=2, max_nb=64, t_sig=256,
                  n_steps=32, n_unique_cap=128, max_adc=10, max_tracks=8)
    return dict(jm=jm, tm=tm, batches=batches, band=band, shapes=shapes,
                response=response, mods=mods)


def test_make_mesh_follows_jax():
    import jax
    from larndsim_tpu.parallel import mesh as jmesh
    for n, m in [(8, 4), (6, 4), (4, 2), (3, 2), (8, 1), (1, 4), (5, 4)]:
        want = jmesh.make_mesh(n, m, devices=jax.devices())
        got = tmesh.make_mesh(n, m, devices=['cpu'] * 8)
        assert (got.shape['modules'], got.shape['events']) == \
            want.devices.shape, (n, m)
        assert got.axis_names == want.axis_names
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=[])


def test_stack_module_params(step_batch):
    m1, m2, m3 = step_batch['mods']
    stack = tmesh.stack_module_params([m1, m2])
    assert stack.electron_lifetime.shape == (2,)
    assert stack.tpc_borders.shape == (2,) + tuple(m1.tpc_borders.shape)
    for m, p in enumerate((m1, m2)):
        row = tmesh.module_params(stack, m, 'cpu')
        for k in ('electron_lifetime', 'response_bin_size', 'tpc_borders'):
            assert torch.equal(getattr(row, k), getattr(p, k)), k
        assert sorted(row.host) == sorted(p.host)
        assert all(np.array_equal(row.host[k], p.host[k]) for k in p.host)
    # module 3's tiles have another pixel count: no shared step
    with pytest.raises(ValueError, match='n_pixels'):
        tmesh.stack_module_params([m1, m3])


def _gen_draw(seed):
    gen = torch.Generator().manual_seed(seed)
    return tcharge.generator_draw(gen, 'cpu')


def test_sharded_charge_step_equals_each_cell(step_batch):
    """A 2 x 2 grid of CPU contexts (two modules' params, two event
    shares): each cell's outputs equal ``charge_step`` run alone on its
    module's params and batch, bit for bit; the hit total is their sum."""
    s = step_batch
    # the small tree's geometry, a module of short electron lifetime
    dets = [s['tm'].params.replace(electron_lifetime=t)
            for t in (2.2e3, 20.0)]
    mesh = tmesh.make_mesh(4, 2, devices=['cpu'] * 4)
    assert mesh.shape == {'modules': 2, 'events': 2}
    step = tmesh.make_sharded_charge_step(
        mesh, tmesh.stack_module_params(dets),
        torch.from_numpy(s['response']), shift_band=s['band'],
        **s['shapes'])
    grid = tmesh.shard_segments(s['batches'], mesh, pad_to=32)
    adc, uniq, frac, n_hits = step(grid, [[_gen_draw(2 * m + e) for e in
                                           range(2)] for m in range(2)])
    total = 0
    for m in range(2):
        for e in range(2):
            segs = tmesh.shard_segments(s['batches'][2 * m + e:2 * m + e + 1],
                                        tmesh.make_mesh(1, devices=['cpu']),
                                        pad_to=32)[0][0]
            want = tcharge.charge_step(
                segs, dets[m], torch.from_numpy(s['response']),
                _gen_draw(2 * m + e), shift_band=s['band'], **s['shapes'])
            assert torch.equal(adc[m][e], want[2]), (m, e)
            assert torch.equal(uniq[m][e], want[0]), (m, e)
            assert torch.equal(frac[m][e], want[4]), (m, e)
            total += int((want[3].n_adc > 0).sum())
    assert n_hits == total > 0
    # the two modules' lifetimes give other charge
    assert not torch.equal(adc[0][0], adc[1][0]) or not torch.equal(
        adc[0][1], adc[1][1])


def test_charge_step_agrees_with_jax(step_batch):
    """JAX's ``charge_step`` (with its XLA induced current, the one its jit
    takes) and the port's, with the same draws."""
    import jax
    from larndsim_tpu import segments as jseg
    from larndsim_tpu_torch.segments import from_structured
    s = step_batch
    batch = s['batches'][0]
    jdet = s['jm'].params
    band = s['band']
    key = jax.random.PRNGKey(3)
    want = jcharge.charge_step(jseg.from_structured(batch, pad_to=32), jdet,
                               jax.numpy.asarray(s['response']), key,
                               **s['shapes'])
    got = tcharge.charge_step(from_structured(batch, pad_to=32,
                                              device='cpu'),
                              s['tm'].params, torch.from_numpy(s['response']),
                              jax_draw(key), shift_band=band, **s['shapes'])
    uniq, n_unique, adc, fee_res, frac, track_map, overflow = got
    assert int(n_unique) == int(want[1]) > 0
    for name, g, w in (('uniq', uniq, want[0]), ('adc', adc, want[2]),
                       ('track_map', track_map, want[5]),
                       ('overflow', overflow, want[6]),
                       ('n_adc', fee_res.n_adc, want[3].n_adc),
                       ('ticks', fee_res.ticks, want[3].ticks)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert (fee_res.n_adc > 0).sum() > 0
    f, fw = frac.numpy(), np.asarray(want[4])
    assert np.isclose(f, fw, rtol=1e-5, atol=1e-6).mean() >= 0.99
    np.testing.assert_allclose(f, fw, atol=1e-3)
