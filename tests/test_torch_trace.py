"""Phase tracing and the memory log of the port (``larndsim_tpu_torch.utils.
trace`` / ``.memlog``) against the JAX package's (``larndsim_tpu.utils``).

The clocks of both trace modules are replaced by one fake clock, so the
tables are exact: self times, thread-CPU times and counts equal to the
hand count (tolerance 0), and ``report()`` equal to JAX's row for row on
the same sequence of phases: wall, CPU and calls, with no device column;
a phase records nothing on a card (its device time comes from the
profiler's trace, tests/test_torch_gpu.py).  The memory log: the same
five fields as JAX's ``FIELDS``, the tables read back through ``io.h5``
and h5py (and JAX's ``read_memlog``) equal to what was stored; the npz
branch; a disabled logger writes nothing; on the CPU the card's columns
are 0.
"""
from __future__ import annotations

import json
import os
import sys
import threading

import h5py
import numpy as np
import pytest

from larndsim_tpu.utils import memlog as jmemlog
from larndsim_tpu.utils import trace as jtrace
from larndsim_tpu_torch.utils import memlog as tmemlog
from larndsim_tpu_torch.utils import trace as ttrace


class FakeClock:
    """``time.perf_counter`` and ``time.thread_time`` that move only when
    the test says so (both by the same step)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        return self.t

    def thread_time(self):
        return self.t / 2

    def advance(self, dt):
        self.t += dt


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (ttrace, jtrace):
        monkeypatch.setattr(mod, 'time', c)
        mod.reset()
    yield c
    for mod in (ttrace, jtrace):
        mod.reset()


def _sequence(trace, clock):
    """export (0.5 s) holding flush (2 s) and drain (0.25 s); charge twice
    (1 s, then 3 s); light once (1.5 s)."""
    with trace.phase('export'):
        clock.advance(0.5)
        with trace.phase('export/flush'):
            clock.advance(2.0)
        with trace.phase('truth/drain'):
            clock.advance(0.25)
    for dt in (1.0, 3.0):
        with trace.phase('charge_batch'):
            clock.advance(dt)
    with trace.phase('light_batch'):
        clock.advance(1.5)


def test_nested_phases_report_self_time(clock):
    _sequence(ttrace, clock)
    assert ttrace.summary() == {
        'export': (0.5, 1), 'export/flush': (2.0, 1),
        'truth/drain': (0.25, 1), 'charge_batch': (4.0, 2),
        'light_batch': (1.5, 1)}
    assert ttrace.summary_total()['export'] == (2.75, 1)
    assert ttrace.summary_cpu() == {
        'export': 0.25, 'export/flush': 1.0, 'truth/drain': 0.125,
        'charge_batch': 2.0, 'light_batch': 0.75}
    # the self times add up to the wall
    assert sum(t for t, _ in ttrace.summary().values()) == clock.t
    # wall, CPU and calls: no device column
    assert [r.split('(')[1] for r in ttrace.report().splitlines()] == [
        '  2.00 s cpu, 2 calls)', '  1.00 s cpu, 1 calls)',
        '  0.75 s cpu, 1 calls)', '  0.25 s cpu, 1 calls)',
        '  0.12 s cpu, 1 calls)']


def test_reset_clears_every_table(clock):
    _sequence(ttrace, clock)
    ttrace.reset()
    assert ttrace.summary() == ttrace.summary_cpu() == {}
    assert ttrace.report() == ''
    with ttrace.phase('charge_batch'):
        clock.advance(1.0)
    assert ttrace.summary() == {'charge_batch': (1.0, 1)}


def test_a_phase_that_raises_is_counted(clock):
    with pytest.raises(RuntimeError):
        with ttrace.phase('charge_batch'):
            clock.advance(1.0)
            raise RuntimeError('batch failed')
    assert ttrace.summary() == {'charge_batch': (1.0, 1)}


def test_report_rows_equal_jax(clock):
    """The same phases in both packages: the same rows (label, seconds,
    cpu, calls), in the same order (by self time, longest first)."""
    for trace in (jtrace, ttrace):
        clock.t = 0.0
        _sequence(trace, clock)
    want, got = jtrace.report(), ttrace.report()
    assert got == want
    assert [r.split()[0] for r in got.splitlines()] == [
        'charge_batch', 'export/flush', 'light_batch', 'export',
        'truth/drain']


def test_two_threads_on_one_label():
    """Phases ending on several threads under one label lose no update:
    counts exact with more threads than cores and a short switch
    interval."""
    ttrace.reset()
    n_threads, n_phases = 2 * (os.cpu_count() or 1) + 2, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_phases):
                with ttrace.phase('truth/worker'):
                    with ttrace.phase('truth/pull'):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = ttrace.summary()
    assert s['truth/worker'][1] == s['truth/pull'][1] == n_threads * n_phases
    assert s['truth/worker'][0] >= 0.0
    ttrace.reset()


def test_phase_on_the_cpu_records_no_device_time(monkeypatch):
    """A phase records nothing on the device it names, on the CPU or on
    the card: no CUDA event, no NVTX range (its device time comes from a
    profiler's trace), and outside a profiler's capture no profiler
    range."""
    import torch
    made = []

    def forbidden(name):
        def record(*args, **kw):
            made.append(name)
        return record
    monkeypatch.setattr(torch.cuda, 'Event', forbidden('Event'))
    monkeypatch.setattr(torch.cuda.nvtx, 'range_push', forbidden('push'))
    monkeypatch.setattr(torch.cuda.nvtx, 'range_pop', forbidden('pop'))
    monkeypatch.setattr(torch.profiler, 'record_function',
                        forbidden('record_function'))
    ttrace.reset()
    for device in ('cpu', 'cuda', torch.device('cuda', 1)):
        with ttrace.phase('charge_batch', device):
            pass
    assert made == []
    assert ttrace.summary()['charge_batch'][1] == 3
    assert 'device' not in ttrace.report()
    ttrace.reset()


def test_start_and_stop_trace_write_a_chrome_trace(tmp_path):
    import torch
    ttrace.reset()
    ttrace.start_trace(str(tmp_path / 'trace'))
    with pytest.raises(RuntimeError, match='already running'):
        ttrace.start_trace(str(tmp_path / 'other'))
    with ttrace.phase('charge/prep'):
        torch.ones(8).sum()
    path = ttrace.stop_trace()
    assert os.path.dirname(path) == str(tmp_path / 'trace')
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert any(e.get('name') == 'charge/prep' for e in events)
    ttrace.reset()


# --------------------------------------------------------------------------
# the memory log
# --------------------------------------------------------------------------

def _log(module, **kw):
    ml = module.MemoryLogger(**kw)
    ml.start()
    ml.take_snapshot()
    ml.take_snapshot()
    ml.archive('loading')
    ml.take_snapshot()
    ml.archive('loop_mod-1')
    return ml


def test_fields_equal_jax():
    assert tmemlog.FIELDS == jmemlog.FIELDS


def test_hdf5_round_trip_through_io_h5_and_h5py(tmp_path):
    from larndsim_tpu_torch.io.h5 import File
    ml = _log(tmemlog, device='cpu')
    out = str(tmp_path / 'mem.h5')
    ml.store(out)
    tables = tmemlog.read_memlog(out)
    assert set(tables) == {'loading', 'loop_mod-1'}
    with h5py.File(out, 'r') as f, File(out, 'r') as g:
        assert set(f.keys()) == set(g.keys()) == set(tables)
        for phase in f:
            rec = np.asarray(f[phase])
            assert rec.dtype.names == tmemlog.FIELDS
            np.testing.assert_array_equal(rec, np.array(g[phase]))
            want = np.array(ml.archive_log[phase], np.float64)
            for i, name in enumerate(tmemlog.FIELDS):
                np.testing.assert_array_equal(rec[name], want[:, i])
    rec = np.asarray(h5py.File(out, 'r')['loading'])
    assert len(rec) == 2 and (rec['time'] >= 0).all()
    assert rec['cpu_mem_peak'].max() > 0
    # the CPU has no card: its columns are 0, as JAX's CPU backend gives
    assert (rec['gpu_mem_used'] == 0).all() and (rec['gpu_mem_free'] == 0).all()
    # JAX's reader reads the port's file, the port's reader JAX's
    assert set(jmemlog.read_memlog(out)) == set(tables)
    jout = str(tmp_path / 'jax.h5')
    _log(jmemlog).store(jout)
    jt = tmemlog.read_memlog(jout)
    assert set(jt) == {'loading', 'loop_mod-1'}
    assert len(jt['loading']) == 2


def test_store_keeps_other_members_and_replaces_a_phase(tmp_path):
    out = str(tmp_path / 'mem.h5')
    _log(tmemlog).store(out)
    ml = tmemlog.MemoryLogger()
    ml.start()
    ml.take_snapshot()
    ml.archive('loading')
    ml.store(out)
    with h5py.File(out, 'r') as f:
        assert set(f.keys()) == {'loading', 'loop_mod-1'}
        assert len(f['loading']) == 1 and len(f['loop_mod-1']) == 1


def test_npz_branch(tmp_path):
    ml = _log(tmemlog)
    out = str(tmp_path / 'mem.npz')
    ml.store(out)
    with np.load(out) as z:
        assert z['loading'].shape == (2, 5)
    tables = tmemlog.read_memlog(out)
    assert len(tables['loop_mod-1']) == 1
    cols = tables['loading']
    names = (list(cols.columns) if hasattr(cols, 'columns')
             else list(cols.dtype.names))
    assert names == list(tmemlog.FIELDS)


def test_disabled_logger_writes_nothing(tmp_path):
    ml = _log(tmemlog, disabled=True)
    assert ml.log == [] and ml.archive_log == {}
    ml.store(str(tmp_path / 'mem.h5'))
    assert not (tmp_path / 'mem.h5').exists()
    _log(tmemlog).store(None)
    assert os.listdir(tmp_path) == []
