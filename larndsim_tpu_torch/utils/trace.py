"""Phase tracing: wall and thread-CPU time per label.

Counterpart of ``larndsim_tpu.utils.trace``: ``phase(label)`` accumulates
the wall time (``time.perf_counter``) and the calling thread's CPU time
(``time.thread_time``) of a block under its label, and marks the block as
a ``torch.profiler.record_function`` range while a profiler runs (in its
trace, where a capture lines the phases up with the card's kernels; with
none running the range would record nothing, and opening it costs more
than the rest of the phase).  A nested phase's
time is its own: the enclosing phase's row reports its *self* time, so the
table sums to the wall.  Phases end on the dispatch thread and on truth
workers under the same labels, so the shared tables are updated under a
lock.  A phase's device time comes from the profiler's trace, never from
the phase itself.

``tally(label, n)`` adds ``n`` (1 by default) to the count under its label
and times nothing: it records no wall or CPU time, opens no profiler
range, and stays out of the phase tables (``summary``, ``report``), so
that no phase's row moves by it; ``tallies()`` reads the counts.

``start_trace`` / ``stop_trace`` capture a ``torch.profiler`` trace of the
CPU and, where there is one, the card, written as a Chrome trace into the
given directory.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

_TIMES: dict[str, float] = defaultdict(float)
_COUNTS: dict[str, int] = defaultdict(int)
_CHILD: dict[str, float] = defaultdict(float)
#: per-label CPU seconds of the calling thread(s) (time.thread_time): a
#: thread's wall time includes waits and time-slicing against other
#: threads, its CPU time only what it computed
_CPU: dict[str, float] = defaultdict(float)
_CHILD_CPU: dict[str, float] = defaultdict(float)
#: label -> count of the count-only entries (``tally``)
_TALLIES: dict[str, int] = defaultdict(int)
_STACK = threading.local()
_ACC_LOCK = threading.Lock()
#: the running torch.profiler capture and its directory
_PROFILE: list = []


@contextlib.contextmanager
def phase(label: str, device=None):
    """Time the block under ``label``.  ``device``, where the block's work
    runs, is taken for the call sites' sake and records nothing."""
    stack = getattr(_STACK, 'frames', None)
    if stack is None:
        stack = _STACK.frames = []
    stack.append(label)
    t0 = time.perf_counter()
    c0 = time.thread_time()
    try:
        with (torch.profiler.record_function(label)
              if torch._C._autograd._profiler_enabled()
              else contextlib.nullcontext()):
            yield
    finally:
        dt = time.perf_counter() - t0
        dc = time.thread_time() - c0
        stack.pop()
        parent = stack[-1] if stack else None
        with _ACC_LOCK:
            _TIMES[label] += dt
            _CPU[label] += dc
            _COUNTS[label] += 1
            if parent is not None:
                _CHILD[parent] += dt
                _CHILD_CPU[parent] += dc


def tally(label: str, n: int = 1) -> None:
    """Add ``n`` to the count under ``label``; no time is taken or
    kept."""
    with _ACC_LOCK:
        _TALLIES[label] += int(n)


def tallies() -> dict[str, int]:
    """label -> count of the count-only entries."""
    with _ACC_LOCK:
        return dict(_TALLIES)


def summary() -> dict[str, tuple[float, int]]:
    """label -> (self_seconds, calls): nested-phase time is subtracted
    from the enclosing phase."""
    with _ACC_LOCK:
        return {k: (_TIMES[k] - _CHILD.get(k, 0.0), _COUNTS[k])
                for k in _TIMES}


def summary_total() -> dict[str, tuple[float, int]]:
    """label -> (total_seconds, calls) including nested phases."""
    with _ACC_LOCK:
        return {k: (_TIMES[k], _COUNTS[k]) for k in _TIMES}


def summary_cpu() -> dict[str, float]:
    """label -> self CPU seconds of the calling thread(s)."""
    with _ACC_LOCK:
        return {k: _CPU[k] - _CHILD_CPU.get(k, 0.0) for k in _CPU}


def reset():
    with _ACC_LOCK:
        for table in (_TIMES, _COUNTS, _CHILD, _CPU, _CHILD_CPU, _TALLIES):
            table.clear()


def report() -> str:
    """One row per label, by self wall time, longest first: self seconds,
    self CPU seconds and calls."""
    cpu = summary_cpu()
    return '\n'.join(
        f'{k:32s} {t:8.2f} s  ({cpu.get(k, 0.0):6.2f} s cpu, {n} calls)'
        for k, (t, n) in sorted(summary().items(), key=lambda kv: -kv[1][0]))


def start_trace(logdir: str):
    """Start a ``torch.profiler`` capture of the CPU and, where there is
    one, the card; :func:`stop_trace` writes it into ``logdir``."""
    if _PROFILE:
        raise RuntimeError('a trace is already running')
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _PROFILE.append((prof, logdir))


def stop_trace() -> str:
    """Stop the capture and write it as a Chrome trace into its
    directory; returns the file's path."""
    prof, logdir = _PROFILE.pop()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f'trace_{os.getpid()}_{time.time_ns()}.json')
    prof.export_chrome_trace(path)
    return path
