"""Phase tracing: wall, thread-CPU and device time per label.

Counterpart of ``larndsim_tpu.utils.trace``: ``phase(label)`` accumulates
the wall time (``time.perf_counter``) and the calling thread's CPU time
(``time.thread_time``) of a block under its label, and marks the block as
a ``torch.profiler.record_function`` range (in the profiler's trace).  A
nested phase's time is its own: the enclosing phase's row reports its
*self* time, so the table sums to the wall.  Phases end on the dispatch
thread and on truth workers under the same labels, so the shared tables
are updated under a lock.

With ``device`` a CUDA device, the block is also an NVTX range, and a pair
of CUDA events (``enable_timing``) is recorded on the device's current
stream at its ends.  Nothing waits for them: :func:`summary_device` reads
them after one ``torch.cuda.synchronize()``, when :func:`report` prints the
table.  The device time of a phase is its stream's span between the two
events (idle gaps on the stream included), minus its nested phases' spans.

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
#: per-label device milliseconds read from finished event pairs
_DEVICE: dict[str, float] = defaultdict(float)
_CHILD_DEVICE: dict[str, float] = defaultdict(float)
#: (label, enclosing label or None, start event, end event) not read yet
_EVENTS: list = []
#: event pairs kept before the finished ones are read in
_EVENTS_FOLD_AT = 4096
_STACK = threading.local()
_ACC_LOCK = threading.Lock()
#: the running torch.profiler capture and its directory
_PROFILE: list = []


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == 'cuda'


def _fold(wait: bool) -> None:
    """Add the pending event pairs' device times into the tables: every
    pair after one synchronize (``wait``), else those already done.  The
    caller holds the lock."""
    if wait and _EVENTS:
        torch.cuda.synchronize()
    keep = []
    for label, parent, start, end in _EVENTS:
        if not wait and not end.query():
            keep.append((label, parent, start, end))
            continue
        ms = start.elapsed_time(end)
        _DEVICE[label] += ms
        if parent is not None:
            _CHILD_DEVICE[parent] += ms
    _EVENTS[:] = keep


@contextlib.contextmanager
def phase(label: str, device=None):
    """Time the block under ``label``; with ``device`` a CUDA device, also
    its span on the device's current stream."""
    stack = getattr(_STACK, 'frames', None)
    if stack is None:
        stack = _STACK.frames = []
    on_card = _on_card(device)
    stack.append(label)
    if on_card:
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        torch.cuda.nvtx.range_push(label)
    t0 = time.perf_counter()
    c0 = time.thread_time()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        dt = time.perf_counter() - t0
        dc = time.thread_time() - c0
        if on_card:
            torch.cuda.nvtx.range_pop()
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
        stack.pop()
        parent = stack[-1] if stack else None
        with _ACC_LOCK:
            _TIMES[label] += dt
            _CPU[label] += dc
            _COUNTS[label] += 1
            if parent is not None:
                _CHILD[parent] += dt
                _CHILD_CPU[parent] += dc
            if on_card:
                _EVENTS.append((label, parent, start, end))
                if len(_EVENTS) >= _EVENTS_FOLD_AT:
                    _fold(wait=False)


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


def summary_device() -> dict[str, float]:
    """label -> self device milliseconds, for the labels timed on a card;
    waits once for the card when events are pending."""
    with _ACC_LOCK:
        _fold(wait=True)
        return {k: _DEVICE[k] - _CHILD_DEVICE.get(k, 0.0) for k in _DEVICE}


def reset():
    with _ACC_LOCK:
        for table in (_TIMES, _COUNTS, _CHILD, _CPU, _CHILD_CPU, _DEVICE,
                      _CHILD_DEVICE):
            table.clear()
        _EVENTS.clear()


def report() -> str:
    """One row per label, by self wall time, longest first: self seconds,
    self CPU seconds, self device milliseconds (labels timed on a card
    only) and calls."""
    cpu = summary_cpu()
    dev = summary_device()

    def row(k, t, n):
        ms = f'{dev[k]:9.3f} ms device, ' if k in dev else ''
        return (f'{k:32s} {t:8.2f} s  ({cpu.get(k, 0.0):6.2f} s cpu, '
                f'{ms}{n} calls)')
    return '\n'.join(row(k, t, n) for k, (t, n) in sorted(
        summary().items(), key=lambda kv: -kv[1][0]))


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
