"""The traced run's reduction of a ``torch.profiler`` capture.

The profiler records the card's activity alone (``ProfilerActivity.CUDA``:
recording every host op as well slowed the 2x2's calls by 70% on the
card).  The host's side comes from the harness: the window's bounds and
every phase of the port (``utils/trace.py``'s ``phase``, wrapped) as
``time.time_ns()`` ranges, moved onto the profiler's clock by the offset
of one marker kernel (:data:`MARKER`, launched on an idle card) from the
host time of its launch.  From the raw events
(``kineto_results.events()``, read in memory, never written out):

- ``busy_s``: the union of the device's kernel, copy and set intervals
  inside the window, leaving out the harness's own stream (the one the
  second marker ran on, where K1's work is counted); ``window_s`` the
  window's length;
- ``kernel_s``: device seconds by kernel name, and ``device_ops`` the ten
  names that took most;
- ``idle_gaps``: the device's idle time inside the window split by the
  innermost phase open on the window's thread (``cli`` where none is), the
  ten that took most.
"""
from __future__ import annotations

from collections import defaultdict

#: the marker's kernel, ``torch.cuda._sleep``'s
MARKER = 'spin_kernel'
#: the host's own orchestration: no phase of the port is open
UNTRACED = 'cli'
TOP = 10
NAME_CHARS = 120


def _start_ns(ev) -> int:
    return ev.start_ns() if hasattr(ev, 'start_ns') else ev.start_us() * 1000


def _duration_ns(ev) -> int:
    return (ev.duration_ns() if hasattr(ev, 'duration_ns')
            else ev.duration_us() * 1000)


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith('CUDA')


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def innermost(ranges) -> list[tuple[int, int, str]]:
    """The properly nested (start, end, name) ranges of one thread as
    disjoint (start, end, innermost name) pieces."""
    pieces = []
    stack: list[tuple[int, str]] = []     # (end, name)
    t = None
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if t is not None and end > t:
                pieces.append((t, end, top))
            t = end
        if stack and t is not None and s > t:
            pieces.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        if t is not None and end > t:
            pieces.append((t, end, top))
        t = max(t, end) if t is not None else end
    return pieces


def attribute(gaps, pieces) -> dict[str, int]:
    """Nanoseconds of each gap covered by each named piece (the rest under
    :data:`UNTRACED`); both lists sorted and disjoint."""
    out: dict[str, int] = defaultdict(int)
    j = 0
    for gs, ge in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= gs:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < ge:
            ov = min(ge, pieces[k][1]) - max(gs, pieces[k][0])
            if ov > 0:
                out[pieces[k][2]] += ov
                covered += ov
            k += 1
        out[UNTRACED] += (ge - gs) - covered
    return out


def reduce(events, window, ranges, marker_host_ns: int) -> dict:
    """busy_s, window_s, kernel_s {name: s}, device_ops and idle_gaps
    [[name, s]] (ten each, largest first) of a capture's raw ``events``.
    ``window``: the window's (start, end) and ``ranges`` the phases'
    (start, end, label) of its thread, in host ``time.time_ns()``;
    ``marker_host_ns``: the host time of the :data:`MARKER` launch, made
    on an idle card before the window; a second marker after it, on the
    harness's own stream, names that stream."""
    device = [(_start_ns(ev), _start_ns(ev) + _duration_ns(ev), ev.name(),
               ev.device_resource_id())
              for ev in events
              if _is_device(ev) and not ev.is_user_annotation()]
    marks = sorted((s, stream) for s, _, name, stream in device
                   if MARKER in name)
    if not marks:
        raise RuntimeError(f'no {MARKER} in the trace: the card\'s clock '
                           'cannot be lined up with the host\'s')
    offset = marks[0][0] - marker_host_ns
    harness_stream = marks[1][1] if len(marks) > 1 else None
    w0, w1 = window[0] + offset, window[1] + offset
    ranges = [(max(s + offset, w0), min(e + offset, w1), name)
              for s, e, name in ranges if e + offset > w0 and s + offset < w1]
    inside = []
    kernel_ns: dict[str, int] = defaultdict(int)
    for s, e, name, stream in device:
        if e > w0 and s < w1 and MARKER not in name \
                and stream != harness_stream:
            inside.append((max(s, w0), min(e, w1)))
            kernel_ns[name] += min(e, w1) - max(s, w0)
    busy = union(inside)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    idle = attribute(gaps, innermost(ranges))

    def top(d):
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in sorted(
            d.items(), key=lambda kv: -kv[1])[:TOP]]
    return dict(busy_s=sum(e - s for s, e in busy) / 1e9,
                window_s=(w1 - w0) / 1e9,
                kernel_s={k: v / 1e9 for k, v in kernel_ns.items()},
                device_ops=top(kernel_ns), idle_gaps=top(idle),
                clock_offset_ns=offset)
