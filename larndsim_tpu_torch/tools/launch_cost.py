"""Host cost of one kernel launch through ``kernels.binding``, on the card.

    python -m larndsim_tpu_torch.tools.launch_cost [--parent DIR] [--device cpu]

Without ``--parent``: the launch step of ``binding._launch`` timed option by
option (:func:`launch_options`, on P1's window kernel at case a's shapes),
each step of P1's three wrappers (:func:`wrapper_steps`), then each P1
wrapper (cases a, c and g) beside its plain version: host microseconds a
call (:func:`host_us`) and queued milliseconds a call (:func:`queued_ms`).
``chip_smoke.py``'s probes phase adds the device microseconds a call from
``torch.profiler`` (:func:`device_us`).

With ``--parent DIR`` (the parent checkout, an unpacked ``git archive``):
the wrappers' host and queued times measured in each tree, each run a
process of its own in turns (parent, change, change, parent), one JSON
line a run and one line with each side's numbers.  The run loads this file
by its path and times the ``larndsim_tpu_torch`` of the tree it runs in.

On the card unless ``--device cpu`` (a rehearsal of the wiring: the plain
versions on the host clock, said in every line, not a card time).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

#: calls a host timing averages over, and the runs it takes the least of
N_HOST, REPS = 2000, 3
#: calls between two CUDA events for a queued time, and profiled calls
N_QUEUED, N_PROFILED = 20, 50
#: P1's kernels and the case whose shapes each is timed at
CASES = dict(probe_window='a', probe_roll='c', probe_async_copy='g')
TURNS = ('parent', 'change', 'change', 'parent')
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: a run in one tree: this file loaded by its path, the tree's package
#: imported from the working directory
_RUN = ('import importlib.util as u, sys; '
        's = u.spec_from_file_location("launch_cost_run", {path!r}); '
        'm = u.module_from_spec(s); s.loader.exec_module(m); '
        'm.tree_main({device!r})')


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def host_us(fn, device, n: int = N_HOST, reps: int = REPS) -> float:
    """Least host microseconds of one of ``n`` calls of ``fn()`` made back
    to back (no synchronisation between them: the enqueue) over ``reps``
    runs, after one warm-up call."""
    fn()
    _sync(device)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
        _sync(device)
    return best * 1e6


def device_us(fn, n: int = N_PROFILED, tries: int = 3) -> tuple[float, dict]:
    """Device microseconds of one call of ``fn()``: ``torch.profiler``'s
    device time (kernels and copies) over ``n`` calls, divided by ``n``;
    and that time a call by device op name.  A trace that holds fewer
    device ops than calls (the profiler drops a trace's events at times)
    is taken again, up to ``tries`` times; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in events) >= n:
            ops = {e.key: e.self_device_time_total / n for e in events}
            return sum(ops.values()), ops
    raise RuntimeError(f'the profiler kept fewer than {n} device ops of '
                       f'{n} calls in {tries} traces')


def case_calls(device) -> dict:
    """{kernel: (wrapper call, plain call)} of P1's three kernels at their
    cases' shapes on ``device`` (the tree's own ``probe_folded``)."""
    from larndsim_tpu_torch.tools import probe_folded as p1
    plain = {p1.window: p1.window_plain, p1.roll: p1.roll_plain,
             p1.async_copy: p1.async_copy_plain}
    calls = {}
    for name, case in CASES.items():
        fn, (x, *rest), _ = p1.case_call(case)
        x = torch.from_numpy(x).to(device)
        calls[name] = (lambda fn=fn, x=x, rest=rest: fn(x, *rest),
                       lambda fn=fn, x=x, rest=rest: plain[fn](x, *rest))
    return calls


def launch_options(device, n: int = N_HOST) -> dict:
    """Host microseconds of one launch of P1's window kernel (case a) by
    each option of the launch step: the signatures set on every launch (as
    before they were bound once per load), a device context entered or
    skipped where the thread's card already is the tensors', the stream as
    a ``torch.cuda.Stream`` object or its raw handle; and the ctypes call
    alone, its stream given."""
    import ctypes
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.tools import probe_folded as p1
    slab = torch.from_numpy(p1.slab_host()).to(device)
    out = torch.empty((p1.N_Q, p1.LANES), device=device)
    lib = binding._lib()
    fn, idx = lib.probe_window_launch, device.index or 0
    args = (slab.data_ptr(), out.data_ptr(), p1.N_SUB, p1.LANES, 0, 3,
            p1.N_Q)
    raw = torch._C._cuda_getCurrentRawStream(idx)

    def bind_all():
        for name, argtypes in binding._SIGNATURES.items():
            f = getattr(lib, name)
            f.argtypes = argtypes
            f.restype = ctypes.c_int

    def context(stream):
        with torch.cuda.device(idx):
            return fn(*args, stream())

    def skipped(stream):
        if torch._C._cuda_getDevice() == idx:
            return fn(*args, stream())
        return context(stream)

    def stream_object():
        return torch.cuda.current_stream(idx).cuda_stream

    def raw_stream():
        return torch._C._cuda_getCurrentRawStream(idx)

    options = {
        'signatures set every launch, device context, Stream object':
            lambda: (bind_all(), context(stream_object)),
        'signatures once, device context, Stream object':
            lambda: context(stream_object),
        'signatures once, device context, raw stream':
            lambda: context(raw_stream),
        'signatures once, context skipped, Stream object':
            lambda: skipped(stream_object),
        'signatures once, context skipped, raw stream (binding._launch)':
            lambda: binding._launch(fn, device, *args),
        'the ctypes call alone, its stream given': lambda: fn(*args, raw),
    }
    return {name: host_us(call, device, n) for name, call in options.items()}


def wrapper_steps(device, n: int = N_HOST) -> dict:
    """Host microseconds of each step of P1's three wrappers at their
    cases' shapes (``kernels.binding``), beside the whole call and the
    plain call: the dispatching function's device test and import, the
    argument checks, the output's ``torch.empty``, the library lookup,
    the launch step and the count's lock.  {kernel: {step: us}}."""
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.tools import probe_folded as p1
    f32, lib = torch.float32, binding._lib()
    s = p1.slab_host()
    slab = torch.from_numpy(s).to(device)
    x = torch.from_numpy(s[:p1.GRP, :p1.N_Q].copy()).to(device)
    shapes = dict(probe_window=(p1.N_Q, p1.LANES), probe_roll=tuple(x.shape),
                  probe_async_copy=(2, p1.N_ROWS, 16, p1.LANES))
    outs = {k: torch.empty(v, device=device) for k, v in shapes.items()}

    def dispatch():
        if slab.device.type == 'cpu':
            raise AssertionError('a CUDA slab')
        from larndsim_tpu_torch.kernels import binding as _  # noqa: F401

    def lock():
        with binding._COUNT_LOCK:
            pass

    checks = dict(
        probe_window=lambda: binding._check(
            'slab', slab, f32, tuple(slab.shape), binding._cuda(slab, 'w')),
        probe_roll=lambda: binding._check(
            'x', x, f32, tuple(x.shape), binding._cuda(x, 'r')),
        probe_async_copy=lambda: (binding._cuda(slab, 'c'), binding.tma_window(
            slab.shape, slab.stride(), slab.data_ptr(), 8, 16, 2)))
    launches = dict(
        probe_window=lambda: binding._launch(
            lib.probe_window_launch, device, slab.data_ptr(),
            outs['probe_window'].data_ptr(), p1.N_SUB, p1.LANES, 0, 3,
            p1.N_Q),
        probe_roll=lambda: binding._launch(
            lib.probe_roll_launch, device, x.data_ptr(),
            outs['probe_roll'].data_ptr(), p1.GRP * p1.N_Q, p1.LANES, 1,
            p1.LANES - 37),
        probe_async_copy=lambda: binding._launch(
            lib.probe_async_copy_launch, device, slab.data_ptr(),
            outs['probe_async_copy'].data_ptr(), p1.N_ROWS, p1.N_SUB,
            p1.LANES, slab.stride(0), slab.stride(1), 8, 16, 2))
    steps = {}
    for name, (call, plain) in case_calls(device).items():
        steps[name] = {
            'whole call': host_us(call, device, n),
            'plain call': host_us(plain, device, n),
            'dispatch (device test, import)': host_us(dispatch, device, n),
            'checks': host_us(checks[name], device, n),
            'output (torch.empty)': host_us(
                lambda shape=shapes[name]: torch.empty(shape, dtype=f32,
                                                       device=device),
                device, n),
            'library (_lib)': host_us(binding._lib, device, n),
            'launch step (_launch)': host_us(launches[name], device, n),
            'count lock': host_us(lock, device, n),
        }
    return steps


def queued_ms(fn) -> float:
    """Least milliseconds a call of :data:`N_QUEUED` calls of ``fn()``
    queued between two CUDA events (``perf_guard.timed_queued``; host-bound
    where the host is slower than the card)."""
    from larndsim_tpu_torch.tools.perf_guard import timed_queued
    return timed_queued(fn, n=N_QUEUED).min_ms


def tree_main(device: str = 'cuda') -> dict:
    """One run in the working directory's tree: each P1 wrapper's and its
    plain version's host microseconds a call and (on the card) queued
    milliseconds a call; prints and returns one JSON record."""
    import larndsim_tpu_torch
    dev = torch.device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    rec = dict(package=os.path.dirname(larndsim_tpu_torch.__file__),
               device=str(dev), kernels={})
    for name, (call, plain) in case_calls(dev).items():
        row = dict(host_us=host_us(call, dev),
                   plain_host_us=host_us(plain, dev))
        if dev.type == 'cuda':
            row.update(queued_ms=queued_ms(call),
                       plain_queued_ms=queued_ms(plain))
        rec['kernels'][name] = row
    print(json.dumps(rec), flush=True)
    return rec


def compare(parent: str, device: str = 'cuda') -> dict:
    """:func:`tree_main` in the parent's tree and in this one, each run a
    process of its own, in the order of :data:`TURNS`; each side's numbers
    by kernel."""
    trees = dict(parent=os.path.abspath(parent), change=_ROOT)
    runs = []
    for tree in TURNS:
        proc = subprocess.run(
            [sys.executable, '-c', _RUN.format(path=os.path.abspath(__file__),
                                               device=device)],
            cwd=trees[tree], capture_output=True, text=True, timeout=900,
            check=False)
        if proc.returncode:
            raise RuntimeError(f'{tree} run failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if rec['package'] != os.path.join(trees[tree], 'larndsim_tpu_torch'):
            raise RuntimeError(f'{tree} run timed {rec["package"]}')
        rec['tree'] = tree
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    sides = {name: {tree: {key: [r['kernels'][name][key] for r in runs
                                 if r['tree'] == tree]
                           for key in runs[0]['kernels'][name]}
                    for tree in ('parent', 'change')}
             for name in CASES}
    print(json.dumps(dict(turns=TURNS, by_kernel=sides)), flush=True)
    return sides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', default=None,
                    help='the parent checkout, to time against this one')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    opts = ap.parse_args(argv)
    if opts.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: launch costs are the card\'s '
                           '(pass --device cpu to rehearse the wiring)')
    where = (subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                             '--format=csv,noheader'], capture_output=True,
                            text=True, check=True).stdout.strip()
             if opts.device == 'cuda' else
             'cpu: a rehearsal on the host clock, not a card time')
    print(f'card: {where}', flush=True)
    if opts.parent:
        compare(opts.parent, opts.device)
        return 0
    dev = torch.device(opts.device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', 0)
        for name, us in launch_options(dev).items():
            print(f'launch step {name}: {us:.2f} us', flush=True)
        for name, steps in wrapper_steps(dev).items():
            print(f'{name} wrapper steps: ' + ', '.join(
                f'{step} {us:.2f} us' for step, us in steps.items()),
                flush=True)
    tree_main(opts.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
