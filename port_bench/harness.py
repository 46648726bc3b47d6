"""One run of one cell of the port's benchmark.

``python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout, on a machine with the cards
the cell asks for.  Everything that belongs to one configuration, one
traffic mix, one per-layer metric or one comparison is a file of its own,
found by the names in ``BENCHMARK.json`` and the configuration's:
``configs/<config>.json`` (the run's keys, the asset writer, the
comparisons, their sample and limits), ``traffic/<mix>.json`` (the
generator's parameters), ``metrics/<metric>.py`` (a reader with a
``read(window)`` function that returns a number, or None where it finds
nothing to read) and ``compare/<name>.py`` for each name of the
configuration's ``check.comparisons`` (``["charge"]`` where it names
none: a ``compare(kept, files, cfg, rng, device, log)`` function that
returns its numbers, with the counts they rest on, for the kept call).

A run:

1. set-up (``setup_s``, from the process's start): the port and its
   kernels, the configuration's cached assets (made at a checkout's first
   run), the seed's input files, and one call on a one-spill file that
   builds and warms every kernel, plan and host library the calls use;
2. the window: ``run_simulation`` of the port in a closed loop, one call a
   file, back to back, each ended by ``torch.cuda.synchronize()``; calls
   start until ``--seconds`` have passed.  ``events_per_s`` is the spills
   of all calls over their summed wall; ``peak_device_gib`` the card's
   peak allocation in the window.  With ``--trace 1`` the window runs
   under ``torch.profiler`` and the launches of K1 and K2 are recorded,
   and the per-layer metrics are read after it;
3. the comparison: for one call of the window, drawn from the seed, each
   of the configuration's comparisons computes its numbers (``charge``:
   the benchmark's own charge chain, ``reference/charge.py``, makes the
   data packets of a sample of the call's (spill, TPC group) units, and
   ``check.py`` holds the call's output file to them and checks the whole
   file's packets against the input); ``check.judge`` holds the merged
   numbers to the configuration's limits, and every number is printed
   beside its limit.

The last line of standard output is the result, a JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'larndsim_tpu')
GIB = float(1 << 30)
#: where the program runs; the CPU tests set 'cpu'
DEVICE = 'cuda'


@dataclasses.dataclass
class Window:
    """What a per-layer metric reads: the window's calls (``wall_s``,
    ``events``, ``phases``: each phase label's self wall seconds in that
    call), and in a traced run the profiler's reduction (``trace``:
    ``trace_read.reduce``) and the summed bound seconds of the recorded
    K1 and K2 launches (``bound_s``: {'k1': s, 'k2': s})."""
    calls: list
    trace: dict | None = None
    bound_s: dict | None = None

    @property
    def events(self) -> int:
        return sum(c['events'] for c in self.calls)

    @property
    def wall_s(self) -> float:
        return sum(c['wall_s'] for c in self.calls)

    def phase_s(self, match) -> float:
        """Self wall seconds, summed over the calls, of the phase labels
        for which ``match(label)`` holds."""
        return sum(s for c in self.calls for label, s in c['phases'].items()
                   if match(label))

    def has_phase(self, match) -> bool:
        return any(match(label) for c in self.calls for label in c['phases'])

    def kernel_s(self, name: str) -> float:
        """Device seconds of the kernels whose name holds ``name``."""
        return sum(s for k, s in self.trace['kernel_s'].items() if name in k)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, workload: str) -> tuple[dict, dict]:
    """The cell named ``workload`` and its configuration's entry."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'no workload {workload!r} in BENCHMARK.json '
                         f'({sorted(cells)})')
    cell = cells[workload]
    config = {c['name']: c for c in bench['configs']}[cell['config']]
    return cell, config


def metrics_of(bench: dict, cell: dict, section: str) -> list[dict]:
    """The cell's metrics of ``end_to_end`` or ``per_layer``."""
    return [m for m in bench[section]
            if cell['name'] in m.get('workloads', [cell['name']])]


def _function(path: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f'port_bench_file_{len(sys.modules)}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


def reader(name: str, directory: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _function(os.path.join(directory, f'{name}.py'), 'read')


def comparisons(cfg: dict, directory: str | None = None) -> dict:
    """The ``compare`` function of ``<directory>/<name>.py`` (``compare/``
    beside this file by default) for each name of the configuration's
    ``check.comparisons`` (``["charge"]`` where it names none); a name
    without its file stops the run."""
    directory = directory or os.path.join(HERE, 'compare')
    out = {}
    for name in cfg['check'].get('comparisons', ['charge']):
        path = os.path.join(directory, f'{name}.py')
        if not os.path.isfile(path):
            raise SystemExit(f'{cfg["name"]}: no comparison {name!r} '
                             f'({path} not found)')
        out[name] = _function(path, 'compare')
    return out


def call_seed(seed: int, index: int) -> int:
    """``rand_seed`` of call ``index`` of a run (-1: the warm-up)."""
    return int(np.random.SeedSequence(
        [int(seed) % (1 << 63), 1 << 20, index + 1]).generate_state(1)[0])


def forbidden_modules() -> list[str]:
    return sorted(n for n in sys.modules if n.split('.')[0] in FORBIDDEN)


class LaunchLog:
    """In a traced run: every K1 launch's bytes and operations, counted by
    kernels on a stream of the harness's own that waits for the launch
    (the trace leaves that stream out, and nothing waits for it until the
    window has closed), and every K2 launch's shapes, by wrappers around
    the port's binding; read after the window (:func:`bound_s`)."""

    def __init__(self, binding, stream=None):
        self.binding, self.stream = binding, stream
        self.k1, self.k2 = [], []

    @contextlib.contextmanager
    def recording(self):
        import torch

        from . import costs
        b = self.binding
        k1, k2 = b.induced_current, b.fee_fsm
        side = self.stream

        def induced_current(*args, **kw):
            out = k1(*args, **kw)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.k1.append(costs.k1_work(args))
            for a in args:
                if isinstance(a, torch.Tensor):
                    a.record_stream(side)
            return out

        def fee_fsm(sig_rows, noise, q_init, thresholds, tick_times, s):
            self.k2.append((sig_rows.shape[0], sig_rows.shape[1], s.max_adc,
                            tick_times.shape[0]))
            return k2(sig_rows, noise, q_init, thresholds, tick_times, s)

        b.induced_current, b.fee_fsm = induced_current, fee_fsm
        try:
            yield self
        finally:
            b.induced_current, b.fee_fsm = k1, k2

    def bound_s(self) -> dict:
        from . import costs
        if self.stream is not None:
            self.stream.synchronize()
        k1 = sum(costs.bound_s(n_bytes, int(ops))
                 for n_bytes, ops in self.k1)
        k2 = sum(costs.bound_s(c['bytes'], c['ops'])
                 for c in (costs.fsm_costs(*shape) for shape in self.k2))
        out = dict(k1=k1, k2=k2, k1_launches=len(self.k1),
                   k2_launches=len(self.k2))
        self.k1.clear()
        return out


class PhaseLog:
    """In a traced run: the host ``time.time_ns()`` range of every phase
    of the port that the calling (window's) thread opens, kept by a
    wrapper around ``utils.trace.phase``."""

    def __init__(self, program_trace):
        self.program_trace = program_trace
        self.ranges = []

    @contextlib.contextmanager
    def recording(self):
        t = self.program_trace
        real = t.phase
        thread = threading.get_ident()

        @contextlib.contextmanager
        def phase(label, device=None):
            t0 = time.time_ns()
            try:
                with real(label, device):
                    yield
            finally:
                if threading.get_ident() == thread:
                    self.ranges.append((t0, time.time_ns(), label))

        t.phase = phase
        try:
            yield self
        finally:
            t.phase = real


def check_card(cell: dict) -> None:
    """Stop, with no result, unless the cards the cell asks for are
    visible."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: the benchmark measures the port on '
                         'the card and runs nowhere else')
    if torch.cuda.device_count() < cell['chips']:
        raise SystemExit(f'{cell["name"]} needs {cell["chips"]} cards, '
                         f'{torch.cuda.device_count()} visible')


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, bench_path: str | None = None,
             traffic_dir: str | None = None, compare_dir: str | None = None,
             log=None) -> dict:
    """One run of cell ``workload``; returns the result line's object."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = load_json(bench_path or os.path.join(ROOT, 'BENCHMARK.json'))
    cell, config_entry = cell_of(bench, workload)
    check_card(cell)
    import torch
    from . import assets, check, traffic
    # the program under test
    from larndsim_tpu_torch.cli import simulate_pixels as program
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.utils import trace as program_trace

    on_card = DEVICE == 'cuda'
    cfg = load_json(os.path.join(ROOT, config_entry['file']))
    compare = comparisons(cfg, compare_dir)
    spec = traffic.load(cell['traffic'], traffic_dir)
    files, borders = assets.prepare(cfg)
    work = tempfile.mkdtemp(prefix='port_bench-')
    try:
        inputs = traffic.make_inputs(spec, borders, seed,
                                     os.path.join(work, 'in'))
        out_dir = os.path.join(work, 'out')
        os.makedirs(out_dir)
        kwargs = dict(cfg['run'], **files, device=DEVICE)
        quiet = contextlib.redirect_stdout(sys.stderr)
        t0 = time.perf_counter()
        with quiet:
            program.run_simulation(inputs['warmup'],
                                   os.path.join(out_dir, 'warmup.h5'),
                                   rand_seed=call_seed(seed, -1), **kwargs)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        os.remove(os.path.join(out_dir, 'warmup.h5'))
        log(f'[setup] warm-up call {time.perf_counter() - t0:.3f} s')

        side = torch.cuda.Stream() if trace else None
        launches = LaunchLog(binding, side)
        phases = PhaseLog(program_trace)
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
        rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        calls, kept = [], None
        setup_s = time.perf_counter() - t_start
        with contextlib.ExitStack() as stack:
            if trace:
                stack.enter_context(launches.recording())
                stack.enter_context(phases.recording())
                stack.enter_context(prof)
                # the markers: the card's clock against the host's, and
                # the harness's stream, which the trace leaves out
                torch.cuda.synchronize()
                marker_ns = time.time_ns()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                with torch.cuda.stream(side):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            window = [time.time_ns(), None]
            t_end = time.perf_counter() + seconds
            while not calls or time.perf_counter() < t_end:
                i = len(calls)
                path, n_events = inputs['files'][i % len(inputs['files'])]
                out = os.path.join(out_dir, f'out_{i}.h5')
                t1 = time.perf_counter()
                with quiet:
                    program.run_simulation(path, out,
                                           rand_seed=call_seed(seed, i),
                                           **kwargs)
                if on_card:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t1
                calls.append(dict(wall_s=wall, events=n_events, input=path,
                                  output=out, rand_seed=call_seed(seed, i),
                                  phases={k: s for k, (s, _) in
                                          program_trace.summary().items()}))
                # one output kept, drawn uniformly over the calls
                if kept is None or rng.random() < 1.0 / len(calls):
                    if kept is not None:
                        os.remove(kept['output'])
                    kept = calls[-1]
                else:
                    os.remove(out)
            window[1] = time.time_ns()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        walls = ' '.join(f'{c["wall_s"]:.4f}' for c in calls)
        log(f'[window] {len(calls)} calls, walls {walls} s')
        win = Window(calls)
        result = dict(correct=False, attempted=len(calls), failed=0)
        if trace:
            from . import trace_read
            win.bound_s = launches.bound_s()
            win.trace = trace_read.reduce(
                prof.profiler.kineto_results.events(), window,
                phases.ranges, marker_ns)
            del prof
            log(f'[trace] card clock - host clock '
                f'{win.trace["clock_offset_ns"]} ns, '
                f'{win.bound_s["k1_launches"]} K1 and '
                f'{win.bound_s["k2_launches"]} K2 launches')
            metrics = {}
            for m in metrics_of(bench, cell, 'per_layer'):
                value = reader(m['name'], os.path.join(HERE, 'metrics'))(win)
                if value is not None:
                    metrics[m['name']] = dict(value=value, unit=m['unit'])
            result['breakdown'] = dict(device_ops=win.trace['device_ops'],
                                       idle_gaps=win.trace['idle_gaps'])
        else:
            metrics = {}
            names = [m['name'] for m in metrics_of(bench, cell, 'end_to_end')]
            values = dict(events_per_s=win.events / win.wall_s,
                          peak_device_gib=peak / GIB, setup_s=setup_s)
            units = {m['name']: m['unit'] for m in bench['end_to_end']}
            for name in names:
                metrics[name] = dict(value=values[name], unit=units[name])
        result['metrics'] = metrics
        dev = dict(platform='gpu' if on_card else DEVICE,
                   kind=(torch.cuda.get_device_name(0) if on_card
                         else DEVICE),
                   count=cell['chips'], memory_peak_bytes=int(peak))
        if trace:
            dev.update(busy_s=win.trace['busy_s'],
                       window_s=win.trace['window_s'])
        result['device'] = dev

        # the comparison, after the program's state is freed
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        numbers = {}
        for name, fn in compare.items():
            got = fn(kept, files, cfg, rng, DEVICE, log)
            if numbers.keys() & got.keys():
                raise ValueError(f'comparison {name!r} gives numbers '
                                 f'already given: '
                                 f'{sorted(numbers.keys() & got.keys())}')
            numbers.update(got)
        log(f'[check] {", ".join(compare)} {time.perf_counter() - t1:.3f} s '
            f'on call {calls.index(kept)}')
        ok, checks = check.judge(numbers, cfg['limits'])
        result['correct'] = bool(ok)
        result['checks'] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f'the run loaded {found}: nothing it runs may import '
              f'{FORBIDDEN}', file=sys.stderr)
        return 4
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    print(f'check correct {result["correct"]}', file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
