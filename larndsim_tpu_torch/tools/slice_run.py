"""The mode-0 slice's I/O, measured: one CLI run per process, and a
comparison of two checkouts on the card.

The mode-0 slice is ``chip_smoke.py``'s: the Module-0-shaped detector of
``assets.geometry.write_module0`` with Module-0's light keys in the
threshold mode (:data:`MODE0_LIGHT`, :data:`MODE0_TRUTH`) and the input
:data:`SPILLS`.  The other slices' keys and inputs, which
``chip_smoke.py`` and ``tools/host_walls.py`` share, are here too.

    python larndsim_tpu_torch/tools/slice_run.py run --tree DIR \\
        --input IN.h5 --output OUT.h5 --kw JSON

runs ``cli.simulate_pixels.run_simulation(IN, OUT, **kw)`` once in this
process, with the ``larndsim_tpu_torch`` of the checkout ``DIR`` (this
script imports nothing of it before that), after a warm-up run of the
first :data:`WARM_EVENTS` events (on the card, the plain kernel versions
raise); its
last line is ``RESULT {json}``: the run's wall, kernel launches (counters
set to 0 just before the run), phase table (self seconds by label,
``truth/h5`` among them), host memory
(resident at the run's start; the run's peak, VmRSS sampled every
:data:`RSS_PERIOD` s by a thread; the process's peak, warm-up included),
peak device memory, output bytes and, in mode 0, each light group call's
(event, n_ticks, triggers).  :func:`run` starts it and returns that JSON.

    python larndsim_tpu_torch/tools/slice_run.py kernels --tree DIR \
        --input IN.h5 --output OUT.h5 --kw JSON

times the charge chain's waveform sum (D1) and current fractions (D2) of
the checkout ``DIR`` on the card (:func:`kernels_child`; through the
names both keep: the ops' ``sum_pixel_signals`` / ``current_fractions``,
the launch counters, ``tools.perf_guard``'s ``build_workload`` and
``op_calls``), on the first batch of a one-spill run of IN.h5 and on the
guard's 2x2 and ND-LAr batches; :func:`kernels` starts it.

    python -m larndsim_tpu_torch.tools.slice_run compare --parent DIR

makes the slice's assets and input once, then runs the parent checkout
``DIR`` (an unpacked ``git archive``), this checkout, this checkout and
the parent, each in a process of its own, and prints each run's numbers,
the truth dataset's bytes in the file (through this checkout's reader)
and whether every run's truth records equal the first run's, bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time

#: the slice's input: bench.py's per-spill tracks, Module-0 occupancy 4
SPILLS = dict(n_events=8, tracks_per_event=16, segments_per_track=42,
              segment_length=0.4, dEdx=8.0, seed=2)
#: the mode-0 slice's light keys: Module-0's (light_properties with
#: light_trig_mode 0: 96 channels in groups of 6 at -2000 ADC), the
#: loader's default [1, 10] us light window, no LUT smearing; and bench.py's
#: module0 truth (bench.py:147-150: contributor points, K 50, 0.1 pe/us)
MODE0_LIGHT = dict(light_trig_mode=0, light_window=(1.0, 10.0),
                   enable_lut_smearing=False)
MODE0_TRUTH = dict(max_light_truth_ids=50, mc_truth_threshold=0.1)
#: the JAX bench's 2x2 "truth on": contributors per channel, threshold
SMEAR_TRUTH = dict(max_light_truth_ids=50, mc_truth_threshold=0.1)
#: the 2x2 slice's input: bench.py's 2x2 occupancy (8 spills x 24 tracks x
#: 42 segments, bench.py:76-95), every TPC with tracks in every spill (3
#: each), so that the four modules trigger alike
SPILLS_2X2 = dict(SPILLS, tracks_per_event=24, every_tpc=True)
#: the ND-LAr slice's input: bench.py's ND-LAr occupancy (144 tracks x 42
#: segments a spill, bench.py:120-136, :196-204), NDLAR_TIMED spills
NDLAR_SPILLS = dict(SPILLS, tracks_per_event=144)
NDLAR_TIMED = 4
#: bench.py's derived ND-LAr batching (bench.py:115-126): batch_size 10000
#: at event_group_size 32
NDLAR_BENCH = dict(batch_size=10000, group=32)
#: seconds between two samples of the resident set during a run
RSS_PERIOD = 0.005
#: events of the warm-up run before the timed one: one spill compiles and
#: loads everything the timed run then calls
WARM_EVENTS = 1
#: calls between two CUDA events in a queued time (:func:`device_ms`)
QUEUED = 10
#: the chain's kernels that ``kernels`` times, by their launch counters
CHAIN_KERNELS = dict(d1='sum_pixel_signals', d2='current_fractions')
_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def _status_gib(field: str) -> float:
    """A memory field of this process's /proc status (VmRSS: resident
    now), in GiB."""
    with open('/proc/self/status') as f:
        for line in f:
            if line.startswith(field + ':'):
                return int(line.split()[1]) / 2 ** 20
    raise OSError(f'/proc/self/status has no {field}')


def child(opts) -> None:
    """One timed run with the checkout ``opts.tree``; prints RESULT."""
    sys.path[0] = os.path.abspath(opts.tree)
    import torch
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    from larndsim_tpu_torch.kernels import binding, build
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.ops import accumulate, current, fee
    from larndsim_tpu_torch.utils import trace
    kw = json.loads(opts.kw)
    on_card = kw.get('device', 'cuda') == 'cuda'
    if on_card:
        build.load()
        torch.zeros(1, device='cuda')

        # on the card the kernels run, never their plain versions
        def forbidden(*args, **kwargs):
            raise AssertionError('a plain kernel version ran on the card')
        current.current_plain = fee.fee_fsm_plain = forbidden
        accumulate.sum_pixel_signals_plain = forbidden
        fee.current_fractions_plain = forbidden
    warm = opts.output + '.warm'
    cli.run_simulation(opts.input, warm, n_events=WARM_EVENTS, **kw)
    os.remove(warm)
    calls = []
    orig = getattr(light_model, 'simulate_light_group_mode0', None)
    if orig is not None:
        def spy(*a, **k):
            out = orig(*a, **k)
            calls.append([(int(e), r.n_ticks, len(r.trigger_idx))
                          for e, r in zip(k['event_ids'], out)])
            return out
        light_model.simulate_light_group_mode0 = spy
    # the run's own peak resident set: sampled every RSS_PERIOD s (the
    # process's peak includes the warm-up)
    rss = [_status_gib('VmRSS')] * 2
    done = threading.Event()

    def sample():
        while not done.wait(RSS_PERIOD):
            rss[1] = max(rss[1], _status_gib('VmRSS'))
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    binding.reset_launches()
    t0 = time.perf_counter()
    cli.run_simulation(opts.input, opts.output, **kw)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done.set()
    sampler.join()
    print('RESULT ' + json.dumps(dict(
        wall=wall, launches=dict(binding.launches),
        phases={k: v[0] for k, v in trace.summary().items()},
        rss_before_gib=rss[0],
        peak_rss_gib=max(rss[1], _status_gib('VmRSS')),
        process_peak_rss_gib=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20,
        peak_device_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if on_card else 0.0),
        file_bytes=os.path.getsize(opts.output), calls=calls)), flush=True)


def device_ms(fn, reps: int = 3) -> dict:
    """The card's time of ``fn()`` after one warm-up call: ``single_ms``,
    the least of ``reps`` calls each between two CUDA events and
    synchronised (the host's call overhead included, as the guard times
    an op), and ``queued_ms``, the least of ``reps`` runs of
    :data:`QUEUED` calls enqueued between two events, a call's share (the
    device's time of a call)."""
    import torch
    fn()
    out = {}
    for key, n in (('single_ms', 1), ('queued_ms', QUEUED)):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / n)
        out[key] = min(times)
    return out


def kernels_child(opts) -> None:
    """D1 and D2 of the checkout ``opts.tree`` on the card; prints RESULT.

    Batches: the first of a one-spill CLI run of ``opts.input`` (D2's
    first with a scanned ADC slot), as the chain calls the ops there, and
    the guard's 2x2 and ND-LAr batches (``tools.perf_guard.op_calls``: the
    op's call with its CSR made in it).  Each kernel is timed with its
    inputs made (the op's call, a CSR given by the chain dropped) and
    alone (the binding's call that launched it in the op, again on the
    same arguments); on the guard's batches the FSM as the chain calls it
    on D1's output too (the ``get_adc_values*`` row).  Each batch gives the
    SHA-256 of D1's (U, n_ticks) waveforms and of D2's fractions."""
    sys.path[0] = os.path.abspath(opts.tree)
    import hashlib
    import inspect

    import torch
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    from larndsim_tpu_torch.kernels import binding, build
    from larndsim_tpu_torch.ops import accumulate, fee
    from larndsim_tpu_torch.tools import perf_guard as pg
    build.load()
    dev = torch.device('cuda')
    ops = dict(d1=(accumulate, 'sum_pixel_signals'),
               d2=(fee, 'current_fractions'))
    wrappers = {n: f for n, f in vars(binding).items()
                if inspect.isfunction(f) and f.__module__ == binding.__name__
                and not n.startswith('_')}
    launched = []

    def spy(fn):
        def call(*args, **kwargs):
            before = dict(binding.launches)
            out = fn(*args, **kwargs)
            if any(binding.launches.get(c, 0) > before.get(c, 0)
                   for c in CHAIN_KERNELS.values()):
                launched.append((fn, args, kwargs))
            return out
        return call

    def spying(on: bool) -> None:
        for name, fn in wrappers.items():
            setattr(binding, name, spy(fn) if on else fn)

    def sha(t) -> str:
        return hashlib.sha256(
            t.contiguous().cpu().numpy().tobytes()).hexdigest()

    def measure(d1, d2) -> dict:
        """d1, d2: (op, args, kwargs, the binding calls that launched)."""
        res = {}
        for key, (op, args, kw, calls) in (('d1', d1), ('d2', d2)):
            kw = {k: v for k, v in kw.items() if k != 'csr'}
            res[f'{key}_with_inputs'] = device_ms(lambda: op(*args, **kw))
            res[f'{key}_alone'] = device_ms(
                lambda: [f(*a, **k) for f, a, k in calls])
            res[f'{key}_launches'] = len(calls)
        signals, pix_idx, ts, U = d1[1][:4]
        res['d1_sha'] = sha(accumulate.sum_pixel_signals(
            signals, pix_idx, ts, U, n_ticks=d1[2]['n_ticks'],
            time_sampling=d1[2]['time_sampling']))
        d2_kw = {k: v for k, v in d2[2].items() if k != 'csr'}
        res['d2_sha'] = sha(d2[0](*d2[1], **d2_kw))
        S, P, T = signals.shape
        res['shapes'] = dict(S=S, P=P, T=T, U=U, n_ticks=d1[2]['n_ticks'],
                             rows=d1[2].get('rows'),
                             n_adc_scan=d2_kw['n_adc_scan'],
                             max_tracks=d2_kw['max_tracks'])
        return res

    # the first batch: the ops' first calls in a one-spill run, and the
    # binding calls inside each
    kept = {}
    origs = {key: getattr(mod, name) for key, (mod, name) in ops.items()}

    def keep(key):
        def call(*args, **kwargs):
            n = len(launched)
            out = origs[key](*args, **kwargs)
            if key == 'd1' or kwargs['n_adc_scan'] > 0:
                kept.setdefault(key, (origs[key], args, kwargs,
                                      launched[n:]))
            return out
        return call
    for key, (mod, name) in ops.items():
        setattr(mod, name, keep(key))
    spying(True)
    try:
        cli.run_simulation(opts.input, opts.output, n_events=WARM_EVENTS,
                           **json.loads(opts.kw))
    finally:
        spying(False)
        for key, (mod, name) in ops.items():
            setattr(mod, name, origs[key])
    launched.clear()
    out = dict(first_batch=measure(kept['d1'], kept['d2']))
    del kept
    for config in ('module0', 'ndlar'):
        with tempfile.TemporaryDirectory() as tmp:
            w = pg.build_workload(dev, tmp, workload=pg.CONFIGS[config][0],
                                  config=config)
        calls = pg.op_calls(w)
        rows = {}
        for key, (mod, name) in ops.items():
            op, args, kw = next(c for c in calls.values()
                                if c[0] is origs[key] and 'csr' not in c[2])
            n = len(launched)
            spying(True)
            try:
                op(*args, **kw)
            finally:
                spying(False)
            rows[key] = (op, args, kw, launched[n:])
        launched.clear()
        res = measure(rows['d1'], rows['d2'])
        fsm_row, (fsm, args, kw) = next(
            (k, c) for k, c in calls.items() if k.startswith('get_adc_values'))
        res['fsm_as_chain'] = dict(row=fsm_row,
                                   **device_ms(lambda: fsm(*args, **kw)))
        out[f'guard_{config}'] = res
        del w, calls, rows
        torch.cuda.empty_cache()
    print('RESULT ' + json.dumps(out), flush=True)


def _result(argv: list, tree: str, timeout: float) -> dict:
    """This script's ``argv`` run in a process of its own; its RESULT,
    with the process's standard output under ``stdout``."""
    proc = subprocess.run([sys.executable, _HERE, *argv],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f'the {argv[0]} run in {tree} failed '
                           f'({proc.returncode}):\n{proc.stdout[-3000:]}\n'
                           f'{proc.stderr[-3000:]}')
    last = [line for line in proc.stdout.splitlines()
            if line.startswith('RESULT ')][-1]
    return dict(json.loads(last[len('RESULT '):]), stdout=proc.stdout)


def run(tree: str, inp: str, out: str, kw: dict,
        timeout: float = 600) -> dict:
    """One run in a process of its own (see the module docstring); its
    RESULT, with the process's standard output under ``stdout``."""
    return _result(['run', '--tree', tree, '--input', inp, '--output', out,
                    '--kw', json.dumps(kw)], tree, timeout)


def kernels(tree: str, inp: str, out: str, kw: dict,
            timeout: float = 900) -> dict:
    """:func:`kernels_child` in a process of its own; its RESULT."""
    return _result(['kernels', '--tree', tree, '--input', inp, '--output',
                    out, '--kw', json.dumps(kw)], tree, timeout)


def mode0_slice(directory: str, device: str = 'cuda') -> tuple[str, dict]:
    """The mode-0 slice's assets and input in ``directory``: (input path,
    run_simulation keywords)."""
    from ..assets.geometry import write_module0
    from ..assets.make_input import write_input
    from ..params import load_detector
    paths = write_module0(os.path.join(directory, 'module0_mode0'),
                          light=MODE0_LIGHT, sim_overrides=MODE0_TRUTH)
    inp = os.path.join(directory, 'spills.h5')
    write_input(inp, load_detector(paths['detector_properties'],
                                   paths['pixel_layout'],
                                   device='cpu').tpc_borders, **SPILLS)
    return inp, dict(config='module0',
                     detector_properties=paths['detector_properties'],
                     pixel_layout=paths['pixel_layout'],
                     simulation_properties=paths['simulation_properties'],
                     # absent file: the synthetic 45 x 45 x 1891 response
                     response_file=os.path.join(directory,
                                                'response_44.npy'),
                     rand_seed=7, step_scale=1.0, device=device)


def compare(parent: str) -> int:
    """Parent, change, change, parent on the mode-0 slice."""
    import numpy as np

    from ..io.h5 import File
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'card: {smi}', flush=True)
    first = None
    with tempfile.TemporaryDirectory() as tmp:
        inp, kw = mode0_slice(tmp)
        for i, (name, tree) in enumerate((('parent', parent),
                                          ('change', _ROOT),
                                          ('change', _ROOT),
                                          ('parent', parent))):
            out = os.path.join(tmp, f'run{i}_{name}.h5')
            res = run(tree, inp, out, kw)
            with File(out, 'r') as f:
                ds = f['light_wvfm_mc_assn']
                stored, rec = ds.storage_size(), np.asarray(ds)
            first = rec if first is None else first
            equal = rec.dtype == first.dtype and all(
                np.array_equal(rec[n], first[n]) for n in rec.dtype.names)
            line = dict(run=i, tree=name, wall_s=res['wall'],
                        truth_h5_s=res['phases'].get('truth/h5', 0.0),
                        peak_rss_gib=res['peak_rss_gib'],
                        rss_at_start_gib=res['rss_before_gib'],
                        process_peak_rss_gib=res['process_peak_rss_gib'],
                        peak_device_gib=res['peak_device_gib'],
                        file_bytes=res['file_bytes'],
                        truth_records=len(rec), truth_bytes=rec.nbytes,
                        truth_stored_bytes=stored,
                        truth_equal_to_run0=bool(equal),
                        launches=res['launches'])
            print(json.dumps(line), flush=True)
            if not equal:
                return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest='cmd', required=True)
    for cmd in ('run', 'kernels'):
        r = sub.add_parser(cmd)
        for name in ('--tree', '--input', '--output', '--kw'):
            r.add_argument(name, required=True)
    c = sub.add_parser('compare')
    c.add_argument('--parent', required=True)
    opts = ap.parse_args(argv)
    if opts.cmd in ('run', 'kernels'):
        (child if opts.cmd == 'run' else kernels_child)(opts)
        return 0
    return compare(os.path.abspath(opts.parent))


if __name__ == '__main__':
    sys.exit(main())
