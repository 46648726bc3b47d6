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
``truth/h5`` among them), host memory (resident at the run's start; the
run's peak, VmRSS sampled every :data:`RSS_PERIOD` s by a thread; the
process's peak, warm-up included), peak device memory, output bytes and,
in mode 0, each light group call's (event, n_ticks, triggers).
:func:`run` starts it and returns that JSON.

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
#: seconds between two samples of the resident set during a run
RSS_PERIOD = 0.005
#: events of the warm-up run before the timed one: one spill compiles and
#: loads everything the timed run then calls
WARM_EVENTS = 1
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


def run(tree: str, inp: str, out: str, kw: dict,
        timeout: float = 600) -> dict:
    """One run in a process of its own (see the module docstring); its
    RESULT, with the process's standard output under ``stdout``."""
    proc = subprocess.run(
        [sys.executable, _HERE, 'run', '--tree', tree, '--input', inp,
         '--output', out, '--kw', json.dumps(kw)],
        capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f'the run in {tree} failed ({proc.returncode}):\n'
                           f'{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}')
    last = [line for line in proc.stdout.splitlines()
            if line.startswith('RESULT ')][-1]
    return dict(json.loads(last[len('RESULT '):]), stdout=proc.stdout)


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
    r = sub.add_parser('run')
    r.add_argument('--tree', required=True)
    r.add_argument('--input', required=True)
    r.add_argument('--output', required=True)
    r.add_argument('--kw', required=True)
    c = sub.add_parser('compare')
    c.add_argument('--parent', required=True)
    opts = ap.parse_args(argv)
    if opts.cmd == 'run':
        child(opts)
        return 0
    return compare(os.path.abspath(opts.parent))


if __name__ == '__main__':
    sys.exit(main())
