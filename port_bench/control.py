"""The control of a cell's comparison: the reference a precision below
the configuration's, judged as the program is.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 \\
        [--out readings.jsonl]

For each seed: the cell's first input file of that seed and the first
call's ``rand_seed`` (as ``run.py`` makes them), the sample of units drawn
as a run draws it, the reference at the configuration's float32 and at
its ``check.control`` precision (``reference/charge.py``), and the
numbers of ``check.compare_units`` of the control against the float32
reference, beside the limits.  The control has to fail one of them on
every seed; the exit code is 0 when it does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from port_bench import assets, check, harness, traffic  # noqa: E402
from port_bench.reference import charge  # noqa: E402


def readings(workload: str, seed: int, *, bench_path: str | None = None,
             traffic_dir: str | None = None) -> dict:
    """The control's numbers on one seed."""
    bench = harness.load_json(bench_path
                              or os.path.join(ROOT, 'BENCHMARK.json'))
    cell, entry = harness.cell_of(bench, workload)
    cfg = harness.load_json(os.path.join(ROOT, entry['file']))
    spec = traffic.load(cell['traffic'], traffic_dir)
    files, borders = assets.prepare(cfg)
    mods = charge.modules(files, cfg['run'])
    work = tempfile.mkdtemp(prefix='port_bench-control-')
    try:
        inp = os.path.join(work, 'input.h5')
        traffic.write_run_file(inp, spec, traffic.pool(spec, borders), seed,
                               0)
        tracks = charge.read_segments(inp, mods[0].det)
        calls, groups = charge.plan(tracks, mods)
        rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        sample = charge.choose_units(calls, cfg['check']['units'], rng)
        out = {}
        for p in ('float32', cfg['check']['control']):
            t0 = time.perf_counter()
            out[p] = charge.run(tracks, calls, groups,
                                harness.call_seed(seed, 0), sample,
                                harness.DEVICE, precision=p,
                                log=lambda m: print(m, file=sys.stderr))
            print(f'[control] {workload} seed {seed} {p} '
                  f'{time.perf_counter() - t0:.2f} s', file=sys.stderr)
        numbers = check.compare_units(out[cfg['check']['control']],
                                      out['float32'])
        limits = {k: cfg['limits'][k] for k in numbers if k in cfg['limits']}
        ok, checks = check.judge(numbers, limits)
        return dict(workload=workload, seed=seed,
                    precision=cfg['check']['control'], numbers=numbers,
                    passes_limits=ok, checks=checks)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    failed_all = True
    for seed in args.seeds:
        rec = readings(args.workload, seed)
        failed_all &= not rec['passes_limits']
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(rec) + '\n')
    return 0 if failed_all else 1


if __name__ == '__main__':
    sys.exit(main())
