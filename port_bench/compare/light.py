"""The light comparison: the kept call's beam waveforms against the
benchmark's own light chain (``reference/light.py``) on every (spill,
module) of the call, and the whole file's light rows against the input.

Numbers, each held to a limit of the configuration's ``limits``:

- ``wvfm_samples_differ``: the share of the reference's ADC samples
  (trigger, channel, sample) that the file does not hold: a sample of
  another value, or of a row the file lacks;
- ``wvfm_adc_gap_max``: the largest gap in ADC counts between a sample of
  the file and the reference's, over the rows both hold;
- ``light_rows_differ``: over the whole file, each module's waveform rows
  against the reference's (one a spill, where every spill triggers every
  module), and the ``light_trig`` rows against the first module's rows.

The waveforms of several modules are read where the program merges them
(``light_wvfm``, each module's channels one block after another) or, in a
file it did not merge, from each module's ``light_wvfm/light_wvfm_mod<i>``.
A sample with no waveform is not correct.

Run as a script, it is the control of these numbers on a cell:

    python3 port_bench/compare/light.py --workload 2x2.numi --seeds 1 2 3

For each seed: the cell's first input file of that seed and the first
call's ``rand_seed`` (as ``run.py`` makes them, and as ``control.py``
takes them for the charge), and the reference at float32 and at the
configuration's ``check.control`` precision (the arrival series summed in
bfloat16), held to each other as the program is held to the reference
and judged by ``check.judge``.  The control has to fail one number on every seed;
the exit code is 0 when it does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

if __name__ == '__main__':
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from port_bench.reference import charge  # noqa: E402
from port_bench.reference import light  # noqa: E402
from port_bench.reference.frozen.io.h5 import File  # noqa: E402


def program_rows(path: str, n_modules: int, per: int) -> tuple[list, int]:
    """The file's waveform rows of each module, (rows, channels, samples)
    float64 arrays, and its number of ``light_trig`` rows."""
    empty = np.zeros((0, per, 0))
    with File(path, 'r') as f:
        n_trig = len(f['light_trig']) if 'light_trig' in f else 0
        if 'light_wvfm/light_wvfm_mod0' in f:
            return [np.asarray(f[f'light_wvfm/light_wvfm_mod{m}'], np.float64)
                    if f'light_wvfm/light_wvfm_mod{m}' in f else empty
                    for m in range(n_modules)], n_trig
        if 'light_wvfm' not in f:
            return [empty] * n_modules, n_trig
        merged = np.asarray(f['light_wvfm'], np.float64)
    return [merged[:, m * per:(m + 1) * per] for m in range(n_modules)], \
        n_trig


def waveform_numbers(prog: list, reference: list, shape: tuple) -> dict:
    """``wvfm_samples_differ`` and ``wvfm_adc_gap_max`` of the modules'
    rows ``prog`` against the reference's (:func:`light.run`), each row of
    ``shape`` (channels, samples), with the count of the reference's
    samples (``n_wvfm_samples``)."""
    total = differ = 0
    gap = 0.0
    for rows, ref in zip(prog, reference):
        for k, (_, wave) in enumerate(ref):
            want = np.zeros(shape) if wave is None else wave
            total += want.size
            if k >= len(rows) or rows[k].shape != want.shape:
                differ += want.size
                continue
            d = np.abs(rows[k] - want)
            differ += int((d > 0).sum())
            gap = max(gap, float(d.max(initial=0.0)))
    return dict(wvfm_samples_differ=differ / total if total else 1.0,
                wvfm_adc_gap_max=gap, n_wvfm_samples=total)


def compare(kept: dict, files: dict, cfg: dict, rng, device, log) -> dict:
    """The numbers above with the count they rest on
    (``n_wvfm_samples``); every (spill, module) of the call is compared,
    so ``rng`` draws nothing."""
    mods = charge.modules(files, cfg['run'])
    tracks = charge.read_segments(kept['input'], mods[0].det)
    reference = light.run(tracks, mods, files, cfg['run'], kept['rand_seed'],
                          device, log=log)
    keys = light.load(files['detector_properties'])
    shape = (keys.n_op_channel // len(reference), keys.digit_samples())
    prog, n_trig = program_rows(kept['output'], len(reference), shape[0])
    numbers = waveform_numbers(prog, reference, shape)
    numbers['light_rows_differ'] = sum(
        abs(len(rows) - len(ref)) for rows, ref in zip(prog, reference)) \
        + abs(n_trig - len(prog[0]))
    log(f'[check] light: {len(reference)} modules x '
        f'{len(reference[0])} rows, {numbers["n_wvfm_samples"]} samples, '
        f'{n_trig} light_trig rows')
    return numbers


def readings(workload: str, seed: int, *, bench_path: str | None = None,
             traffic_dir: str | None = None) -> dict:
    """The control's numbers on one seed."""
    from port_bench import assets, check, harness, traffic
    bench = harness.load_json(bench_path
                              or os.path.join(harness.ROOT, 'BENCHMARK.json'))
    cell, entry = harness.cell_of(bench, workload)
    cfg = harness.load_json(os.path.join(harness.ROOT, entry['file']))
    spec = traffic.load(cell['traffic'], traffic_dir)
    files, borders = assets.prepare(cfg)
    mods = charge.modules(files, cfg['run'])
    work = tempfile.mkdtemp(prefix='port_bench-light-control-')
    try:
        inp = os.path.join(work, 'input.h5')
        traffic.write_run_file(inp, spec, traffic.pool(spec, borders), seed,
                               0)
        tracks = charge.read_segments(inp, mods[0].det)
        out = {}
        for p in ('float32', cfg['check']['control']):
            t0 = time.perf_counter()
            out[p] = light.run(tracks, mods, files, cfg['run'],
                               harness.call_seed(seed, 0), harness.DEVICE,
                               precision=p)
            print(f'[control] {workload} seed {seed} light {p} '
                  f'{time.perf_counter() - t0:.2f} s', file=sys.stderr)
        keys = light.load(files['detector_properties'])
        shape = (keys.n_op_channel // len(mods), keys.digit_samples())
        control = [np.stack([np.zeros(shape) if w is None else w
                             for _, w in rows])
                   for rows in out[cfg['check']['control']]]
        numbers = waveform_numbers(control, out['float32'], shape)
        limits = {k: cfg['limits'][k] for k in numbers if k in cfg['limits']}
        # judged as a run is: the sample here is the waveforms' samples
        ok, checks = check.judge(
            dict(numbers, n_packets=numbers['n_wvfm_samples']), limits)
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
