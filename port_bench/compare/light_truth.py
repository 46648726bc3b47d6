"""The light-truth comparison: the kept call's ``light_wvfm_mc_assn``
records against the benchmark's own light truth
(``reference/light_truth.py``) on every (spill, module) of the call, and
the whole file's records against the input.

Records are matched by their key (event, trigger, channel, sample,
segment), packed into one integer per record and sorted, never one by
one in Python.  A record whose value lies within a relative
:data:`NEAR` of the threshold on its side is left out where the other
side lacks it: a float32 rounding decides on which side of the threshold
such a value falls.

Numbers, each held to a limit of the configuration's ``limits``:

- ``truth_records_differ``: the records found in one side and not the
  other (a key twice in the file counts once more), as a share of the
  reference's;
- ``truth_pe_gap_rel_median``: over the records found in both, the median
  of each record's gap of ``pe_current`` relative to the reference's; the
  largest, ``truth_pe_gap_rel_max``, is printed beside it and held to no
  limit (a value that nearly cancels in the SiPM's bipolar response
  divides by a small number);
- ``truth_rows_misplaced``: over the whole file, the records whose
  segment is no segment of the input in their event, or whose channel is
  not one their segment's module writes its records on (with module
  variation, the first module's ids), or whose module holds no segment
  in their event.

Run as a script, it is the control of these numbers on a cell:

    python3 port_bench/compare/light_truth.py --workload 2x2_truth.numi \\
        --seeds 1 2 3

For each seed: the cell's first input file of that seed (as ``run.py``
makes it), and the reference at float32 and at the configuration's
``check.control`` precision (each contributor's series summed in
bfloat16), held to each other as the program is held to the reference and
judged by ``check.judge``.  The control has to fail one number on every
seed; the exit code is 0 when it does.
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
from port_bench.reference import light_truth  # noqa: E402
from port_bench.reference.frozen.io.h5 import File  # noqa: E402

#: the fields of a record's key, most significant first
KEY = ('event_id', 'trigger_id', 'op_channel_id', 'tick', 'segment_id')
#: the relative distance from the threshold within which a record
#: without its counterpart is left out
NEAR = 1e-3


def program_records(path: str) -> np.ndarray:
    """The file's ``light_wvfm_mc_assn`` records (none where it has no
    such dataset)."""
    with File(path, 'r') as f:
        if 'light_wvfm_mc_assn' not in f:
            return np.zeros(0, light_truth.RECORD)
        return np.asarray(f['light_wvfm_mc_assn'])


def _keys(a: np.ndarray, b: np.ndarray,
          fields=KEY) -> tuple[np.ndarray, np.ndarray]:
    """One int64 key a record of ``a`` and of ``b``, ordered as their
    ``fields``: the fields packed side by side above each field's least
    value over both sides (a cell's fields need ~40 of the 62 bits)."""
    cols = [np.concatenate([a[f], b[f]]).astype(np.int64) for f in fields]
    widths = [int(c.max() - c.min()).bit_length() if len(c) else 0
              for c in cols]
    assert sum(widths) <= 62, f'record keys need {sum(widths)} bits'
    key = np.zeros(len(a) + len(b), np.int64)
    for c, w in zip(cols, widths):
        key = (key << w) | (c - c.min() if len(c) else c)
    return key[:len(a)], key[len(a):]


def _near(values: np.ndarray, threshold: float) -> np.ndarray:
    return np.abs(np.abs(values) - threshold) <= NEAR * threshold


def record_numbers(prog: np.ndarray, reference: np.ndarray,
                   threshold: float) -> dict:
    """``truth_records_differ`` and the ``pe_current`` gaps of the records
    ``prog`` against ``reference``, with the count of the reference's
    records (``n_truth_records``) and of the records left out near the
    threshold (``n_truth_near``)."""
    kp, kr = _keys(prog, reference)
    up, ip, counts = np.unique(kp, return_index=True, return_counts=True)
    ur, ir = np.unique(kr, return_index=True)
    at = np.clip(np.searchsorted(ur, up), 0, max(len(ur) - 1, 0))
    hit = ur[at] == up if len(ur) else np.zeros(len(up), bool)
    jp, jr = np.nonzero(hit)[0], at[hit]
    only_p = ~hit
    only_r = np.ones(len(ur), bool)
    only_r[jr] = False
    vp = prog['pe_current'][ip[only_p]]
    vr = reference['pe_current'][ir[only_r]]
    near = int(_near(vp, threshold).sum() + _near(vr, threshold).sum())
    differ = (len(vp) + len(vr) - near + int((counts - 1).sum())
              + len(kr) - len(ur))
    a = prog['pe_current'][ip[jp]]
    b = reference['pe_current'][ir[jr]]
    gap = np.abs(a - b) / np.maximum(np.abs(b), np.finfo(np.float64).tiny)
    return dict(
        truth_records_differ=differ / len(kr) if len(kr) else float(differ),
        truth_pe_gap_rel_median=float(np.median(gap)) if len(gap) else 0.0,
        truth_pe_gap_rel_max=float(gap.max(initial=0.0)),
        n_truth_records=len(kr), n_truth_near=near)


def misplaced(prog: np.ndarray, tracks: np.ndarray, mods: list, files: dict,
              run_keys: dict) -> int:
    """``truth_rows_misplaced``: the records of ``prog`` whose (event,
    segment) is no (event, segment) of a module's batches, or whose
    channel is not one of that module's written ids."""
    keys = light.load(files['detector_properties'])
    calls, groups = charge.plan(tracks, mods)
    passes = light.passes(files, run_keys, mods, keys)
    of_module = {id(p.mod): i for i, p in enumerate(passes)}
    written = np.zeros((len(passes), keys.n_op_channel), bool)
    for i, p in enumerate(passes):
        written[i, p.simulated] = True
    ids = np.asarray(tracks['segment_id'], np.int64)
    ev, seg, where = [], [], []
    for e, g, rows, _ in calls:
        ev.append(np.full(len(rows), e, np.int64))
        seg.append(ids[rows])
        where.append(np.full(len(rows), of_module[id(groups[g][0])]))
    if not ev or not len(prog):
        return len(prog)
    ev, seg, where = (np.concatenate(x) for x in (ev, seg, where))
    home = np.zeros(len(ev), light_truth.RECORD)
    home['event_id'], home['segment_id'] = ev, seg
    k_home, k_prog = _keys(home, prog, ('event_id', 'segment_id'))
    order = np.argsort(k_home, kind='stable')
    at = np.clip(np.searchsorted(k_home[order], k_prog), 0, len(order) - 1)
    found = k_home[order][at] == k_prog
    module = where[order][at]
    channel = prog['op_channel_id'].astype(np.int64)
    in_range = (channel >= 0) & (channel < keys.n_op_channel)
    ok = found & in_range
    ok[ok] = written[module[ok], channel[ok]]
    return int((~ok).sum())


def reference_records(path: str, files: dict, run_keys: dict, device,
                      precision: str = 'float32', log=None) -> tuple:
    """The reference's records of every (spill, module) of the input
    ``path``, with its segments (``charge.read_segments``), its charge
    passes and its count of triggers."""
    mods = charge.modules(files, run_keys)
    tracks = charge.read_segments(path, mods[0].det)
    made = light_truth.run(tracks, mods, files, run_keys, device,
                           precision=precision, log=log)
    records = np.concatenate([r for rows in made for *_, r in rows]
                             or [np.zeros(0, light_truth.RECORD)])
    return records, tracks, mods, sum(len(rows) for rows in made)


def file_numbers(prog: np.ndarray, reference: np.ndarray, tracks, mods,
                 files: dict, run_keys: dict) -> dict:
    """Every number of the comparison of the file's records ``prog``
    (:func:`program_records`) with the reference's
    (:func:`reference_records`)."""
    _, threshold = light_truth.truth_keys(files['simulation_properties'])
    return dict(record_numbers(prog, reference, threshold),
                truth_rows_misplaced=misplaced(prog, tracks, mods, files,
                                               run_keys),
                n_truth_file_records=len(prog))


def compare(kept: dict, files: dict, cfg: dict, rng, device, log) -> dict:
    """The numbers above with the counts they rest on
    (``n_truth_records``: the reference's records; ``n_truth_near``;
    ``n_truth_file_records``: the file's); every (spill, module) of the
    call is compared, so ``rng`` draws nothing."""
    t0 = time.perf_counter()
    reference, tracks, mods, n_trig = reference_records(
        kept['input'], files, cfg['run'], device, log=log)
    t1 = time.perf_counter()
    prog = program_records(kept['output'])
    numbers = file_numbers(prog, reference, tracks, mods, files, cfg['run'])
    log(f'[check] light truth: {n_trig} triggers, {len(reference)} '
        f'reference and {len(prog)} file records, '
        f'{numbers["n_truth_near"]} near the threshold; reference '
        f'{t1 - t0:.3f} s, matching {time.perf_counter() - t1:.3f} s')
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
    _, threshold = light_truth.truth_keys(files['simulation_properties'])
    work = tempfile.mkdtemp(prefix='port_bench-truth-control-')
    try:
        inp = os.path.join(work, 'input.h5')
        traffic.write_run_file(inp, spec, traffic.pool(spec, borders), seed,
                               0)
        out = {}
        for p in ('float32', cfg['check']['control']):
            t0 = time.perf_counter()
            out[p] = reference_records(inp, files, cfg['run'],
                                       harness.DEVICE, precision=p)[0]
            print(f'[control] {workload} seed {seed} light truth {p} '
                  f'{time.perf_counter() - t0:.2f} s', file=sys.stderr)
        numbers = record_numbers(out[cfg['check']['control']],
                                 out['float32'], threshold)
        limits = {k: cfg['limits'][k] for k in numbers if k in cfg['limits']}
        # judged as a run is: the sample here is the truth records
        ok, checks = check.judge(
            dict(numbers, n_packets=numbers['n_truth_records']), limits)
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
