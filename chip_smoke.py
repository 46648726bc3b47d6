#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``larndsim_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Phases, one line each; any failure exits non-zero with nothing caught:

1. device: torch / CUDA versions and the card's name and power limit;
2. build: compile the CUDA kernels of ``larndsim_tpu_torch/csrc`` and the
   host libraries of ``csrc/host`` (host C++: the LZF codec, the truth
   record emitter, the batch assigner);
3. reference: the port's CLI on a tiny noise-free geometry, on the card
   (kernels) and on the CPU (plain versions, which tests/test_torch_*.py
   hold against the JAX package): data packets must agree; then four
   spills at ``event_group_size`` 3 on the card: data packets equal to
   the ungrouped card run's and to the CPU's grouped run's, with fewer
   kernel launches, and, with a per-pixel threshold file, equal to the
   ungrouped run with that file;
4. warm-up: the main path once, capturing the first batch's inputs of the
   charge chain's four kernels;
5. K1 / D1 / K2 / D2: each kernel against its plain PyTorch version on the
   card, at the first batch's shapes (and, for the FSM, a drawn case with
   many hits): K1, D1 (the waveform sum, in the FSM's tick-major rows
   form and the (U, n_ticks) form) and K2 bit for bit (max |err| 0, every
   output equal), D2 (the current fractions) at rtol 1e-5 / atol 1e-6
   with two launches, and one on a CSR made for it, identical, with
   CUDA-event times of both (D1 and D2 alone and with their input build)
   and D1's ``index_put_`` yardstick;
6. slice: the main path timed: ``larndsim_tpu_torch.cli.simulate_pixels.
   run_simulation``, charge only, on a Module-0-shaped detector at the
   published widths (2 TPCs x 2x4 tiles of 70x70 pixels, 78,400 pixels),
   the synthetic 45x45x1891 response and 8 spills of 16 tracks x 42
   segments, with every launch counter set to 0 before and read after;
   the plain versions are forbidden during it (every later run of the
   main path too), D1 launches once per K1 launch and D2 once per batch
   in which a pixel latched; its phase table
   (``utils.trace``: self wall, thread-CPU time and calls per label)
   and the host cost of one phase on the card;
7. light: the charge+light warm-up (the slice's input on the same
   detector with the light keys of one 2x2 module: 96 channels, beam
   trigger, 16 us window, LUT smearing; ``max_light_truth_ids`` 0) keeps
   its first light batch, which is run again on the card (twice) and on
   the CPU with the same draws, made on the CPU from one seed: LUT
   smearing on; off with contributor truth on; on with the LUT-smearing
   truth (K 50, threshold 0.1) by its device route and by its host route
   (``tools.light_check``: waveforms within one quantum, 64 ADC, >= 99.9%
   of samples equal; contributor truth records equal; smearing truth
   records beyond 1e-3 of the threshold equal, pe_current at rtol 1e-4;
   two card runs identical; the two routes agree on the card);
8. charge+light slice: the same run timed, launch counters set to 0
   before and read after, plain kernel versions forbidden: the light
   datasets' shapes, data packets equal to the charge-only slice's, wall,
   segments/s, the light stage's stream span per batch (CUDA events
   around ``simulate_light_batch``: host gaps between its launches
   included, so not busy device time) and peak device memory;
9. truth slice: the charge+light slice with the JAX bench's "2x2, truth
   on" (``max_light_truth_ids`` 50, ``mc_truth_threshold`` 0.1), once per
   truth route, timed as the slice before: packets and ``light_wvfm``
   equal to the truth-off run's, the two routes' records agree, and each
   route's wall, records and their MB, light stage span, peak device and
   host memory, the device route's pulls and the host route's worker
   seconds, and each route's phase table;
   grouped: the charge-only slice at ``event_group_size`` 4 (bench.py's
   default), timed as the slice (hit-set overlap >= 0.7 with the ungrouped
   run: other charge draws), then the truth slice on the device route at
   ``event_group_size`` 4: ``light_wvfm`` equal to the
   ungrouped run's, truth records beyond 1e-3 of the threshold equal
   (pe_current rtol 1e-4), data packets per event within 25% and hit-set
   overlap >= 0.7 (other charge draws), fewer K1 / K2 launches; its wall,
   segments/s, phase table and peak device memory;
   memory log: the charge-only slice with ``save_memory``, read back
   through ``utils.memlog.read_memlog``: the phases ``loading``,
   ``quench_drift_mod-1`` and ``loop_mod-1`` with the card's memory;
10. io: the charge-only slice from its input rewritten chunked (gzip and
   shuffle, 1024 rows a chunk, as edep-sim files are appended), timed as
   the slice: data packets equal to the contiguous input's run;
11. mode0: the slice's input with Module-0's light keys in the threshold
   mode (96 channels in groups of 6 at -2000 ADC, the loader's default
   [1, 10] us window, no LUT smearing, bench.py's module0 truth: contributor
   points, K 50, threshold 0.1): a warm-up of the first spill keeps its
   first light batch, run again on the card (twice) and on the CPU with
   CPU-made draws (trigger tables, window, waveforms and truth records as
   in the light phase); then the run timed at ``event_group_size`` 4 in
   this process, and ungrouped in processes of their own
   (``tools/slice_run.py``), with the light truth shuffled and LZF'd
   (``truth_compression`` 'lzf', the default) and plain ('none'), each
   with the launch counters and the plain versions forbidden: data
   packets equal to the charge-only slice's, at least one batch with two
   triggers, grouped ``light_wvfm`` and ``light_trig`` equal to
   ungrouped, every dataset of the 'lzf' and 'none' outputs equal bit for
   bit through the port's reader; triggers per event, ``n_ticks`` per
   batch, the light datasets' rows, trigger packets per io group, truth
   records, wall, ``truth/h5``, peak host RSS, file and truth bytes,
   launches, peak device memory and the phase tables; the LZF codec's
   decode MB/s (the read-back of the 'lzf' truth) and encode MB/s (a few
   of its chunks);
12. mod2mod: the 2x2 with module variation at full width
   (``assets.geometry.write_2x2``: 4 modules, 8 TPCs, 70x70 tiles at 4.434
   mm on modules 1, 2 and 4 and 80x80 tiles at 3.87975 mm with their own
   response on module 3, two light LUTs, 384 channels; the ``2x2``
   configuration; the 2x2 production truth, LUT smearing, K 50, threshold
   0.1, device route), on bench.py's 2x2 occupancy with every TPC hit
   (SPILLS_2X2): a truth-off run (the warm-up, following the module loop
   with ``tools/module_tracker.py``) keeps the first K1 / K2 inputs of
   modules 1 and 3, each held to its plain version bit for bit and timed,
   and module 3's first light batch, run again on the card (twice) and on
   the CPU with CPU-made draws; then the truth-on run, ungrouped and at
   ``event_group_size`` 4, as the slice (launch counters per module):
   data packets on all 8 io groups, equal to the truth-off run's; a
   merged ``light_wvfm`` of (8, 384, 256) with no per-module dataset left,
   every module's channels lit, equal to the truth-off and the grouped
   runs'; ``light_dat/light_dat_module0-3``; truth records (grouped equal);
   wall, segments/s, peak device memory and the phase tables;
13. ndev: multi-device dispatch (``n_devices``) on one card: the 2x2 run
   of the mod2mod phase (truth on, device route, ungrouped) at
   ``n_devices`` 4 on ``['cuda:0'] * 4`` (the four modules on threads of
   their own, each on its own stream) and 8 (each module on two
   contexts), and the truth slice at ``event_group_size`` 4 at
   ``n_devices`` 2 and 4 on ``cuda:0`` (groups round-robin over the
   contexts, each with its thread and stream), each run twice, launch
   counters set to 0 before and read after (per module), plain versions
   forbidden: every dataset equal bit for bit to the one-context run's
   (``tools/file_check.py``), launches per module equal to it; walls,
   each module thread's wall, peak device memory and the phase tables;
   with two cards or more, the 2x2 again over the real cards (else one
   line says so);
14. ndlar: ND-LAr at full scale (``assets.geometry.write_ndlar``: 35
   modules, 70 TPCs, 80 x 80-pixel tiles at 3.87975 mm, 8.96 M pixel ids,
   50 ns sampling, 6401 ticks, charge only), ``config='ndlar'`` on
   bench.py's ND-LAr occupancy (144 tracks x 42 segments a spill): a
   warm-up of 2 spills at bench's batching (batch_size 10000,
   event_group_size 32) keeps the four chain kernels' first inputs, each
   held to its plain version (D2 at its tolerance) and timed, with K1's
   tile choice on that
   batch counted by the kernel in the compared launch
   (``kernels.binding.induced_current_tiling``: its chunks at R 2 and R 1
   and the chunk halvings); then 4 timed spills at bench's batching and at the
   YAML's own (2500 segments, two TPCs a batch, ungrouped), launch
   counters set to 0 before and read after, plain versions forbidden:
   data packets on all 70 io groups, hit-set overlap of the two batchings
   >= 0.7, walls, segments/s, launches, peak device memory and the phase
   tables;
15. mesh: ``graft_entry.dryrun_multichip(4)`` on ``['cuda:0'] * 4`` (the
   sim step on a 2 x 2 grid and the 2x2 CLI with module variation at
   ``n_devices`` 4, with the JAX dry run's checks), then
   ``parallel.mesh.make_sharded_sim_step`` on a 2 x 2 grid on card 0 at a
   full module's light width (96 channels, 16384 ticks, beam trigger with
   noise, top-8 truth) on the guard's 2x2 batch cut into four cells: each
   cell equal bit for bit to ``parallel.mesh.sim_cell`` alone on the
   card, one K1 and one K2 launch a cell, the step's wall; in both the
   dry run and the timed step, the first K1, D1, K2 and D2 inputs of one
   cell held to their plain versions (D2 at its tolerance), one launch of
   each a cell;
16. host: the host runtime.  The truth slice by the host route
   again at ``truth_workers`` 4, one native emitter call's inputs kept:
   every dataset equal to the one-worker run's, the call's records equal
   byte for byte to the numpy emitter's on the same inputs, both timed;
   then the charge-only slice, the 2x2 run of the mod2mod phase (truth on)
   and ND-LAr at its YAML's batching, each with ``pipeline`` off, on, on,
   off: every dataset and the launches equal to the first run's, the
   walls; the batch assigner on their inputs against its numpy version,
   both timed;
17. probes: the card probes of ``larndsim_tpu_torch/tools``.  P1
   (``probe_folded``): cases a-g, each in its own process (all started
   together), each OK and importing nothing of JAX; the launch step's host
   cost by option (``tools/launch_cost.py``); each of its three kernels
   against its plain version, with the queued ms, the profiler's device us
   and the host us a call of both.  P2 / P3 (``probe_fee`` /
   ``probe_fee2``): every variant timed
   at the probe shapes beside the FSM kernel (the entry points, launch
   counters set to 0 before and read after), then every variant equal to
   its plain version at the same shapes on a random signal;
18. guard: ``tools.perf_guard`` times the chain's hot ops (charge, light
   and the light truth) at production shapes, with each one's bound on
   this card and the share reached (D1 and D2 with their plain versions'
   times and D1's ``index_put_`` yardstick); then its ND-LAr workload
   (``--config ndlar``: one event of 82 tracks x 42 segments on the
   ND-LAr tree), the charge ops alone, with K1's tile choice.
By the end neither JAX nor the JAX package ``larndsim_tpu`` may have been
imported.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.  ``--profile DIR`` adds a cProfile table (host) and a
``torch.profiler`` table (device) of two more slice runs to DIR.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# the slices' inputs and keys, shared with the measurement tools
from larndsim_tpu_torch.tools import slice_run
from larndsim_tpu_torch.tools.slice_run import (MODE0_LIGHT, MODE0_TRUTH,
                                                NDLAR_BENCH, NDLAR_SPILLS,
                                                NDLAR_TIMED, SMEAR_TRUTH,
                                                SPILLS, SPILLS_2X2)

K1_SOURCE = 'larndsim_tpu_torch/csrc/induced_current.cu'
K2_SOURCE = 'larndsim_tpu_torch/csrc/fee_fsm.cu'
K1_REPLACES = 'larndsim_tpu/ops/current_pallas.py:608'
K2_REPLACES = 'larndsim_tpu/ops/fee_pallas.py:293'
D1_SOURCE = 'larndsim_tpu_torch/csrc/pixel_sum.cu'
D2_SOURCE = 'larndsim_tpu_torch/csrc/current_fractions.cu'
#: D1 and D2 replace device ops of the JAX package that are XLA ops shaped
#: for the TPU, not pallas_calls
D1_REPLACES = 'larndsim_tpu/ops/accumulate.py:153'
D2_REPLACES = 'larndsim_tpu/ops/fee.py:228'
XLA_OPS = 'XLA ops, not a pallas_call'
#: the charge chain's four kernels, in the chain's order
CHAIN = ('induced_current', 'sum_pixel_signals', 'fee_fsm',
         'current_fractions')
#: each chain kernel's key in the kept inputs, and its guard row
KEY = dict(induced_current='k1', sum_pixel_signals='d1', fee_fsm='k2',
           current_fractions='d2')
ROW = dict(induced_current='induced_current',
           sum_pixel_signals='sum_pixel_signals_with_csr', fee_fsm='fee_fsm',
           current_fractions='current_fractions_4_with_csr')
P1_SOURCE = 'larndsim_tpu_torch/csrc/probe_window.cu'
P23_SOURCE = 'larndsim_tpu_torch/csrc/probe_fee.cu'
#: P1's kernels: the JAX probe's pallas_calls each replaces, and the case
#: that holds it against its plain version here
P1_KERNELS = dict(probe_window=('tools/probe_folded.py:55, :92', 'a'),
                  probe_roll=('tools/probe_folded.py:74, :138', 'c'),
                  probe_async_copy=('tools/probe_folded.py:115', 'g'))
#: truth contributors per channel in the light phase's truth check
LIGHT_TRUTH_IDS = 64
#: bench.py's event_group_size (bench.py:216-217)
GROUP = 4
#: the ndlar phase's warm-up spills (seed 1), before its NDLAR_TIMED timed
#: spills (seed 2)
NDLAR_WARM = 2


def log(phase: str, msg: str) -> None:
    print(f'[{phase}] {msg}', flush=True)


def event_ms(fn):
    """``fn()`` and its milliseconds on the current stream (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events),
    after one untimed call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def data_packets(path: str) -> collections.Counter:
    from larndsim_tpu_torch.io.h5 import File
    with File(path, 'r') as f:
        pk = np.array(f['packets'])
    pk = pk[pk['packet_type'] == 0]
    return collections.Counter(
        tuple(int(p[k]) for k in ('io_group', 'io_channel', 'chip_id',
                                  'channel_id', 'timestamp', 'dataword'))
        for p in pk)


def reference_phase(tmp: str) -> None:
    """Tiny noise-free run: on the card == on the CPU (plain versions)."""
    from larndsim_tpu_torch.assets.geometry import write_module0
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.params import load_detector
    quiet = dict(long_diff=0.0, tran_diff=0.0, reset_noise_charge=0.0,
                 uncorrelated_noise_charge=0.0, discriminator_noise=0.0)
    paths = write_module0(os.path.join(tmp, 'tiny'), tiles=(1, 1),
                          pixels_per_tile=14, drift_length=3.0,
                          time_interval=(0.0, 30.0), time_padding=10.0,
                          time_window=8.9, detector_overrides=quiet)
    inp = os.path.join(tmp, 'tiny.h5')
    write_input(inp, load_detector(paths['detector_properties'],
                                   paths['pixel_layout']).tpc_borders,
                n_events=2, tracks_per_event=3, segments_per_track=6,
                segment_length=0.4, dEdx=8.0, seed=2)
    kw = dict(config='module0',
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=os.path.join(tmp, 'tiny_response.npy'),
              rand_seed=7, step_scale=2.0)
    outs = {}
    for dev in ('cuda', 'cpu'):
        outs[dev] = os.path.join(tmp, f'tiny_{dev}.h5')
        run_simulation(inp, outs[dev], device=dev, **kw)
    on_card, on_cpu = data_packets(outs['cuda']), data_packets(outs['cpu'])
    n = max(sum(on_card.values()), sum(on_cpu.values()))
    matched = sum((on_card & on_cpu).values())
    assert n > 0 and matched >= 0.99 * n, (matched, n)
    log('reference', f'tiny run: {matched}/{n} data packets agree, card '
        'vs CPU plain versions')
    grouped_reference(tmp, paths, kw)


def grouped_reference(tmp: str, paths: dict, kw: dict) -> None:
    """Four spills of the tiny noise-free geometry at event_group_size 3:
    the packets of the ungrouped run on the card and of the grouped run on
    the CPU; with a per-pixel threshold file, those of its ungrouped run
    (each pixel's threshold by its id, not by its group key)."""
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.params import load_detector
    dm = load_detector(paths['detector_properties'], paths['pixel_layout'],
                       device='cpu')
    inp = os.path.join(tmp, 'tiny_spills.h5')
    write_input(inp, dm.tpc_borders, n_events=4, tracks_per_event=3,
                segments_per_track=6, segment_length=0.4, dEdx=8.0, seed=7)
    nx, ny = dm.params.n_pixels
    keys = np.arange(nx * ny * dm.params.n_tpcs)
    thr = os.path.join(tmp, 'tiny_thresholds.npz')
    np.savez(thr, keys=keys, values=np.random.default_rng(3).uniform(
        5e3, 9e3, len(keys)).astype(np.float32), default=7e3)
    runs = {}
    for name, dev, g, thr_file in (('card', 'cuda', 1, None),
                                   ('card grouped', 'cuda', 3, None),
                                   ('CPU grouped', 'cpu', 3, None),
                                   ('thresholds', 'cuda', 1, thr),
                                   ('thresholds grouped', 'cuda', 3, thr)):
        out = os.path.join(tmp, f'tiny_{name.replace(" ", "_")}.h5')
        binding.reset_launches()
        run_simulation(inp, out, device=dev, event_group_size=g,
                       pixel_thresholds_file=thr_file, **kw)
        runs[name] = (data_packets(out), binding.launches['induced_current'])
    n = sum(runs['card'][0].values())
    assert n > 0
    assert runs['card grouped'][0] == runs['card'][0], 'grouped packets'
    assert runs['CPU grouped'][0] == runs['card'][0], 'CPU grouped packets'
    assert runs['thresholds grouped'][0] == runs['thresholds'][0], \
        'grouped packets with per-pixel thresholds'
    assert runs['thresholds'][0] != runs['card'][0], \
        'the threshold file changed nothing'
    assert runs['card grouped'][1] < runs['card'][1], \
        (runs['card grouped'][1], runs['card'][1])
    log('reference', f'4 spills at event_group_size 3: {n} data packets '
        'equal to the ungrouped card run and to the CPU grouped run; '
        f'{sum(runs["thresholds"][0].values())} with a per-pixel threshold '
        'file, equal grouped and ungrouped; K1 launches '
        f'{runs["card grouped"][1]} grouped vs {runs["card"][1]}')


def phase_table(name: str) -> str:
    """The last run's phase table (``utils.trace.report``), printed under
    ``name``; it must hold the charge chain's phases."""
    from larndsim_tpu_torch.utils import trace
    table = trace.report()
    assert 'charge_batch' in table, f'{name}: no charge phase in the table'
    log('phases', f'{name} (label, self wall s, self thread-CPU s, '
        'calls):')
    for row in table.splitlines():
        print(f'    {row}', flush=True)
    return table


def trace_cost(n: int = 2000) -> dict:
    """Host microseconds of one empty phase that names the card, its table
    read once at the end as ``report()`` reads it, and of a profiler range
    alone (which a phase opens only while a profiler runs)."""
    import torch
    from larndsim_tpu_torch.utils import trace

    def us(body, end=torch.cuda.synchronize):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            body()
        end()
        return (time.perf_counter() - t0) / n * 1e6

    def card_phase():
        with trace.phase('cost', 'cuda'):
            pass

    def profiler_range():
        with torch.profiler.record_function('cost'):
            pass
    cost = dict(phase=us(card_phase, trace.report),
                profiler_range=us(profiler_range))
    trace.reset()
    return cost


def packet_events(path: str):
    """Data packets per event and the hit set (io_group, chip, channel)."""
    from larndsim_tpu_torch.io.h5 import File
    with File(path, 'r') as f:
        pk = np.array(f['packets'])
        ev = np.array(f['mc_packets_assn'])['event_ids'][:, 0]
    data = pk['packet_type'] == 0
    hits = set(zip(pk['io_group'][data].tolist(), pk['chip_id'][data].tolist(),
                   pk['channel_id'][data].tolist()))
    return collections.Counter(ev[data].tolist()), hits


@contextlib.contextmanager
def kernel_inputs():
    """The chain kernels' first inputs on each thread while the block runs
    (``ops.current.induced_current``, ``ops.accumulate.sum_pixel_signals``,
    ``ops.fee.fee_fsm`` and ``ops.fee.current_fractions`` wrapped):
    ``{thread name: {'k1': args, 'k2': args, 'd1': (args, kwargs), 'd2':
    (args, kwargs)}}``, in the order of the threads' first calls; D2's
    first call that scans an ADC slot."""
    from larndsim_tpu_torch.ops import accumulate, current, fee
    kept = collections.defaultdict(dict)
    targets = ((current, 'induced_current'), (accumulate, 'sum_pixel_signals'),
               (fee, 'fee_fsm'), (fee, 'current_fractions'))
    origs = [getattr(mod, name) for mod, name in targets]

    def keep(key, fn):
        def spy(*args, **kwargs):
            if key != 'd2' or kwargs['n_adc_scan'] > 0:
                kept[threading.current_thread().name].setdefault(
                    key, (args, kwargs) if key[0] == 'd' else args)
            return fn(*args, **kwargs)
        return spy
    for (mod, name), fn in zip(targets, origs):
        setattr(mod, name, keep(KEY[name], fn))
    try:
        yield kept
    finally:
        for (mod, name), fn in zip(targets, origs):
            setattr(mod, name, fn)


def kept_gib(kept) -> float:
    """GiB of the distinct card storages that kept kernel inputs hold."""
    import torch
    sizes = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                sizes[x.untyped_storage().data_ptr()] = \
                    x.untyped_storage().nbytes()
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(kept)
    return sum(sizes.values()) / 2 ** 30


def hold_cell(kept: dict, cell: str, label: str) -> dict:
    """K1, D1, K2 and D2 on the first inputs of mesh cell ``cell`` (its
    thread's name) against their plain versions on the card: bit for bit,
    D2 within its tolerance."""
    return dict(k1=compare_k1(kept[cell]['k1'], label, plain_once=True),
                d1=compare_d1(kept[cell]['d1'], label, plain_once=True),
                k2=_fsm_case(kept[cell]['k2'], label, plain_once=True),
                d2=compare_d2(kept[cell]['d2'], label, plain_once=True))


def compare_k1(args, label: str = 'first batch',
               plain_once: bool = False, tiling: bool = False) -> dict:
    """K1 against its plain version on ``args``, both timed; with
    ``plain_once`` the plain version is timed on the comparison's own call
    (CUDA events), not on two more (a plain call at ND-LAr's shapes takes
    seconds); with ``tiling`` the compared launch also counts its tile
    choice (``kernels.binding.induced_current_tiling``), kept under
    ``tiling``."""
    import torch
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.ops import current
    from larndsim_tpu_torch.tools import perf_guard as pg
    if tiling:
        got, tiles = binding.induced_current_tiling(*args)
    else:
        got, tiles = current.induced_current(*args), None
    torch.cuda.synchronize()
    want, plain_once_ms = event_ms(lambda: current.current_plain(*args))
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    assert peak > 0, f'{label}: no induced current'
    assert err == 0.0, f'K1 {label} disagrees: max |err| {err} (peak {peak})'
    ms = cuda_ms(lambda: current.induced_current(*args), reps=5)
    plain_ms = plain_once_ms if plain_once else cuda_ms(
        lambda: current.current_plain(*args), reps=1)
    c = pg.k1_costs(args)
    b = pg.bound(c['bytes'], c['ops'], ms)
    S, n_steps = args[0].shape
    log('K1', f'induced current, {label} (S={S}, P={args[4].shape[1]}, '
        f't_sig={args[9].shape[1]}, n_steps={n_steps}): max |err| {err:.3e} '
        f'(peak {peak:.4e}, tolerance 0); kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms, bound {b["bound_ms"]:.4f} ms by {b["bound_by"]}')
    out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b['bound_ms'], bound_by=b['bound_by'])
    if tiles is not None:
        log('K1', f'{label} tile choice, counted by the kernel: '
            f'{tiles["pairs"]} pairs with live steps, {tiles["r2_chunks"]} chunks at R 2 and '
            f'{tiles["r1_chunks"]} at R 1, {tiles["halvings"]} chunk '
            f'halvings; at most {tiles["max_slots"]} response rows and a '
            f'shift span of {tiles["max_span"]} ticks in a chunk, against '
            f'{tiles["window_floats"]} window floats')
        out['tiling'] = tiles
    return out


def _fsm_case(args, label: str, plain_once: bool = False):
    """K2 against its plain version on ``args``, both timed
    (``plain_once`` as for :func:`compare_k1`)."""
    import torch
    from larndsim_tpu_torch.ops import fee
    from larndsim_tpu_torch.tools import perf_guard as pg
    got = fee.fee_fsm(*args)
    torch.cuda.synchronize()
    want, plain_once_ms = event_ms(lambda: fee.fee_fsm_plain(*args))
    err = 0.0
    for name, a, b in zip(fee.FeeResult._fields, want, got):
        err = max(err, float((b.double() - a.double()).abs().max()))
        assert torch.equal(a, b), f'K2 {label} {name} differs: max |err| {err}'
    n_hits = int(want[2].sum())
    assert n_hits > 0, f'K2 {label}: no hits'
    ms = cuda_ms(lambda: fee.fee_fsm(*args), reps=5)
    plain_ms = plain_once_ms if plain_once else cuda_ms(
        lambda: fee.fee_fsm_plain(*args), reps=1)
    n_scan, U = args[0].shape
    c = pg.fsm_costs(n_scan, U, args[5].max_adc, args[4].shape[0],
                     drawn=False)
    b = pg.bound(c['bytes'], c['ops'], ms)
    log('K2', f'FSM {label} (U={U}, n_scan={n_scan}, max_adc='
        f'{args[5].max_adc}): {n_hits} hits, integers and floats equal (max '
        f'|err| {err:.3e}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'bound {b["bound_ms"]:.4f} ms by {b["bound_by"]}')
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b['bound_ms'], bound_by=b['bound_by'])


def compare_d1(call, label: str = 'first batch', plain_once: bool = False,
               library: bool = False) -> dict:
    """D1, the waveform sum, on ``call`` ((args, kwargs) as the chain
    passes them: the FSM's ``rows`` and the batch's CSR) against its plain
    version, bit for bit, in the rows form and in the (U, n_ticks) form;
    timed alone (the CSR given) and with its input build (the CSR made in
    the call), the plain version too (``plain_once`` as for
    :func:`compare_k1`); with ``library`` its yardstick too, one
    ``index_put_`` with accumulate=True of the aligned entries into the
    (rows, U) buffer (``tools.perf_guard.pixel_sum_library``; atol 1e-6 x
    peak: its atomic adds run in any order)."""
    import torch
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.ops import accumulate
    from larndsim_tpu_torch.tools import perf_guard as pg
    args, kw = call
    signals, pix_idx, track_starts, U = args
    base = dict(n_ticks=kw['n_ticks'], time_sampling=kw['time_sampling'])
    rows = kw.get('rows') or kw['n_ticks']
    csr = kw.get('csr') or accumulate.pixel_csr(
        pix_idx, track_starts, U, time_sampling=kw['time_sampling'])
    got = accumulate.sum_pixel_signals(*args, **base, rows=rows, csr=csr)
    got_u = accumulate.sum_pixel_signals(*args, **base)
    torch.cuda.synchronize()
    want_u, plain_once_ms = event_ms(
        lambda: accumulate.sum_pixel_signals_plain(*args, **base))
    want = accumulate.sum_pixel_signals_plain(*args, **base, rows=rows)
    peak = float(want.abs().max())
    err = max(float((got - want).abs().max()),
              float((got_u - want_u).abs().max()))
    assert peak > 0, f'D1 {label}: no waveform'
    assert torch.equal(got, want) and torch.equal(got_u, want_u), \
        f'D1 {label} disagrees: max |err| {err} (peak {peak})'
    del got_u, want_u
    ms = cuda_ms(lambda: binding.sum_pixel_rows(
        signals, csr.pairs, csr.offsets, kw['n_ticks'], rows), reps=5)
    ms_inputs = cuda_ms(lambda: accumulate.sum_pixel_signals(
        *args, **base, rows=rows), reps=5)
    plain_ms = plain_once_ms if plain_once else cuda_ms(
        lambda: accumulate.sum_pixel_signals_plain(*args, **base, rows=rows),
        reps=1)
    lib_ms, lib = None, 'not timed on this batch'
    if library:
        call_lib, out = pg.pixel_sum_library(args, dict(base, rows=rows))
        call_lib()
        lib_err = float((out - want).abs().max())
        assert lib_err <= 1e-6 * peak, (lib_err, peak)
        lib_ms = cuda_ms(call_lib, reps=5)
        lib = f'{lib_ms:.3f} ms (max |err| {lib_err:.3e})'
        del out
    c = pg.sum_costs(*args, kw['n_ticks'], kw['time_sampling'], rows=rows)
    b = pg.bound(c['bytes'], c['ops'], ms)
    S, P, T = signals.shape
    log('D1', f'waveform sum, {label} (S={S}, P={P}, T={T}, U={U}, '
        f'n_ticks={kw["n_ticks"]}, rows={rows}): max |err| {err:.3e} (peak '
        f'{peak:.4e}, tolerance 0; rows and (U, n_ticks) forms); kernel '
        f'{ms:.3f} ms alone, {ms_inputs:.3f} ms with its CSR made, plain '
        f'{plain_ms:.3f} ms, index_put_ {lib}, bound {b["bound_ms"]:.4f} '
        f'ms by {b["bound_by"]} (share {b["share"]:.4f})')
    return dict(max_abs_err=err, ms=ms, ms_with_inputs=ms_inputs,
                plain_ms=plain_ms, bound_ms=b['bound_ms'],
                bound_by=b['bound_by'], library_ms=lib_ms)


def compare_d2(call, label: str = 'first batch',
               plain_once: bool = False) -> dict:
    """D2, the current fractions, on ``call`` ((args, kwargs) as the chain
    passes them, with the batch's CSR) against its plain version at rtol
    1e-5 / atol 1e-6; two launches, and a launch whose CSR is made in the
    call, identical; timed alone (the CSR and A given) and with its input
    build, the plain version too (``plain_once`` as for
    :func:`compare_k1`)."""
    import torch
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.ops import accumulate, fee
    from larndsim_tpu_torch.tools import perf_guard as pg
    args, kw = call
    kw = pg.plain_kw(kw)
    signals, pix_idx, slot, track_starts, res, det = args
    U = res.integrals.shape[0]
    csr = call[1].get('csr') or accumulate.pixel_csr(
        pix_idx, track_starts, U, time_sampling=det.time_sampling)
    got = fee.current_fractions(*args, **kw, csr=csr)
    again = fee.current_fractions(*args, **kw, csr=csr)
    built = fee.current_fractions(*args, **kw)
    torch.cuda.synchronize()
    want, plain_once_ms = event_ms(
        lambda: fee.current_fractions_plain(*args, **kw))
    assert float(want.max()) > 0, f'D2 {label}: no fraction'
    assert torch.equal(got, again), f'D2 {label}: two launches differ'
    assert torch.equal(got, built), \
        f'D2 {label}: the shared CSR and a CSR made for it differ'
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               msg=lambda m: f'D2 {label}: {m}')
    n_a = min(kw['n_adc_scan'], kw['max_adc'])
    A = fee.fraction_decay(det, signals.device)
    dt = float(np.float32(det.time_sampling))
    ms = cuda_ms(lambda: binding.current_fractions(
        signals, csr.pairs, csr.offsets, slot, res.reset_start,
        res.latch_end, A, dt, max_adc=kw['max_adc'],
        max_tracks=kw['max_tracks'], n_adc_scan=n_a,
        n_weights=fee.scan_ticks(det) + 2), reps=5)
    ms_inputs = cuda_ms(lambda: fee.current_fractions(*args, **kw), reps=5)
    plain_ms = plain_once_ms if plain_once else cuda_ms(
        lambda: fee.current_fractions_plain(*args, **kw), reps=1)
    c = pg.fraction_costs(signals, pix_idx, slot, track_starts,
                          res.reset_start, res.latch_end, kw['max_tracks'],
                          n_a, det.time_sampling)
    b = pg.bound(c['bytes'], c['ops'], ms)
    S, P, T = signals.shape
    log('D2', f'current fractions, {label} (S={S}, P={P}, T={T}, U={U}, '
        f'{n_a} of {kw["max_adc"]} ADC slots, {kw["max_tracks"]} tracks): '
        f'max |err| {err:.3e} (rtol 1e-5 / atol 1e-6), two launches and the '
        f'CSR made for it identical; kernel {ms:.3f} ms alone, '
        f'{ms_inputs:.3f} ms with its inputs made, plain {plain_ms:.3f} ms, '
        f'bound {b["bound_ms"]:.4f} ms by {b["bound_by"]} (share '
        f'{b["share"]:.4f})')
    return dict(max_abs_err=err, ms=ms, ms_with_inputs=ms_inputs,
                plain_ms=plain_ms, bound_ms=b['bound_ms'],
                bound_by=b['bound_by'], library_ms=None, n_adc_scan=n_a)


def compare_k2(args, det) -> dict:
    """The first batch's FSM inputs, then a drawn case with many hits."""
    import torch
    from larndsim_tpu_torch.ops import fee
    first = _fsm_case(args, 'first batch')
    dev = args[0].device
    gen = torch.Generator(dev).manual_seed(11)
    U = 16384
    n_scan = fee.scan_ticks(det)
    sig = torch.rand((n_scan, U), generator=gen, device=dev) * 30000.0
    sig = torch.where(torch.rand((n_scan, U), generator=gen, device=dev)
                      > 0.97, sig, 0.0)
    sig[det.time_ticks:] = 0.0
    s = fee.fsm_scalars(det, max_adc=args[5].max_adc)
    drawn = _fsm_case(
        (sig, torch.randn((n_scan, 5, U), generator=gen, device=dev),
         torch.randn((U,), generator=gen, device=dev) * s.sigma_reset,
         torch.full((U,), det.f32('discrimination_threshold'), device=dev),
         fee.tick_times(det), s), 'drawn')
    first['max_abs_err'] = max(first['max_abs_err'], drawn['max_abs_err'])
    return first


def p1_entries() -> list[dict]:
    """P1: the seven cases, each in its own process (as the JAX probe runs
    them; all started together), then each kernel against its plain
    version on the card: queued ms a call, the profiler's device us a call
    and the host us a call of both, and the launch step's host cost by
    option (``tools/launch_cost.py``)."""
    import torch
    from larndsim_tpu_torch.tools import launch_cost as lc
    from larndsim_tpu_torch.tools import perf_guard as pg
    from larndsim_tpu_torch.tools import probe_folded as p1
    records = p1.run_isolated('cuda')
    bad = [r for r in records if not r['ok']]
    assert not bad, f'P1 cases failed: {bad}'
    log('probes', 'P1 ' + ' '.join(f'{r["case"]}:OK' for r in records)
        + ', each in its own process with nothing of JAX imported')
    dev = torch.device('cuda', torch.cuda.current_device())
    for option, us in lc.launch_options(dev).items():
        log('probes', f'P1 launch step, {option}: {us:.2f} us host')
    steps = lc.wrapper_steps(dev)
    for name, by_step in steps.items():
        log('probes', f'P1 {name} wrapper, host us by step: ' + ', '.join(
            f'{step} {us:.2f}' for step, us in by_step.items()))
    entries = []
    for name, (call, plain) in lc.case_calls(dev).items():
        replaces, case = P1_KERNELS[name]
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err == 0.0, f'{name} disagrees with its plain version: {err}'
        ms, plain_ms = lc.queued_ms(call), lc.queued_ms(plain)
        dev_us, dev_ops = lc.device_us(call)
        plain_dev_us, plain_ops = lc.device_us(plain)
        host_us = steps[name]['whole call']
        plain_host_us = steps[name]['plain call']
        b = pg.bound(2 * got.numel() * 4, 0)   # the window in, once out
        launches = sum(r['launches'] for r in records
                       if p1.KERNEL[r['case']] == name)
        assert launches > 0, (name, records)
        log('probes', f'P1 {name} (case {case}, out {tuple(got.shape)}): '
            f'equal to its plain version; {launches} launches in the cases; '
            f'queued {ms:.4f} ms a call, plain (one PyTorch call) '
            f'{plain_ms:.4f} ms; device {dev_us:.3f} us a call '
            f'({", ".join(dev_ops)}), plain {plain_dev_us:.3f} us '
            f'({", ".join(plain_ops)}); host {host_us:.2f} us a call, plain '
            f'{plain_host_us:.2f} us; bound {b["bound_ms"]:.6f} ms by '
            f'{b["bound_by"]}')
        entries.append(dict(
            name=name, route='cuda', source=P1_SOURCE, replaces=replaces,
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b['bound_ms'], bound_by=b['bound_by'],
            library_ms=plain_ms,
            library='the plain version: one PyTorch call',
            device_us=dev_us, plain_device_us=plain_dev_us, host_us=host_us,
            plain_host_us=plain_host_us, host_steps_us=steps[name]))
    return entries


def _max_err(got, want, skip_outs: bool) -> float:
    """Max |got - want| over a probe's results (the ``anyio`` outputs,
    which neither version writes, skipped); raises unless all are equal."""
    import torch
    err = 0.0
    for name, g, w in zip(want._fields, got, want):
        if name == 'outs':
            if skip_outs:
                continue
            pairs = list(zip(g, w))
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            assert a.shape == b.shape and a.dtype == b.dtype, name
            err = max(err, float((a.double() - b.double()).abs().max()))
            assert torch.equal(a, b), f'{name} disagrees: max |err| {err}'
    return err


def p23_entries() -> list[dict]:
    """P2 / P3 through their entry points at the probe shapes (launch
    counters set to 0 before, read after), then every variant against its
    plain version at the same shapes on a random signal."""
    import torch
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.tools import probe_fee, probe_fee2
    binding.reset_launches()
    records = {'probe_fee': probe_fee.main([]),
               'probe_fee2': probe_fee2.main([])}
    torch.cuda.synchronize()
    launches = dict(binding.launches)
    U, n_scan_p, n_scan = probe_fee.U, probe_fee.N_SCAN_P, probe_fee.N_SCAN
    entries = []
    for name, mod, ref, replaces in (
            ('probe_fee', probe_fee, 'full', 'tools/probe_fee.py:133'),
            ('probe_fee2', probe_fee2, 'base',
             'tools/probe_fee2.py:133, :146')):
        assert launches[name] > 0, launches
        run = getattr(mod, name)
        plain = getattr(mod, f'{name}_plain')
        args = tuple(mod.make_inputs(U, n_scan_p, 'cuda').values())
        err, plain_ms = 0.0, {}
        for v in mod.VARIANTS:
            got = run(v, *args, n_scan=n_scan)
            want, plain_ms[v] = event_ms(
                lambda: plain(v, *args, n_scan=n_scan))
            err = max(err, _max_err(got, want, 'anyio' in v))
        del args
        rows = records[name]['rows']
        variants = {}
        for v in mod.VARIANTS:
            b = mod.costs(v, U, n_scan, n_scan_p)
            variants[v] = dict(ms=rows[v]['min_ms'],
                               share_of_k2=rows[v]['share_of_k2'],
                               bound_ms=b['bound_ms'], bound_by=b['bound_by'],
                               share=b['bound_ms'] / rows[v]['min_ms'],
                               plain_ms=plain_ms[v])
        k2_ms = rows['fee_fsm (K2)']['min_ms']
        log('probes', f'{name}: {len(mod.VARIANTS)} variants equal to their '
            f'plain versions (U={U}, n_scan_p={n_scan_p}, n_scan={n_scan}, '
            f'random signal; max |err| {err}); {launches[name]} launches in '
            f'the timed run; {ref} {variants[ref]["ms"]:.3f} ms vs plain '
            f'{plain_ms[ref]:.3f} ms')
        entries.append(dict(
            name=name, route='cuda', source=P23_SOURCE, replaces=replaces,
            launches=launches[name], max_abs_err=err,
            ms=variants[ref]['ms'], plain_ms=plain_ms[ref],
            bound_ms=variants[ref]['bound_ms'],
            bound_by=variants[ref]['bound_by'], library_ms=None,
            library='none: a per-pixel recurrence over ticks; no one '
            'PyTorch call computes it', k2_ms=k2_ms, variants=variants))
    return entries


def guard_phase(config: str = 'module0') -> dict:
    """tools.perf_guard at production shapes (``config`` its workload),
    counters set to 0 before and read after."""
    import torch
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.tools import perf_guard as pg
    binding.reset_launches()
    entry = pg.main(['--config', config])
    torch.cuda.synchronize()
    launches = dict(binding.launches)
    assert launches['induced_current'] > 0 and launches['fee_fsm'] > 0, \
        launches
    for name, r in entry['roofline'].items():
        assert np.isfinite(entry['ops_ms'][name]['min_ms']), name
        shapes = entry['truth_shapes' if name.startswith('light_truth')
                       else 'group_shapes' if name.endswith('_beam')
                       or name.endswith('_beam_x4')
                       else 'light_shapes' if name.startswith('light_')
                       else 'shapes']
        log('guard', f'{config} {name}: '
            f'{entry["ops_ms"][name]["min_ms"]:.3f} ms, bound '
            f'{r["bound_ms"]:.4f} ms by {r["bound_by"]}, share '
            f'{r["share"]:.4f} (shapes {shapes})')
    for name, t in entry['host_ms'].items():
        assert np.isfinite(t['min_ms']), name
        log('guard', f'{name}: {t["min_ms"]:.3f} ms host wall (no bound; '
            f'shapes {entry["truth_shapes"]})')
    return entry


def light_phase(seen: list) -> None:
    """The first light batch of the charge+light warm-up, run again on the
    card twice and on the CPU with the same CPU-made draws."""
    from larndsim_tpu_torch.tools import light_check
    assert len(seen) == 1, 'the warm-up ran no light batch'
    args, kw = seen[0]
    thr = SMEAR_TRUTH['mc_truth_threshold']
    on_card = {}
    for route, smear, truth, path in (
            ('smearing', True, 0, None),
            ('contributor truth', False, LIGHT_TRUTH_IDS, None),
            ('smearing truth, device', True,
             SMEAR_TRUTH['max_light_truth_ids'], 'device'),
            ('smearing truth, host', True,
             SMEAR_TRUTH['max_light_truth_ids'], 'host')):
        opts = dict(smearing=smear, truth_ids=truth, truth_path=path,
                    threshold=thr if path else None)
        card = light_check.rerun(args, kw, 'cuda', 5, **opts)
        again = light_check.rerun(args, kw, 'cuda', 5, **opts)
        cpu = light_check.rerun(args, kw, 'cpu', 5, **opts)
        assert light_check.identical(card, again), \
            f'light {route}: two card runs differ'
        rec = light_check.compare(card, cpu, args[1],
                                  smeared_at=thr if path else None)
        assert rec['peak'] > 0, f'light {route}: an empty waveform'
        assert (rec['records'] > 0) == bool(truth), rec
        on_card[path] = card
        near = (f' ({rec["near"][0]} / {rec["near"][1]} within 1e-3 of '
                'the threshold, not compared)' if path else '')
        log('light', f'{route}: one beam batch (S={args[0].size}, '
            f'C={card.waveforms.shape[1]}, n_ticks={card.n_ticks}) -> '
            f'{card.waveforms.shape}; card vs CPU, same draws: max |err| '
            f'{rec["max_abs_err"]:.1f} ADC (peak {rec["peak"]:.1f}, '
            f'tolerance one quantum 64), {100 * rec["equal_share"]:.3f}% '
            f'of samples equal (>= 99.9%), {rec["records"]} truth records '
            f'equal (pe_current rtol 1e-4){near}; two card runs identical')
    rec = light_check.compare(on_card['device'], on_card['host'], args[1],
                              smeared_at=thr)
    log('light', f'smearing truth on the card, device route vs host route: '
        f'{rec["records"]} records agree ({rec["near"][0]} / '
        f'{rec["near"][1]} within 1e-3 of the threshold), waveforms max '
        f'|err| {rec["max_abs_err"]:.1f} ADC')


def peak_rss_gib() -> float:
    """This process's peak resident set so far (Linux: ru_maxrss in
    KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def truth_phase(tmp: str, out_off: str, kw_l: dict, n_seg: int,
                light_slice, light_model) -> dict:
    """The charge+light slice with the smearing truth on, once per route:
    physics equal to the truth-off run ``out_off``, the routes' records in
    agreement.  Returns each route's run: its keywords, output, launches
    and wall."""
    from larndsim_tpu_torch.assets.geometry import write_module0
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.tools import light_check
    paths_t = write_module0(os.path.join(tmp, 'module0_truth'), light=True,
                            sim_overrides=SMEAR_TRUTH)
    with File(out_off, 'r') as f:
        wv_off = np.array(f['light_wvfm'])
    pulls, worker_s = [], []
    orig_pull = light_model._pull_group_dense_truth
    orig_worker = light_model._worker_smeared_truth

    def spy_pull(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig_pull(*args, **kwargs)
        pulls.append((time.perf_counter() - t0,
                      12 * sum(len(o['tick']) for o in out)))
        return out

    def spy_worker(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig_worker(*args, **kwargs)
        worker_s.append(time.perf_counter() - t0)
        return out
    records, runs = {}, {}
    for route in ('device', 'host'):
        out = os.path.join(tmp, f'slice_truth_{route}.h5')
        run_kw = dict(kw_l, simulation_properties=paths_t[
            'simulation_properties'], truth_path=route)
        pulls.clear()
        worker_s.clear()
        light_model._pull_group_dense_truth = spy_pull
        light_model._worker_smeared_truth = spy_worker
        rss_before = peak_rss_gib()
        try:
            wall, launches, peak, trig_ms, _ = light_slice(out, run_kw)
        finally:
            light_model._pull_group_dense_truth = orig_pull
            light_model._worker_smeared_truth = orig_worker
        runs[route] = dict(kw=run_kw, out=out, launches=launches, wall=wall,
                           table=phase_table(f'truth slice, {route} route'))
        assert data_packets(out) == data_packets(out_off), \
            f'truth {route}: packets differ from the truth-off run'
        with File(out, 'r') as f:
            assert np.array_equal(np.array(f['light_wvfm']), wv_off), \
                f'truth {route}: light_wvfm differs from the truth-off run'
            rec = np.array(f['light_wvfm_mc_assn'])
        assert len(rec) > 0 and np.isfinite(rec['pe_current']).all()
        assert (np.abs(rec['pe_current'])
                > SMEAR_TRUTH['mc_truth_threshold']).all()
        records[route] = rec
        # the process's peak: a rise over the route is the route's peak
        rss = (f'peak host RSS of the process {rss_before:.2f} GiB before '
               f'the run, {peak_rss_gib():.2f} GiB after')
        if route == 'device':
            extra = (f'{len(pulls)} pulls, '
                     f'{sum(b for _, b in pulls) / 1e6:.3f} MB (indices + '
                     'values) in '
                     f'{1e3 * sum(t for t, _ in pulls):.3f} ms in all')
        else:
            extra = (f'{len(worker_s)} worker recomputes, '
                     f'{sum(worker_s):.3f} host s in all')
        log('truth slice', f'{route} route: wall {wall:.3f} s, '
            f'{n_seg / wall:.1f} segments/s; {len(rec)} '
            f'records, {rec.nbytes / 1e6:.3f} MB; light stage stream span '
            f'{np.mean(trig_ms):.3f} ms per triggering batch (min '
            f'{min(trig_ms):.3f}, max {max(trig_ms):.3f}, {len(trig_ms)} '
            f'batches); {extra}; launches {launches}; peak device memory '
            f'{peak:.2f} GiB, {rss}; packets '
            'and light_wvfm equal to the truth-off run')
    cols = ('trigger_id', 'op_channel_id', 'tick', 'event_id', 'segment_id')
    agree = light_check.records_agree(records['host'], records['device'],
                                      SMEAR_TRUTH['mc_truth_threshold'],
                                      keys=cols)
    log('truth slice', f'device vs host route: {agree["records"]} records '
        f'agree ({agree["near"][0]} / {agree["near"][1]} within 1e-3 of the '
        'threshold)')
    return runs


def grouped_phase(tmp: str, solo: dict, charge_only: dict, n_seg: int,
                  main_path) -> dict:
    """The charge-only slice, then the truth slice on the device route, at
    event_group_size GROUP, against their ungrouped runs ``charge_only``
    and ``solo``."""
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.tools import light_check
    out = os.path.join(tmp, 'slice_grouped.h5')
    wall, launches, peak = main_path(out, dict(charge_only['kw'],
                                               event_group_size=GROUP))
    phase_table(f'charge-only slice, event_group_size {GROUP}')
    per_ev, hits = packet_events(out)
    per_ev_solo, hits_solo = packet_events(charge_only['out'])
    overlap = len(hits & hits_solo) / max(len(hits | hits_solo), 1)
    assert overlap >= 0.7, overlap
    log('grouped', f'charge-only slice, event_group_size {GROUP}: wall '
        f'{wall:.3f} s ({charge_only["wall"]:.3f} s ungrouped), '
        f'{n_seg / wall:.1f} segments/s; K1 / K2 launches '
        f'{launches["induced_current"]} / {launches["fee_fsm"]} '
        f'(ungrouped {charge_only["launches"]["induced_current"]} / '
        f'{charge_only["launches"]["fee_fsm"]}); data packets '
        f'{sum(per_ev.values())} vs {sum(per_ev_solo.values())}, hit-set '
        f'overlap {overlap:.3f}; peak device memory {peak:.2f} GiB')
    out = os.path.join(tmp, 'slice_truth_grouped.h5')
    wall, launches, peak = main_path(out, dict(solo['kw'],
                                               event_group_size=GROUP))
    table = phase_table(f'truth slice, device route, event_group_size '
                        f'{GROUP}')
    with File(out, 'r') as f, File(solo['out'], 'r') as g:
        assert np.array_equal(np.array(f['light_wvfm']),
                              np.array(g['light_wvfm'])), \
            'grouped light_wvfm differs from the ungrouped run'
        rec, rec_solo = (np.array(x['light_wvfm_mc_assn']) for x in (f, g))
    agree = light_check.records_agree(
        rec, rec_solo, SMEAR_TRUTH['mc_truth_threshold'],
        keys=('trigger_id', 'op_channel_id', 'tick', 'event_id',
              'segment_id'))
    per_ev, hits = packet_events(out)
    per_ev_solo, hits_solo = packet_events(solo['out'])
    assert set(per_ev) == set(per_ev_solo), (per_ev, per_ev_solo)
    worst = max(abs(per_ev[e] - per_ev_solo[e]) / max(per_ev[e],
                                                      per_ev_solo[e])
                for e in per_ev)
    overlap = len(hits & hits_solo) / max(len(hits | hits_solo), 1)
    assert worst <= 0.25 and overlap >= 0.7, (worst, overlap)
    for name in ('induced_current', 'fee_fsm'):
        assert launches[name] < solo['launches'][name], \
            (name, launches[name], solo['launches'][name])
    log('grouped', f'truth slice, device route, event_group_size {GROUP}: '
        f'wall {wall:.3f} s ({solo["wall"]:.3f} s ungrouped), '
        f'{n_seg / wall:.1f} segments/s; launches {launches} (ungrouped '
        f'{solo["launches"]}); light_wvfm equal to the ungrouped run; '
        f'{agree["records"]} truth records equal ({agree["near"][0]} / '
        f'{agree["near"][1]} within 1e-3 of the threshold); data packets '
        f'{sum(per_ev.values())} vs {sum(per_ev_solo.values())}, per event '
        f'within {100 * worst:.1f}% (<= 25%), hit-set overlap '
        f'{overlap:.3f} (>= 0.7); peak device memory {peak:.2f} GiB')
    return dict(launches=launches, wall=wall, table=table, out=out,
                kw=dict(solo['kw'], event_group_size=GROUP))


def memlog_phase(tmp: str, inp: str, kw: dict) -> None:
    """The charge-only slice with save_memory, read back through
    read_memlog: per-phase peaks of the card's and the host's memory."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.utils.memlog import read_memlog
    mem = os.path.join(tmp, 'memlog.h5')
    run_simulation(inp, os.path.join(tmp, 'slice_memlog.h5'),
                   save_memory=mem, **kw)
    tables = read_memlog(mem)
    want = ('loading', 'quench_drift_mod-1', 'loop_mod-1')
    assert set(want) <= set(tables), sorted(tables)
    peaks = []
    for name in want:
        t = tables[name]
        used = np.asarray(t['gpu_mem_used'], np.float64)
        assert len(used) > 0 and (used > 0).all(), (name, used)
        peaks.append(f'{name}: {len(used)} snapshots, card in use up to '
                     f'{used.max() / 2 ** 30:.3f} GiB (free down to '
                     f'{np.asarray(t["gpu_mem_free"]).min() / 2 ** 30:.2f} '
                     'GiB), host traced peak '
                     f'{np.asarray(t["cpu_mem_peak"]).max() / 2 ** 20:.1f} '
                     'MiB')
    log('memlog', 'charge-only slice with save_memory, read back through '
        'read_memlog: ' + '; '.join(peaks))


def mode0_phase(tmp: str, inp: str, kw: dict, n_seg: int,
                charge_only_out: str, main_path) -> dict:
    """The slice with Module-0's light keys in the threshold mode
    (MODE0_LIGHT, MODE0_TRUTH): a warm-up of the first spill keeps its first
    light batch, which is run again on the card (twice) and on the CPU with
    CPU-made draws (trigger tables equal, waveforms and truth records as in
    the light phase); then the run timed at event_group_size GROUP here,
    and ungrouped in processes of their own (:func:`io_mode0`), launch
    counters set to 0 before and read after and the plain versions
    forbidden, with every mode-0 light call's window and triggers
    recorded."""
    import torch
    from larndsim_tpu_torch.assets.geometry import write_module0
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.tools import light_check
    paths = write_module0(os.path.join(tmp, 'module0_mode0'),
                          light=MODE0_LIGHT, sim_overrides=MODE0_TRUTH)
    kw0 = dict(kw, detector_properties=paths['detector_properties'],
               simulation_properties=paths['simulation_properties'])
    t0 = time.perf_counter()
    with light_check.first_batch() as seen:
        run_simulation(inp, os.path.join(tmp, 'warm_mode0.h5'), n_events=1,
                       **kw0)
    torch.cuda.synchronize()
    log('mode0', f'warm-up (first spill) {time.perf_counter() - t0:.2f} s')
    assert len(seen) == 1, 'the warm-up ran no light batch'
    args, bkw = seen[0]
    card = light_check.rerun(args, bkw, 'cuda', 5)
    again = light_check.rerun(args, bkw, 'cuda', 5)
    cpu = light_check.rerun(args, bkw, 'cpu', 5)
    assert light_check.identical(card, again), 'mode 0: two card runs differ'
    rec = light_check.compare(card, cpu, args[1])
    assert rec['triggers'] > 0, 'the checked batch fired no trigger'
    assert rec['records'] > 0, 'the checked batch made no truth record'
    log('mode0', f'first light batch (S={args[0].size}, C='
        f'{card.waveforms.shape[1]}, n_ticks={card.n_ticks}, start '
        f'{card.start_time:.6f} us): card vs CPU, same draws: trigger '
        f'ticks {card.trigger_idx.tolist()} equal, types and channels '
        f'equal; waveforms {card.waveforms.shape} max |err| '
        f'{rec["max_abs_err"]:.1f} ADC (peak {rec["peak"]:.1f}, tolerance '
        f'one quantum 64), {100 * rec["equal_share"]:.3f}% of samples equal '
        f'(>= 99.9%); {rec["records"]} contributor truth records equal '
        '(pe_current rtol 1e-4); two card runs identical')

    calls = []
    orig = light_model.simulate_light_group_mode0

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append([(int(e), r.n_ticks, len(r.trigger_idx))
                      for e, r in zip(k['event_ids'], out)])
        return out
    out = os.path.join(tmp, f'slice_mode0_g{GROUP}.h5')
    light_model.simulate_light_group_mode0 = spy
    try:
        wall, launches, peak = main_path(out, dict(kw0,
                                                   event_group_size=GROUP))
    finally:
        light_model.simulate_light_group_mode0 = orig
    runs = {GROUP: dict(out=out, wall=wall, launches=launches, peak=peak,
                        calls=list(calls), table=phase_table(
                            f'mode-0 slice, event_group_size {GROUP}'))}
    io = io_mode0(tmp, inp, kw0)
    solo = runs[1] = dict(io['lzf'], peak=io['lzf']['peak_device_gib'])
    assert data_packets(solo['out']) == data_packets(charge_only_out), \
        'mode 0: packets differ from the charge-only slice'
    with File(solo['out'], 'r') as f, File(runs[GROUP]['out'], 'r') as h:
        for name in ('light_wvfm', 'light_trig'):
            assert np.array_equal(np.array(f[name]), np.array(h[name])), \
                f'mode 0: grouped {name} differs from the ungrouped run'
        wv, trig = np.array(f['light_wvfm']), np.array(f['light_trig'])
        rec = np.array(f['light_wvfm_mc_assn'])
        pk = np.array(f['packets'])
    assert np.isfinite(wv).all() and (wv != 0).any(), 'mode 0: light_wvfm'
    assert wv.shape[1:] == (96, 256) and len(wv) == len(trig)
    assert len(rec) > 0 and (np.abs(rec['pe_current'])
                             > MODE0_TRUTH['mc_truth_threshold']).all()
    batches = [tuple(b) for c in solo['calls'] for b in c]
    per_event = collections.Counter()
    for ev, _, n in batches:
        per_event[ev] += n
    n_trig = sum(per_event.values())
    twice = sum(n >= 2 for _, _, n in batches)
    assert n_trig > 0, 'mode 0: no threshold trigger'
    assert twice > 0, 'mode 0: no batch triggered twice'
    n_grouped = [len(c) for c in runs[GROUP]['calls']]
    assert max(n_grouped) > 1, 'mode 0: no grouped light call'
    io_trig = collections.Counter(
        pk['io_group'][pk['packet_type'] == 7].tolist())
    log('mode0', f'{n_trig} threshold triggers in {len(batches)} light '
        f'batches; per event {dict(sorted(per_event.items()))}; '
        f'{twice} batches with >= 2 triggers; n_ticks per batch '
        f'{[nt for _, nt, _ in batches]}; light_trig {len(trig)} rows, '
        f'light_wvfm {wv.shape}; trigger packets per io group '
        f'{dict(sorted(io_trig.items()))}; {len(rec)} truth records '
        f'({rec.nbytes / 1e6:.3f} MB)')
    for g, r in sorted(runs.items()):
        where = ('its own process, truth lzf' if g == 1 else 'this process')
        log('mode0', f'event_group_size {g} ({where}): wall '
            f'{r["wall"]:.3f} s, {n_seg / r["wall"]:.1f} segments/s; light '
            f'calls per group {[len(c) for c in r["calls"]]}; K1 / K2 '
            f'launches {r["launches"]["induced_current"]} / '
            f'{r["launches"]["fee_fsm"]}; peak device memory '
            f'{r["peak"]:.2f} GiB')
    log('mode0', 'data packets equal to the charge-only slice\'s; grouped '
        'light_wvfm and light_trig equal to the ungrouped run\'s')
    return runs


def mod2mod_phase(tmp: str, main_path) -> dict:
    """The 2x2 with module variation at full width (``assets.geometry.
    write_2x2``: 4 modules, 8 TPCs, the 2.4.16 and 2.5.16 layouts, module
    3 on the second layout and response, two light LUTs, 384 channels) with
    the 2x2 production truth (LUT smearing, SMEAR_TRUTH, device route), on
    bench.py's 2x2 occupancy (SPILLS_2X2): a truth-off run (the warm-up)
    keeps K1's and K2's first inputs of modules 1 and 3, each held to its
    plain version, and module 3's first light batch, run again on the card
    (twice) and on the CPU; then the run with truth, ungrouped and at
    event_group_size GROUP, launch counters set to 0 before and read after
    (per module), the plain versions forbidden."""
    import torch
    import yaml
    from larndsim_tpu_torch.assets.geometry import (simulation_properties,
                                                    write_2x2)
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.params import load_detector
    from larndsim_tpu_torch.tools import light_check
    from larndsim_tpu_torch.tools.module_tracker import module_tracker
    t0 = time.perf_counter()
    paths = write_2x2(os.path.join(tmp, '2x2'), sim_overrides=SMEAR_TRUTH)
    sim_off = os.path.join(tmp, '2x2', 'truth_off.yaml')
    with open(sim_off, 'w') as f:
        yaml.safe_dump(simulation_properties(), f)
    geo = load_detector(paths['detector_properties'],
                        paths['pixel_layout'][0])
    inp = os.path.join(tmp, 'spills_2x2.h5')
    n_seg = write_input(inp, geo.tpc_borders, **SPILLS_2X2)
    dets = {m: load_detector(paths['detector_properties'],
                             [paths['pixel_layout'][i] for i in (0, 0, 1, 0)],
                             i_module=m).params for m in (1, 3)}
    log('mod2mod', f'tree and input in {time.perf_counter() - t0:.2f} s: '
        f'{n_seg} segments in {SPILLS_2X2["n_events"]} spills; module 1 '
        f'n_pixels {dets[1].n_pixels} at {dets[1].host["pixel_pitch"]} cm, '
        f'module 3 {dets[3].n_pixels} at {dets[3].host["pixel_pitch"]} cm '
        f'(bin {dets[3].host["response_bin_size"]} cm), {dets[1].n_tpcs} '
        'TPCs, 384 optical channels')
    kw = dict(config='2x2', detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=sim_off,
              response_file=paths['response_file'],
              light_lut_filename=paths['light_lut_filename'],
              light_det_noise_filename=os.path.join(tmp, 'noise_2x2.npy'),
              rand_seed=7, step_scale=1.0, device='cuda')
    out_off = os.path.join(tmp, 'slice_2x2_truth_off.h5')
    t0 = time.perf_counter()
    with module_tracker(capture=True) as t, light_check.first_batch(
            keep=lambda a, k: t['module'] == 3) as seen:
        cli.run_simulation(inp, out_off, **kw)
    torch.cuda.synchronize()
    per = {m: (n['induced_current'], n['fee_fsm'])
           for m, n in sorted(t['launches'].items())}
    log('mod2mod', f'truth-off run (the warm-up) '
        f'{time.perf_counter() - t0:.2f} s; K1 / K2 launches per module '
        f'{per}')
    k1 = {m: compare_k1(t['k1'][m], f'module {m} batch') for m in (3, 1)}
    k2 = {m: _fsm_case(t['k2'][m], f'module {m} batch') for m in (3, 1)}

    assert len(seen) == 1, 'module 3 ran no light batch'
    args, bkw = seen[0]
    thr = SMEAR_TRUTH['mc_truth_threshold']
    opts = dict(smearing=True, truth_ids=SMEAR_TRUTH['max_light_truth_ids'],
                truth_path='device', threshold=thr)
    card = light_check.rerun(args, bkw, 'cuda', 5, **opts)
    again = light_check.rerun(args, bkw, 'cuda', 5, **opts)
    cpu = light_check.rerun(args, bkw, 'cpu', 5, **opts)
    assert light_check.identical(card, again), 'mod2mod: two card runs differ'
    rec = light_check.compare(card, cpu, args[1], smeared_at=thr)
    assert rec['peak'] > 0 and rec['records'] > 0, rec
    assert card.waveforms.shape[1] == 96, card.waveforms.shape
    log('mod2mod', f'module 3\'s first light batch (S={args[0].size}, C='
        f'{card.waveforms.shape[1]}, channels '
        f'{int(card.op_channel_idx.min())}-{int(card.op_channel_idx.max())}'
        f', LUT 1, n_ticks {card.n_ticks}): card vs CPU, same draws: max '
        f'|err| {rec["max_abs_err"]:.1f} ADC (peak {rec["peak"]:.1f}, '
        f'tolerance one quantum 64), {100 * rec["equal_share"]:.3f}% of '
        f'samples equal (>= 99.9%), {rec["records"]} smearing truth records '
        f'equal ({rec["near"][0]} / {rec["near"][1]} within 1e-3 of the '
        'threshold); two card runs identical')

    kw_on = dict(kw, simulation_properties=paths['simulation_properties'])
    runs = {}
    for g in (1, GROUP):
        out = os.path.join(tmp, f'slice_2x2_g{g}.h5')
        with module_tracker() as t:
            wall, launches, peak = main_path(out, dict(kw_on,
                                                       event_group_size=g),
                                             inp=inp)
        runs[g] = dict(out=out, wall=wall, launches=launches, peak=peak,
                       per_module=t['launches'], table=phase_table(
                           f'2x2 with module variation, truth on, '
                           f'event_group_size {g}'))
    solo, grouped = runs[1], runs[GROUP]
    assert data_packets(solo['out']) == data_packets(out_off), \
        'mod2mod: packets differ from the truth-off run'
    with File(solo['out'], 'r') as f, File(out_off, 'r') as h, \
            File(grouped['out'], 'r') as q:
        names = sorted(_datasets(f))
        assert not any('light_wvfm_mod' in n for n in names), names
        assert [n for n in names if n.startswith('light_dat/')] == [
            f'light_dat/light_dat_module{i}' for i in range(4)], names
        wv = np.array(f['light_wvfm'])
        assert np.array_equal(wv, np.array(h['light_wvfm'])), \
            'mod2mod: light_wvfm differs from the truth-off run'
        assert np.array_equal(wv, np.array(q['light_wvfm'])), \
            'mod2mod: grouped light_wvfm differs from the ungrouped run'
        rec, rec_g = (np.array(x['light_wvfm_mc_assn']) for x in (f, q))
        dat = [f[f'light_dat/light_dat_module{i}'].shape for i in range(4)]
        trig = np.array(f['light_trig'])
        pk = np.array(f['packets'])
    n_spills = SPILLS_2X2['n_events']
    assert wv.shape == (n_spills, 384, 256), wv.shape
    assert trig.shape == (n_spills,) and trig['op_channel'].shape[1] == 384
    lit = [float(np.abs(wv[:, 96 * m:96 * (m + 1)]).max()) for m in range(4)]
    assert np.isfinite(wv).all() and min(lit) > 0, lit
    assert sum(d[0] for d in dat) == n_seg and all(d[1] == 96 for d in dat)
    assert len(rec) > 0 and (np.abs(rec['pe_current']) > thr).all()
    agree = light_check.records_agree(
        rec_g, rec, thr, keys=('trigger_id', 'op_channel_id', 'tick',
                               'event_id', 'segment_id'))
    data = pk[pk['packet_type'] == 0]
    per_io = collections.Counter(data['io_group'].tolist())
    assert sorted(per_io) == list(range(1, 9)), per_io
    assert (data['dataword'] <= 255).all()
    _, hits = packet_events(solo['out'])
    _, hits_g = packet_events(grouped['out'])
    overlap = len(hits & hits_g) / max(len(hits | hits_g), 1)
    assert overlap >= 0.7, overlap
    for name in ('induced_current', 'fee_fsm'):
        assert grouped['launches'][name] < solo['launches'][name], name
    for name in CHAIN:
        for r in runs.values():
            assert all(r['per_module'][m][name] > 0 for m in (1, 2, 3, 4)), \
                (name, r['per_module'])
    log('mod2mod', f'light_wvfm {wv.shape} merged from 4 modules (no '
        f'light_wvfm_mod* left; each module\'s 96 channels peak at '
        f'{[round(x, 1) for x in lit]} ADC), light_trig {trig.shape} x '
        f'{trig["op_channel"].shape[1]} channels, light_dat_module0-3 rows '
        f'{[d[0] for d in dat]}; data packets {len(data)} on io groups '
        f'{dict(sorted(per_io.items()))}, equal to the truth-off run\'s; '
        f'{len(rec)} truth records ({rec.nbytes / 1e6:.3f} MB); light_wvfm '
        f'equal to the truth-off run\'s')
    for g, r in sorted(runs.items()):
        per = {m: tuple(n[k] for k in CHAIN)
               for m, n in sorted(r['per_module'].items())}
        log('mod2mod', f'event_group_size {g}: wall {r["wall"]:.3f} s, '
            f'{n_seg / r["wall"]:.1f} segments/s; K1 / D1 / K2 / D2 '
            f'launches {tuple(r["launches"][k] for k in CHAIN)} (batches '
            f'with no latch {r["launches"]["batches_unlatched"]}), per '
            f'module {per}; peak device memory {r["peak"]:.2f} GiB')
    log('mod2mod', f'grouped: light_wvfm equal to the ungrouped run\'s, '
        f'{agree["records"]} truth records equal ({agree["near"][0]} / '
        f'{agree["near"][1]} within 1e-3 of the threshold), hit-set overlap '
        f'{overlap:.3f} (>= 0.7; other charge draws)')
    return dict(k1=k1, k2=k2, runs=runs, kw=kw_on, inp=inp, n_seg=n_seg)


def ndlar_phase(tmp: str, main_path) -> dict:
    """ND-LAr at full scale (``assets.geometry.write_ndlar``: 35 modules,
    70 TPCs, 8.96 M pixel ids, 50 ns sampling, 6401 ticks, charge only),
    ``config='ndlar'`` on bench.py's ND-LAr occupancy: the warm-up at
    bench's batching keeps K1's and K2's first inputs, each held to its
    plain version bit for bit and timed, with K1's tile choice on that
    batch, counted by the kernel in the compared launch; then the timed
    spills at bench's batching (batch_size 10000,
    event_group_size 32) and at the YAML's own (2500, two TPCs a batch,
    ungrouped), launch counters set to 0 before and read after, the plain
    versions forbidden: walls, segments/s, launches, peak device memory,
    data packets on all 70 io groups and the phase tables."""
    import torch
    from larndsim_tpu_torch.assets.geometry import write_ndlar
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.params import load_detector
    t0 = time.perf_counter()
    paths = write_ndlar(os.path.join(tmp, 'ndlar'))
    # bench.py's derived simulation properties (the YAML's, batch_size
    # raised)
    bench_sim = write_ndlar(
        os.path.join(tmp, 'ndlar_bench'), sim_overrides=dict(
            batch_size=NDLAR_BENCH['batch_size']))['simulation_properties']
    dm = load_detector(paths['detector_properties'], paths['pixel_layout'])
    det = dm.params
    warm_in = os.path.join(tmp, 'ndlar_warm.h5')
    inp = os.path.join(tmp, 'ndlar_spills.h5')
    write_input(warm_in, dm.tpc_borders,
                **dict(NDLAR_SPILLS, n_events=NDLAR_WARM, seed=1))
    n_seg = write_input(inp, dm.tpc_borders,
                        **dict(NDLAR_SPILLS, n_events=NDLAR_TIMED))
    nx, ny = det.n_pixels
    log('ndlar', f'tree and input in {time.perf_counter() - t0:.2f} s: '
        f'{len(dm.mod_ids)} modules, {det.n_tpcs} TPCs, n_pixels {nx} x {ny} '
        f'a TPC ({nx * ny * det.n_tpcs} pixel ids) at '
        f'{det.host["pixel_pitch"]} cm, {det.time_ticks} ticks of '
        f'{det.time_sampling} us; {n_seg} segments in {NDLAR_TIMED} timed '
        f'spills ({NDLAR_WARM} warm-up spills before)')
    kw = dict(config='ndlar', detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=bench_sim,
              response_file=os.path.join(tmp, 'response_38.npy'),
              rand_seed=7, step_scale=1.0, device='cuda',
              event_group_size=NDLAR_BENCH['group'])
    t0 = time.perf_counter()
    with kernel_inputs() as kept:
        cli.run_simulation(warm_in, os.path.join(tmp, 'ndlar_warm.h5.out'),
                           **kw)
        torch.cuda.synchronize()
    captured = next(iter(kept.values()))
    log('ndlar', f'warm-up ({NDLAR_WARM} spills, bench batching) '
        f'{time.perf_counter() - t0:.2f} s')
    k1 = compare_k1(captured['k1'], 'ND-LAr batch', plain_once=True,
                    tiling=True)
    d1 = compare_d1(captured['d1'], 'ND-LAr batch', plain_once=True)
    k2 = _fsm_case(captured['k2'], 'ND-LAr batch', plain_once=True)
    d2 = compare_d2(captured['d2'], 'ND-LAr batch', plain_once=True)
    # the kept inputs would count in the timed runs' peak memory
    held = kept_gib(kept)
    del captured, kept
    log('ndlar', f'the warm-up\'s kept kernel inputs ({held:.2f} GiB on the '
        'card) released before the timed runs')

    runs = {}
    for name, run_kw in (('bench', kw), ('yaml', dict(
            kw, simulation_properties=paths['simulation_properties'],
            event_group_size=1))):
        out = os.path.join(tmp, f'ndlar_{name}.h5')
        wall, launches, peak = main_path(out, run_kw, inp=inp)
        runs[name] = dict(out=out, wall=wall, launches=launches, peak=peak,
                          kw=run_kw, inp=inp,
                          table=phase_table(f'ND-LAr, {name} batching'))
    pk = {}
    for name, r in runs.items():
        with File(r['out'], 'r') as f:
            p = np.array(f['packets'])
            n_assn = len(f['mc_packets_assn'])
        assert n_assn == len(p)
        data = p[p['packet_type'] == 0]
        assert (data['dataword'] <= 255).all()
        assert sorted(set(p['io_group'].tolist())) == list(range(1, 71))
        pk[name] = collections.Counter(data['io_group'].tolist())
        assert len(pk[name]) >= 60, (name, len(pk[name]))
    _, hits_b = packet_events(runs['bench']['out'])
    _, hits_y = packet_events(runs['yaml']['out'])
    overlap = len(hits_b & hits_y) / max(len(hits_b | hits_y), 1)
    assert overlap >= 0.7, overlap
    for name in ('induced_current', 'fee_fsm'):
        assert runs['bench']['launches'][name] < \
            runs['yaml']['launches'][name], name
    for name, r in runs.items():
        log('ndlar', f'{name} batching: wall {r["wall"]:.3f} s '
            f'({r["wall"] / NDLAR_TIMED:.3f} s a spill), '
            f'{n_seg / r["wall"]:.1f} segments/s; K1 / D1 / K2 / D2 '
            f'launches {tuple(r["launches"][k] for k in CHAIN)} (batches '
            f'with no latch {r["launches"]["batches_unlatched"]}); '
            f'{sum(pk[name].values())} data packets on {len(pk[name])} of '
            f'70 io groups; peak device memory {r["peak"]:.2f} GiB')
    log('ndlar', f'hit-set overlap of the two batchings {overlap:.3f} '
        '(>= 0.7; other charge draws)')
    return dict(k1=k1, d1=d1, k2=k2, d2=d2, runs=runs, n_seg=n_seg)


#: the mesh phase's grid: two module rows (the second with a shorter
#: electron lifetime, us) by two event columns, all on card 0
MESH_LIFETIMES = (2.2e3, 1.0e3)


def mesh_phase(tmp: str) -> dict:
    """``graft_entry.dryrun_multichip(4)`` on ``['cuda:0'] * 4``; then
    ``parallel.mesh.make_sharded_sim_step`` on a 2 x 2 grid on card 0 at a
    full module's light width (the Module-0-shaped tree with the light keys
    of one 2x2 module: 96 channels, a 16 us window of 16384 ticks, LUT
    smearing), the beam trigger with noise and the top-8 truth, on the
    guard's 2x2 batch (4 events x 24 tracks x 42 segments) cut into four
    cells, one event each, its times moved into the first 1.5 us of its
    spill: a warm-up call, then one timed, launch
    counters set to 0 before and read after, per cell; each cell equal bit
    for bit to ``parallel.mesh.sim_cell`` run alone on the card's default
    stream with the same draws.  In the dry run and in the timed call the
    first K1 and K2 inputs of one cell are kept, and each kernel is held
    to its plain version on them, bit for bit."""
    import torch
    from larndsim_tpu_torch import graft_entry as ge
    from larndsim_tpu_torch.kernels import binding
    from larndsim_tpu_torch.models import charge as charge_model
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.parallel import mesh as tmesh
    from larndsim_tpu_torch.segments import from_structured, to_structured
    from larndsim_tpu_torch.tools import perf_guard as pg
    t0 = time.perf_counter()
    with kernel_inputs() as kept:
        dry = ge.dryrun_multichip(4, ['cuda:0'] * 4)
        torch.cuda.synchronize()
    log('mesh', f'dryrun_multichip(4) on cuda:0 x 4: grid {dry["mesh"].shape}'
        f', sim step and the 2x2 CLI with module variation at n_devices 4 '
        f'({dry["n_packets"]} packets), JAX\'s checks passed, '
        f'{time.perf_counter() - t0:.2f} s')
    dry_held = hold_cell(kept, 'cell-1-0', 'dry run, cell 1-0')
    del kept

    dev = torch.device('cuda', 0)
    w = pg.build_workload(dev, os.path.join(tmp, 'mesh'))
    lw = pg.build_light_workload(w)
    light, lut = lw['light'], lw['lut']
    tracks = to_structured(w['segs'])[:w['n_segments']]
    events = np.unique(tracks['event_id'])
    assert len(events) == 4, events
    stages = []
    for ev in events:
        # each event's times from its spill's start, moved into the first
        # 1.5 us (inside the beam trigger's digitized window)
        cell = tracks[tracks['event_id'] == ev].copy()
        spill = np.floor(cell['t0'].min() / w['sim'].spill_period) \
            * w['sim'].spill_period
        for k in ('t0', 't0_start', 't0_end'):
            cell[k] = (cell[k] - spill) * 0.15
        stages.append(charge_model.stage_batch(
            from_structured(cell, pad_to=1024, device=dev), w['det_model'],
            w['sim']))
    charge = dict(
        {k: max(getattr(st, k) for st in stages) for k in (
            'max_active', 'radius', 'max_nb', 't_sig', 'n_steps',
            'n_unique_cap')},
        max_adc=w['sim'].max_adc_values,
        max_tracks=w['sim'].max_tracks_per_pixel,
        shift_band=(min(st.shift_band[0] for st in stages),
                    max(st.shift_band[1] for st in stages)),
        min_step=stages[0].min_step)
    shapes = ge.light_shapes(light)
    case = dict(add_noise=True, k_truth=ge.K_TRUTH, trig_mode=1,
                max_trig=ge.MAX_TRIG)
    mesh = tmesh.make_mesh(4, 2, devices=['cuda:0'] * 4)
    C = light.n_op_channel
    step = tmesh.make_sharded_sim_step(mesh, light, torch.arange(C),
                                       **charge, **shapes, **case)
    det_stack = tmesh.stack_module_params([
        w['det'].replace(electron_lifetime=t) for t in MESH_LIFETIMES])
    luts = [torch.stack([a, a]) for a in (lut.vis, lut.t0, lut.time_dist,
                                          lut.t0_avg)]
    noise = torch.stack([lw['noise'], lw['noise']])
    grid = [[stages[2 * m + e].segs for e in range(2)] for m in range(2)]

    def draws(m, e):
        gen = torch.Generator(dev).manual_seed(100 + 2 * m + e)
        return (charge_model.generator_draw(gen, dev),
                light_model.generator_draw(gen, dev))

    def call():
        return step(grid, det_stack, w['response'], *luts,
                    [[draws(m, e) for e in range(2)] for m in range(2)],
                    noise_rows=noise)
    call()                            # FFT plans, allocator
    per_cell = collections.defaultdict(collections.Counter)
    orig_count = binding._count

    def count(name):
        orig_count(name)
        per_cell[threading.current_thread().name][name] += 1
    binding._count = count
    try:
        with kernel_inputs() as kept:
            binding.reset_launches()
            t0 = time.perf_counter()
            out = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        binding._count = orig_count
    launches = dict(binding.launches)
    held = hold_cell(kept, 'cell-1-1', 'mesh step, cell 1-1')
    for m in range(2):
        for e in range(2):
            want = tmesh.sim_cell(
                grid[m][e], tmesh.module_params(det_stack, m, dev),
                w['response'], light, torch.arange(C, device=dev),
                [a[m] for a in luts], noise[m], draws(m, e), charge=charge,
                **shapes, **case)
            for k in ('adc', 'waveforms', 'trigger_idx', 'n_triggers',
                      'truth_ids', 'truth_contrib'):
                assert torch.equal(out[k][m][e], want[k]), (k, m, e)
            assert per_cell[f'cell-{m}-{e}'] == dict.fromkeys(CHAIN, 1), \
                per_cell
    wv = out['waveforms'][0][0]
    assert wv.shape == (ge.MAX_TRIG, C, shapes['digit_samples'])
    assert out['n_hits_total'] > 0
    assert all(float(out['waveforms'][m][e].abs().max()) > 0
               and int(out['truth_ids'][m][e].max()) >= 0
               for m in range(2) for e in range(2))
    cells = {f'{m}{e}': (int(stages[2 * m + e].segs.valid.sum()),
                         dict(per_cell[f'cell-{m}-{e}']))
             for m in range(2) for e in range(2)}
    log('mesh', f'sim step on a 2 x 2 grid on cuda:0 (C {C}, n_ticks '
        f'{shapes["n_ticks"]}, beam trigger with noise, k_truth '
        f'{ge.K_TRUTH}; charge shapes {charge}): wall {wall:.3f} s, '
        f'{out["n_hits_total"]} pixels with a hit; segments and launches '
        f'per cell {cells}; every cell equal to sim_cell alone on the card, '
        'bit for bit; K1, D1, K2 and D2 held to their plain versions on '
        'the inputs of cell 1-1 and of the dry run\'s cell 1-0')
    return dict(wall=wall, launches=launches, cells=cells, held=held,
                dry_held=dry_held)


def ndev_phase(tmp: str, m2m: dict, grouped: dict, main_path) -> dict:
    """Multi-device dispatch (``n_devices``) on the card: the 2x2 of the
    mod2mod phase (truth on, device route, ungrouped) at ``n_devices`` 4 on
    ``['cuda:0'] * 4`` (four module threads, each on its own stream) and 8
    (each module on two contexts), and the truth slice at event_group_size
    GROUP at ``n_devices`` 2 and 4 on ``cuda:0`` (groups round-robin over
    the contexts, each with its thread and stream), each run twice (the
    first run of a configuration meets new streams, whose memory pools
    start empty): every dataset equal bit for bit to the one-context run's
    (``tools.file_check``), launches per module equal to it, the plain
    versions forbidden; walls, each module thread's wall, peak device
    memory and the phase tables.  With two cards or more, the 2x2 again
    over the real cards."""
    import torch
    from larndsim_tpu_torch.tools.file_check import differences
    from larndsim_tpu_torch.tools.module_tracker import module_tracker
    solo = m2m['runs'][1]
    want = {m: tuple(n[k] for k in CHAIN)
            for m, n in sorted(solo['per_module'].items())}
    out = {}

    def run_2x2(name, n, devices):
        walls, module_walls = [], []
        for rep in range(2):
            path = os.path.join(tmp, f'slice_2x2_ndev{n}_{len(out)}_{rep}.h5')
            with module_tracker() as t:
                wall, launches, peak = main_path(
                    path, dict(m2m['kw'], n_devices=n, device=devices),
                    inp=m2m['inp'])
            table = phase_table(f'2x2, truth on, n_devices {n} on {name}, '
                                f'run {rep + 1}')
            diff = differences(solo['out'], path)
            assert not diff, f'ndev: 2x2 at {n} on {name} differs from ' \
                f'one context: {diff}'
            per = {m: tuple(c[k] for k in CHAIN)
                   for m, c in sorted(t['launches'].items())}
            assert per == want, (per, want)
            assert sorted(t['wall']) == [1, 2, 3, 4], t['wall']
            walls.append(wall)
            module_walls.append({m: round(w, 3)
                                 for m, w in sorted(t['wall'].items())})
        log('ndev', f'2x2, truth on, n_devices {n} on {name}: every dataset '
            f'equal to the one-context run\'s (twice); wall {walls[0]:.3f} '
            f'/ {walls[1]:.3f} s (first / second run; one context '
            f'{solo["wall"]:.3f} s), {m2m["n_seg"] / walls[1]:.1f} '
            f'segments/s; K1 / D1 / K2 / D2 launches per module {per} (one '
            f'context {want}); each module thread\'s wall to its last write (s) '
            f'{module_walls}; peak device memory of the card {peak:.2f} GiB '
            f'(one context {solo["peak"]:.2f} GiB; the modules share it)')
        return dict(wall=walls, launches=launches, per_module=per,
                    module_wall=module_walls, peak=peak, table=table)

    out['2x2'] = run_2x2('cuda:0 x 4', 4, ['cuda:0'] * 4)
    out['2x2_8'] = run_2x2('cuda:0 x 8', 8, ['cuda:0'] * 8)
    for n in (2, 4):
        walls = []
        for rep in range(2):
            path = os.path.join(tmp, f'slice_truth_grouped_ndev{n}_{rep}.h5')
            wall, launches, peak = main_path(
                path, dict(grouped['kw'], n_devices=n,
                           device=['cuda:0'] * n))
            table = phase_table(f'truth slice, device route, '
                                f'event_group_size {GROUP}, n_devices {n} '
                                f'on cuda:0 x {n}, run {rep + 1}')
            diff = differences(grouped['out'], path)
            assert not diff, f'ndev: truth slice at n_devices {n} ' \
                f'differs: {diff}'
            assert launches == grouped['launches'], (launches,
                                                     grouped['launches'])
            walls.append(wall)
        log('ndev', f'truth slice, device route, event_group_size {GROUP}, '
            f'n_devices {n} on cuda:0 x {n}: every dataset equal to the '
            f'one-context run\'s (twice); wall {walls[0]:.3f} / '
            f'{walls[1]:.3f} s (first / second run; one context '
            f'{grouped["wall"]:.3f} s); launches {launches}; peak device '
            f'memory {peak:.2f} GiB')
        out[f'module0_{n}'] = dict(wall=walls, launches=launches, peak=peak,
                                   table=table)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        out['cards'] = run_2x2(f'{n_cards} cards', 4, 'cuda')
    else:
        log('ndev', 'the 2x2 over real cards needs two cards or more: this '
            f'machine has {n_cards}')
    return out


def assigner_walls(slices: dict) -> dict:
    """The batch assigner on each slice's whole input, at its TPC batch
    size: the library's groups equal to the numpy version's, both timed
    (host wall, best of two, in turns)."""
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.params import load_detector, load_sim
    from larndsim_tpu_torch.utils import batching
    out = {}
    for name, run in slices.items():
        kw = run['kw']
        layout = kw['pixel_layout']
        borders = load_detector(kw['detector_properties'],
                                layout[0] if isinstance(layout, list)
                                else layout, device='cpu').tpc_borders
        size = load_sim(kw['simulation_properties']).event_batch_size
        with File(run['inp'], 'r') as f:
            tracks = np.array(f['segments'])
        ms = {}
        for label, fn in (('native', batching.assign_groups),
                          ('plain', batching.assign_groups_plain),
                          ('plain', batching.assign_groups_plain),
                          ('native', batching.assign_groups)):
            t0 = time.perf_counter()
            groups = fn(tracks, borders, size)
            ms.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            assert np.array_equal(groups, batching.assign_groups_plain(
                tracks, borders, size)), name
        out[name] = {k: min(v) for k, v in ms.items()}
        log('host', f'batch assigner, {name}: {len(tracks)} segments, '
            f'{len(borders)} TPCs, {size} a batch: groups equal to the '
            f'numpy version\'s; native {out[name]["native"]:.3f} ms, numpy '
            f'{out[name]["plain"]:.3f} ms (host wall, best of two, in '
            'turns)')
    return out


def host_phase(tmp: str, truth_host: dict, slices: dict, main_path) -> dict:
    """The port's host runtime on the card's host.  The truth slice by the
    host route (``truth_host``, run at ``truth_workers`` 1 by the truth
    phase) again at ``truth_workers`` 4, one native emitter call's inputs
    kept: every dataset equal to the one-worker run's, and the kept call's
    records equal, byte for byte, to the numpy emitter's on the same inputs,
    both timed.  Then each run of ``slices`` (the charge-only slice, the
    2x2 with its production truth, ND-LAr at its YAML's batching) four
    times more, ``pipeline`` off, on, on, off, launch counters set to 0
    before and read after, the plain kernel versions forbidden: every
    dataset and the launches equal to the first run's; the walls.  And the
    batch assigner on each of their inputs (:func:`assigner_walls`)."""
    from larndsim_tpu_torch.models import truth_emit
    from larndsim_tpu_torch.tools.file_check import differences
    kept, lock = [], threading.Lock()
    native = truth_emit.records

    def spy(*args, **kwargs):
        with lock:
            if not kept:    # the worker's buffers are reused: copies
                kept.append(([np.array(a) if isinstance(a, np.ndarray)
                              else a for a in args], dict(kwargs)))
        return native(*args, **kwargs)
    truth_emit.records = spy
    out = os.path.join(tmp, 'slice_truth_host_w4.h5')
    try:
        wall4, launches4, _ = main_path(out, dict(truth_host['kw'],
                                                  truth_workers=4))
    finally:
        truth_emit.records = native
    diff = differences(truth_host['out'], out)
    assert not diff, f'host: truth_workers 4 differs from 1: {diff}'
    assert launches4 == truth_host['launches'], launches4
    args, kwargs = kept[0]
    got = truth_emit.records(*args, **kwargs)
    want = truth_emit.records_plain(*args, **kwargs)
    assert len(got) > 0 and got.tobytes() == want.tobytes(), \
        'host: the native emitter\'s records differ from the numpy ones'
    ms = {}
    for name, fn in (('native', truth_emit.records),
                     ('plain', truth_emit.records_plain),
                     ('plain ', truth_emit.records_plain),
                     ('native ', truth_emit.records)):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        ms.setdefault(name.strip(), []).append(
            1e3 * (time.perf_counter() - t0))
    res = args[0]
    log('host', f'truth slice, host route: wall {truth_host["wall"]:.3f} s '
        f'at truth_workers 1, {wall4:.3f} s at 4, every dataset equal; one '
        f'emitter call ({res.shape[0]} rows x {res.shape[1]} samples, '
        f'{len(got)} records, {got.nbytes / 1e6:.3f} MB): records equal '
        'byte for byte to the numpy emitter\'s; native '
        f'{min(ms["native"]):.3f} ms, numpy {min(ms["plain"]):.3f} ms (host '
        'wall, best of two, in turns)')
    walls = dict(truth_host=dict(w1=truth_host['wall'], w4=wall4),
                 emit_ms={k: min(v) for k, v in ms.items()},
                 assign_ms=assigner_walls(slices))
    for name, run in slices.items():
        runs = {False: [], True: []}
        for rep, pipeline in enumerate((False, True, True, False)):
            path = os.path.join(tmp, f'pipeline_{name}_{rep}.h5')
            wall, launches, peak = main_path(path, dict(run['kw'],
                                                        pipeline=pipeline),
                                             inp=run['inp'])
            diff = differences(run['out'], path)
            assert not diff, f'host: {name}, pipeline {pipeline}, ' \
                f'differs from the first run: {diff}'
            assert launches == run['launches'], (name, launches,
                                                 run['launches'])
            runs[pipeline].append(wall)
            if rep == 2:
                table = phase_table(f'{name}, pipeline on')
        log('host', f'{name}: every dataset and the launches of each run '
            'equal to the first run\'s; walls pipeline off / on / on / off '
            f'{runs[False][0]:.3f} / {runs[True][0]:.3f} / '
            f'{runs[True][1]:.3f} / {runs[False][1]:.3f} s (the first '
            f'run {run["wall"]:.3f} s); peak device memory {peak:.2f} GiB')
        walls[name] = dict(off=runs[False], on=runs[True], table=table)
    return walls


def io_phase(tmp: str, inp: str, kw: dict, charge_only_out: str,
             main_path) -> None:
    """The charge-only slice from its input rewritten chunked (gzip and
    shuffle, 1024 rows a chunk, as edep-sim files are appended), launch
    counters set to 0 before and read after: data packets equal to the
    contiguous input's run."""
    from larndsim_tpu_torch.io.h5 import File
    chunked = os.path.join(tmp, 'spills_chunked.h5')
    with File(inp, 'r') as f, File(chunked, 'w') as g:
        for name in f.keys():
            data = np.asarray(f[name])
            g.create_dataset(name, data=data, maxshape=(None,),
                             chunks=(1024,), compression='gzip', shuffle=True)
    with File(chunked, 'r') as f:
        seg = f['segments']
        assert seg.chunks == (1024,) and seg.compression == 'gzip', \
            (seg.chunks, seg.compression)
        layout = (f'segments {seg.shape[0]} rows in {seg.chunks} chunks, '
                  f'{seg.storage_size()} bytes stored (gzip + shuffle) of '
                  f'{seg.dtype.itemsize * seg.shape[0]}')
    out = os.path.join(tmp, 'slice_chunked_input.h5')
    wall, launches, _ = main_path(out, kw, inp=chunked)
    n_data = slice_checks(out)
    assert data_packets(out) == data_packets(charge_only_out), \
        'chunked input: packets differ from the contiguous input\'s run'
    log('io', f'charge-only slice from a chunked input ({layout}): wall '
        f'{wall:.3f} s, {n_data} data packets equal to the contiguous '
        f'input\'s run; launches {launches}')


def _datasets(g, prefix=''):
    """name -> dataset, every dataset under the group ``g``."""
    from larndsim_tpu_torch.io.h5 import Group
    out = {}
    for name, obj in g.members.items():
        if isinstance(obj, Group):
            out.update(_datasets(obj, prefix + name + '/'))
        else:
            out[prefix + name] = obj
    return out


def io_mode0(tmp: str, inp: str, kw0: dict) -> dict:
    """The mode-0 slice ungrouped, with the light truth shuffled and LZF'd
    ('lzf', the default) and plain ('none'), each in a process of its own
    (``tools/slice_run.py``: a warm-up of the first spill, then the timed
    run, launch counters set to 0 before and read after, plain versions
    forbidden): every dataset of the two outputs equal bit for bit through
    the port's reader; each run's wall, ``truth/h5``, peak host RSS, file
    bytes and truth bytes stored; the codec's decode MB/s from the 'lzf'
    truth's read-back (one thread) and its encode MB/s on a few of the
    run's truth chunks (every core, as the writer encodes)."""
    from larndsim_tpu_torch.io import lzf
    from larndsim_tpu_torch.io.export import TRUTH_CHUNK
    from larndsim_tpu_torch.io.h5 import File
    from larndsim_tpu_torch.tools.file_check import bits_equal
    root = os.path.dirname(os.path.abspath(__file__))
    runs = {}
    for comp in ('lzf', 'none'):
        out = os.path.join(tmp, f'slice_mode0_{comp}.h5')
        res = slice_run.run(root, inp, out, dict(kw0,
                                                 truth_compression=comp))
        assert res['launches']['induced_current'] > 0, res['launches']
        assert res['launches']['fee_fsm'] > 0, res['launches']
        assert res['launches']['sum_pixel_signals'] == \
            res['launches']['induced_current'], res['launches']
        assert res['launches']['current_fractions'] > 0, res['launches']
        table = res['stdout'].rsplit('Phase breakdown:\n', 1)[1].split(
            'RESULT ')[0]
        assert 'charge_batch' in table, f'mode 0, {comp}: no charge phase'
        log('phases', f'mode-0 slice, ungrouped, truth {comp}, its own '
            'process (label, self wall s, self thread-CPU s, calls):')
        for row in table.strip().splitlines():
            print(f'    {row}', flush=True)
        runs[comp] = dict(res, out=out)
    with File(runs['lzf']['out'], 'r') as a, \
            File(runs['none']['out'], 'r') as b:
        sa, sb = _datasets(a), _datasets(b)
        assert sorted(sa) == sorted(sb), (sorted(sa), sorted(sb))
        # the first access decodes the whole dataset: the decoder's rate
        t0 = time.perf_counter()
        rec_lzf = np.asarray(sa['light_wvfm_mc_assn'])
        t_dec = time.perf_counter() - t0
        for name in sa:
            assert bits_equal(sa[name], sb[name]), \
                f'truth lzf vs none: {name} differs'
        ta, tb = sa['light_wvfm_mc_assn'], sb['light_wvfm_mc_assn']
        assert ta.compression == 'lzf' and ta.shuffle
        assert tb.compression is None and not tb.shuffle
        stored = {'lzf': ta.storage_size(), 'none': tb.storage_size()}
        rec = np.asarray(tb)
    for comp, r in runs.items():
        log('io', f'mode-0 slice, truth {comp}: wall {r["wall"]:.3f} s, '
            f'truth/h5 {r["phases"].get("truth/h5", 0.0):.3f} s; the run\'s '
            f'peak host RSS {r["peak_rss_gib"]:.3f} GiB ('
            f'{r["rss_before_gib"]:.3f} GiB resident at its start, the '
            f'process\'s peak {r["process_peak_rss_gib"]:.3f} GiB); file '
            f'{r["file_bytes"]} bytes, truth '
            f'{stored[comp]} bytes stored; peak device memory '
            f'{r["peak_device_gib"]:.2f} GiB')
    log('io', f'every dataset of the lzf and none outputs equal bit for bit; '
        f'{len(rec)} truth records, {rec.nbytes} bytes: stored lzf / none '
        f'{stored["lzf"] / stored["none"]:.4f}')
    # the encoder on two rounds of chunks for every core, as the writer
    # encodes them (the whole truth went through it in the run)
    cb = TRUTH_CHUNK * rec.dtype.itemsize
    n_enc = min(len(rec) // TRUTH_CHUNK, 2 * lzf.threads())
    assert n_enc, 'fewer truth records than one chunk'
    raw = rec[:n_enc * TRUTH_CHUNK].view(np.uint8).reshape(n_enc, cb)
    t0 = time.perf_counter()
    streams, sizes, _ = lzf.encode_chunks(raw, rec.dtype.itemsize)
    t_enc = time.perf_counter() - t0
    for i in range(n_enc):
        assert np.array_equal(lzf.decode(streams[i, :sizes[i]], cb,
                                         rec.dtype.itemsize), raw[i]), \
            f'codec chunk {i}'
    log('io', f'LZF codec: decode (LZF + unshuffle, 1 thread, the read-back '
        f'of the lzf truth: {rec_lzf.nbytes} bytes from '
        f'{stored["lzf"]}) {rec_lzf.nbytes / t_dec / 1e6:.1f} MB/s; encode '
        f'(shuffle + LZF, {lzf.threads()} threads, {n_enc} chunks of the '
        f'run\'s truth, {raw.nbytes} bytes) {raw.nbytes / t_enc / 1e6:.1f} '
        f'MB/s, ratio {raw.nbytes / sizes.sum():.3f}; round trip equal')
    return runs


def light_checks(out: str, n_seg: int) -> str:
    """The light datasets of the charge+light slice: one waveform row and
    one trigger per spill, the incidence of every segment."""
    from larndsim_tpu_torch.io.h5 import File
    n_spills = SPILLS['n_events']
    with File(out, 'r') as f:
        wv = np.array(f['light_wvfm'])
        trig = f['light_trig'].shape
        dat = f['light_dat/light_dat_allmodules'].shape
    assert wv.shape == (n_spills, 96, 256), wv.shape
    assert trig == (n_spills,), trig
    assert dat == (n_seg, 96), dat
    assert np.isfinite(wv).all() and (wv != 0).any(), 'light_wvfm'
    return (f'light_wvfm {wv.shape}, light_trig {trig}, '
            f'light_dat/light_dat_allmodules {dat}')


def slice_checks(out: str) -> int:
    from larndsim_tpu_torch.io.h5 import File
    with File(out, 'r') as f:
        for name in ('packets', 'mc_packets_assn', 'segments'):
            assert name in f, f'output lacks {name}'
        pk = np.array(f['packets'])
        n_assn = f['mc_packets_assn'].shape[0]
    data = pk[pk['packet_type'] == 0]
    assert len(data) > 0, 'no data packets'
    adc = data['dataword'].astype(np.int64)
    assert ((adc >= 0) & (adc <= 255)).all(), 'ADC outside [0, 255]'
    assert n_assn == len(pk), (n_assn, len(pk))
    return len(data)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--profile', default=None,
                    help='directory for host and device profiles of the slice')
    opts = ap.parse_args(argv)
    t_start = time.perf_counter()
    spans, t_mark = [], [t_start]

    def mark(name):
        """The seconds since the last mark, kept under ``name``."""
        now = time.perf_counter()
        spans.append(f'{name} {now - t_mark[0]:.1f}')
        t_mark[0] = now

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log('device', f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.device_count()} device(s); nvidia-smi: {smi}')

    from larndsim_tpu_torch.assets.geometry import write_module0
    from larndsim_tpu_torch.assets.make_input import write_input
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    from larndsim_tpu_torch.io import lzf
    from larndsim_tpu_torch.kernels import binding, build
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.models import truth_emit
    from larndsim_tpu_torch.ops import accumulate, current, fee
    from larndsim_tpu_torch.params import load_detector
    from larndsim_tpu_torch.tools import light_check
    from larndsim_tpu_torch.utils import batching

    t0 = time.perf_counter()
    build.load()
    log('build', f'{len(build.sources())} CUDA sources -> '
        f'{os.path.basename(build.library_path())} in '
        f'{time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds:.2f} s)')
    for name, mod in (('LZF codec', lzf), ('truth emitter', truth_emit),
                      ('batch assigner', batching)):
        t0 = time.perf_counter()
        mod.library()
        log('build', f'{name} ({mod.SOURCES[0].split("larndsim_tpu_torch/")[1]}'
            f', host C++) in {time.perf_counter() - t0:.2f} s')

    mark('start+build')
    with tempfile.TemporaryDirectory() as tmp:
        reference_phase(tmp)
        mark('reference')

        paths = write_module0(os.path.join(tmp, 'module0'))
        dm = load_detector(paths['detector_properties'],
                           paths['pixel_layout'])
        inp = os.path.join(tmp, 'spills.h5')
        n_seg = write_input(inp, dm.tpc_borders, **SPILLS)
        kw = dict(config='module0',
                  detector_properties=paths['detector_properties'],
                  pixel_layout=paths['pixel_layout'],
                  simulation_properties=paths['simulation_properties'],
                  # absent file: the synthetic 45 x 45 x 1891 response
                  response_file=os.path.join(tmp, 'response_44.npy'),
                  rand_seed=7, step_scale=1.0, device='cuda')
        det = dm.params
        log('slice', f'Module-0-shaped: n_pixels {det.n_pixels} x '
            f'{det.n_tpcs} TPCs, {det.time_ticks} ticks; input {n_seg} '
            f'segments in {SPILLS["n_events"]} spills')

        # warm-up run; the first call of each chain kernel keeps its inputs
        t0 = time.perf_counter()
        with kernel_inputs() as kept:
            cli.run_simulation(inp, os.path.join(tmp, 'warm.h5'), **kw)
            torch.cuda.synchronize()
        log('warm-up', f'slice run {time.perf_counter() - t0:.2f} s '
            '(first call: CUDA context, allocator, response upload)')
        captured = next(iter(kept.values()))
        k1 = compare_k1(captured['k1'])
        d1 = compare_d1(captured['d1'], library=True)
        k2 = compare_k2(captured['k2'],
                        load_detector(paths['detector_properties'],
                                      paths['pixel_layout'],
                                      device='cuda').params)
        d2 = compare_d2(captured['d2'])
        # the kept inputs would count in the slices' peak memory
        del captured, kept

        def forbidden(name):
            def plain(*args, **kwargs):
                raise AssertionError(f'{name} ran on the main path')
            return plain

        plain_versions = ((current, 'current_plain'),
                          (accumulate, 'sum_pixel_signals_plain'),
                          (fee, 'fee_fsm_plain'),
                          (fee, 'current_fractions_plain'))

        def main_path(out, run_kw, inp=inp):
            """One timed slice run: launch counters set to 0 before, read
            after; the plain kernel versions forbidden.  D1 must launch
            once per K1 launch, D2 once per batch in which a pixel latched
            (the batches with no latch are counted under
            ``batches_unlatched``)."""
            plains = [getattr(mod, name) for mod, name in plain_versions]
            for mod, name in plain_versions:
                setattr(mod, name, forbidden(name))
            batches = collections.Counter()
            lock = threading.Lock()
            orig_d2 = fee.current_fractions

            def counted_d2(*args, **kwargs):
                with lock:
                    batches['latched' if kwargs['n_adc_scan'] > 0
                            else 'unlatched'] += 1
                return orig_d2(*args, **kwargs)
            fee.current_fractions = counted_d2
            try:
                torch.cuda.reset_peak_memory_stats()
                binding.reset_launches()
                t0 = time.perf_counter()
                cli.run_simulation(inp, out, **run_kw)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = dict(binding.launches)
            finally:
                for (mod, name), fn in zip(plain_versions, plains):
                    setattr(mod, name, fn)
                fee.current_fractions = orig_d2
            assert launches['induced_current'] > 0, launches
            assert launches['fee_fsm'] > 0, launches
            assert launches['sum_pixel_signals'] == \
                launches['induced_current'], launches
            assert launches['current_fractions'] == batches['latched'] > 0, \
                (launches, batches)
            launches['batches_unlatched'] = batches['unlatched']
            return wall, launches, torch.cuda.max_memory_allocated() / 2 ** 30

        out = os.path.join(tmp, 'slice.h5')
        wall, launches, peak_gib = main_path(out, kw)
        n_data = slice_checks(out)
        log('slice', f'wall {wall:.3f} s, {n_seg / wall:.1f} segments/s, '
            f'{n_data} data packets, launches {launches}, peak device '
            f'memory {peak_gib:.2f} GiB')
        phase_table('charge-only slice')
        cost = trace_cost()
        log('phases', f'cost of one phase on the card: {cost["phase"]:.1f} '
            'us of host time; a profiler range alone '
            f'{cost["profiler_range"]:.1f} us')
        mark('slice')

        # ---- charge + light ----
        paths_l = write_module0(os.path.join(tmp, 'module0_light'),
                                light=True)
        kw_l = dict(kw, detector_properties=paths_l['detector_properties'])
        t0 = time.perf_counter()
        with light_check.first_batch() as seen:
            cli.run_simulation(inp, os.path.join(tmp, 'warm_light.h5'),
                               **kw_l)
        torch.cuda.synchronize()
        log('warm-up', f'charge+light run {time.perf_counter() - t0:.2f} s '
            '(first call: light LUT, FFT plans)')
        light_phase(seen)

        def light_slice(out, run_kw):
            """main_path with the light stage's CUDA-event span per batch:
            (wall, launches, peak GiB, triggering spans, later spans)."""
            batches = []
            orig_light = light_model.simulate_light_batch

            def timed_light(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                res = orig_light(*args, **kwargs)
                ev[1].record()
                batches.append((kwargs.get('i_subbatch', 0), ev))
                return res
            light_model.simulate_light_batch = timed_light
            try:
                wall, launches, peak = main_path(out, run_kw)
            finally:
                light_model.simulate_light_batch = orig_light
            trig = [a.elapsed_time(b) for i_sub, (a, b) in batches
                    if i_sub == 0]
            rest = [a.elapsed_time(b) for i_sub, (a, b) in batches
                    if i_sub != 0]
            return wall, launches, peak, trig, rest

        out_l = os.path.join(tmp, 'slice_light.h5')
        wall_l, launches_l, peak_l, trig_ms, rest_ms = light_slice(out_l,
                                                                   kw_l)
        shapes = light_checks(out_l, n_seg)
        n_data_l = slice_checks(out_l)
        assert data_packets(out_l) == data_packets(out), \
            (n_data_l, n_data)
        log('slice', f'charge+light: {shapes}; {n_data_l} data packets, '
            f'equal to the charge-only slice\'s; wall {wall_l:.3f} s, '
            f'{n_seg / wall_l:.1f} segments/s; light stage stream span '
            f'per batch (CUDA events) {np.mean(trig_ms):.3f} ms per '
            f'triggering batch (min '
            f'{min(trig_ms):.3f}, max {max(trig_ms):.3f}, '
            f'{len(trig_ms)} batches), {np.mean(rest_ms):.3f} ms per later '
            f'batch ({len(rest_ms)}); launches {launches_l}, peak device '
            f'memory {peak_l:.2f} GiB')
        mark('light')

        truth_runs = truth_phase(tmp, out_l, kw_l, n_seg, light_slice,
                                 light_model)
        solo = truth_runs['device']
        mark('truth')
        grouped = grouped_phase(
            tmp, solo, dict(kw=kw, out=out, wall=wall, launches=launches),
            n_seg, main_path)
        mark('grouped')
        memlog_phase(tmp, inp, kw)
        mark('memlog')
        io_phase(tmp, inp, kw, out, main_path)
        mark('io')
        mode0_phase(tmp, inp, kw, n_seg, out, main_path)
        mark('mode0')
        m2m = mod2mod_phase(tmp, main_path)
        mark('mod2mod')
        ndev = ndev_phase(tmp, m2m, grouped, main_path)
        mark('ndev')
        ndlar = ndlar_phase(tmp, main_path)
        mark('ndlar')
        mesh = mesh_phase(tmp)
        mark('mesh')
        host_phase(tmp, truth_runs['host'], dict(
            charge=dict(kw=kw, inp=inp, out=out, wall=wall,
                        launches=launches),
            **{'2x2': dict(m2m['runs'][1], kw=m2m['kw'], inp=m2m['inp'])},
            ndlar_yaml=ndlar['runs']['yaml']), main_path)
        mark('host')

        if opts.profile:
            profile_slice(inp, os.path.join(tmp, 'profiled.h5'), kw,
                          opts.profile, cli)

    probes = p1_entries() + p23_entries()
    mark('probes')
    guard = guard_phase()
    guard_ndlar = guard_phase('ndlar')
    log('guard', f'ndlar K1 tile choice: '
        f'{guard_ndlar["kernels"]["induced_current"]["tiling"]}; ticks '
        f'{guard_ndlar["workload"]["time_ticks"]}')
    mark('guard')
    foreign = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'flax', 'larndsim_tpu'))
    assert not foreign, f'the port imported {foreign}'

    def on_2x2(name, k=None):
        """The kernel on the 2x2 path: launches per module (ungrouped and
        grouped), and K1's / K2's checks on a module-1 and a module-3
        batch."""
        return dict(launches_2x2={
            f'g{g}': {m: n[name] for m, n in sorted(r['per_module'].items())}
            for g, r in m2m['runs'].items()}, **{
                f'module{m}_batch': k[m] for m in (1, 3) if k})

    def on_ndev(name):
        """The kernel's launches under dispatch: per module of the 2x2 at
        n_devices 4, and the truth slice's at n_devices 2."""
        return dict(launches_ndev_2x2={
            m: n[CHAIN.index(name)]
            for m, n in ndev['2x2']['per_module'].items()},
            launches_ndev_module0=ndev['module0_2']['launches'][name])

    def at_production(name):
        """The guard's row of the kernel at production shapes; D1 and D2
        with their plain versions' times and the library call's there."""
        k, row = guard['kernels'][name], ROW[name]
        extra = {f'guard_{x}': k[x] for x in ('plain_ms', 'library_ms')
                 if x in k}
        if 'kernel_row' in k:
            extra['guard_kernel_ms'] = guard['ops_ms'][k['kernel_row']][
                'min_ms']
        return dict(guard_ms=guard['ops_ms'][row]['min_ms'],
                    guard_shapes=guard['shapes'], **{
                        f'guard_{x}': v for x, v in
                        guard['roofline'][row].items()}, **extra,
                    launches_per_batch=k['launches_per_batch'],
                    library=k['library'])

    def on_ndlar(name, k):
        """The kernel on ND-LAr: launches of the timed spills at bench's
        batching (and at the YAML's), its check on an ND-LAr batch, and the
        guard's ND-LAr row; and on the mesh: its launches per cell and its
        checks on a cell of the step and of the dry run."""
        key, row = KEY[name], ROW[name]
        g = guard_ndlar['kernels'].get(name, {})
        return dict(
            launches_ndlar=ndlar['runs']['bench']['launches'][name],
            launches_ndlar_yaml=ndlar['runs']['yaml']['launches'][name],
            launches_mesh={c: n.get(name, 0)
                           for c, (_, n) in mesh['cells'].items()},
            mesh_cell=mesh['held'][key], dryrun_cell=mesh['dry_held'][key],
            ndlar_batch=k, ndlar_guard_ms=guard_ndlar['ops_ms'][row][
                'min_ms'], ndlar_guard_shapes=guard_ndlar['shapes'], **{
                f'ndlar_guard_{x}': g[x] for x in ('plain_ms', 'library_ms')
                if x in g}, **({'ndlar_guard_kernel_ms': guard_ndlar[
                    'ops_ms'][g['kernel_row']]['min_ms']}
                    if 'kernel_row' in g else {}), **{
                f'ndlar_guard_{x}': v for x, v in
                guard_ndlar['roofline'][row].items()})

    def unlatched(run):
        """Batches of ``run`` in which no pixel latched (no D2 launch)."""
        return run['launches']['batches_unlatched']

    # D1's and D2's ms is the kernel alone (the batch's CSR given),
    # ms_with_inputs the call that also makes the CSR
    kernels = [
        dict(name='induced_current', route='cuda', source=K1_SOURCE,
             replaces=K1_REPLACES, launches=launches['induced_current'],
             launches_charge_light=launches_l['induced_current'],
             launches_grouped=grouped['launches']['induced_current'],
             **k1, library_ms=None, **at_production('induced_current'),
             **on_2x2('induced_current', m2m['k1']),
             **on_ndev('induced_current'),
             **on_ndlar('induced_current', ndlar['k1'])),
        dict(name='sum_pixel_signals', route='cuda', source=D1_SOURCE,
             replaces=D1_REPLACES, replaces_kind=XLA_OPS,
             launches=launches['sum_pixel_signals'],
             launches_charge_light=launches_l['sum_pixel_signals'],
             launches_grouped=grouped['launches']['sum_pixel_signals'],
             **d1, **at_production('sum_pixel_signals'),
             **on_2x2('sum_pixel_signals'), **on_ndev('sum_pixel_signals'),
             **on_ndlar('sum_pixel_signals', ndlar['d1'])),
        dict(name='fee_fsm', route='cuda', source=K2_SOURCE,
             replaces=K2_REPLACES, launches=launches['fee_fsm'],
             launches_charge_light=launches_l['fee_fsm'],
             launches_grouped=grouped['launches']['fee_fsm'], **k2,
             library_ms=None, **at_production('fee_fsm'),
             **on_2x2('fee_fsm', m2m['k2']),
             **on_ndev('fee_fsm'), **on_ndlar('fee_fsm', ndlar['k2'])),
        dict(name='current_fractions', route='cuda', source=D2_SOURCE,
             replaces=D2_REPLACES, replaces_kind=XLA_OPS,
             launches=launches['current_fractions'],
             batches_unlatched=launches['batches_unlatched'],
             launches_charge_light=launches_l['current_fractions'],
             launches_grouped=grouped['launches']['current_fractions'],
             batches_unlatched_grouped=unlatched(grouped),
             batches_unlatched_2x2={f'g{g}': unlatched(r)
                                    for g, r in m2m['runs'].items()},
             batches_unlatched_ndlar={
                 name: unlatched(r) for name, r in ndlar['runs'].items()},
             **d2, **at_production('current_fractions'),
             **on_2x2('current_fractions'), **on_ndev('current_fractions'),
             **on_ndlar('current_fractions', ndlar['d2'])),
    ] + probes
    for k in kernels[:4]:
        log('kernels', f'{k["name"]}: launches slice {k["launches"]}, '
            f'grouped {k["launches_grouped"]}, 2x2 '
            f'{sum(k["launches_2x2"]["g1"].values())} / '
            f'{sum(k["launches_2x2"][f"g{GROUP}"].values())}, ND-LAr '
            f'{k["launches_ndlar"]} / {k["launches_ndlar_yaml"]}, mesh '
            f'{k["launches_mesh"]}'
            + (f'; batches with no latch: slice {k["batches_unlatched"]}, '
               f'grouped {k["batches_unlatched_grouped"]}, 2x2 '
               f'{k["batches_unlatched_2x2"]}, ND-LAr '
               f'{k["batches_unlatched_ndlar"]}'
               if 'batches_unlatched' in k else ''))
    log('time', 'seconds by phase: ' + ', '.join(spans))
    log('done', f'every phase passed in {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(f'card: {smi}')
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def profile_slice(inp: str, out: str, kw: dict, directory: str, cli) -> None:
    """Two more slice runs: one under cProfile (host time by function),
    one under torch.profiler (device time by kernel)."""
    import cProfile
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(directory, exist_ok=True)
    host = cProfile.Profile()
    host.runcall(cli.run_simulation, inp, out + '.host', **kw)
    torch.cuda.synchronize()
    with open(os.path.join(directory, 'slice_host.txt'), 'w') as f:
        pstats.Stats(host, stream=f).sort_stats('cumulative').print_stats(60)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cli.run_simulation(inp, out, **kw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # 'cuda' names the device column in every torch version
    table = prof.key_averages().table(sort_by='self_cuda_time_total',
                                      row_limit=40)
    path = os.path.join(directory, 'slice_profile.txt')
    with open(path, 'w') as f:
        f.write(f'profiled slice wall {wall:.3f} s\n{table}\n')
    from torch.autograd import DeviceType
    device_ms = {e.key: e.self_device_time_total / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}
    # the kernels by their csrc/*.cu names (a template's instances summed)
    from larndsim_tpu_torch.kernels import build
    ours = {name: round(sum(v for k, v in device_ms.items() if name in k), 3)
            for name in build.kernel_names()
            if any(name in k for k in device_ms)}
    busy_ms = sum(device_ms.values())
    log('profile', f'wall {wall:.3f} s under the profiler; device kernels '
        f'{busy_ms:.1f} ms in all ({100 * busy_ms / (1e3 * wall):.1f}% of '
        f'that wall), ours {ours} -> {path}')


if __name__ == '__main__':
    sys.exit(main())
