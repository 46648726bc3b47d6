"""Simulation entry point: edep-sim HDF5 in -> LArPix packets + light
waveforms out.

Counterpart of ``larndsim_tpu.cli.simulate_pixels.run_simulation`` on one
device; the light chain runs in the configuration's trigger mode, the beam
trigger (1) or the threshold trigger (0).  With module-to-module variation
(the ``2x2`` configuration) the modules run in turn, each with its own
layout, response, light LUT, thresholds, gains, tracks and channels, as
the JAX CLI's sequential module loop runs them.  Flag names match the JAX
CLI for every flag supported here, plus ``--device``, ``--truth_path``,
``--unique_guard`` and ``--pipeline`` (the JAX CLI's
``LARNDSIM_PIPELINE=1``).
``n_devices`` N spreads the work over N dispatch contexts, as the JAX CLI
spreads it over N chips: event groups go round-robin over a module's
contexts (each with its own copy of the module's tensors per card, its
own CUDA stream and its own thread), and with module variation the
modules run on threads of their own over subsets of the contexts.  Groups
are submitted and accumulated in order on the module's thread, and every
file write of a module passes its write gate in module order, so the
output file holds the same datasets, bit for bit, for any N.
``event_group_size`` G runs up to G independent (event, TPC) batches as one
charge call (pixel keys offset per event) and their first batches' light
as one group call (in mode 0, one per window bucket).  The charge chain's
draws come from a
``torch.Generator`` per call, seeded from (rand_seed, the call's first
event, call number); the light chain's from a generator of their own per
(event, sub-batch) (:func:`light_draw`), so switching light on moves no
charge draw and grouping moves no light draw.  Event times come from
``np.random.default_rng(rand_seed)`` as in the JAX CLI, so the packet
timestamps match it.  The run ends with the phase table
(``utils.trace``); ``save_memory`` writes the memory log
(``utils.memlog``).

    python -m larndsim_tpu_torch.cli.simulate_pixels IN.h5 OUT.h5 \\
        --detector_properties det.yaml --pixel_layout layout.yaml \\
        --simulation_properties sim.yaml --response_file missing.npy
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
import warnings
from collections import defaultdict, deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from ..assets.light_lut import load_light_lut, make_light_noise
from ..assets.response import load_response
from ..config import get_config
from ..io import edep, export, lzf
from ..io.edep import swap_coordinates
from ..io.h5 import File, partial_path
from ..models import light as light_model
from ..models import truth_emit
from ..models.charge import bucket, generator_draw, simulate_charge_batch
from ..ops import light as light_ops
from ..ops.drift import drift, select_active_volume
from ..ops.quench import quench
from ..parallel.devices import (card_scope, dispatch_stream,
                                module_devices, resolve_devices, to_device)
from ..params import (DetectorFiles, get_module_ids, load_detector,
                      load_light, load_sim, physics)
from ..segments import from_structured, from_structured_group, to_structured
from ..utils import batching, trace
from ..utils.batching import TPCBatcher
from ..utils.memlog import MemoryLogger
from ..utils.pixel_lut import PixelLUT


def gen_event_times(nevents: int, event_rate: float, t0: float = 0.0,
                    rng=None) -> np.ndarray:
    """Sequential uncorrelated event times [us] (fee.gen_event_times,
    fee.py:66-81)."""
    rng = rng or np.random.default_rng()
    return np.cumsum(rng.exponential(scale=event_rate,
                                     size=int(nevents))) + t0


def _as_list(val, n_modules, cfg, id_name, ids=None):
    """A scalar-or-list configuration entry resolved per module through its
    ``*_ID`` indirection (cli/simulate_pixels.py:106-122)."""
    if val is None or not isinstance(val, list):
        return val
    if ids is None:
        ids = cfg.get(id_name)
    if ids is not None:
        if len(ids) != n_modules or max(ids) >= len(val):
            raise KeyError(f'Bad {id_name} indirection')
        return [val[i] for i in ids]
    if len(val) != n_modules:
        raise KeyError(f'Expected {n_modules} entries for {id_name}')
    return val


def _scalar(val):
    """One file where module variation is off: several raise."""
    if isinstance(val, list):
        if len(val) > 1:
            raise KeyError('Multiple config files provided without module '
                           'variation')
        return val[0]
    return val


def _of_module(val, i_mod: int):
    """Module ``i_mod``'s entry of a per-module list, or the one value."""
    return val[i_mod - 1] if isinstance(val, list) else val


def _response(files: DetectorFiles, path, **synth) -> np.ndarray:
    """``load_response(path, **synth)`` through the call's table, keyed by
    the path and the arguments."""
    return files.get('response', (path, *sorted(synth.items())),
                     lambda: load_response(path, **synth))


class _WriteGate:
    """A module's file writes, in module order (cli:76-106 of the JAX
    CLI): while the gate is closed, :meth:`submit` queues a write; opening
    it runs the queued writes and opens it, atomically with respect to
    :meth:`submit`, so a module's writes land after every earlier
    module's and in its own order."""

    def __init__(self, open_now: bool = False):
        self._lock = threading.Lock()
        self._open = open_now
        self._q: deque = deque()

    def submit(self, fn) -> None:
        with self._lock:
            if not self._open:
                self._q.append(fn)
                return
        fn()

    def open(self) -> None:
        with self._lock:
            while self._q:
                self._q.popleft()()
            self._open = True


@dataclasses.dataclass
class _Context:
    """One dispatch context of a module (JAX cli:482-506): its device, the
    module's tensors there, and, where the module has several contexts,
    its CUDA stream (None on the CPU) and its thread (``pool``)."""
    device: torch.device
    det_model: object
    response: torch.Tensor
    light: object = None
    lut: object = None
    light_noise: torch.Tensor | None = None
    light_inc: torch.Tensor | None = None
    light_t0: torch.Tensor | None = None
    light_vox: torch.Tensor | None = None
    stream: object = None
    pool: ThreadPoolExecutor | None = None

    def scope(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return card_scope(self.device, self.stream)


def unique_pixel_bound(rows: np.ndarray, slot, det_model) -> int:
    """An upper bound on the unique pixel keys of one charge call on the
    drifted segment ``rows`` (event ``slot`` per row, or None): per event,
    the union of each segment's anode box widened by the pixelization's
    radius, plus one pixel for the rounding of its ends."""
    det = det_model.params
    pitch = det.host['pixel_pitch']
    nx, ny = det.n_pixels
    borders = det.host['tpc_borders']
    plane = np.clip(rows['pixel_plane'].astype(np.int64), 0,
                    borders.shape[0] - 1)
    r = max(int(np.ceil(rows['tran_diff'].max() * 5 / pitch)), 1) + 1

    def span(lo_key, hi_key, axis, n):
        a = np.floor((rows[lo_key] - borders[plane, axis, 0]) / pitch)
        b = np.floor((rows[hi_key] - borders[plane, axis, 0]) / pitch)
        lo = np.clip(np.minimum(a, b) - r, 0, n - 1).astype(np.int64)
        hi = np.clip(np.maximum(a, b) + r, 0, n - 1).astype(np.int64)
        return lo, hi - lo + 1
    x0, w = span('x_start', 'x_end', 0, nx)
    y0, h = span('y_start', 'y_end', 1, ny)
    if len(rows) * int(w.max()) * int(h.max()) > 1 << 22:
        return int((w * h).sum())
    ox = np.arange(int(w.max()))[None, :, None]
    oy = np.arange(int(h.max()))[None, None, :]
    ev = np.zeros(len(rows), np.int64) if slot is None \
        else np.asarray(slot[:len(rows)], np.int64)
    base = ((ev * borders.shape[0] + plane) * ny + y0) * nx + x0
    keys = base[:, None, None] + oy * nx + ox
    inside = (ox < w[:, None, None]) & (oy < h[:, None, None])
    return int(np.unique(keys[inside]).size)


def batch_generator(rand_seed: int, i_mod: int, event: int, seq: int,
                    device) -> torch.Generator:
    """Generator of one charge call's draws, seeded from its identity: its
    first event and its number in the run."""
    seed = np.random.SeedSequence(
        [rand_seed, max(i_mod, 0), int(event), seq]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def light_draw(rand_seed: int, i_mod: int, event: int, i_subbatch: int,
               device) -> light_ops.LightDraw:
    """Draws of one light batch, from a generator seeded from its identity
    in a stream of its own (apart from :func:`batch_generator`'s)."""
    seed = np.random.SeedSequence(
        [rand_seed, max(i_mod, 0), int(event), i_subbatch],
        spawn_key=(1,)).generate_state(1)[0]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return light_model.generator_draw(gen, device)


def _no_output_on_error(run):
    """A run that fails removes the partial output file it began (the
    output is moved onto its path only when it is complete)."""
    @functools.wraps(run)
    def wrapped(input_filename, output_filename, *args, **kwargs):
        try:
            return run(input_filename, output_filename, *args, **kwargs)
        except BaseException:
            part = partial_path(output_filename)
            if os.path.lexists(part):
                os.remove(part)
            raise
    return wrapped


@_no_output_on_error
def run_simulation(input_filename: str,
                   output_filename: str,
                   config: str = '2x2',
                   mod2mod_variation: bool | None = None,
                   pixel_layout=None,
                   pixel_layout_id=None,
                   detector_properties: str | None = None,
                   simulation_properties: str | None = None,
                   response_file=None,
                   response_id=None,
                   light_simulated: bool | None = None,
                   light_lut_filename=None,
                   light_lut_id=None,
                   light_det_noise_filename: str | None = None,
                   bad_channels: str | None = None,
                   n_events: int | None = None,
                   pixel_thresholds_file=None,
                   pixel_thresholds_id=None,
                   pixel_gains_file=None,
                   pixel_gains_id=None,
                   rand_seed: int | None = None,
                   save_memory: str | None = None,
                   step_scale: float = 1.0,
                   event_group_size: int = 1,
                   n_devices: int = 1,
                   truth_compression: str = 'lzf',
                   truth_workers: int = 1,
                   device='cuda',
                   truth_path: str = 'device',
                   unique_guard: int = 65536,
                   pipeline: bool = False):
    """Simulate the charge and light readout of a pixelated LArTPC.

    ``mod2mod_variation`` None follows the configuration; with it on (and
    more than one module), each module runs in turn with its own pixel
    layout, response, light LUT, thresholds and gains, picked from lists
    by the ``*_id`` arguments or the configuration's ``*_ID`` entries, its
    own tracks (those inside its two TPCs) and its share of the optical
    channels; the light waveforms are merged along the channel axis at the
    end.  Without it, a list of several files raises KeyError.
    ``light_simulated`` None follows the configuration and the detector
    YAML (no light keys: no light); ``step_scale`` coarsens the MC
    charge-sampling density (1.0 is the reference MIN_STEP_SIZE density);
    ``device`` is where the chains run ('cuda' raises when no card is
    present).  Light runs in the detector YAML's ``light_trig_mode``: the
    beam trigger (1) fires once on an event's first batch, the threshold
    trigger (0) wherever a channel group crosses its threshold, on every
    batch, with ``light_trig`` rows written per flush and trigger packets
    per module io group.  ``truth_path`` is the route of
    the light MC truth with LUT smearing ('device': dense truth on the
    card, kept records pulled; 'host': the card's top-K contributors,
    records recomputed on ``truth_workers`` worker threads); the records
    are written in batch order, and a worker's error fails the run.
    ``event_group_size`` G groups up to G (event, TPC) batches of a module
    into one charge call and their events' first batches into one light
    call; a group also closes before it would pass ``sim.batch_size``
    segments, or ``unique_guard`` unique pixels at the largest
    unique-pixel-per-segment ratio seen so far in the module (0: no
    guard).  ``n_devices`` N runs the work in N dispatch contexts on the
    devices ``device`` resolves to (:func:`resolve_devices`: 'cuda' the
    visible cards, 'cpu' N contexts on the CPU, or a list of devices,
    repeats allowed, as ``['cuda:0'] * 4``): a module's event groups go
    round-robin over its contexts, each on its own thread and CUDA stream;
    with module variation and N > 1 the modules run at once, each on a
    thread of its own over its share of the contexts.  Every draw is keyed
    by its batch, groups are accumulated in order and each module's file
    writes pass a gate in module order, so every dataset is the same, bit
    for bit, for any N (and the unique-pixel guard decides as it does
    with one context).  ``pipeline`` (JAX's ``LARNDSIM_PIPELINE=1``) runs
    the groups of a module that has one context on a worker thread of that
    context, with its own CUDA stream, so that the module's thread plans,
    accumulates and writes while the worker computes; the output is the
    same, bit for bit (a module with several contexts already runs so).
    ``save_memory`` names the memory log's file (HDF5
    for .h5 / .hdf5, else npz).  ``truth_compression`` is the light
    truth's filter after the byte shuffle ('lzf', 'gzip', or 'none':
    neither).  Appended datasets are written a chunk at a time as they
    fill, the rest of the file when the run ends.
    """
    devices = resolve_devices(device, n_devices)
    device = devices[0]
    # float32 products in full float32 on the card, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not os.path.exists(input_filename):
        raise FileNotFoundError(input_filename)
    if os.path.exists(output_filename):
        raise FileExistsError(output_filename)

    cfg = get_config(config)
    pixel_layout = pixel_layout or cfg['PIXEL_LAYOUT']
    detector_properties = detector_properties or cfg['DET_PROPERTIES']
    simulation_properties = simulation_properties or cfg['SIM_PROPERTIES']
    response_file = response_file or cfg['RESPONSE']
    if light_simulated is None:
        light_simulated = cfg.get('LIGHT_SIMULATED', True)
    if light_lut_filename is None:
        light_lut_filename = cfg.get('LIGHT_LUT')
    if light_det_noise_filename is None:
        light_det_noise_filename = cfg.get('LIGHT_DET_NOISE')
    if pixel_thresholds_file is None:
        pixel_thresholds_file = cfg.get('PIXEL_THRESHOLDS_FILE')
    if pixel_gains_file is None:
        pixel_gains_file = cfg.get('PIXEL_GAINS_FILE')

    # a table per run: repeated runs in one process would add up
    trace.reset()
    # the call's detector files, each read once for all the modules
    files = DetectorFiles('cli/detector_files')
    mod_ids_all = get_module_ids(detector_properties, files=files)
    n_modules = len(mod_ids_all)
    if mod2mod_variation is None:
        mod2mod_variation = cfg.get('MOD2MOD_VARIATION', False)
    if mod2mod_variation and n_modules == 1:
        warnings.warn('Single module with module variation: deactivating.')
        mod2mod_variation = False
    if mod2mod_variation:
        pixel_layout = _as_list(pixel_layout, n_modules, cfg,
                                'PIXEL_LAYOUT_ID', ids=pixel_layout_id)
        response_file = _as_list(response_file, n_modules, cfg,
                                 'RESPONSE_ID', ids=response_id)
        light_lut_filename = _as_list(light_lut_filename, n_modules, cfg,
                                      'LIGHT_LUT_ID', ids=light_lut_id)
        pixel_thresholds_file = _as_list(
            pixel_thresholds_file, n_modules, cfg, 'PIXEL_THRESHOLDS_ID',
            ids=pixel_thresholds_id)
        pixel_gains_file = _as_list(pixel_gains_file, n_modules, cfg,
                                    'PIXEL_GAINS_ID', ids=pixel_gains_id)
    else:
        pixel_layout = _scalar(pixel_layout)
        response_file = _scalar(response_file)
        light_lut_filename = _scalar(light_lut_filename)
        pixel_thresholds_file = _scalar(pixel_thresholds_file)
        pixel_gains_file = _scalar(pixel_gains_file)

    sim = dataclasses.replace(load_sim(simulation_properties),
                              mod2mod_variation=bool(mod2mod_variation))
    light_loaded = load_light(detector_properties, asset_root=os.path.dirname(
        os.path.dirname(detector_properties)), device=device)
    light = light_loaded.replace(light_simulated=bool(light_simulated)
                                 and light_loaded.light_simulated)
    if light.light_simulated:
        light_model.check_supported(light, truth_path)
    if truth_compression not in export.TRUTH_COMPRESSION:
        raise ValueError(f'truth_compression {truth_compression!r}, not one '
                         f'of {export.TRUTH_COMPRESSION}')
    # a host library that cannot build fails here
    batching.library()
    truth_on = light.light_simulated and sim.max_mc_truth_ids > 0
    if truth_on:
        if truth_compression == 'lzf':
            lzf.library()
        if truth_path == 'host' and light.enable_lut_smearing:
            truth_emit.library()
    memlog = MemoryLogger(save_memory is None, device)
    memlog.start()
    t_sim0 = time.time()
    if rand_seed is None:
        rand_seed = int(time.time())
    np_rng = np.random.default_rng(rand_seed)

    # ---------------- input ----------------
    with trace.phase('cli/input'):
        inp = edep.load_edep(input_filename, n_events=n_events,
                             event_separator=sim.event_separator,
                             is_spill_sim=sim.is_spill_sim,
                             spill_period=sim.spill_period,
                             max_events_per_file=sim.max_events_per_file)
        tracks = inp.tracks
        vertices, mc_hdr, mc_stack = inp.vertices, inp.mc_hdr, inp.mc_stack
        memlog.take_snapshot()
        memlog.archive('loading')

        # the first layout's geometry for the event times and the active
        # volume (cli:261-265)
        with trace.phase('cli/detector'):
            geo = load_detector(detector_properties,
                                _of_module(pixel_layout, 1), device=device,
                                files=files)
        trig_mode = light.light_trig_mode

        num_evids = int(tracks[sim.event_separator].max()
                        % sim.max_events_per_file) + 1
        if sim.is_spill_sim:
            event_times = np.arange(num_evids) * sim.spill_period
        else:
            event_times = gen_event_times(num_evids, geo.params.event_rate,
                                          t0=geo.params.non_beam_event_gap,
                                          rng=np_rng)

        # event times into vertices/mc_hdr (cli:616-642)
        if vertices is not None and not sim.is_spill_sim:
            import numpy.lib.recfunctions as rfn
            if 't_event' not in vertices.dtype.names:
                vertices = rfn.merge_arrays(
                    (np.zeros(vertices.shape[0], dtype=[('t_event', 'f4')]),
                     vertices), flatten=True)
            uniq_ev, counts = np.unique(vertices[sim.event_separator],
                                        return_counts=True)
            vertices['t_event'] = np.repeat(
                event_times[uniq_ev % sim.max_events_per_file], counts)
        if mc_hdr is not None and vertices is not None \
                and 't_event' in vertices.dtype.names:
            import numpy.lib.recfunctions as rfn
            if 't_event' not in mc_hdr.dtype.names:
                mc_hdr = rfn.merge_arrays(
                    (np.zeros(mc_hdr.shape[0], dtype=[('t_event', 'f4')]),
                     mc_hdr), flatten=True)
            mc_hdr['t_event'] = vertices['t_event']

        active_mask = select_active_volume(tracks, geo.tpc_borders)
        all_mod_tracks = tracks[active_mask]
        all_mod_segment_ids = inp.segment_ids[active_mask]
        all_mod_traj_ids = inp.trajectory_ids[active_mask]

    # appended datasets go to disk a chunk at a time; the rest at close
    out = File(output_filename, 'w')

    def _host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    def run_module(i_mod: int, mod_devices: list, gate: _WriteGate):
        """One module's simulation (cli:323-441, the reference's module
        loop body) on the dispatch contexts of ``mod_devices``, its file
        writes through ``gate``; ``i_mod`` -1 without module variation.
        Returns its drifted tracks, its light_dat rows (None without light)
        and its detector model."""
        home = mod_devices[0]
        with trace.phase('cli/detector'):
            det_model = load_detector(detector_properties, pixel_layout,
                                      i_module=i_mod, device=home,
                                      files=files)
            det = det_model.params
            n_resp_t = int(round(det.f32('time_window')
                                 / det.f32('response_sampling')))
            # the module's own copy on its card, of a table read once
            response = torch.from_numpy(_response(
                files, _of_module(response_file, i_mod), n_t=n_resp_t,
                bin_size=det.f32('response_bin_size'),
                sampling=det.f32('response_sampling'),
                pixel_pitch=det.f32('pixel_pitch'))).to(home, copy=True)
            thresholds_lut = (PixelLUT.load(_of_module(pixel_thresholds_file,
                                                       i_mod))
                              if pixel_thresholds_file else None)
            gains_lut = (PixelLUT.load(_of_module(pixel_gains_file, i_mod))
                         if pixel_gains_file else None)

        if mod2mod_variation:
            # the module's own tracks: those inside its two TPCs
            module_borders = det_model.tpc_borders[(i_mod - 1) * 2:i_mod * 2]
            mask = select_active_volume(all_mod_tracks, module_borders)
            tracks_sel = all_mod_tracks[mask]
            segment_ids = all_mod_segment_ids[mask]
            traj_ids = all_mod_traj_ids[mask]
        else:
            module_borders = det_model.tpc_borders
            tracks_sel = all_mod_tracks
            segment_ids = all_mod_segment_ids
            traj_ids = all_mod_traj_ids

        io_groups = np.array(list(det_model.module_to_io_groups.values()))
        trig_module = int(np.argwhere(
            io_groups == export.get_trig_io(trig_mode))[0][0]) + 1 \
            if io_groups.size else 1

        # ---- quench + drift over the whole module ----
        t0 = time.time()
        with trace.phase('cli/quench_drift', home):
            segs_all = from_structured(tracks_sel,
                                       pad_to=bucket(len(tracks_sel), lo=64),
                                       device=home)
            segs_all = drift(quench(segs_all, det, physics.BIRKS), det)
            tracks_mod = to_structured(segs_all, dtype=tracks_sel.dtype)
        print(f'Quenching and drifting: {time.time() - t0:.2f} s')
        memlog.take_snapshot()
        memlog.archive(f'quench_drift_mod{i_mod}')

        # ---- light incidence over the module (cli:398-441) ----
        light_dat = None
        home_ctx = _Context(home, det_model, response)
        if light.light_simulated:
            t0 = time.time()
            n_light_channel = (light.n_op_channel // n_modules
                               if mod2mod_variation else light.n_op_channel)
            lut = light_ops.LightLUT.from_structured(load_light_lut(
                _of_module(light_lut_filename, i_mod),
                n_det_tpc=max(n_light_channel // 2, 1)), home)
            if light_det_noise_filename and \
                    os.path.isfile(light_det_noise_filename):
                light_noise = np.load(light_det_noise_filename)
            else:
                light_noise = make_light_noise(light.n_op_channel)
            channel_offset = 0
            # the module's channels simulate as the first module's ids,
            # with their own noise rows (cli:419-424, :633-637)
            op_channel = light.tpc_to_op_channel.reshape(-1)
            if mod2mod_variation:
                channel_offset = n_light_channel * (i_mod - 1)
                light_noise = light_noise[
                    channel_offset:channel_offset + n_light_channel]
                op_channel = light.tpc_to_op_channel[:2].reshape(-1)
            op_channel_sim = light_ops.host_array(op_channel)
            light_noise = torch.as_tensor(light_noise, dtype=torch.float32,
                                          device=home)
            light_h = to_device(light, home)
            with trace.phase('light/incidence', home):
                light_inc, light_t0, light_vox = \
                    light_ops.calculate_light_incidence(
                        segs_all, det, light_h, lut.vis, lut.t0,
                        n_channels=n_light_channel,
                        channel_offset=channel_offset)
                # per-segment light summary for the output file
                # (cli:758-760)
                valid = segs_all.valid.cpu().numpy()
                light_dat = np.zeros((int(valid.sum()), n_light_channel),
                                     dtype=[('segment_id', 'u4'),
                                            ('n_photons_det', 'f4'),
                                            ('t0_det', 'f4')])
                # host copies: light_dat, and mode 0's windows
                # (mode0_window)
                light_inc_h = light_inc.cpu().numpy()[valid]
                light_t0_h = light_t0.cpu().numpy()[valid]
                light_dat['segment_id'] = segment_ids[:, None]
                light_dat['n_photons_det'] = light_inc_h
                light_dat['t0_det'] = light_t0_h
            op_channel_tpc = light_ops.host_array(light.op_channel_to_tpc)
            home_ctx = dataclasses.replace(
                home_ctx, light=light_h, lut=lut, light_noise=light_noise,
                light_inc=light_inc, light_t0=light_t0, light_vox=light_vox)
            print(f'Light incidence: {time.time() - t0:.2f} s')
        del segs_all

        # ---- dispatch contexts (JAX cli:482-519) ----
        # one copy of the module's tensors per card, shared by the
        # contexts on it; with several contexts, or one with ``pipeline``,
        # each has its own stream and thread, and waits for the set-up's
        # work before its first group
        if len(mod_devices) == 1 and not pipeline:
            ctxs = [home_ctx]
        else:
            with trace.phase('cli/detector'):
                copies = {home: home_ctx}
                ctxs = []
                for k, d in enumerate(mod_devices):
                    if d not in copies:
                        copies[d] = dataclasses.replace(home_ctx, device=d, **{
                            f.name: to_device(getattr(home_ctx, f.name), d)
                            for f in dataclasses.fields(_Context)
                            if f.name not in ('device', 'stream', 'pool')})
                    ctxs.append(dataclasses.replace(
                        copies[d],
                        stream=dispatch_stream(d, ('context', i_mod, k)),
                        pool=ThreadPoolExecutor(
                            1, thread_name_prefix=f'module-{i_mod}-ctx{k}'
                            if i_mod > 0 else f'dispatch-ctx{k}')))
                for d in copies:
                    if d.type == 'cuda':
                        torch.cuda.current_stream(d).synchronize()

        # ---- batching loop ----
        results_acc = defaultdict(list)
        clock_period = det.clock_reset_period * det.clock_cycle
        sync_start = (event_times[0] // clock_period * clock_period
                      + clock_period)
        light_done_events: set = set()
        i_light_trig = 0  # the module's light-trigger counter (cli:446)
        # the host route's workers; records of every route are written in
        # accumulate order through the FIFO of (future, event, first
        # trigger, group)
        truth_executor = ThreadPoolExecutor(max(int(truth_workers), 1)) \
            if truth_on and truth_path == 'host' \
            and light.enable_lut_smearing else None
        # a worker's records are written once they are this many groups
        # old (or at the end), so where they land in the file depends on
        # no worker's timing
        truth_lag = max(int(truth_workers), 1) + 1
        pending_truth: deque = deque()
        #: pending work in submission order: ('job', a group's results or
        #: their future) and ('call', a file write); drained in order
        actions: deque = deque()
        #: submitted groups not accumulated yet: group -> [rows, event
        #: slots, unique-pixel bound or None]
        outstanding: dict = {}
        max_in_flight = 2 * len(ctxs)

        def flush_results():
            """Write the accumulated rows (cli:639-724): packets, and the
            light waveforms (mode 0: and their light_trig rows); without
            charge rows, the light rows alone."""
            nonlocal results_acc
            light_only = not results_acc.get('event_pix')
            if light_only and not results_acc.get('light_event_id'):
                results_acc = defaultdict(list)
                return
            res = {k: np.concatenate([_host(x) for x in v], axis=0)
                   for k, v in results_acc.items() if len(v)}
            results_acc = defaultdict(list)
            has_light = len(res.get('light_event_id', []))
            if not light_only:
                uniq_events = np.unique(res['event_pix'])
                uniq_event_times = event_times[uniq_events
                                               % sim.max_events_per_file]
                if has_light:
                    if trig_mode == 1:
                        # beam mode: the trigger type stands in for the
                        # module
                        light_trig_modules = res['trigger_type']
                    else:
                        # each trigger's module, by its first channel's TPC
                        op0 = res['light_op_channel_idx'][:, 0]
                        light_trig_modules = np.array(
                            [det_model.tpc_to_module[t]
                             for t in op_channel_tpc[op0]])
                    light_trigger_times = (res['light_start_time']
                                           + res['light_trigger_idx']
                                           * light.light_tick_size)
                    light_trigger_event_ids = res['light_event_id']
                else:
                    light_trig_modules = np.ones(len(uniq_events))
                    light_trigger_times = np.zeros_like(uniq_event_times)
                    light_trigger_event_ids = uniq_events
                gate.submit(functools.partial(
                    export.export_to_hdf5,
                    res['event_pix'], res['hit_row'], res['hit_adc'],
                    res['hit_ticks'], res['hit_frac'], res['unique_pix'],
                    res['track_pixel_map'], res['traj_pixel_map'],
                    out, uniq_event_times, det_model, trig_mode, sim,
                    light_trigger_times=light_trigger_times,
                    light_trigger_event_id=light_trigger_event_ids,
                    light_trigger_modules=light_trig_modules,
                    bad_channels=bad_channels, i_mod=i_mod))
            if has_light:
                if trig_mode == 0:
                    # the event times of the light rows' own events (a
                    # flush can hold light rows of events without charge
                    # rows)
                    uniq_l = np.unique(res['light_event_id'])
                    gate.submit(functools.partial(
                        write_light, export.export_light_trig_to_hdf5,
                        res['light_event_id'], res['light_start_time'],
                        res['light_trigger_idx'],
                        res['light_op_channel_idx'], out,
                        event_times[uniq_l % sim.max_events_per_file],
                        det_model, light))
                gate.submit(functools.partial(
                    write_light, export.export_light_wvfm_to_hdf5,
                    res['light_event_id'], res['light_waveforms'], out, sim,
                    light, i_mod=i_mod))

        def write_light(export_fn, *args, **kw):
            with trace.phase('export/light'):
                export_fn(*args, **kw)

        def write_truth(truth):
            with trace.phase('truth/h5'):
                export.export_light_truth_to_hdf5(out, truth,
                                                  truth_compression)

        def drain_truth(block: bool = False, older_than: int = 0):
            """Write the pending truth records in order: those made on the
            card, and a worker's once its group is ``truth_lag`` groups
            older than group ``older_than`` (all of them with ``block``);
            a worker's error is raised here."""
            while pending_truth:
                fut, ievd_t, trig_t, seq, made = pending_truth[0]
                if not (block or made or seq <= older_than - truth_lag):
                    break
                pending_truth.popleft()
                truth = fut.result()
                with trace.phase('truth/records'):
                    if isinstance(truth, dict):
                        truth = export.truth_sparse_to_records(
                            truth, ievd_t, trig_t)
                    else:   # a worker's records, trigger ids counted from 0
                        truth['trigger_id'] += trig_t
                trace.tally('truth/records', len(truth))
                gate.submit(functools.partial(write_truth, truth))

        def accumulate_light(ievd_l, lres, seq):
            """One light batch's rows (cli:761-799); its truth records are
            queued behind those of earlier batches."""
            nonlocal i_light_trig
            drain_truth(older_than=seq)
            ntrig = lres.trigger_idx.shape[0]
            if not ntrig:
                return
            results_acc['light_event_id'].append(np.full(ntrig, ievd_l))
            results_acc['light_start_time'].append(np.full(
                ntrig, lres.start_time))
            results_acc['light_trigger_idx'].append(lres.trigger_idx)
            results_acc['trigger_type'].append(lres.trigger_type)
            results_acc['light_op_channel_idx'].append(lres.op_channel_idx)
            results_acc['light_waveforms'].append(lres.waveforms)
            fut = lres.truth_future
            made = lres.truth_sparse is not None
            if made:
                fut = Future()
                fut.set_result(lres.truth_sparse)
            if fut is not None:
                trace.tally('truth/triggers', ntrig)
                pending_truth.append((fut, int(ievd_l), i_light_trig, seq,
                                      made))
            i_light_trig += ntrig

        def light_rows(ctx, sels, pad):
            """The incidence, first arrivals and voxels of each batch's
            segments, (G, pad, C), (G, pad, C) and (G, pad, 3), zero past
            each batch's length."""
            inc = ctx.light_inc.new_zeros((len(sels), pad,
                                           ctx.light_inc.shape[1]))
            t0 = ctx.light_t0.new_zeros((len(sels), pad,
                                         ctx.light_t0.shape[1]))
            vox = ctx.light_vox.new_zeros((len(sels), pad, 3))
            for g, sel in enumerate(sels):
                # nothing waits for the upload
                rows = light_ops.upload(sel, ctx.device)
                inc[g, :len(sel)] = ctx.light_inc[rows]
                t0[g, :len(sel)] = ctx.light_t0[rows]
                vox[g, :len(sel)] = ctx.light_vox[rows]
            return inc, t0, vox

        def mode0_window(sel):
            """Mode 0's (n_ticks, start_time) of a batch, from the host
            copies of its incidence."""
            return light_model.mode0_window(light_inc_h[sel],
                                            light_t0_h[sel], light)

        def light_batch(ctx, ievd, sel, i_sub, window, segs=None):
            if segs is None:
                segs = from_structured(tracks_mod[sel],
                                       pad_to=bucket(len(sel), lo=32),
                                       device=ctx.device)
            with trace.phase('light/incidence', ctx.device):
                inc, t0, vox = light_rows(ctx, [sel], segs.size)
            mode0 = dict(t0_det=t0[0],
                         module_to_tpcs=det_model.module_to_tpcs,
                         sim_window=window) \
                if trig_mode == 0 else {}
            return light_model.simulate_light_batch(
                segs, ctx.light, sim, inc[0], vox[0], ctx.lut,
                ctx.light_noise,
                light_draw(rand_seed, i_mod, ievd, i_sub, ctx.device),
                i_subbatch=i_sub, truth_path=truth_path,
                truth_executor=truth_executor, event_id=int(ievd),
                op_channel=op_channel, **mode0)

        def light_group(ctx, firsts, windows):
            """Two or more events' first batches as one group call, each
            with its own draws."""
            sels = [sel for _, sel in firsts]
            pad = bucket(max(len(sel) for sel in sels), lo=32)
            with trace.phase('light/incidence', ctx.device):
                inc, _, vox = light_rows(ctx, sels, pad)
            args = (from_structured_group([tracks_mod[sel] for sel in sels],
                                          pad, device=ctx.device),
                    ctx.light, sim, inc, vox, ctx.lut, ctx.light_noise,
                    [light_draw(rand_seed, i_mod, ievd, 0, ctx.device)
                     for ievd, _ in firsts])
            kw = dict(truth_path=truth_path, truth_executor=truth_executor,
                      event_ids=[int(ievd) for ievd, _ in firsts],
                      op_channel=op_channel)
            if trig_mode == 0:
                return light_model.simulate_light_group_mode0(
                    *args, windows=windows,
                    module_to_tpcs=det_model.module_to_tpcs, **kw)
            return light_model.simulate_light_group(*args, **kw)

        def light_plan(items):
            """The light calls of a group's batches (cli:1033-1054,
            :866-917), planned in batch order at submission: an event's
            first batch runs with i_subbatch 0, a later one alone with
            i_subbatch 1 (in beam mode it adds nothing; in mode 0 it
            triggers as any batch).  Two or more first batches run as one
            group call (mode 0: one per window bucket, a bucket of one
            alone).  Returns the calls, (batch indices, i_subbatch), and
            mode 0's window of each batch."""
            firsts, later = [], []
            for i, (ievd, sel) in enumerate(items):
                (later if ievd in light_done_events else firsts).append(i)
                light_done_events.add(ievd)
            windows = {i: mode0_window(sel) for i, (_, sel)
                       in enumerate(items)} if trig_mode == 0 else {}
            buckets = defaultdict(list)
            for i in firsts:
                buckets[windows[i][0] if trig_mode == 0 else 0].append(i)
            return ([(group_i, 0) for group_i in buckets.values()]
                    + [([i], 1) for i in later]), windows

        def run_light(ctx, items, plan, segs):
            """A group's light calls on ``ctx``; ``segs``: the charge
            call's segments when it holds one batch."""
            calls, windows = plan
            lres = {}
            with trace.phase('light_batch', ctx.device):
                for group_i, i_sub in calls:
                    if len(group_i) > 1:
                        lres.update(zip(group_i, light_group(
                            ctx, [items[i] for i in group_i],
                            [windows.get(i) for i in group_i])))
                    else:
                        i = group_i[0]
                        lres[i] = light_batch(ctx, *items[i], i_sub,
                                              windows.get(i), segs)
            return lres

        def compute_group(items, seq, plan, ctx):
            """A group's charge call, with its light, on ``ctx`` (on its
            thread and stream where it has them); its results go to the
            host here."""
            with ctx.scope():
                with trace.phase('cli/segments'):
                    sels = [sel for _, sel in items]
                    cat = np.concatenate(sels)
                    selected = tracks_mod[cat]
                    segs = from_structured(selected,
                                           pad_to=bucket(len(cat), lo=32),
                                           device=ctx.device)
                    slot = None
                    if len(items) > 1:
                        slot = np.zeros(segs.size, np.int32)
                        slot[:len(cat)] = np.repeat(
                            np.arange(len(items)), [len(sel) for sel in sels])
                    gen = batch_generator(rand_seed, i_mod, items[0][0], seq,
                                          ctx.device)
                lres = run_light(ctx, items, plan,
                                 segs if len(items) == 1 else None) \
                    if plan is not None else {}
                with trace.phase('charge_batch', ctx.device):
                    res = simulate_charge_batch(
                        segs, ctx.det_model, sim,
                        generator_draw(gen, ctx.device), ctx.response,
                        pixel_thresholds=thresholds_lut,
                        pixel_gains=gains_lut, already_drifted=True,
                        step_scale=step_scale, host_segs=selected,
                        event_slot=slot)
                if lres:
                    with trace.phase('light/pull', ctx.device):
                        for r in lres.values():
                            r.waveforms = _host(r.waveforms)
            return seq, items, cat, lres, res

        def accumulate_charge(items, cat, res):
            """One charge call's rows (cli:953-998): events and pixels
            decoded from the keys, batch-local track indices made global
            ids."""
            nonlocal uniq_ratio
            uniq_ratio = max(uniq_ratio, res.n_unique / len(cat))
            uniq = res.unique_pix
            valid_u = uniq >= 0
            events = np.array([ievd for ievd, _ in items], dtype=np.int64)
            if len(items) > 1:
                event_u = events[np.where(valid_u, uniq // n_pix_total, 0)]
                pid_u = np.where(valid_u, uniq % n_pix_total, -1)
            else:
                event_u = np.full(len(uniq), events[0])
                pid_u = uniq
            tmap = res.track_pixel_map
            tmap_seg = np.where(tmap >= 0,
                                segment_ids[cat][np.clip(tmap, 0, None)], -1)
            tmap_trj = np.where(tmap >= 0,
                                traj_ids[cat][np.clip(tmap, 0, None)], -1)
            row_offset = sum(len(x) for x in results_acc['unique_pix'])
            new_row = np.cumsum(valid_u) - 1
            keep_h = valid_u[res.hit_row]
            results_acc['event_pix'].append(event_u[valid_u])
            results_acc['unique_pix'].append(pid_u[valid_u])
            results_acc['track_pixel_map'].append(tmap_seg[valid_u])
            results_acc['traj_pixel_map'].append(tmap_trj[valid_u])
            results_acc['hit_row'].append(
                new_row[res.hit_row[keep_h]] + row_offset)
            results_acc['hit_adc'].append(res.hit_adc[keep_h])
            results_acc['hit_ticks'].append(res.hit_ticks[keep_h])
            results_acc['hit_frac'].append(res.hit_fractions[keep_h])
            if len(results_acc['event_pix']) >= sim.write_batch_size:
                with trace.phase('export'):
                    flush_results()

        def accumulate_group(payload):
            """A group's rows, light first, in batch order."""
            seq, items, cat, lres, res = payload
            del outstanding[seq]
            with trace.phase('cli/accumulate'):
                for i, (ievd, _) in enumerate(items):
                    if i in lres:
                        accumulate_light(ievd, lres[i], seq)
                if res.overflow:
                    warnings.warn('More segments per pixel than '
                                  'MAX_TRACKS_PER_PIXEL '
                                  f'({sim.max_tracks_per_pixel}); '
                                  'backtracking may be incomplete')
                accumulate_charge(items, cat, res)

        def drain_actions(block: bool = False):
            """Run the pending work in submission order (JAX cli:1005-1022):
            a group's accumulation waits for its context only with
            ``block`` or when more than ``max_in_flight`` groups are out."""
            while actions:
                kind, item = actions[0]
                if kind == 'job' and isinstance(item, Future) \
                        and not item.done() and not block \
                        and len(outstanding) <= max_in_flight:
                    break
                actions.popleft()
                if kind == 'call':
                    item()
                else:
                    accumulate_group(item.result()
                                     if isinstance(item, Future) else item)

        def process_group():
            """Submit the buffered batches as one charge call, with their
            light (JAX cli:1024-1065): planned here, computed inline with
            one context, else on the next context's thread."""
            nonlocal group_seq
            if not group:
                return
            group_seq += 1
            items = list(group)
            group.clear()
            plan = light_plan(items) if light.light_simulated else None
            slot = None
            if len(items) > 1:
                slot = np.repeat(np.arange(len(items)),
                                 [len(sel) for _, sel in items])
            outstanding[group_seq] = [
                np.concatenate([sel for _, sel in items]), slot, None]
            ctx = ctxs[(group_seq - 1) % len(ctxs)]
            if ctx.pool is None:
                actions.append(('job', compute_group(items, group_seq, plan,
                                                     ctx)))
            else:
                actions.append(('job', ctx.pool.submit(
                    compute_group, items, group_seq, plan, ctx)))
            drain_actions()

        def guard_closes(would: int) -> bool:
            """Whether the unique-pixel guard closes the group before a
            batch that would bring it to ``would`` segments, at the largest
            ratio of every earlier group, as with one context.  The ratio
            is a running maximum: a close the accumulated groups decide
            stands; otherwise the outstanding groups are waited for only
            when their bound could close it."""
            if not unique_guard:
                return False
            if uniq_ratio and would * uniq_ratio > unique_guard:
                return True
            bound = 0.0
            for entry in outstanding.values():
                if entry[2] is None:
                    entry[2] = unique_pixel_bound(tracks_mod[entry[0]],
                                                  entry[1], det_model) \
                        / len(entry[0])
                bound = max(bound, entry[2])
            if would * bound > unique_guard:
                drain_actions(block=True)
            return bool(uniq_ratio) and would * uniq_ratio > unique_guard

        def write_sync(times):
            def write():
                with trace.phase('export/sync'):
                    export.export_sync_to_hdf5(
                        out, np.full(times.shape, clock_period), det_model,
                        sim, i_mod)
            gate.submit(write)

        def write_timestamp(t_event):
            def write():
                with trace.phase('export/timestamp'):
                    export.export_timestamp_trigger_to_hdf5(
                        out, [t_event], det_model, trig_mode, sim, i_mod)
            gate.submit(write)

        def empty_batch(ievd):
            """An empty batch's zero waveform row, float64, for its event
            (cli:1103-1132), flushed with the rows before it."""
            if light.light_simulated:
                results_acc['light_event_id'].append(np.full(1, ievd))
                results_acc['light_start_time'].append(np.zeros(1))
                results_acc['light_trigger_idx'].append(np.zeros(1, int))
                results_acc['trigger_type'].append(
                    np.full(1, light.light_trig_mode))
                results_acc['light_op_channel_idx'].append(
                    op_channel_sim[None, :])
                results_acc['light_waveforms'].append(
                    np.zeros((1, len(op_channel_sim),
                              light_model.digit_samples(light))))
                flush_results()

        with trace.phase('cli/batching'):
            batcher = TPCBatcher(all_mod_tracks, tracks_mod,
                                 sim.event_separator,
                                 tpc_batch_size=sim.event_batch_size,
                                 tpc_borders=module_borders)

        # the module's pixel key space: its own layout's pixels
        nx, ny = det.n_pixels
        n_pix_total = nx * ny * det.n_tpcs
        group_cap = max(int(event_group_size), 1)
        if n_pix_total * (group_cap + 1) >= 2 ** 31:
            warnings.warn('event_group_size reduced to 1: pixel keys would '
                          'overflow int32 for this geometry')
            group_cap = 1
        group: list = []       # buffered (event, segment rows) of one call
        group_seq = 0          # calls so far: each one's draws of its own
        uniq_ratio = 0.0       # the largest unique pixels per segment so far

        try:
            event_id_buffer = -1
            steps = iter(batcher)
            for _ in range(len(batcher)):
                # a batch: its (event, TPC group) mask over the module
                with trace.phase('cli/batching'):
                    ievd, batch_mask = next(steps)
                    idx = np.nonzero(batch_mask)[0]
                this_event_time = event_times[int(ievd)
                                              % sim.max_events_per_file]
                if ievd > event_id_buffer:
                    # queued, so that they land in the file at the same
                    # place for any number of contexts (cli:1071-1101)
                    event_id_buffer = ievd
                    if this_event_time - sync_start >= 0:
                        sync_times = np.arange(sync_start,
                                               this_event_time + 1,
                                               clock_period)
                        if len(sync_times):
                            actions.append(('call', functools.partial(
                                write_sync, sync_times)))
                            sync_start = sync_times[-1] + clock_period
                    if i_mod == trig_module or i_mod == -1:
                        actions.append(('call', functools.partial(
                            write_timestamp, this_event_time)))
                if len(idx) == 0:
                    process_group()
                    actions.append(('call', functools.partial(empty_batch,
                                                              ievd)))
                    drain_actions()
                    continue
                if len(idx) > sim.batch_size:
                    # an oversized batch: the pending group first, then its
                    # sub-batches, each a call of its own (cli:1136-1147)
                    process_group()
                    warnings.warn('Entered sub-batch loop; consider '
                                  'increasing batch_size (currently '
                                  f'{sim.batch_size})')
                    for i0 in range(0, len(idx), sim.batch_size):
                        group.append((ievd, idx[i0:i0 + sim.batch_size]))
                        process_group()
                else:
                    # the group is capped by its segments too: one call
                    # holds an (S, P, T) signals tensor (cli:1149-1160)
                    would = sum(len(sel) for _, sel in group) + len(idx)
                    if group and (would > sim.batch_size
                                  or guard_closes(would)):
                        process_group()
                    group.append((ievd, idx))
                    if len(group) >= group_cap:
                        process_group()
                drain_actions()
                memlog.take_snapshot()
            process_group()
            drain_actions(block=True)
        finally:
            for ctx in ctxs:
                if ctx.pool is not None:
                    ctx.pool.shutdown(cancel_futures=True)
                if ctx.stream is not None:
                    ctx.stream.synchronize()
        with trace.phase('export/flush'):
            flush_results()
        if truth_on:
            with trace.phase('truth/drain'):
                drain_truth(block=True)
        if truth_executor is not None:
            truth_executor.shutdown()
        memlog.archive(f'loop_mod{i_mod}')
        return tracks_mod, light_dat, det_model

    # ---------------- module loop (cli:1197-1251) ----------------
    mod_ids = mod_ids_all if mod2mod_variation else [-1]
    if mod2mod_variation and len(devices) > 1 and len(mod_ids) > 1:
        # each module on a thread and stream of its own over its share of
        # the contexts; a module's writes wait for the earlier modules'
        # (the gates open in module order as the threads end)
        n_mod = len(mod_ids)
        dev_lists = module_devices(devices, n_mod)
        gates = [_WriteGate(open_now=p == 0) for p in range(n_mod)]
        runs: list = [None] * n_mod
        errors: list = [None] * n_mod
        for d in set(devices):
            if d.type == 'cuda':
                torch.cuda.synchronize(d)

        def runner(pos, i_mod):
            try:
                home = dev_lists[pos][0]
                with card_scope(home, dispatch_stream(home, ('module', pos))):
                    runs[pos] = run_module(i_mod, dev_lists[pos],
                                           gates[pos])
                    if home.type == 'cuda':
                        torch.cuda.current_stream(home).synchronize()
            except BaseException as exc:   # raised after the joins
                errors[pos] = exc

        threads = [threading.Thread(target=runner, args=(p, m),
                                    name=f'module-{m}')
                   for p, m in enumerate(mod_ids)]
        for t in threads:
            t.start()
        for pos, t in enumerate(threads):
            t.join()
            if pos + 1 < n_mod:
                try:
                    gates[pos + 1].open()
                except BaseException as exc:
                    errors[pos + 1] = errors[pos + 1] or exc
        first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
    else:
        gate = _WriteGate(open_now=True)
        runs = [run_module(i_mod, devices, gate) for i_mod in mod_ids]
    segments_to_files = (runs[0][0] if len(runs) == 1
                         else np.concatenate([r[0] for r in runs]))
    # the last module's model for the run's own exports (cli:1263)
    det_model = runs[-1][2]

    # ---------------- truth + final exports ----------------
    with trace.phase('export/final'):
        if sim.is_spill_sim:
            local_spill = edep.local_spill_ids(segments_to_files,
                                               sim.event_separator,
                                               sim.max_events_per_file)
            for fld in ('t0_start', 't0_end', 't0'):
                if fld in segments_to_files.dtype.names:
                    segments_to_files[fld] = (segments_to_files[fld]
                                              + local_spill * sim.spill_period)
        if light.light_simulated and trig_mode == 1:
            # one beam trigger row per event, every channel (cli:1264-1275);
            # mode 0 wrote its rows per flush
            if sim.is_spill_sim:
                light_event_id = np.unique(local_spill)
            elif vertices is not None:
                light_event_id = vertices['event_id']
            else:
                light_event_id = np.unique(
                    segments_to_files[sim.event_separator])
            light_event_times = (light_event_id * sim.spill_period
                                 if sim.is_spill_sim else event_times)
            with trace.phase('export/light'):
                export.export_light_trig_to_hdf5(
                    light_event_id, np.zeros(len(light_event_id)),
                    np.zeros(len(light_event_id), int),
                    light_ops.host_array(light.tpc_to_op_channel).ravel(),
                    out, light_event_times, det_model, light)
        if light.light_simulated and mod2mod_variation:
            with trace.phase('export/light_merge'):
                export.merge_module_light_wvfm_same_trigger(out, det_model)
        swap_coordinates(segments_to_files)
        out.create_dataset(sim.tracks_dset_name, data=segments_to_files)
        out[sim.tracks_dset_name].attrs['zbeam'] = True
        if light.light_simulated:
            if mod2mod_variation:
                for (_, light_dat, _), i_mod in zip(runs, det_model.mod_ids):
                    out.create_dataset(
                        f'light_dat/light_dat_module{i_mod - 1}',
                        data=light_dat)
            else:
                out.create_dataset('light_dat/light_dat_allmodules',
                                   data=runs[0][1])
        for name, data in (('trajectories', inp.trajectories),
                           ('vertices', vertices), ('mc_hdr', mc_hdr),
                           ('mc_stack', mc_stack)):
            if data is not None:
                out.create_dataset(name, data=data)
        if 'configs' in out:
            out['configs'].attrs['pixel_layout'] = str(pixel_layout)
        out.close()
    memlog.store(save_memory)
    print(f'Output saved in: {output_filename}')
    print(f'Elapsed time: {time.time() - t_sim0:.2f} s')
    rep = trace.report()
    if rep:
        print('Phase breakdown:')
        print(rep)


def main(argv=None):
    import argparse
    import inspect

    import yaml

    def _bool(v):
        return str(v).lower() in ('1', 'true', 'yes', 'on')

    def _file_or_list(v):
        """A file, or a YAML list of files or ids ('[a.yaml, b.yaml]')."""
        return yaml.safe_load(v) if v.lstrip().startswith('[') else v

    parser = argparse.ArgumentParser(description=run_simulation.__doc__)
    for name, p in inspect.signature(run_simulation).parameters.items():
        if p.default is inspect.Parameter.empty:
            parser.add_argument(name)
            continue
        ann = str(p.annotation)
        typ = (_bool if 'bool' in ann else int if 'int' in ann
               else float if 'float' in ann else str if ann.startswith('str')
               else _file_or_list)
        parser.add_argument(f'--{name}', type=typ, default=p.default)
    run_simulation(**vars(parser.parse_args(argv)))


if __name__ == '__main__':
    main()
