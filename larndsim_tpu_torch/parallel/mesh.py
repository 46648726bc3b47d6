"""The charge and light steps on a ('modules', 'events') grid of devices.

Counterpart of the JAX package's multi-chip testbed (``larndsim_tpu.
parallel.mesh``: ``make_mesh``, ``stack_module_params``,
``make_sharded_charge_step``, ``make_sharded_sim_step`` and
``shard_segments``, mesh.py:41-270).  It is not the production
multi-device path: that is the CLI's dispatch contexts
(``cli.simulate_pixels``, ``n_devices``), which keep each module's own
shapes.  Here every cell of the grid holds one module's parameters (its
row) and one share of the events (its column), and runs
``models.charge.charge_step`` (and, in the sim step, the light chain after
it) on its device, on a thread and CUDA stream of its own; the cells' hit
counts are summed over the grid, where the JAX step takes a ``psum`` over
the mesh.  Modules are independent and events too, so the physics needs no
other exchange.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import charge as charge_model
from ..models import light as light_model
from ..ops import light as light_ops
from ..params.detector import LEAVES, STATICS, DetectorParams
from ..segments import from_structured
from .devices import card_scope, dispatch_stream, to_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices in a ('modules', 'events') grid: ``devices[m][e]``."""
    devices: tuple
    axis_names: tuple = ('modules', 'events')

    @property
    def shape(self) -> dict:
        return {'modules': len(self.devices),
                'events': len(self.devices[0])}

    def cells(self):
        """(module row, event column, device) of every cell."""
        return [(m, e, d) for m, row in enumerate(self.devices)
                for e, d in enumerate(row)]


def make_mesh(n_devices: int | None = None, n_modules: int = 1,
              devices=None) -> Mesh:
    """A ('modules', 'events') grid over ``devices`` (the visible cards by
    default; repeats allowed), the first ``n_devices`` of them: as many
    module rows as the largest divisor of the device count that is at
    most ``n_modules``."""
    if devices is None:
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if not n:
        raise ValueError('a mesh needs at least one device')
    n_mod = max(d for d in range(1, n_modules + 1) if n % d == 0)
    n_ev = n // n_mod
    return Mesh(tuple(tuple(devices[m * n_ev:(m + 1) * n_ev])
                      for m in range(n_mod)))


def stack_module_params(params_list: list) -> DetectorParams:
    """Per-module ``DetectorParams`` stacked along a new leading axis (the
    module variation as one parameter set); their shapes (statics) must
    agree."""
    first = params_list[0]
    for p in params_list[1:]:
        diff = [k for k in STATICS if getattr(p, k) != getattr(first, k)]
        if diff:
            raise ValueError(f'modules differ in {diff}: they cannot share '
                             'one step')
    tens = {k: torch.stack([getattr(p, k).to(first.device)
                            for p in params_list]) for k in LEAVES}
    host = {k: np.stack([np.asarray(p.host[k]) for p in params_list])
            for k in first.host}
    return dataclasses.replace(first, host=host, **tens)


def module_params(det_stack: DetectorParams, m: int,
                  device) -> DetectorParams:
    """Row ``m`` of stacked params, on ``device``."""
    host = {k: (v[m] if np.ndim(v[m]) else float(v[m]))
            for k, v in det_stack.host.items()}
    return dataclasses.replace(det_stack, host=host, **{
        k: getattr(det_stack, k)[m].to(device) for k in LEAVES})


def shard_segments(segs_np_list: list, mesh: Mesh,
                   pad_to: int) -> list:
    """One structured segment array per cell, in row-major cell order, as
    ``Segments`` of ``pad_to`` rows on each cell's device: a grid
    ``[m][e]``."""
    cells = mesh.cells()
    if len(segs_np_list) != len(cells):
        raise ValueError(f'{len(segs_np_list)} segment arrays for '
                         f'{len(cells)} cells')
    grid = [[None] * mesh.shape['events'] for _ in range(mesh.shape[
        'modules'])]
    for (m, e, d), seg in zip(cells, segs_np_list):
        grid[m][e] = from_structured(seg, pad_to=pad_to, device=d)
    return grid


def make_sharded_charge_step(mesh: Mesh, det_stack: DetectorParams,
                             response: torch.Tensor, *, max_active: int,
                             radius: int, max_nb: int, t_sig: int,
                             n_steps: int, n_unique_cap: int, max_adc: int,
                             max_tracks: int, shift_band: tuple[int, int],
                             min_step: float = 0.001):
    """The charge step of every cell: module row m's params (a row of
    ``det_stack``, :func:`stack_module_params`) and the response on each
    cell's device, once.

    Returns a function ``(segs_grid, draws) -> (adc, uniq, fractions,
    n_hits_total)``: ``segs_grid`` from :func:`shard_segments`, ``draws``
    a grid of ``models.charge.Draw``; ``adc``, ``uniq`` and ``fractions``
    grids of each cell's tensors, ``n_hits_total`` the pixels with a hit,
    summed over the grid.
    """
    step = functools.partial(
        charge_model.charge_step, max_active=max_active, radius=radius,
        max_nb=max_nb, t_sig=t_sig, n_steps=n_steps,
        n_unique_cap=n_unique_cap, max_adc=max_adc, max_tracks=max_tracks,
        shift_band=shift_band, min_step=min_step)
    params = {(m, e): (module_params(det_stack, m, d), response.to(d))
              for m, e, d in mesh.cells()}

    def cell(m, e, d, segs, draw):
        with card_scope(d, dispatch_stream(d, ('cell', m, e))):
            det, resp = params[m, e]
            uniq, _, adc, fee_res, fractions, _, _ = step(segs, det, resp,
                                                          draw)
            hits = int((fee_res.n_adc > 0).sum())
            if d.type == 'cuda':
                torch.cuda.current_stream(d).synchronize()
        return adc, uniq, fractions, hits

    def run(segs_grid, draws):
        outs = _run_cells(mesh, lambda m, e, d: cell(
            m, e, d, segs_grid[m][e], draws[m][e]))
        grid = lambda i: [[o[i] for o in row] for row in outs]
        return grid(0), grid(1), grid(2), sum(o[3] for row in outs
                                              for o in row)

    return run


def _run_cells(mesh: Mesh, fn) -> list:
    """``fn(m, e, device)`` of every cell, each on a thread of its own
    (named ``cell-{m}-{e}`` while it runs the cell), after the caller's
    streams have made the inputs; a grid ``[m][e]`` of the results."""
    cells = mesh.cells()
    for d in {d for _, _, d in cells if d.type == 'cuda'}:
        torch.cuda.current_stream(d).synchronize()

    def named(m, e, d):
        threading.current_thread().name = f'cell-{m}-{e}'
        return fn(m, e, d)
    with ThreadPoolExecutor(len(cells)) as pool:
        outs = list(pool.map(lambda c: named(*c), cells))
    n_ev = mesh.shape['events']
    return [outs[m * n_ev:(m + 1) * n_ev] for m in range(mesh.shape[
        'modules'])]


def sim_cell(segs, det: DetectorParams, response: torch.Tensor, light,
             op_channel: torch.Tensor, luts, noise_rows, draws, *,
             charge: dict, n_ticks: int, conv_ticks: int, digit_samples: int,
             pad_front: int, pad_back: int, add_noise: bool = False,
             k_truth: int = 0, trig_mode: int = 1, max_trig: int = 4,
             group_threshold: torch.Tensor | None = None) -> dict:
    """The simulation step of one cell (JAX mesh.py:165-228), every input
    on its device: ``charge`` the keyword arguments of
    ``models.charge.charge_step``; ``luts`` the module's (vis, t0,
    time_dist, t0_avg); ``noise_rows`` its (C, n_bins) noise spectra;
    ``draws`` (charge ``Draw``, ``LightDraw``).  The arguments after
    ``charge`` as those of :func:`make_sharded_sim_step`.  Returns the
    cell's ``adc``, ``waveforms``, ``trigger_idx``, ``n_triggers``,
    ``truth_ids``, ``truth_contrib`` and ``hits`` (its pixels with a hit,
    read on the host)."""
    charge_draw, light_draw = draws
    dev = segs.x.device
    vis, t0, time_dist, t0_avg = luts
    C = len(op_channel)
    _, _, adc, fee_res, _, _, _ = charge_model.charge_step(
        segs, det, response, charge_draw, **charge)
    n_det, _, vox = light_ops.calculate_light_incidence(
        segs, det, light, vis, t0, n_channels=C)
    sig = light_model._signal_stage(
        segs, vox, n_det, op_channel, time_dist, t0_avg, 0.0,
        light.light_gain[op_channel.long()], light_draw, light,
        n_ticks=n_ticks, conv_ticks=conv_ticks,
        lut_smearing=light.enable_lut_smearing)
    if trig_mode == 0:
        above = light_ops.group_above_threshold(
            sig, group_threshold, per_trig=light.op_channel_per_trig,
            sample_factor=light_ops.sample_factor(light))
        idx, counts = light_ops.dead_time_trigger_scan(
            above.any(0, keepdim=True),
            digit_ticks=light_ops.digit_ticks(light), max_trig=max_trig)
        trig_idx, n_trig = idx[0], counts[0]
    else:
        # the beam trigger at tick 0, the other slots empty
        trig_idx = torch.full((max_trig,), -1, dtype=torch.int32,
                              device=dev)
        trig_idx[0] = 0
        n_trig = torch.tensor(1, dtype=torch.int32, device=dev)
    signal = torch.nn.functional.pad(sig, (pad_front, pad_back))
    if add_noise:
        signal = signal + light_ops.gen_light_detector_noise(
            tuple(signal.shape), noise_rows, light_draw, light)
    wv = light_ops.digitize_signal(
        signal, torch.clamp(trig_idx, min=0) + pad_front, light,
        digit_samples=digit_samples)
    wv = wv * (trig_idx >= 0).to(wv.dtype)[:, None, None]
    if k_truth > 0:
        truth_ids, truth_contrib, _, _ = light_ops.light_truth_select(
            segs, vox, n_det, k_truth=k_truth)
    else:
        truth_ids = torch.full((C, 1), -1, dtype=torch.int32, device=dev)
        truth_contrib = torch.zeros((C, 1), device=dev)
    return dict(adc=adc, waveforms=wv, trigger_idx=trig_idx,
                n_triggers=n_trig, truth_ids=truth_ids,
                truth_contrib=truth_contrib,
                hits=int((fee_res.n_adc > 0).sum()))


def make_sharded_sim_step(mesh: Mesh, light, op_channel, *, max_active: int,
                          radius: int, max_nb: int, t_sig: int, n_steps: int,
                          n_unique_cap: int, max_adc: int, max_tracks: int,
                          shift_band: tuple[int, int], n_ticks: int,
                          conv_ticks: int, digit_samples: int, pad_front: int,
                          pad_back: int, min_step: float = 0.001,
                          add_noise: bool = False, k_truth: int = 0,
                          trig_mode: int = 1, max_trig: int = 4,
                          group_threshold=None):
    """The whole simulation step of every cell (JAX mesh.py:108-255): the
    charge chain (``models.charge.charge_step``), then the light chain on
    the same segments (light incidence, photon series, scintillation,
    Poisson statistics and SiPM response, ``models.light._signal_stage``),
    the trigger, noise, digitization and the top-K truth contributors
    (:func:`sim_cell`).

    ``light`` is a ``LightParams`` and ``op_channel`` the simulated
    channels' ids.  The trigger: ``trig_mode`` 1, the beam's (tick 0, the
    other ``max_trig`` - 1 slots -1); 0, the threshold trigger of one
    module (each group of ``op_channel_per_trig`` channels against its
    ``group_threshold``, any group of the module, then the dead-time walk,
    up to ``max_trig`` triggers).  Each trigger's ``digit_samples`` are read
    from the response padded by ``pad_front`` / ``pad_back`` ticks, with
    noise when ``add_noise``; an invalid trigger's samples are 0.  With
    ``k_truth`` > 0 each channel's ``k_truth`` largest contributors.

    Returns a function ``(segs_grid, det_stack, response, vis, t0,
    time_dist, t0_avg, draws, noise_rows=None) -> dict``: ``segs_grid``
    from :func:`shard_segments`; ``det_stack`` stacked module params
    (:func:`stack_module_params`) and the light LUT arrays with a leading
    module axis, row m for module row m's cells; ``draws`` a grid of (charge
    ``Draw``, ``LightDraw``: its ``uniform`` gives the noise phases);
    ``noise_rows`` (n_modules, C, n_bins) noise spectra (ones of 8 bins
    when None).  The dict holds grids ``[m][e]`` of each cell's ``adc``,
    ``waveforms`` (max_trig, C, digit_samples), ``trigger_idx``
    (max_trig,), ``n_triggers``, ``truth_ids`` and ``truth_contrib`` (C,
    k_truth; (C, 1) of -1 and 0 without truth), and ``n_hits_total``, the
    pixels with a hit summed over the grid.
    """
    if trig_mode == 0:
        if group_threshold is None:
            raise ValueError('the threshold trigger needs the groups\' '
                             'thresholds')
        group_threshold = torch.as_tensor(np.asarray(group_threshold,
                                                     np.float32))
    charge = dict(max_active=max_active, radius=radius, max_nb=max_nb,
                  t_sig=t_sig, n_steps=n_steps, n_unique_cap=n_unique_cap,
                  max_adc=max_adc, max_tracks=max_tracks,
                  shift_band=shift_band, min_step=min_step)
    op_channel = torch.as_tensor(op_channel)
    per_device = {d: (to_device(light, d), op_channel.to(d),
                      None if group_threshold is None
                      else group_threshold.to(d))
                  for _, _, d in mesh.cells()}
    C = len(op_channel)

    def run(segs_grid, det_stack, response, vis, t0, time_dist, t0_avg,
            draws, noise_rows=None):
        if noise_rows is None:
            noise_rows = torch.ones((mesh.shape['modules'], C, 8))

        def one(m, e, d):
            lp, ch, thr = per_device[d]
            with card_scope(d, dispatch_stream(d, ('sim', m, e))):
                out = sim_cell(
                    segs_grid[m][e], module_params(det_stack, m, d),
                    response.to(d), lp, ch,
                    [a[m].to(d) for a in (vis, t0, time_dist, t0_avg)],
                    noise_rows[m].to(d), draws[m][e], charge=charge,
                    n_ticks=n_ticks, conv_ticks=conv_ticks,
                    digit_samples=digit_samples, pad_front=pad_front,
                    pad_back=pad_back, add_noise=add_noise, k_truth=k_truth,
                    trig_mode=trig_mode, max_trig=max_trig,
                    group_threshold=thr)
                if d.type == 'cuda':
                    torch.cuda.current_stream(d).synchronize()
            return out
        outs = _run_cells(mesh, one)
        res = {k: [[o[k] for o in row] for row in outs]
               for k in ('adc', 'waveforms', 'trigger_idx', 'n_triggers',
                         'truth_ids', 'truth_contrib')}
        res['n_hits_total'] = sum(o['hits'] for row in outs for o in row)
        return res

    return run
