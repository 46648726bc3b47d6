"""The charge step on a ('modules', 'events') grid of devices.

Counterpart of the JAX package's multi-chip testbed (``larndsim_tpu.
parallel.mesh``: ``make_mesh``, ``stack_module_params``,
``make_sharded_charge_step`` and ``shard_segments``, mesh.py:41-106,
:258-270).  It is not the production multi-device path: that is the CLI's
dispatch contexts (``cli.simulate_pixels``, ``n_devices``), which keep each
module's own shapes.  Here every cell of the grid holds one module's
parameters (its row) and one share of the events (its column), and runs
``models.charge.charge_step`` on its device, on a thread and CUDA stream
of its own; the cells' hit counts are summed over the grid, where the JAX
step takes a ``psum`` over the mesh.  Modules are independent and events
too, so the physics needs no other exchange.
"""
from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import charge as charge_model
from ..params.detector import LEAVES, STATICS, DetectorParams
from ..segments import from_structured
from .devices import card_scope, dispatch_stream


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
        cells = mesh.cells()
        # the cells' streams read what the caller's streams made
        for d in {d for _, _, d in cells if d.type == 'cuda'}:
            torch.cuda.current_stream(d).synchronize()
        with ThreadPoolExecutor(len(cells)) as pool:
            outs = list(pool.map(lambda c: cell(*c, segs_grid[c[0]][c[1]],
                                                draws[c[0]][c[1]]), cells))
        grid = lambda i: [[outs[m * mesh.shape['events'] + e][i]
                           for e in range(mesh.shape['events'])]
                          for m in range(mesh.shape['modules'])]
        return grid(0), grid(1), grid(2), sum(o[3] for o in outs)

    return run
