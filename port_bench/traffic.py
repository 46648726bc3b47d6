"""The benchmark's one traffic generator: edep-sim input files of beam
spills, from a traffic mix's parameters and ``--seed``.

A mix is a JSON file ``traffic/<name>.json`` of the generator's parameters
(:data:`KEYS`): ``spills_per_file``; ``vertices_per_spill`` neutrino
interactions a spill, each at a point drawn uniformly in the middle 60% of
a TPC drawn uniformly; ``tracks_per_vertex`` straight tracks from it in
isotropic directions, each of at most ``segments_per_track`` segments of
``segment_length_cm`` at ``dEdx_MeV_per_cm``, cut where it leaves its TPC;
the vertex's time drawn in the spill's first 10 us, spills
``spill_period_us`` apart; ``pool_seed`` and ``files``: the files made
before the window, more than its calls use (the calls take them in turn).
Further keys (``why``, ``sources``) describe the mix and are not read.

Every file of a mix holds the same spills, the mix's pool (made from
``pool_seed``), each file in another order drawn from the run's
``--seed``: a seed changes the order of the work, the charge draws and the
comparison's sample, never the work itself, so that runs of other seeds
measure the same thing.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .reference.frozen.assets.make_input import (SEGMENTS_DTYPE,
                                                 TRAJECTORIES_DTYPE,
                                                 VERTICES_DTYPE)
from .reference.frozen.io.h5 import File

HERE = os.path.dirname(os.path.abspath(__file__))
KEYS = ('spills_per_file', 'vertices_per_spill', 'tracks_per_vertex',
        'segments_per_track', 'segment_length_cm', 'dEdx_MeV_per_cm',
        'spill_period_us', 'pool_seed', 'files')


def load(name: str, directory: str | None = None) -> dict:
    """The mix ``<directory>/<name>.json`` (``traffic/`` beside this file
    by default), checked for the generator's keys."""
    directory = directory or os.path.join(HERE, 'traffic')
    with open(os.path.join(directory, f'{name}.json')) as f:
        spec = json.load(f)
    missing = [k for k in KEYS if k not in spec]
    if missing:
        raise KeyError(f'traffic {name!r} lacks {missing}')
    return spec


def make_spills(tpc_borders: np.ndarray, spec: dict, n_spills: int,
                seed: int):
    """``n_spills`` spills of the mix ``spec``; positions in the edep-sim
    convention (the drift coordinate written to ``x``).  Returns
    (segments, trajectories, vertices)."""
    rng = np.random.default_rng(seed)
    borders = np.sort(np.asarray(tpc_borders, np.float64), axis=-1)
    n_vtx = n_spills * spec['vertices_per_spill']
    per = spec['tracks_per_vertex']
    n_trk = n_vtx * per
    tpc = rng.integers(len(borders), size=n_vtx)
    lo, hi = borders[tpc, :, 0], borders[tpc, :, 1]
    vertex = lo + rng.uniform(0.2, 0.8, (n_vtx, 3)) * (hi - lo)
    spill = np.arange(n_vtx) // spec['vertices_per_spill']
    t_vtx = spill * spec['spill_period_us'] + rng.uniform(0, 10, n_vtx)
    cos_t = rng.uniform(-1, 1, n_trk)
    phi = rng.uniform(0, 2 * np.pi, n_trk)
    sin_t = np.sqrt(1 - cos_t ** 2)
    direction = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t],
                         axis=1)
    of = np.repeat(np.arange(n_vtx), per)
    n, step = spec['segments_per_track'], spec['segment_length_cm']
    pos = vertex[of][:, None, :] + (np.arange(n + 1)[None, :, None] * step
                                    * direction[:, None, :])
    begin, end = pos[:, :-1], pos[:, 1:]
    out = ((end < lo[of][:, None]) | (end > hi[of][:, None])).any(axis=2)
    n_kept = np.where(out.any(axis=1), out.argmax(axis=1), n)
    keep = np.arange(n)[None, :] < n_kept[:, None]
    dt_seg = step / 30.0 * 1e-3           # c = 30 cm/ns, in us
    t0 = t_vtx[of][:, None] + np.arange(n)[None, :] * dt_seg
    track = np.repeat(np.arange(n_trk), n).reshape(n_trk, n)[keep]
    begin, end, t0 = begin[keep], end[keep], t0[keep]
    mid = 0.5 * (begin + end)
    ev = spill[of[track]]
    seg = np.zeros(len(track), dtype=SEGMENTS_DTYPE)
    for name in ('event_id', 'vertex_id', 'file_vertex_id'):
        seg[name] = ev
    seg['vertex_id'] = of[track]
    seg['file_vertex_id'] = of[track]
    seg['segment_id'] = np.arange(len(track))
    seg['traj_id'] = track
    seg['file_traj_id'] = track
    # the drift coordinate (detector z) is stored in x
    for axis, c in ((2, 'x'), (1, 'y'), (0, 'z')):
        seg[f'{c}_start'] = begin[:, axis]
        seg[f'{c}_end'] = end[:, axis]
        seg[c] = mid[:, axis]
    seg['dx'] = step
    seg['dEdx'] = spec['dEdx_MeV_per_cm']
    seg['dE'] = spec['dEdx_MeV_per_cm'] * step
    seg['t0_start'] = t0
    seg['t0_end'] = t0 + dt_seg
    seg['t0'] = t0 + dt_seg / 2
    seg['pdg_id'] = 13

    trj = np.zeros(n_trk, dtype=TRAJECTORIES_DTYPE)
    trj['event_id'] = spill[of]
    trj['vertex_id'] = trj['file_vertex_id'] = of
    trj['traj_id'] = trj['file_traj_id'] = np.arange(n_trk)
    trj['parent_id'] = -1
    trj['primary'] = True
    trj['pxyz_start'] = direction
    trj['xyz_start'] = vertex[of][:, [2, 1, 0]]
    trj['t_start'] = t_vtx[of]
    trj['pdg_id'] = 13
    trj['dist_travel'] = n_kept * step

    vtx = np.zeros(n_vtx, dtype=VERTICES_DTYPE)
    vtx['event_id'] = spill
    vtx['vertex_id'] = vtx['file_vertex_id'] = np.arange(n_vtx)
    vtx['x_vert'], vtx['y_vert'], vtx['z_vert'] = vertex[:, 2], vertex[:, 1], \
        vertex[:, 0]
    vtx['t_vert'] = t_vtx
    return seg, trj, vtx


def write_file(filename: str, segments, trajectories, vertices) -> int:
    with File(filename, 'w') as f:
        f.create_dataset('segments', data=segments)
        f.create_dataset('trajectories', data=trajectories)
        f.create_dataset('vertices', data=vertices)
    return len(segments)


def reorder_spills(segments, trajectories, vertices, order,
                   spill_period: float):
    """The spills of a file in another order: spill ``order[k]`` becomes
    spill k, its rows moved there and its times moved by whole spill
    periods; vertex, trajectory and segment ids are numbered anew in the
    new row order."""
    order = np.asarray(order)
    new_of = np.empty(len(order), np.int64)
    new_of[order] = np.arange(len(order))
    v_idx = np.argsort(new_of[vertices['event_id']], kind='stable')
    vertex_of = np.empty(len(v_idx), np.int64)
    vertex_of[vertices['vertex_id'][v_idx]] = np.arange(len(v_idx))

    def moved(rows, times):
        old = rows['event_id'].astype(np.int64)
        new = new_of[old]
        idx = np.argsort(new, kind='stable')
        rows = rows[idx].copy()
        rows['event_id'] = new[idx]
        rows['vertex_id'] = rows['file_vertex_id'] = \
            vertex_of[rows['vertex_id']]
        shift = (new[idx] - old[idx]) * spill_period
        for name in times:
            rows[name] = rows[name] + shift
        return rows, idx
    vtx, _ = moved(vertices, ('t_vert',))
    trj, t_idx = moved(trajectories, ('t_start', 't_end'))
    traj_of = np.empty(len(t_idx), np.int64)
    traj_of[trajectories['file_traj_id'][t_idx]] = np.arange(len(t_idx))
    trj['traj_id'] = trj['file_traj_id'] = np.arange(len(trj))
    seg, _ = moved(segments, ('t0_start', 't0_end', 't0'))
    seg['segment_id'] = np.arange(len(seg))
    seg['traj_id'] = seg['file_traj_id'] = traj_of[seg['file_traj_id']]
    return seg, trj, vtx


def file_seed(seed: int, index: int) -> int:
    """The seed of file ``index``'s order in a run of ``--seed``."""
    return int(np.random.SeedSequence(
        [int(seed) % (1 << 63), index + 1]).generate_state(1)[0])


def pool(spec: dict, tpc_borders: np.ndarray):
    """The mix's spills: (segments, trajectories, vertices)."""
    return make_spills(tpc_borders, spec, spec['spills_per_file'],
                       spec['pool_seed'])


def write_run_file(path: str, spec: dict, spills, seed: int,
                   index: int) -> int:
    """File ``index`` of a run of ``seed``: the pool in its order."""
    order = np.random.default_rng(file_seed(seed, index)).permutation(
        spec['spills_per_file'])
    return write_file(path, *reorder_spills(*spills, order,
                                            spec['spill_period_us']))


def make_inputs(spec: dict, tpc_borders: np.ndarray, seed: int,
                directory: str) -> dict:
    """The run's input files in ``directory``: a one-spill warm-up file
    (the pool's first spill) and ``spec['files']`` files of the pool, each
    in its own order drawn from ``seed``.  Returns dict(warmup=path,
    files=[(path, spills)])."""
    os.makedirs(directory, exist_ok=True)
    spills = pool(spec, tpc_borders)
    warm = os.path.join(directory, 'warmup.h5')
    seg, trj, vtx = spills
    write_file(warm, seg[seg['event_id'] == 0], trj[trj['event_id'] == 0],
               vtx[vtx['event_id'] == 0])
    files = []
    for i in range(spec['files']):
        path = os.path.join(directory, f'input_{i}.h5')
        write_run_file(path, spec, spills, seed, i)
        files.append((path, spec['spills_per_file']))
    return dict(warmup=warm, files=files)
