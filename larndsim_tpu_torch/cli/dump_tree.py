"""edep-sim ROOT -> HDF5 converter.

Counterpart of ``larndsim_tpu.cli.dump_tree`` (reference converter
cli/dumpTree.py:171-474), writing through the port's ``io.h5`` (no h5py):
reads `EDepSimEvents` TTrees (+ optional `event_spill_map` TMap and
`spillPeriod_s` TParameter) and writes the `segments` / `trajectories` /
`vertices` HDF5 schema the simulation consumes, as chunked datasets
appended as it goes.  Pure host tooling: it requires PyROOT and the
edep-sim event classes, upstream dependencies outside this package;
`tests/test_torch_dump_tree.py` runs it against a fake-ROOT shim beside
the JAX converter.  The output dtypes live in assets/make_input.py and
are shared with the synthetic input generator.

    python -m larndsim_tpu_torch.cli.dump_tree IN.root OUT.h5

Reference semantics preserved:
- unit conversions mm -> cm, ns -> us (dumpTree.py:45-46);
- spill time = spillCounter * spillPeriod_s * 1e6 us, written ONLY to
  the vertices' `t_event` (dumpTree.py:228-237, :285); segment t0 stays
  the raw edep-sim hit time (:441);
- event filter: require a segment container named
  $ARCUBE_ACTIVE_VOLUME (default 'volTPCActive') unless keep_all_dets
  (:255-262), and only that container's hits are dumped (:362-365);
- trajectories dumped = primaries + (on the first hit from a
  not-yet-dumped contributor) the contributor's entire family — every
  trajectory sharing its primary ancestor, contributing or not — with
  full kinematics (:299-340, :341-361 family merge, :388-423); every
  trajectory consumes a `file_traj_id` whether dumped or not (:300-302).
  Row order within a family follows event-trajectory order (the
  reference emits the reversed ancestor-walk order; consumers join by
  ids, not row order);
- segment `vertex_id`/`file_vertex_id`/`pdg_id` resolve through the
  first contributor's primary ancestor (:370-386, :424-425, :455);
- chunked HDF5 appends every ~1000 trajectories (:240-249).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

from ..assets.make_input import (SEGMENTS_DTYPE, TRAJECTORIES_DTYPE,
                                 VERTICES_DTYPE)
from ..io.h5 import File

EDEP2CM = 0.1
EDEP2US = 0.001


class SpillTimer:
    """Spill-time bookkeeping of the reference loop (dumpTree.py:198-237):
    without an `event_spill_map` every event is its own "spill" at t=0;
    with one, a counter increments whenever the event's global spill id
    changes and t_spill = counter * spillPeriod_s * 1e6 us."""

    def __init__(self, spill_period_s: float | None):
        self.spill_period_s = spill_period_s   # None = no event_spill_map
        self._counter = -1
        self._last = None

    def t_spill(self, spill_id) -> float:
        if self.spill_period_s is None:
            return 0.0
        if spill_id != self._last:
            self._counter += 1
            self._last = spill_id
        return self._counter * self.spill_period_s * 1e6


def active_volume_name() -> str:
    return os.environ.get('ARCUBE_ACTIVE_VOLUME', 'volTPCActive')


def passes_active_volume(container_names, keep_all_dets: bool) -> bool:
    """Event filter (dumpTree.py:253-262): with keep_all_dets, keep any
    event that has segment detectors at all; otherwise require a container
    named $ARCUBE_ACTIVE_VOLUME (default 'volTPCActive')."""
    names = list(container_names)
    if keep_all_dets:
        return len(names) > 0
    active = active_volume_name()
    return any(name == active for name in names)


def _traj_row(trajectory, ev_id, vertex_id, file_vertex_id, file_traj_id):
    """One trajectory record with full kinematics (dumpTree.py:299-340)."""
    row = np.zeros(1, TRAJECTORIES_DTYPE)
    start_pt = trajectory.Points[0]
    end_pt = trajectory.Points[-1]
    row['event_id'] = ev_id
    row['vertex_id'] = vertex_id
    row['file_vertex_id'] = file_vertex_id
    row['traj_id'] = trajectory.GetTrackId()
    row['file_traj_id'] = file_traj_id
    row['parent_id'] = trajectory.GetParentId()
    row['primary'] = trajectory.GetParentId() == -1
    mass = trajectory.GetInitialMomentum().M()
    p_start = (start_pt.GetMomentum().X(), start_pt.GetMomentum().Y(),
               start_pt.GetMomentum().Z())
    p_end = (end_pt.GetMomentum().X(), end_pt.GetMomentum().Y(),
             end_pt.GetMomentum().Z())
    row['pxyz_start'] = p_start
    row['pxyz_end'] = p_end
    row['xyz_start'] = tuple(start_pt.GetPosition().__getattribute__(ax)()
                             * EDEP2CM for ax in 'XYZ')
    row['xyz_end'] = tuple(end_pt.GetPosition().__getattribute__(ax)()
                           * EDEP2CM for ax in 'XYZ')
    row['E_start'] = np.sqrt(np.sum(np.square(p_start)) + mass ** 2)
    row['E_end'] = np.sqrt(np.sum(np.square(p_end)) + mass ** 2)
    row['t_start'] = start_pt.GetPosition().T() * EDEP2US
    row['t_end'] = end_pt.GetPosition().T() * EDEP2US
    row['start_process'] = start_pt.GetProcess()
    row['start_subprocess'] = start_pt.GetSubprocess()
    row['end_process'] = end_pt.GetProcess()
    row['end_subprocess'] = end_pt.GetSubprocess()
    row['pdg_id'] = trajectory.GetPDGCode()
    dist = 0.0
    pts = trajectory.Points
    for i in range(len(pts) - 1):
        a, b = pts[i].GetPosition(), pts[i + 1].GetPosition()
        dist += np.sqrt((a.X() - b.X()) ** 2 + (a.Y() - b.Y()) ** 2
                        + (a.Z() - b.Z()) ** 2) * EDEP2CM
    row['dist_travel'] = dist
    return row


def _append(f, name, rows, dtype):
    data = (np.concatenate(rows) if rows else np.zeros(0, dtype))
    if name not in f:
        f.create_dataset(name, data=data, maxshape=(None,))
    else:
        f[name].append(data)


def dump(input_file: str, output_file: str,
         n_events: int | None = None, keep_all_dets: bool = False,
         write_batch: int = 1000):
    """Convert an edep-sim ROOT file to the segments HDF5 schema.

    Args:
        input_file: edep-sim ROOT file with an EDepSimEvents tree (+
            optional `event_spill_map` TMap and `spillPeriod_s` TParameter,
            dumpTree.py:198-205).
        output_file: HDF5 output path.
        n_events: stop after this many tree entries (None = all).
        keep_all_dets: keep events with hits in any detector container —
            and dump every container's hits — instead of requiring (and
            dumping only) $ARCUBE_ACTIVE_VOLUME (dumpTree.py:255, :362).
        write_batch: append to the HDF5 file whenever this many
            trajectory rows have accumulated (dumpTree.py:240-249).
    """
    try:
        from ROOT import TFile, TG4Event  # noqa: F401
    except ImportError as exc:
        raise ImportError(
            'dump_tree requires PyROOT with edep-sim event classes; '
            'install the upstream edep-sim toolchain, or produce inputs '
            'with any tool emitting the segments HDF5 schema '
            '(see larndsim_tpu_torch.assets.make_input for the dtypes).'
        ) from exc

    root_file = TFile(input_file)
    tree = root_file.Get('EDepSimEvents')
    n = tree.GetEntries() if n_events is None else min(
        n_events, tree.GetEntries())

    # spill map: which global spill each (run, event) lives in
    # (dumpTree.py:198-205)
    event_spill_map = root_file.Get('event_spill_map')
    timer = SpillTimer(float(root_file.Get('spillPeriod_s').GetVal())
                       if event_spill_map else None)
    active = active_volume_name()

    seg_rows, traj_rows, vert_rows = [], [], []
    pending_traj = 0
    segment_id = 0
    file_vertex_counter = 0
    track_counter = 0   # unique-in-file trajectory ids (dumpTree.py:216)
    out = File(output_file, 'w')
    try:
        for ientry in range(int(n)):
            nb = tree.GetEntry(ientry)
            if nb is not None and nb <= 0:
                # failed/empty read: skip, as the reference does
                # (dumpTree.py:251-252) — proceeding would reprocess the
                # previous entry's stale event object
                continue
            event = tree.Event
            ev_id = event.EventId
            if event_spill_map:
                spill_tobj = event_spill_map.GetValue(
                    f'{event.RunId} {event.EventId}')
                t_spill = timer.t_spill(int(spill_tobj.GetName()))
            else:
                t_spill = timer.t_spill(None)

            if pending_traj >= write_batch:
                _append(out, 'segments', seg_rows, SEGMENTS_DTYPE)
                _append(out, 'trajectories', traj_rows, TRAJECTORIES_DTYPE)
                _append(out, 'vertices', vert_rows, VERTICES_DTYPE)
                seg_rows, traj_rows, vert_rows = [], [], []
                pending_traj = 0

            if not passes_active_volume(
                    (name for name, _hits in event.SegmentDetectors),
                    keep_all_dets):
                continue

            # vertex maps: primary-particle track id -> vertex ids
            # (dumpTree.py:270-291)
            vertex_map, file_vertex_map = {}, {}
            for ivtx, primaries in enumerate(event.Primaries):
                vrow = np.zeros(1, VERTICES_DTYPE)
                vrow['event_id'] = ev_id
                vrow['vertex_id'] = ivtx
                vrow['file_vertex_id'] = file_vertex_counter
                pos = primaries.GetPosition()
                vrow['x_vert'] = pos.X() * EDEP2CM
                vrow['y_vert'] = pos.Y() * EDEP2CM
                vrow['z_vert'] = pos.Z() * EDEP2CM
                vrow['t_vert'] = pos.T() * EDEP2US
                vrow['t_event'] = t_spill
                vert_rows.append(vrow)
                for par in primaries.Particles:
                    vertex_map[par.GetTrackId()] = ivtx
                    file_vertex_map[par.GetTrackId()] = file_vertex_counter
                file_vertex_counter += 1

            # every trajectory consumes a file id; primaries are dumped
            # up front, descendants lazily when a segment needs their
            # line (dumpTree.py:297-340, :388-423)
            track_map, traj_by_id, dumped = {}, {}, set()
            for traj in event.Trajectories:
                track_map[traj.GetTrackId()] = track_counter
                traj_by_id[traj.GetTrackId()] = traj
                track_counter += 1
            for traj in event.Trajectories:
                tid = traj.GetTrackId()
                if traj.GetParentId() == -1 and tid in vertex_map:
                    traj_rows.append(_traj_row(
                        traj, ev_id, vertex_map[tid], file_vertex_map[tid],
                        track_map[tid]))
                    dumped.add(tid)
                    pending_traj += 1

            def primary_of(tid):
                """contributor -> its primary ancestor's track id
                (dumpTree.py:341-361 walk, :383-386 vertex search)."""
                while True:
                    if tid in vertex_map:
                        return tid
                    parent = traj_by_id[tid].GetParentId()
                    if parent == -1 or parent not in traj_by_id:
                        return tid
                    tid = parent

            # family lists: primary track id -> every trajectory whose
            # ancestor walk reaches it (the reference's merged `daughters`
            # lists, dumpTree.py:341-361) — dumped wholesale on the first
            # hit from a not-yet-dumped contributor (:388)
            family: dict = {}
            for traj in event.Trajectories:
                family.setdefault(primary_of(traj.GetTrackId()),
                                  []).append(traj.GetTrackId())

            for det_name, hits in event.SegmentDetectors:
                if (not keep_all_dets) and det_name != active:
                    continue   # dumpTree.py:362-365
                for hit in hits:
                    row = np.zeros(1, SEGMENTS_DTYPE)
                    row['event_id'] = ev_id
                    row['segment_id'] = segment_id
                    segment_id += 1
                    contrib = int(hit.Contrib[0])
                    row['traj_id'] = contrib
                    row['file_traj_id'] = track_map[contrib]
                    primary_tid = primary_of(contrib)
                    if primary_tid not in vertex_map:
                        # rootless family (no registered primary particle):
                        # the reference would leave the row's vertex fields
                        # at their np.empty garbage after an IndexError
                        # print (dumpTree.py:427-433); be explicit instead
                        warnings.warn(
                            f'event {ev_id}: contributor {contrib} has no '
                            'primary-vertex ancestor; vertex ids set to 0')
                    vtx = vertex_map.get(primary_tid, 0)
                    fvtx = file_vertex_map.get(primary_tid, 0)
                    if contrib not in dumped:
                        for tid in family.get(primary_tid, [contrib]):
                            if tid not in dumped:
                                traj_rows.append(_traj_row(
                                    traj_by_id[tid], ev_id, vtx, fvtx,
                                    track_map[tid]))
                                dumped.add(tid)
                                pending_traj += 1
                    row['vertex_id'] = vtx
                    row['file_vertex_id'] = fvtx
                    start, stop = hit.GetStart(), hit.GetStop()
                    row['x_start'] = start.X() * EDEP2CM
                    row['y_start'] = start.Y() * EDEP2CM
                    row['z_start'] = start.Z() * EDEP2CM
                    row['x_end'] = stop.X() * EDEP2CM
                    row['y_end'] = stop.Y() * EDEP2CM
                    row['z_end'] = stop.Z() * EDEP2CM
                    row['x'] = 0.5 * (row['x_start'] + row['x_end'])
                    row['y'] = 0.5 * (row['y_start'] + row['y_end'])
                    row['z'] = 0.5 * (row['z_start'] + row['z_end'])
                    # raw edep hit times: t_spill lives in vertices'
                    # t_event only (dumpTree.py:441, :285)
                    row['t0_start'] = start.T() * EDEP2US
                    row['t0_end'] = stop.T() * EDEP2US
                    row['t0'] = 0.5 * (row['t0_start'] + row['t0_end'])
                    row['dE'] = hit.GetEnergyDeposit()
                    dx = np.sqrt((row['x_end'] - row['x_start']) ** 2
                                 + (row['y_end'] - row['y_start']) ** 2
                                 + (row['z_end'] - row['z_start']) ** 2)
                    row['dx'] = dx
                    row['dEdx'] = row['dE'] / dx if dx > 0 else 0
                    row['pdg_id'] = traj_by_id[contrib].GetPDGCode()
                    seg_rows.append(row)

        _append(out, 'segments', seg_rows, SEGMENTS_DTYPE)
        _append(out, 'trajectories', traj_rows, TRAJECTORIES_DTYPE)
        _append(out, 'vertices', vert_rows, VERTICES_DTYPE)
    finally:
        out.close()
    print(f'wrote {segment_id} segments to {output_file}')


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser(
        description='edep-sim ROOT -> segments HDF5 (reference '
                    'cli/dumpTree.py counterpart)')
    ap.add_argument('input_file')
    ap.add_argument('output_file')
    ap.add_argument('--n_events', type=int, default=None,
                    help='stop after this many events')
    ap.add_argument('--keep_all_dets', action='store_true',
                    help='keep events with hits in any detector container '
                         'instead of requiring $ARCUBE_ACTIVE_VOLUME '
                         '(dumpTree.py:255)')
    a = ap.parse_args()
    dump(a.input_file, a.output_file, n_events=a.n_events,
         keep_all_dets=a.keep_all_dets)
