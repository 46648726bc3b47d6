"""HDF5 export: LArPix packets + MC-truth association, light triggers,
waveforms and light truth.

Counterpart of ``larndsim_tpu.io.export`` (reference fee.export_to_hdf5
fee.py:84-359, export_sync/timestamp_trigger fee.py:361-497, and the light
writers of light_sim.py:663-745): the packet stream is placed block by
block from counts in numpy, each data packet's association row is built
from its hit's touched track slots alone, and both are written through
``io.larpix_packets`` into an open ``io.h5.File`` (the caller opens the
output once and closes it at the end of the run).  The light parameters the packet writers read reduce to
the light-trigger mode.  Appended datasets are chunked and go to disk a
chunk at a time as they grow; the light truth is shuffled and compressed
(LZF by default) in chunks of :data:`TRUTH_CHUNK` records, as the JAX
package writes it.
"""
from __future__ import annotations

import logging
import os
import warnings

import numpy as np
import yaml

from .. import units
from ..params.detector import DetectorModel
from ..params.light import LightParams
from ..params.sim import SimParams
from . import larpix_packets as lp

logger = logging.getLogger('export')


def get_trig_io(light_trig_mode: int) -> int:
    """io_group receiving forwarded triggers (fee.get_trig_io, fee.py:30-38)."""
    return 2 if light_trig_mode == 0 else 1


def _digitize_zero(det) -> float:
    """ADC count for zero integrated charge (fee.digitize on host floats)."""
    hc = det.host
    v = hc['v_pedestal'] * units.mV - hc['v_cm'] * units.mV
    return min(round(max(v, 0.0) * det.adc_counts
                     / (hc['v_ref'] * units.mV - hc['v_cm'] * units.mV)),
               det.adc_counts - 1)


# --------------------------------------------------------------------------
# pixel id -> readout coordinates (dense)
# --------------------------------------------------------------------------

def pixel_readout_coords(pixel_ids: np.ndarray, det_model: DetectorModel):
    """Vectorized pixel id -> (io_group, io_channel, chip, channel, ok).

    Replaces the per-packet dict lookups at fee.py:147-157 and :227-247.
    """
    layout = det_model.layout
    nx, ny = layout.n_pixels
    nppt = layout.n_pixels_per_tile
    pix_x = pixel_ids % nx
    pix_y = (pixel_ids // nx) % ny
    plane = pixel_ids // (nx * ny)
    module_id = plane // 2 + 1

    tile_x = pix_x // nppt[0]
    tile_y = pix_y // nppt[1]
    anode_id = plane % 2
    tile_map = np.asarray(det_model.tile_map)  # (n_anode, ntx, nty)
    ok = ((anode_id >= 0) & (anode_id < tile_map.shape[0])
          & (tile_x < tile_map.shape[1]) & (tile_y < tile_map.shape[2]))
    tile_id = tile_map[np.clip(anode_id, 0, tile_map.shape[0] - 1),
                       np.clip(tile_x, 0, tile_map.shape[1] - 1),
                       np.clip(tile_y, 0, tile_map.shape[2] - 1)]

    in_x = pix_x % nppt[0]
    in_y = pix_y % nppt[1]
    chip = layout.chip_id_map[tile_id, in_x, in_y]
    channel = layout.channel_id_map[tile_id, in_x, in_y]
    io_group_local = layout.io_group_map[tile_id, in_x, in_y]
    io_channel = layout.io_channel_map[tile_id, in_x, in_y]

    # module io-group remap (fee.py:247)
    mod_keys = sorted(det_model.module_to_io_groups)
    io_lut = np.full((max(mod_keys) + 2,
                      max(len(v) for v in det_model.module_to_io_groups.values()) + 1),
                     -1, np.int32)
    for m, groups in det_model.module_to_io_groups.items():
        for i, g in enumerate(groups):
            io_lut[m, i + 1] = g
    mod_ok = (module_id >= 1) & (module_id <= max(mod_keys))
    ok &= mod_ok & (chip >= 0) & (io_group_local >= 1)
    safe_mod = np.clip(module_id, 1, max(mod_keys))
    safe_local = np.clip(io_group_local, 0, io_lut.shape[1] - 1)
    io_group = io_lut[safe_mod, safe_local]
    ok &= io_group >= 0
    return io_group, io_channel, chip, channel, ok


# --------------------------------------------------------------------------
# MC association helpers
# --------------------------------------------------------------------------

def _association_rows(fr, prow, track_ids, traj_ids, event, store: int):
    """The association rows of a flush's data packets (fee.py:297-328):
    per hit, its event, its segment ids and fractions in descending
    fraction order, and its trajectory ids, ascending, with their summed
    fractions; the first ``store`` of each.

    The reference sorts all K track slots of every hit, most of them
    padding (the ids' -1, fraction 0).  Here only the touched slots are
    sorted, each sort one stable argsort of (hit, key) packed in an
    integer: the slots with a segment or trajectory id other than the
    padding's, or a fraction other than 0.0.  In a K-wide descending order
    the padding falls among the zeros, before the negative fractions, so a
    negative fraction lands at its rank among the touched slots plus the
    hit's padding count.

    Args:
        fr: (n, K) float32 current fractions of the hits, finite.
        prow: (n,) each hit's pixel row.
        track_ids, traj_ids: (R, K) segment / trajectory ids per pixel row
            and track slot; padding is -1 in the ids' dtype (4294967295
            for the input's uint32 segment ids).
        event: (n,) each hit's event id.

    Equal fractions (0.0 and -0.0 alike) keep slot order, the padding
    after the touched zeros (the reference orders ties by numpy's unstable
    sort).  Trajectory ids > -1 count, so unsigned padding is a trajectory
    of its own.  A trajectory's fractions are summed in double in
    descending fraction order, as the reference's bincount sums them.
    """
    if fr.dtype != np.float32:
        raise TypeError('association rows: float32 fractions expected, '
                        f'not {fr.dtype}')
    n, K = fr.shape
    pad_tid, pad_trj = (np.array(-1).astype(x.dtype)
                        for x in (track_ids, traj_ids))
    used = (track_ids != pad_tid) | (traj_ids != pad_trj)
    e = np.flatnonzero(used[prow] | (fr.view(np.uint32) != 0))
    h = e // K
    f = fr.reshape(-1)[e]
    # the fraction's bits as a key that ascends as the fraction descends
    u = (f + np.float32(0)).view(np.uint32)
    desc = np.where(u >> 31, u, ~u & np.uint32(0x7fffffff))
    order = np.argsort((h << 32) | desc, kind='stable')
    h, f = h[order], f[order]
    slot = prow[h] * K + e[order] % K
    m = np.bincount(h, minlength=n)
    pos = (np.arange(len(h)) - (np.cumsum(m) - m)[h]
           + np.where(f < 0, K - m[h], 0))
    rows = np.zeros(n, _assn_dtype(store))
    rows['event_ids'][:, 0] = event
    seg = np.full((n, store), int(pad_tid), np.int64)
    frac = np.zeros((n, store))
    s = pos < store
    at = h[s] * store + pos[s]
    seg.reshape(-1)[at] = track_ids.reshape(-1)[slot[s]]
    frac.reshape(-1)[at] = f[s]
    rows['segment_ids'] = seg
    rows['fraction'] = frac

    # trajectories: one group a (hit, id), its entries in descending order
    t = traj_ids.reshape(-1)[slot].astype(np.int64)
    if traj_ids.dtype.kind == 'u':
        padded = np.nonzero(m < K)[0]
        h = np.concatenate([h, padded])
        t = np.concatenate([t, np.full(len(padded), int(pad_trj))])
        f = np.concatenate([f, np.zeros(len(padded), f.dtype)])
    else:
        c = t > -1
        h, t, f = h[c], t[c], f[c]
    key = t
    if len(t) and t.max() >> 32:           # ids past 32 bits: their ranks
        key = np.unique(t, return_inverse=True)[1]
    order = np.argsort((h << 32) | key, kind='stable')
    h, t, f = h[order], t[order], f[order]
    first = np.ones(len(h), bool)
    first[1:] = (h[1:] != h[:-1]) | (t[1:] != t[:-1])
    sums = np.bincount(np.cumsum(first) - 1, weights=f)
    h, t = h[first], t[first]
    g = np.bincount(h, minlength=n)
    rank = np.arange(len(h)) - (np.cumsum(g) - g)[h]
    s = rank < store
    at = h[s] * store + rank[s]
    traj = np.full((n, store), -1, np.int64)
    frac_traj = np.zeros((n, store))
    traj.reshape(-1)[at] = t[s]
    frac_traj.reshape(-1)[at] = sums[s]
    rows['file_traj_ids'] = traj
    rows['fraction_traj'] = frac_traj
    return rows


def _assn_dtype(store: int) -> np.dtype:
    return np.dtype([('event_ids', '(1,)i8'),
                     ('segment_ids', f'({store},)i8'),
                     ('fraction', f'({store},)f8'),
                     ('file_traj_ids', f'({store},)i8'),
                     ('fraction_traj', f'({store},)f8')])


def _service_assn(store: int) -> np.ndarray:
    """One association row of a service packet: no event, no segment."""
    a = np.zeros(1, dtype=_assn_dtype(store))
    a['event_ids'] = -1
    a['segment_ids'] = -1
    a['file_traj_ids'] = -1
    return a


def _place(dst: np.ndarray, at, src: np.ndarray):
    """``dst[at] = src`` for records of one dtype, copied whole (numpy
    copies structured records field by field)."""
    raw = np.dtype((np.void, dst.dtype.itemsize))
    dst.view(raw)[at] = src.view(raw)


def _append_dataset(f, name: str, data: np.ndarray):
    """Append rows to a chunked dataset of the open file, created at the
    first rows (full chunks are written as they fill)."""
    if data.shape[0] == 0:
        return
    if name not in f:
        maxshape = (None,) + data.shape[1:]
        f.create_dataset(name, data=data, maxshape=maxshape)
    else:
        f[name].append(data)


_BAD_CHANNELS_CACHE: dict = {}


def _packed_bad_channels(path, bad_channels_list: dict) -> np.ndarray:
    """Flatten the bad-channels YAML ('{io_group}-{io_channel}-{chip}' ->
    [channels], fee.py:250-254) into sorted packed int64 keys, cached per
    (file path, mtime, size) so a rewritten file is repacked."""
    try:
        st = os.stat(path)
        cache_key = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        cache_key = path
    hit = _BAD_CHANNELS_CACHE.get(cache_key)
    if hit is not None:
        return hit
    keys = []
    for key, channels in bad_channels_list.items():
        g, c, ch = (int(x) for x in str(key).split('-'))
        for chan in channels or ():
            keys.append((((g << 16 | c) << 16 | ch) << 16) | int(chan))
    packed = np.sort(np.asarray(keys, np.int64))
    if len(_BAD_CHANNELS_CACHE) > 8:
        _BAD_CHANNELS_CACHE.clear()
    _BAD_CHANNELS_CACHE[cache_key] = packed
    return packed


def _event_trigger_packets(events, ev_t0_mod, trigger_times, trigger_event,
                           trigger_modules, det_model: DetectorModel,
                           clock, reset_period):
    """Mode 0's light-trigger packets of each event boundary (fee.py:
    209-225): for each boundary in turn, its event's triggers in input
    order, each on its module's io groups in turn.

    Returns:
        (boundary of each packet, the trigger packets).
    """
    by_event = np.argsort(trigger_event, kind='stable')
    ids = trigger_event[by_event]
    lo = np.searchsorted(ids, events, 'left')
    n = np.searchsorted(ids, events, 'right') - lo
    pair_b = np.repeat(np.arange(len(events)), n)
    pair_t = by_event[lo[pair_b] + np.arange(len(pair_b))
                      - (np.cumsum(n) - n)[pair_b]]
    ticks = np.floor(trigger_times[pair_t] / clock
                     + ev_t0_mod[pair_b]).astype(np.int64) % reset_period
    mods, mod_inv = np.unique(trigger_modules[pair_t].astype(np.int64),
                              return_inverse=True)
    groups = [np.asarray(det_model.module_to_io_groups[int(m)], np.int64)
              for m in mods]
    n_g = np.array([len(g) for g in groups], np.int64)
    g_start = (np.cumsum(n_g) - n_g)[mod_inv]
    n_g = n_g[mod_inv]
    pair = np.repeat(np.arange(len(pair_b)), n_g)
    within = np.arange(len(pair)) - (np.cumsum(n_g) - n_g)[pair]
    io = (np.concatenate(groups) if groups else np.empty(0, np.int64))
    return pair_b[pair], lp.make_trigger_packets(
        ticks[pair], io[g_start[pair] + within])


# --------------------------------------------------------------------------
# charge export
# --------------------------------------------------------------------------

def export_to_hdf5(event_pix, hit_row, hit_adc, hit_ticks, hit_fractions,
                   unique_pix, track_ids, traj_ids, f,
                   event_start_times, det_model: DetectorModel,
                   light_trig_mode: int, sim: SimParams,
                   light_trigger_times=None, light_trigger_event_id=None,
                   light_trigger_modules=None, bad_channels=None,
                   i_mod: int = -1):
    """Write the LArPix packet stream + mc_packets_assn for one write batch
    into the open file ``f``.

    Semantics match fee.export_to_hdf5 (fee.py:84-359) with hits in
    *compact* form: ``event_pix``/``unique_pix``/``track_ids``/``traj_ids``
    are per pixel row; ``hit_row``/``hit_adc``/``hit_ticks``/
    ``hit_fractions`` are per latched hit, in (pixel-row, adc-slot)
    row-major order — the order the reference's dense np.nonzero flatten
    produced.  `track_ids`/`traj_ids` carry *global* segment / trajectory
    ids per (pixel, track-slot).  A hit's association row is built from
    its touched track slots alone (:func:`_association_rows`); equal
    fractions keep slot order.
    """
    det = det_model.params
    clock = det.clock_cycle
    reset_period = det.clock_reset_period
    store = sim.association_count_to_store

    event_pix = np.asarray(event_pix)
    hit_row = np.asarray(hit_row)
    hit_adc = np.asarray(hit_adc)
    hit_ticks = np.asarray(hit_ticks)
    hit_fractions = np.asarray(hit_fractions)
    unique_pix = np.asarray(unique_pix)
    track_ids = np.asarray(track_ids)
    traj_ids = np.asarray(traj_ids)

    io_groups_all = np.unique(
        np.array(list(det_model.module_to_io_groups.values())))
    if i_mod >= 1:
        io_groups_all = io_groups_all[(i_mod - 1) * 2: i_mod * 2]

    bad_channels_list = None
    if bad_channels:
        with open(bad_channels) as bcf:
            bad_channels_list = yaml.safe_load(bcf)

    # --- per-pixel event times ---
    unique_events, unique_events_inv = np.unique(event_pix,
                                                 return_inverse=True)
    event_t0_ticks = (event_start_times[unique_events_inv]
                      / clock).astype(np.int64)

    light_trigger_times = (np.empty(0) if light_trigger_times is None
                           else np.asarray(light_trigger_times))
    light_trigger_event_id = (np.empty(0, int) if light_trigger_event_id is
                              None else np.asarray(light_trigger_event_id))
    light_trigger_modules = (np.empty(0) if light_trigger_modules is None
                             else np.asarray(light_trigger_modules))

    # --- filter hits above the digitized zero (order is already
    # (pixel-row, adc-slot) row-major) ---
    dig0 = _digitize_zero(det)
    above = hit_adc > dig0
    pix_row = hit_row[above]
    n_hits = pix_row.size

    if n_hits == 0:
        return

    pix_ids = unique_pix[pix_row]
    io_group, io_channel, chip, channel, ok = pixel_readout_coords(
        pix_ids, det_model)
    event = event_pix[pix_row]
    ev_t0 = event_t0_ticks[pix_row]
    t_us = hit_ticks[above]
    # Clock rollover (fee.py:163-183): per hit, the reference subtracts
    # CLOCK_RESET_PERIOD from `event_start_time_list[itick:]` until the
    # hit tick fits; with event times nondecreasing along the stream the
    # resulting data/sync/trigger timestamps equal a plain modulo, and the
    # only *observable* state is the cumulative rollover count (which
    # drives the tick-group timestamp payload below).  tt_raw // period
    # is the per-hit rollover demand; its running max is the reference's
    # sequential counter, vectorized.
    tt_raw = np.floor(t_us / clock + ev_t0).astype(np.int64)
    rollovers = np.maximum.accumulate(
        np.maximum(tt_raw // reset_period, 0))
    time_tick = tt_raw % reset_period
    ev_t0_mod = ev_t0 % reset_period

    if not ok.all():
        n_bad = int((~ok).sum())
        logger.warning('%d hits on unmapped pixels dropped', n_bad)

    # bad-channel masking (fee.py:250-254), vectorized: the YAML's
    # '{io_group}-{io_channel}-{chip}' -> [channels] map is flattened once
    # into packed (io_group, io_channel, chip, channel) int64 keys and the
    # per-hit test becomes one np.isin against the sorted pack
    if bad_channels_list:
        packed_bad = _packed_bad_channels(bad_channels, bad_channels_list)
        hit_keys = (((io_group.astype(np.int64) << 16 | io_channel) << 16
                     | chip) << 16) | channel
        ok &= ~np.isin(hit_keys, packed_bad)

    # --- the stream, placed from counts: per hit in stream order, its
    # event-boundary block, its timestamp-group packet, its data packet ---
    # event boundary: first hit of each event above the digitized zero —
    # NOT gated on channel mapping: the reference emits the event's
    # timestamp/sync/trigger packets before the chip lookup can `continue`
    # (fee.py:186-225 precede the KeyError/bad-channel drops :229-254).
    # Its block: a timestamp and a sync packet for each io group, then
    # mode 0's light triggers of the event.
    new_event = np.concatenate([[True], event[1:] != event[:-1]])
    bnd = (np.nonzero(new_event)[0] if light_trig_mode != 1
           else np.empty(0, np.int64))
    n_io = len(io_groups_all)
    blk = np.zeros(n_hits, np.int64)
    blk[bnd] = 2 * n_io
    trig = None
    if light_trig_mode == 0 and len(bnd) and light_trigger_event_id.size:
        trig = _event_trigger_packets(
            event[bnd], ev_t0_mod[bnd], light_trigger_times,
            light_trigger_event_id, light_trigger_modules, det_model,
            clock, reset_period)
        n_trig = np.bincount(trig[0], minlength=len(bnd))
        blk[bnd] += n_trig
    # timestamp-group boundary: time_tick change *among surviving hits*
    # (last_time_tick only updates after the drop checks, fee.py:262)
    surv = np.nonzero(ok)[0]
    tick_surv = time_tick[surv]
    tick_hits = surv[np.concatenate([[True],
                                     tick_surv[1:] != tick_surv[:-1]])]
    tick = np.zeros(n_hits, np.int64)
    tick[tick_hits] = 1
    size = blk + tick + ok
    start = np.cumsum(size) - size
    packets = lp.empty_packets(int(start[-1] + size[-1]))

    if len(bnd):
        svc = (start[bnd, None] + np.arange(2 * n_io)).reshape(-1, n_io, 2)
        io = np.tile(io_groups_all, len(bnd))
        ev_s = (event_start_times[unique_events_inv[pix_row[bnd]]]
                * units.mus / units.s)
        _place(packets, svc[..., 0].ravel(), lp.make_timestamp_packets(
            np.repeat(ev_s, n_io), io_group=io))
        _place(packets, svc[..., 1].ravel(), lp.make_sync_packets(
            np.repeat(time_tick[bnd], n_io), io))
    if trig is not None:
        b, pkts = trig
        within = np.arange(len(b)) - (np.cumsum(n_trig) - n_trig)[b]
        _place(packets, start[bnd][b] + 2 * n_io + within, pkts)

    # per-timestamp-group timestamp packet (fee.py:267): payload tracks
    # `event_start_time_list[0]` — the raw t0 of pixel row 0, decremented
    # by one reset period per rollover triggered while processing row 0's
    # hits (adjustments at later rows touch only slices [itick:], so [0]
    # freezes once the stream moves past row 0).
    if pix_row[0] == 0:
        row0_hits = np.nonzero(pix_row == 0)[0]
        last_row0 = row0_hits[-1]
        adj = rollovers[np.minimum(tick_hits, last_row0)]
    else:
        adj = np.zeros(len(tick_hits), np.int64)
    ts_payload = np.floor(
        (event_t0_ticks[0] - adj * reset_period).astype(np.float64)
        * clock * units.mus / units.s)
    _place(packets, start[tick_hits] + blk[tick_hits],
           lp.make_timestamp_packets(ts_payload,
                                     io_group=io_group[tick_hits]))

    # --- data packets and their associations ---
    at = start[surv] + blk[surv] + tick[surv]
    _place(packets, at, lp.make_data_packets(
        io_group[surv], io_channel[surv], chip[surv], channel[surv],
        time_tick[surv], hit_adc[above][surv]))
    assn = np.repeat(_service_assn(store), len(packets))
    _place(assn, at, _association_rows(
        hit_fractions[np.nonzero(above)[0][surv]], pix_row[surv],
        track_ids, traj_ids, event[surv], store))

    lp.to_file(f, packets)
    _append_dataset(f, 'mc_packets_assn', assn)
    hc = det.host
    f['configs'].attrs['vdrift'] = hc['v_drift']
    f['configs'].attrs['long_diff'] = hc['long_diff']
    f['configs'].attrs['tran_diff'] = hc['tran_diff']
    f['configs'].attrs['lifetime'] = hc['electron_lifetime']
    f['configs'].attrs['drift_length'] = det.drift_length


def export_sync_to_hdf5(f, sync_times, det_model: DetectorModel,
                        sim: SimParams, i_mod: int = -1):
    """PPS sync packets (fee.export_sync_to_hdf5, fee.py:361-424)."""
    det = det_model.params
    io_groups = (det_model.module_to_io_groups[i_mod] if i_mod > 0 else
                 np.unique(np.array(
                     list(det_model.module_to_io_groups.values()))))
    sync_ticks = np.asarray(sync_times) / det.clock_cycle
    rounded = (sync_ticks // det.clock_reset_period
               * det.clock_reset_period)
    off = sync_ticks % det.clock_reset_period != 0
    if off.any():
        warnings.warn('The provided sync time is not a multiple of the '
                      'reset period!')
    sync_ticks = np.where(off, rounded, sync_ticks)
    if not (len(sync_ticks) and len(io_groups)):
        return
    # each sync time's packet on every io group, time-major
    packets = lp.make_sync_packets(np.repeat(sync_ticks, len(io_groups)),
                                   np.tile(io_groups, len(sync_ticks)))
    lp.to_file(f, packets)
    _append_dataset(f, 'mc_packets_assn', np.repeat(
        _service_assn(sim.association_count_to_store), len(packets)))


def export_timestamp_trigger_to_hdf5(f, event_start_times,
                                     det_model: DetectorModel,
                                     light_trig_mode: int, sim: SimParams,
                                     i_mod: int = -1):
    """Beam timestamp+trigger packets (fee.py:426-497)."""
    det = det_model.params
    io_group = get_trig_io(light_trig_mode)
    pk = []
    for evt_time in np.asarray(event_start_times):
        t_trig = int(np.floor(evt_time / det.clock_cycle)) \
            % det.clock_reset_period
        pk.append(lp.make_timestamp_packets(
            [evt_time * units.mus / units.s], io_group=io_group))
        pk.append(lp.make_trigger_packets([t_trig], io_group))
    if not pk:
        return
    packets = np.concatenate(pk)
    lp.to_file(f, packets)
    _append_dataset(f, 'mc_packets_assn', np.repeat(
        _service_assn(sim.association_count_to_store), len(packets)))


# --------------------------------------------------------------------------
# light export
# --------------------------------------------------------------------------

def export_light_trig_to_hdf5(event_id, start_times, trigger_idx,
                              op_channel_idx, f, event_times,
                              det_model: DetectorModel, light: LightParams):
    """light_trig dataset (light_sim.export_light_trig_to_hdf5, :715-745)."""
    event_id = np.asarray(event_id)
    if event_id.shape[0] == 0:
        return
    det = det_model.params
    uniq, inv = np.unique(event_id, return_inverse=True)
    ev_start = np.asarray(event_times)[inv]
    ev_sync = (ev_start / det.clock_cycle).astype(np.int64) \
        % det.clock_reset_period

    op_channel_idx = np.atleast_2d(np.asarray(op_channel_idx))
    trig = np.empty(len(event_id), dtype=np.dtype(
        [('op_channel', 'i4', (op_channel_idx.shape[-1],)),
         ('ts_s', 'f8'), ('ts_sync', 'u8')]))
    trig['op_channel'] = op_channel_idx
    trig['ts_s'] = ((np.asarray(start_times) + np.asarray(trigger_idx)
                     * light.light_tick_size + ev_start)
                    * units.mus / units.s)
    trig['ts_sync'] = (((np.asarray(start_times) + np.asarray(trigger_idx)
                         * light.light_tick_size) / det.clock_cycle
                        + ev_sync).astype(np.int64) % det.clock_reset_period)
    _append_dataset(f, 'light_trig', trig)


TRUTH_DTYPE = np.dtype([('trigger_id', 'i4'), ('op_channel_id', 'i4'),
                        ('tick', 'i4'), ('event_id', 'i4'),
                        ('segment_id', 'i8'), ('pe_current', 'f8')])


def truth_sparse_to_records(sparse: dict, event_id: int,
                            i_trig: int) -> np.ndarray:
    """Assemble light_wvfm_mc_assn records from zero-suppressed truth."""
    n = len(sparse['trig'])
    out = np.empty(n, dtype=TRUTH_DTYPE)
    out['trigger_id'] = i_trig + sparse['trig']
    out['op_channel_id'] = sparse['op_channel']
    out['tick'] = sparse['tick']
    out['event_id'] = event_id
    out['segment_id'] = sparse['segment_id']
    out['pe_current'] = sparse['pe_current']
    return out


#: records per chunk of light_wvfm_mc_assn: 1 MiB of TRUTH_DTYPE (JAX
#: io/export.py:554)
TRUTH_CHUNK = 1 << 15
TRUTH_COMPRESSION = ('lzf', 'gzip', 'none')


def export_light_truth_to_hdf5(f, truth_data: np.ndarray,
                               compression: str = 'lzf'):
    """Append light_wvfm_mc_assn records to the open file ``f``.

    The dataset is created at the first records with the JAX package's
    layout (io/export.py:652-687): chunks of :data:`TRUTH_CHUNK` records,
    shuffled and compressed with ``compression`` ('lzf', the default;
    'gzip', as h5py takes it; or 'none': neither shuffled nor compressed,
    as the reference creates the dataset, light_sim.py:710).  Each full
    chunk is compressed and written as soon as it fills."""
    if compression not in TRUTH_COMPRESSION:
        raise ValueError(f'truth compression {compression!r}, not one of '
                         f'{TRUTH_COMPRESSION}')
    if truth_data.shape[0] == 0:
        return
    if 'light_wvfm_mc_assn' not in f:
        kw = {} if compression == 'none' else dict(compression=compression,
                                                    shuffle=True)
        f.create_dataset('light_wvfm_mc_assn', shape=(0,),
                         dtype=truth_data.dtype, maxshape=(None,),
                         chunks=(TRUTH_CHUNK,), **kw)
    f['light_wvfm_mc_assn'].append(truth_data)


def export_light_wvfm_to_hdf5(event_id, waveforms, f, sim: SimParams,
                              light: LightParams, i_mod: int = -1):
    """light_wvfm dataset (light_sim.export_light_wvfm_to_hdf5, :663-713);
    appended rows take the dtype of the first ones."""
    event_id = np.asarray(event_id)
    if event_id.shape[0] == 0:
        return
    if sim.mod2mod_variation and light.light_trig_mode == 1:
        if i_mod < 1:
            raise ValueError('mod2mod variation active but module id '
                             'not provided')
        name = f'light_wvfm/light_wvfm_mod{i_mod - 1}'
    else:
        name = 'light_wvfm'
    _append_dataset(f, name, np.asarray(waveforms))


def merge_module_light_wvfm_same_trigger(f, det_model: DetectorModel):
    """Concatenate the modules' waveform datasets along the channel axis
    into one ``light_wvfm`` (light_sim.merge_module_light_wvfm_same_trigger,
    :766-781), in the open file ``f``.  The ``light_wvfm`` group is
    unlinked; the chunks its datasets already wrote stay in the file,
    unreferenced, as h5py leaves them.  Modules with unequal trigger counts
    raise ValueError."""
    parts = []
    for i_mod in det_model.mod_ids:
        ds = f[f'light_wvfm/light_wvfm_mod{i_mod - 1}']
        if parts and ds.shape[0] != parts[0].shape[0]:
            raise ValueError('The number of triggers should be the same '
                             'in each module with light trigger mode 1')
        parts.append(np.asarray(ds))
    merged = np.concatenate(parts, axis=1)
    del f['light_wvfm']
    f.create_dataset('light_wvfm', data=merged, maxshape=(None, None, None))
