"""The comparison that decides ``correct``: a timed call's output file
against the reference's packets (``reference/charge.py``) for a sample of
the call's (spill, TPC group) units.

Numbers, each held to a limit of the configuration's ``limits``:

- ``packets_differ``: in the sampled units, the data packets (io group,
  io channel, chip, channel, timestamp, ADC word) found in one side and
  not the other, as a share of the reference's;
- ``fraction_gap_median``: over the packets found in both, the median of
  each packet's largest gap of a segment's backtracking fraction
  (``mc_packets_assn``); the largest of all, ``fraction_gap_max``, is
  printed beside it and held to no limit: a hit whose segments' currents
  nearly cancel (the bipolar induction on a neighbouring pixel) divides by
  a small total, so its fractions swing with the order of a float32 sum;
- ``assn_rows_differ``: over the whole file, packets without an
  ``mc_packets_assn`` row or rows without a packet;
- ``misplaced``: over the whole file, the share of data packets whose
  spill and io group hold no segment of the input: a packet moved to
  another spill or module.

Files are read through the frozen HDF5 reader.
"""
from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np

from .reference.frozen.io.h5 import File

PACKET_KEY = ('io_group', 'io_channel', 'chip_id', 'channel_id',
              'timestamp', 'dataword')


def _program(path: str, units) -> tuple[dict, dict]:
    """The program's data packets of each unit (event, io groups) as
    {unit: [(packet key, {segment id: fraction})]}, and the whole file's
    counts: packets, association rows and (event, io group) of every data
    packet."""
    out = defaultdict(list)
    with File(path, 'r') as f:
        if 'packets' not in f:
            return out, dict(n=0, n_assn=0, data=np.zeros((0, 2), np.int64))
        pk = np.asarray(f['packets'])
        assn = np.asarray(f['mc_packets_assn'])
    event = assn['event_ids'][:, 0] if len(assn) == len(pk) \
        else np.full(len(pk), -1)
    data = pk['packet_type'] == 0
    for unit in units:
        ev, groups = unit
        rows = np.nonzero(data & (event == ev)
                          & np.isin(pk['io_group'], groups))[0]
        for r in rows:
            key = tuple(int(pk[k][r]) for k in PACKET_KEY)
            out[unit].append((key, {int(s): float(x) for s, x in zip(
                assn['segment_ids'][r], assn['fraction'][r]) if s >= 0}))
    whole = dict(n=len(pk), n_assn=len(assn),
                 data=np.stack([event[data], pk['io_group'][data]], axis=1))
    return out, whole


def compare_units(prog: dict, reference: dict) -> dict:
    """``packets_differ`` and the fraction gaps of the packets ``prog``
    against ``reference``, both {(event, io groups): [(packet key,
    {segment: fraction})]} over the reference's units; ``n_packets``: the
    reference's packets."""
    cp, cr = Counter(), Counter()
    fp, fr = defaultdict(list), defaultdict(list)
    for unit in reference:
        for key, frac in prog[unit]:
            cp[key] += 1
            fp[key].append(frac)
        for key, frac in reference[unit]:
            cr[key] += 1
            fr[key].append(frac)
    n_ref = sum(cr.values())
    gaps = [max((abs(a.get(s, 0.0) - b.get(s, 0.0)) for s in a.keys()
                 | b.keys()), default=0.0)
            for key in cp.keys() & cr.keys()
            for a, b in zip(fp[key], fr[key])]
    return dict(packets_differ=sum(((cp - cr) + (cr - cp)).values())
                / max(n_ref, 1),
                fraction_gap_median=float(np.median(gaps)) if gaps else 0.0,
                fraction_gap_max=max(gaps, default=0.0), n_packets=n_ref)


def compare(program_file: str, reference: dict, occupied: set) -> dict:
    """Every number of the comparison, with the counts it rests on
    (``n_packets``: the reference's packets in the sample,
    ``n_file_packets``: the file's data packets).  ``reference``: the
    sampled units' packets (:func:`compare_units`); ``occupied``: the
    (event, io group) pairs that hold segments of the input."""
    prog, whole = _program(program_file, list(reference))
    home = np.array([(int(e), int(g)) in occupied for e, g in whole['data']],
                    bool)
    return dict(compare_units(prog, reference),
                assn_rows_differ=abs(whole['n'] - whole['n_assn']),
                misplaced=float((~home).sum()) / max(len(home), 1),
                n_file_packets=len(home))


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit and the sample not empty, the
    numbers beside their limits)."""
    checks = {name: dict(value=numbers.get(name, float('inf')), limit=limit)
              for name, limit in limits.items()}
    ok = (numbers.get('n_packets', 0) > 0
          and all(c['value'] <= c['limit'] for c in checks.values()))
    return ok, checks
