"""Native LArPix packet encoding + HDF5 writer.

Counterpart of ``larndsim_tpu.io.larpix_packets``, writing into an open
``io.h5.File`` so that no h5py is needed.  Reimplements the subset of
`larpix-control` the reference uses (fee.py:15-17: Packet_v2 /
TimestampPacket / TriggerPacket / SyncPacket +
larpix.format.hdf5format.to_file), as vectorized numpy columns instead of
one Python object per packet — the reference's per-packet object loop is a
host-side bottleneck at scale.

On-disk layout follows larpix-control's hdf5format version 2.4: a `packets`
structured dataset plus a `_header` group carrying the format version.
Column semantics:

* data packets: packet_type=0 with chip/channel/timestamp/dataword/parity;
* timestamp packets: packet_type=4, timestamp in seconds;
* message packets: packet_type=5 (unused here);
* sync packets: packet_type=6, trigger_type = sync type byte;
* trigger packets: packet_type=7, trigger_type byte.
"""
from __future__ import annotations

import numpy as np

FORMAT_VERSION = '2.4'

#: packet_type codes in the HDF5 stream
DATA_PACKET = 0
TIMESTAMP_PACKET = 4
MESSAGE_PACKET = 5
SYNC_PACKET = 6
TRIGGER_PACKET = 7

PACKET_DTYPE = np.dtype([
    ('io_group', 'u1'), ('io_channel', 'u1'), ('chip_id', 'u1'),
    ('packet_type', 'u1'), ('downstream_marker', 'u1'), ('parity', 'u1'),
    ('valid_parity', 'u1'), ('channel_id', 'u1'), ('timestamp', 'u8'),
    ('dataword', 'u1'), ('trigger_type', 'u1'), ('local_fifo', 'u1'),
    ('shared_fifo', 'u1'), ('register_address', 'u1'),
    ('register_data', 'u1'), ('direction', 'u1'),
    ('local_fifo_events', 'u1'), ('shared_fifo_events', 'u2'),
    ('counter', 'u4'), ('fifo_diagnostics_enabled', 'u1'),
    ('first_packet', 'u1'), ('receipt_timestamp', 'u8'),
])


def empty_packets(n: int) -> np.ndarray:
    return np.zeros(n, dtype=PACKET_DTYPE)


def _packet_v2_parity(words: np.ndarray) -> np.ndarray:
    """Odd parity over the 63 payload bits of the UART word (vectorized).

    Packet_v2 bit layout (LArPix-v2 UART word): packet_type[0:2],
    chip_id[2:10], channel_id[10:16], timestamp[16:47], first_packet[47],
    dataword[48:56], trigger_type[56:58], local_fifo[58:60],
    shared_fifo[60:62], downstream_marker[62], parity[63].
    """
    x = words & ((np.uint64(1) << np.uint64(63)) - np.uint64(1))
    for shift in (32, 16, 8, 4, 2, 1):
        x ^= x >> np.uint64(shift)
    return (~x & np.uint64(1)).astype('u1')


def make_data_packets(io_group, io_channel, chip_id, channel_id,
                      timestamp, dataword, receipt_timestamp=None
                      ) -> np.ndarray:
    """Vectorized Packet_v2 data packets with valid parity."""
    n = len(np.atleast_1d(io_group))
    pkts = empty_packets(n)
    pkts['packet_type'] = DATA_PACKET
    pkts['io_group'] = io_group
    pkts['io_channel'] = io_channel
    pkts['chip_id'] = chip_id
    pkts['channel_id'] = channel_id
    pkts['timestamp'] = np.asarray(timestamp, np.uint64)
    pkts['dataword'] = np.asarray(dataword).astype(np.uint64) & 0xFF
    pkts['first_packet'] = 1
    pkts['receipt_timestamp'] = (pkts['timestamp']
                                 if receipt_timestamp is None
                                 else receipt_timestamp)
    # assemble the UART word to compute real odd parity (fee.py:260)
    w = (np.uint64(0)
         | (pkts['chip_id'].astype(np.uint64) << np.uint64(2))
         | (pkts['channel_id'].astype(np.uint64) << np.uint64(10))
         | ((pkts['timestamp'] & np.uint64(0x7FFFFFFF)) << np.uint64(16))
         | (np.uint64(1) << np.uint64(47))
         | (pkts['dataword'].astype(np.uint64) << np.uint64(48)))
    pkts['parity'] = _packet_v2_parity(w)
    pkts['valid_parity'] = 1
    return pkts


def make_timestamp_packets(timestamps_s, io_group=1) -> np.ndarray:
    """TimestampPacket stream entries (timestamp in integer seconds)."""
    ts = np.atleast_1d(np.asarray(timestamps_s))
    pkts = empty_packets(len(ts))
    pkts['packet_type'] = TIMESTAMP_PACKET
    pkts['timestamp'] = ts.astype(np.uint64)
    pkts['io_group'] = io_group
    return pkts


def make_sync_packets(timestamps, io_groups, sync_type=b'S') -> np.ndarray:
    ts = np.atleast_1d(np.asarray(timestamps))
    pkts = empty_packets(len(ts))
    pkts['packet_type'] = SYNC_PACKET
    pkts['timestamp'] = ts.astype(np.uint64)
    pkts['io_group'] = io_groups
    pkts['trigger_type'] = sync_type[0]
    return pkts


def make_trigger_packets(timestamps, io_groups,
                         trigger_type=b'\x02') -> np.ndarray:
    ts = np.atleast_1d(np.asarray(timestamps))
    pkts = empty_packets(len(ts))
    pkts['packet_type'] = TRIGGER_PACKET
    pkts['timestamp'] = ts.astype(np.uint64)
    pkts['io_group'] = io_groups
    pkts['trigger_type'] = trigger_type[0]
    return pkts


def to_file(f, packets: np.ndarray) -> None:
    """Append packets to the `packets` dataset of the open file ``f``
    (hdf5format.to_file semantics: create resizable dataset + `_header` on
    first write)."""
    if '_header' not in f:
        header = f.create_group('_header')
        header.attrs['version'] = FORMAT_VERSION
        header.attrs['created'] = 0.0
        header.attrs['modified'] = 0.0
    if 'configs' not in f:
        f.create_group('configs')
    if 'packets' not in f:
        f.create_dataset('packets', data=packets, maxshape=(None,))
    else:
        f['packets'].append(packets)
