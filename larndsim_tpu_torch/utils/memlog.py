"""Wall-time and memory snapshots per labelled phase of a run.

Counterpart of ``larndsim_tpu.utils.memlog``: each snapshot holds the time
since :meth:`MemoryLogger.start`, the host memory traced by ``tracemalloc``
(now and peak) and the card's memory (``torch.cuda.memory_allocated`` in
use, ``torch.cuda.mem_get_info`` free; 0 and 0 when the run is on the
CPU).  :meth:`MemoryLogger.archive` closes a phase; :meth:`store` writes
one plain compound float64 dataset per phase with the fields of
:data:`FIELDS` into an HDF5 file (through ``io.h5``, which h5py reads), or
an ``.npz`` archive for any other file name.  :func:`read_memlog` reads
either back.
"""
from __future__ import annotations

import os
import time
import tracemalloc

import numpy as np
import torch

#: column names of each snapshot row (the reference's memory_logger.py:119)
FIELDS = ('time', 'cpu_mem_used', 'cpu_mem_peak',
          'gpu_mem_used', 'gpu_mem_free')
_DTYPE = np.dtype([(f, 'f8') for f in FIELDS])


def _is_h5(filename: str) -> bool:
    return filename.endswith(('.h5', '.hdf5'))


def _records(entries) -> np.ndarray:
    arr = np.array(entries, np.float64).reshape(-1, len(FIELDS))
    rec = np.zeros(len(arr), _DTYPE)
    for i, name in enumerate(FIELDS):
        rec[name] = arr[:, i]
    return rec


class MemoryLogger:
    """Snapshots of one run; ``disabled`` makes every method a no-op.
    ``device``: where the run works (the card's memory is read only for a
    CUDA device)."""

    def __init__(self, disabled: bool = False, device=None):
        self.disabled = disabled
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == 'cuda' else None)
        self.log: list[tuple] = []
        self.archive_log: dict[str, list] = {}
        self._t0 = None
        self._traces = False

    def start(self):
        if self.disabled:
            return
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            self._traces = True
        self._t0 = time.time()

    def _device_memory(self) -> tuple[int, int]:
        """(bytes in use, bytes free) on the run's card; (0, 0) on the
        CPU."""
        if self.device is None:
            return 0, 0
        free, _ = torch.cuda.mem_get_info(self.device)
        return int(torch.cuda.memory_allocated(self.device)), int(free)

    def take_snapshot(self):
        if self.disabled:
            return
        cpu_now, cpu_peak = (tracemalloc.get_traced_memory()
                             if tracemalloc.is_tracing() else (0, 0))
        used, free = self._device_memory()
        self.log.append((time.time() - (self._t0 or 0.0),
                         cpu_now, cpu_peak, used, free))

    def archive(self, phase: str):
        if self.disabled:
            return
        self.archive_log[phase] = list(self.log)
        self.log = []

    def store(self, filename: str | None):
        """Write the archived phases to ``filename`` (an existing HDF5
        file keeps its other members; a phase of the same name is
        replaced), and stop the host tracing this logger started."""
        if self.disabled or not filename:
            return
        if self._traces:
            tracemalloc.stop()
            self._traces = False
        if _is_h5(filename):
            self._store_hdf5(filename)
        else:
            np.savez_compressed(filename, **{
                phase: np.array(entries)
                for phase, entries in self.archive_log.items()})

    def _store_hdf5(self, filename: str):
        from ..io.h5 import File
        old = File(filename, 'r') if os.path.exists(filename) else None
        f = File(filename, 'w')
        if old is not None:
            f.members, f.attrs = old.members, old.attrs
        for phase, entries in self.archive_log.items():
            f.members.pop(phase, None)
            f.create_dataset(phase, data=_records(entries))
        f.close()


def read_memlog(filename: str) -> dict:
    """Per-phase memory tables from a ``save_memory`` HDF5 or npz file:
    ``{phase: table}``, each a pandas DataFrame where pandas imports, else
    a numpy record array with the :data:`FIELDS` columns."""
    if _is_h5(filename):
        from ..io.h5 import File
        with File(filename, 'r') as f:
            raw = {phase: np.array(f[phase]) for phase in f.keys()}
    else:
        with np.load(filename) as z:
            raw = {phase: _records(z[phase]) for phase in z.files}
    try:
        import pandas as pd
    except ImportError:
        return raw
    return {phase: pd.DataFrame.from_records(rec)
            for phase, rec in raw.items()}
