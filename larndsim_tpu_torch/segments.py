"""Track-segment batch as a dataclass of tensors (one per field).

Counterpart of ``larndsim_tpu.segments``: float32 and int32 columns of the
edep-sim ``segments`` dtype plus a ``valid`` mask, so batches can be padded
to bucketed sizes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params.detector import card_or

FLOAT_FIELDS = (
    'x_start', 'y_start', 'z_start', 'x_end', 'y_end', 'z_end',
    'x', 'y', 'z', 'dx', 'dE', 'dEdx',
    't0', 't0_start', 't0_end', 't', 't_start', 't_end',
    'n_electrons', 'n_photons', 'long_diff', 'tran_diff',
)
INT_FIELDS = ('event_id', 'segment_id', 'traj_id', 'pixel_plane')


@dataclasses.dataclass(frozen=True)
class Segments:
    x_start: torch.Tensor; y_start: torch.Tensor; z_start: torch.Tensor
    x_end: torch.Tensor; y_end: torch.Tensor; z_end: torch.Tensor
    x: torch.Tensor; y: torch.Tensor; z: torch.Tensor
    dx: torch.Tensor; dE: torch.Tensor; dEdx: torch.Tensor
    t0: torch.Tensor; t0_start: torch.Tensor; t0_end: torch.Tensor
    t: torch.Tensor; t_start: torch.Tensor; t_end: torch.Tensor
    n_electrons: torch.Tensor; n_photons: torch.Tensor
    long_diff: torch.Tensor; tran_diff: torch.Tensor
    event_id: torch.Tensor; segment_id: torch.Tensor
    traj_id: torch.Tensor; pixel_plane: torch.Tensor
    valid: torch.Tensor  # bool mask: False on padding rows

    @property
    def size(self) -> int:
        """Rows of the batch (of each event's row of a stacked group)."""
        return self.x_start.shape[-1]

    def event(self, g: int) -> 'Segments':
        """Event ``g`` of a stacked (G, S) group, as an (S,) batch."""
        return Segments(**{f.name: getattr(self, f.name)[g]
                           for f in dataclasses.fields(self)})

    def replace(self, **changes) -> 'Segments':
        return dataclasses.replace(self, **changes)


def from_structured(tracks: np.ndarray, pad_to: int | None = None,
                    device='cuda') -> Segments:
    """Structured edep-sim array -> :class:`Segments` on ``device`` (the
    card unless the caller names another; raises without one).

    Args:
        tracks: structured array with (a superset of) the segment fields.
        pad_to: optional row count; extra rows are zero/invalid.
    """
    device = card_or(device, 'the segments')
    n = tracks.shape[0]
    m = pad_to if pad_to is not None else n
    if m < n:
        raise ValueError(f'pad_to={m} < batch size {n}')
    names = tracks.dtype.names or ()

    def field(name, dtype):
        if name == 'traj_id' and 'traj_id' not in names \
                and 'file_traj_id' in names:
            src = tracks['file_traj_id']
        elif name in names:
            src = tracks[name]
        else:
            src = np.zeros(n)
        out = np.zeros(m, dtype=dtype)
        out[:n] = src.astype(dtype)
        return torch.from_numpy(out).to(device)

    kwargs = {name: field(name, np.float32) for name in FLOAT_FIELDS}
    kwargs.update({name: field(name, np.int32) for name in INT_FIELDS})
    valid = np.zeros(m, bool)
    valid[:n] = True
    return Segments(valid=torch.from_numpy(valid).to(device), **kwargs)


def from_structured_group(tracks_list: list, pad_to: int,
                          device='cuda') -> Segments:
    """G event batches stacked into a (G, pad_to)-shaped :class:`Segments`
    on ``device`` (the card unless the caller names another): row g holds
    ``tracks_list[g]``, zero/invalid past its length."""
    device = card_or(device, 'the segments')
    G = len(tracks_list)

    def field(name, dtype):
        out = np.zeros((G, pad_to), dtype=dtype)
        for g, tracks in enumerate(tracks_list):
            names = tracks.dtype.names or ()
            if name == 'traj_id' and 'traj_id' not in names \
                    and 'file_traj_id' in names:
                src = tracks['file_traj_id']
            elif name in names:
                src = tracks[name]
            else:
                src = np.zeros(tracks.shape[0])
            out[g, :tracks.shape[0]] = src.astype(dtype)
        return torch.from_numpy(out).to(device)

    kwargs = {name: field(name, np.float32) for name in FLOAT_FIELDS}
    kwargs.update({name: field(name, np.int32) for name in INT_FIELDS})
    valid = np.zeros((G, pad_to), bool)
    for g, tracks in enumerate(tracks_list):
        valid[g, :tracks.shape[0]] = True
    return Segments(valid=torch.from_numpy(valid).to(device), **kwargs)


def stack(batches: list) -> Segments:
    """Batches of one size stacked into a (G, S) group, on their device."""
    return Segments(**{f.name: torch.stack([getattr(b, f.name)
                                            for b in batches])
                       for f in dataclasses.fields(Segments)})


def to_structured(segs: Segments, dtype: np.dtype | None = None) -> np.ndarray:
    """Materialize the valid rows back into a structured array."""
    valid = segs.valid.cpu().numpy()
    if dtype is None:
        dtype = np.dtype([(name, 'f4') for name in FLOAT_FIELDS]
                         + [(name, 'i4') for name in INT_FIELDS])
    out = np.zeros(int(valid.sum()), dtype=dtype)
    for name in dtype.names:
        if hasattr(segs, name):
            col = getattr(segs, name).cpu().numpy()[valid]
            out[name] = col.astype(out[name].dtype)
    return out
