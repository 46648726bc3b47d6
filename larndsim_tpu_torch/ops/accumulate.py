"""Per-pixel signal accumulation and track <-> pixel association.

Counterpart of ``larndsim_tpu.ops.accumulate``: sort / searchsorted
primitives in place of the reference's atomic scatter-adds and linear
searches (detsim.py:468-607).  Every reduction here is deterministic:
scatters write each address at most once, and the per-pixel waveform sum
adds contributions in a fixed order (see :func:`sum_pixel_signals`): on
CUDA tensors the kernel ``csrc/pixel_sum.cu``, on CPU tensors
:func:`sum_pixel_signals_plain`, the same bits.  The kernel and the
current fractions' (``ops.fee.current_fractions``) walk each pixel's
entries in one CSR, :func:`pixel_csr`, made once a batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_INT_MAX = torch.iinfo(torch.int32).max


def _first_of_sorted(s: torch.Tensor) -> torch.Tensor:
    """Mask of first occurrences in a sorted 1D tensor (sentinel excluded)."""
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return first & (s != _INT_MAX)


def unique_pixels(pixels: torch.Tensor, max_unique: int):
    """Sorted unique pixel ids across the batch.

    Args:
        pixels: (S, P) int32 ids, -1 padding.
        max_unique: output size.

    Returns:
        (unique, n_unique): (max_unique,) int32 ids padded with -1, and the
        count as a 0-d tensor.
    """
    flat = pixels.reshape(-1)
    s = torch.sort(torch.where(flat < 0, _INT_MAX, flat)).values
    first = _first_of_sorted(s)
    dst = torch.where(first, torch.cumsum(first, 0) - 1, max_unique)
    dst = dst.clamp(max=max_unique).long()
    uniq = torch.full((max_unique + 1,), -1, dtype=torch.int32,
                      device=pixels.device)
    uniq.scatter_(0, dst, s.to(torch.int32))
    return uniq[:max_unique], first.sum().to(torch.int32)


def batch_pixel_counts(pixels: torch.Tensor, npix: torch.Tensor):
    """[total active entries, exact unique count] as one (2,) int32 tensor,
    so the host pays a single device round trip."""
    flat = pixels.reshape(-1)
    s = torch.sort(torch.where(flat < 0, _INT_MAX, flat)).values
    return torch.stack([npix.sum().to(torch.int32),
                        _first_of_sorted(s).sum().to(torch.int32)])


def pixel_index_map(pixels: torch.Tensor, uniq: torch.Tensor):
    """Index of each (segment, pixel) entry in the sorted unique array;
    (S, P) int32, -1 where the pixel is padding."""
    key = torch.where(uniq < 0, _INT_MAX, uniq)
    idx = torch.searchsorted(key, torch.where(pixels < 0, _INT_MAX, pixels))
    return torch.where(pixels < 0, -1, idx).to(torch.int32)


def _group_rank(sorted_key: torch.Tensor) -> torch.Tensor:
    """Rank of each element within its run of equal keys."""
    n = sorted_key.shape[0]
    group_start = torch.ones(n, dtype=torch.bool, device=sorted_key.device)
    group_start[1:] = sorted_key[1:] != sorted_key[:-1]
    pos = torch.arange(n, device=sorted_key.device)
    start_pos = torch.cummax(torch.where(group_start, pos, 0), dim=0).values
    return (pos - start_pos).to(torch.int32)


def track_pixel_map(pix_idx: torch.Tensor, distances: torch.Tensor,
                    n_unique_cap: int, *, max_tracks: int):
    """Per-unique-pixel list of contributing segment indices.

    Segments are slotted in ascending backtrack-distance order, ties broken
    by segment index (one stable sort on a combined key; the flatten order
    is segment-major).

    Returns:
        track_map: (n_unique_cap, max_tracks) int32 segment indices, -1 pad.
        slot: (S, P) int32 slot of each entry (-1 if overflowed or padding).
        overflow: (n_unique_cap,) bool overflow flags.
    """
    S, P = pix_idx.shape
    dev = pix_idx.device
    flat_pix = pix_idx.reshape(-1)
    flat_seg = torch.arange(S, dtype=torch.int32,
                            device=dev).repeat_interleave(P)
    flat_dist = torch.where(distances < 0, 15, distances).reshape(-1)
    flat_pix_key = torch.where(flat_pix < 0, n_unique_cap, flat_pix)

    combined = flat_pix_key * 16 + flat_dist
    order = torch.sort(combined, stable=True).indices
    sp = flat_pix_key[order]
    sp = torch.where(sp >= n_unique_cap, _INT_MAX, sp)
    ss = flat_seg[order]
    rank = _group_rank(sp)

    # entries beyond the backtrack range (code -1 -> 15) are never stored
    # (detsim.py:582-591) and raise the overflow flag
    sd = flat_dist[order]
    present = sp != _INT_MAX
    valid = present & (rank < max_tracks) & (sd < 15)
    # invalid entries write to a sink row that is sliced off
    track_map = torch.full((n_unique_cap + 1, max_tracks), -1,
                           dtype=torch.int32, device=dev)
    track_map[torch.where(valid, sp, n_unique_cap).long(),
              torch.where(valid, rank, 0).long()] = ss
    overflow = torch.zeros(n_unique_cap + 1, dtype=torch.bool, device=dev)
    overflow[torch.where(present & ~valid, sp, n_unique_cap).long()] = True

    slot = torch.empty(S * P, dtype=torch.int32, device=dev)
    slot[order] = torch.where(valid, rank, -1)
    return track_map[:n_unique_cap], slot.reshape(S, P), \
        overflow[:n_unique_cap]


def _start_ticks(track_starts: torch.Tensor, T: int, n_ticks: int,
                 dt: torch.Tensor) -> torch.Tensor:
    """Each entry window's first global tick, round(track_start / dt),
    clamped as the JAX op clamps it (int64)."""
    start_tick = torch.round(track_starts / dt).to(torch.int64)
    # the JAX op places each window at clip(start + T, 0, n_ticks + T) in a
    # buffer padded by T ticks in front
    return torch.clamp(start_tick + T, 0, n_ticks + T) - T


def _sort_by_pixel(pix_idx: torch.Tensor):
    """The flat (segment, pixel) entries stably sorted by pixel, padding
    (-1) last: (sorted keys, entry indices)."""
    flat_pix = pix_idx.reshape(-1)
    return torch.sort(torch.where(flat_pix < 0, _INT_MAX, flat_pix),
                      stable=True)


class PixelCSR(NamedTuple):
    """Each pixel's (segment, pixel) entries, in ascending flat order:
    pixel u's are ``pairs[offsets[u]:offsets[u + 1]]``."""
    pairs: torch.Tensor    # (S * P, 2) int32 (flat entry s * P + p, start
    #                        tick of segment s); padding entries last
    offsets: torch.Tensor  # (n_unique_cap + 1,) int32


def pixel_csr(pix_idx: torch.Tensor, track_starts: torch.Tensor,
              n_unique_cap: int, *, time_sampling: float) -> PixelCSR:
    """The CSR that the waveform-sum and current-fraction kernels walk,
    made on the tensors' device with no read to the host: the flat
    entries in :func:`sum_pixel_signals_plain`'s order (stable by pixel),
    each beside its segment's first tick, round(track_start / dt) in
    float32 (not clamped: the fractions take it as it is, and the clamp of
    the plain waveform sum only moves windows that miss the readout)."""
    S, P = pix_idx.shape
    dev = pix_idx.device
    # a fill, not a copy from the host: the same float32 as torch.tensor
    dt = torch.full((), time_sampling, dtype=torch.float32, device=dev)
    start = torch.round(track_starts / dt).to(torch.int32)
    keys, entries = _sort_by_pixel(pix_idx)
    offsets = torch.searchsorted(
        keys, torch.arange(n_unique_cap + 1, dtype=keys.dtype, device=dev),
        out_int32=True)
    pairs = torch.stack([entries.to(torch.int32),
                         start[torch.div(entries, P,
                                         rounding_mode='floor')]], dim=1)
    return PixelCSR(pairs, offsets)


def sum_pixel_signals(signals: torch.Tensor, pix_idx: torch.Tensor,
                      track_starts: torch.Tensor, n_unique_cap: int, *,
                      n_ticks: int, time_sampling: float,
                      rows: int | None = None,
                      csr: PixelCSR | None = None):
    """Sum per-(segment, pixel) signal windows into per-pixel waveforms;
    the kernel ``csrc/pixel_sum.cu`` on CUDA tensors (its CSR ``csr``, or
    :func:`pixel_csr` made here), :func:`sum_pixel_signals_plain` on CPU
    tensors, the same bits.

    Returns:
        (n_unique_cap, n_ticks) float32 summed waveforms; with ``rows``,
        the FSM's (rows, n_unique_cap) tick-major input instead: the
        waveforms transposed, cut or zero-padded to ``rows`` ticks (on the
        card written so by the kernel; the first form is a transposed view
        of its rows).
    """
    if signals.device.type == 'cpu':
        return sum_pixel_signals_plain(
            signals, pix_idx, track_starts, n_unique_cap, n_ticks=n_ticks,
            time_sampling=time_sampling, rows=rows)
    from ..kernels import binding
    if csr is None:
        csr = pixel_csr(pix_idx, track_starts, n_unique_cap,
                        time_sampling=time_sampling)
    out = binding.sum_pixel_rows(signals, csr.pairs, csr.offsets, n_ticks,
                                 n_ticks if rows is None else rows)
    return out.t() if rows is None else out


def sum_pixel_signals_plain(signals: torch.Tensor, pix_idx: torch.Tensor,
                            track_starts: torch.Tensor, n_unique_cap: int, *,
                            n_ticks: int, time_sampling: float,
                            rows: int | None = None):
    """Plain PyTorch version of the waveform-sum kernel.

    (reference detsim.sum_pixel_signals.)  Each entry's window starts at
    global tick round(track_start / dt), clamped as the JAX op clamps it;
    ticks outside [0, n_ticks) are dropped.  Entries of one pixel are
    added in ascending segment order: pass k adds every pixel's k-th
    entry, and within a pass every address is written once, so the sum is
    the same bits on every run and every device.  The number of passes is
    read back to the host.

    Returns:
        (n_unique_cap, n_ticks) float32 summed waveforms; with ``rows``,
        their zero-padded (or cut) transpose, (rows, n_unique_cap).
    """
    S, P, T = signals.shape
    U = n_unique_cap
    dev = signals.device
    dt = torch.tensor(time_sampling, dtype=torch.float32, device=dev)
    start_tick = _start_ticks(track_starts, T, n_ticks, dt)

    order = _sort_by_pixel(pix_idx)
    present = order.values != _INT_MAX
    rank = torch.where(present, _group_rank(order.values), -1)
    n_pass = int(rank.max()) + 1 if rank.numel() else 0
    # table[k, u]: pixel u's k-th entry, -1 where it has fewer; padding
    # entries land in a sink element that is sliced off
    table = torch.full((n_pass + 1, U + 1), -1, dtype=torch.int64,
                       device=dev)
    table[torch.where(present, rank, n_pass).long(),
          torch.where(present, order.values, U).long()] = order.indices
    sig = signals.reshape(S * P, T)
    t = torch.arange(T, device=dev)
    row0 = torch.arange(U, device=dev)[:, None] * n_ticks
    sink = U * n_ticks
    acc = torch.zeros(sink + 1, dtype=torch.float32, device=dev)
    for k in range(n_pass):
        e = table[k, :U]
        g = start_tick[torch.clamp(e, min=0) // P][:, None] + t   # (U, T)
        keep = (e >= 0)[:, None] & (g >= 0) & (g < n_ticks)
        idx = torch.where(keep, row0 + g, sink)
        acc[idx] = acc[idx] + torch.where(keep, sig[torch.clamp(e, min=0)],
                                          0.0)
    wave = acc[:sink].view(U, n_ticks)
    if rows is None:
        return wave
    out = torch.zeros((rows, U), dtype=torch.float32, device=dev)
    out[:min(rows, n_ticks)] = wave.t()[:rows]
    return out
