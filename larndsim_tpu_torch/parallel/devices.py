"""Devices of the dispatch contexts, and tensors moved among them.

``resolve_devices`` turns the CLI's ``device`` and ``n_devices`` into one
device per dispatch context (the JAX CLI's chips, cli:304-309);
``module_devices`` gives each module its share (cli:1199-1204);
``to_device`` copies a parameter dataclass to another card,
``dispatch_stream`` keeps the contexts' CUDA streams for the process, and
``card_scope`` makes a card and a stream current for a block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings

import torch


def resolve_devices(device, n_devices: int) -> list:
    """One device per dispatch context: 'cuda' the visible cards,
    'cuda:k' that card, 'cpu' ``n_devices`` contexts on the CPU, a
    sequence as given (repeats allowed); the first ``n_devices``, clamped
    with a warning to those available.  'cuda' without a card raises."""
    n = max(int(n_devices), 1)
    if isinstance(device, (list, tuple)):
        avail = [torch.device(d) for d in device]
        if not avail:
            raise ValueError('device: an empty list')
    else:
        dev = torch.device(device)
        if dev.type != 'cuda':
            avail = [dev] * n
        elif dev.index is not None or not torch.cuda.is_available():
            avail = [dev]
        else:
            avail = [torch.device('cuda', i)
                     for i in range(torch.cuda.device_count())]
    if any(d.type == 'cuda' for d in avail) \
            and not torch.cuda.is_available():
        raise RuntimeError('device cuda requested but no CUDA device is '
                           'available')
    avail = [torch.device('cuda', 0) if d.type == 'cuda' and d.index is None
             else d for d in avail]
    if n > len(avail):
        warnings.warn(f'n_devices={n} > available {len(avail)}; clamping')
        n = len(avail)
    return avail[:n]


def module_devices(devices: list, n_modules: int) -> list:
    """Each module's share of the contexts' devices: contiguous slices
    when there are at least as many as modules, else one each, in
    turn."""
    n = len(devices)
    if n >= n_modules:
        return [devices[(p * n) // n_modules:((p + 1) * n) // n_modules]
                for p in range(n_modules)]
    return [[devices[p % n]] for p in range(n_modules)]


def to_device(obj, device):
    """``obj`` with every tensor on ``device``: a tensor, or a frozen
    dataclass whose fields hold tensors or such dataclasses; ``obj``
    itself where nothing moves."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if not dataclasses.is_dataclass(obj) or isinstance(obj, type):
        return obj
    changes = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        moved = to_device(val, device)
        if moved is not val:
            changes[f.name] = moved
    return dataclasses.replace(obj, **changes) if changes else obj


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def dispatch_stream(device, key):
    """CUDA stream ``key`` of ``device`` (None on the CPU), made at its
    first request and kept for the process: PyTorch's caching allocator
    keeps a stream's freed blocks for that stream, so a run that takes the
    streams of an earlier run finds their memory pools warm."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    with _STREAMS_LOCK:
        stream = _STREAMS.get((device, key))
        if stream is None:
            stream = _STREAMS[device, key] = torch.cuda.Stream(device)
    return stream


def card_scope(device, stream):
    """``device`` the current card and ``stream`` its current stream within
    the block; nothing on the CPU."""
    device = torch.device(device)
    if device.type != 'cuda':
        return contextlib.nullcontext()
    scope = contextlib.ExitStack()
    scope.enter_context(torch.cuda.device(device))
    scope.enter_context(torch.cuda.stream(stream))
    return scope
