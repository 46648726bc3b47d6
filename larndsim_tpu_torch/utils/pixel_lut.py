"""Per-pixel threshold/gain lookup.

Counterpart of ``larndsim_tpu.utils.pixel_lut``: a sorted key array and a
``torch.searchsorted`` gather (in place of the reference's GPU hash table,
util/cuda_dict.py).  Loads the same npz format (``keys``, ``values``,
``default``).
"""
from __future__ import annotations

import numpy as np
import torch


class PixelLUT:
    """Static int-key -> float-value map with a default."""

    def __init__(self, keys: np.ndarray, values: np.ndarray, default: float):
        order = np.argsort(keys)
        self.keys = np.asarray(keys)[order]
        self.values = np.asarray(values)[order]
        self.default = float(np.asarray(default).ravel()[0])

    @classmethod
    def load(cls, filename: str) -> 'PixelLUT':
        data = np.load(filename)
        return cls(data['keys'], data['values'], data['default'])

    def lookup(self, query: torch.Tensor) -> torch.Tensor:
        """float32 values for the query keys (missing -> default), on the
        query's device."""
        keys = torch.as_tensor(self.keys, device=query.device)
        values = torch.as_tensor(self.values, dtype=torch.float32,
                                 device=query.device)
        q = query.to(keys.dtype)
        idx = torch.clamp(torch.searchsorted(keys, q), 0, len(self.keys) - 1)
        return torch.where(keys[idx] == q, values[idx], self.default)
