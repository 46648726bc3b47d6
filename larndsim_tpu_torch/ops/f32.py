"""Float32 arithmetic that rounds as the JAX package's does."""
from __future__ import annotations

import torch


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as a true float32 division by ``v`` rounded to float32.

    PyTorch's CUDA kernel turns a division by a Python number into a
    multiplication by its reciprocal, which rounds differently from the
    division XLA performs; a divisor tensor on ``x``'s device keeps the
    division true on every device.
    """
    return x / torch.tensor(v, dtype=torch.float32, device=x.device)
