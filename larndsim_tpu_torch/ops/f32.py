"""Float32 arithmetic that rounds as the JAX package's does."""
from __future__ import annotations

import numpy as np
import torch


def div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as a true float32 division by ``v`` rounded to float32.

    PyTorch's CUDA kernel turns a division by a Python number into a
    multiplication by its reciprocal, which rounds differently from the
    division XLA performs; a divisor tensor on ``x``'s device keeps the
    division true on every device.
    """
    return x / torch.tensor(v, dtype=torch.float32, device=x.device)


def div_const(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` for a constant ``v`` as the JAX package's jitted ops
    compute it: XLA folds the division by a constant into a multiplication
    by its float32 reciprocal, ``float32(1) / float32(v)``.  The
    reciprocal is a float32 value, so multiplying by it as a Python number
    (which the float32 kernels take as float32) gives the same bits as a
    float32 tensor would, and copies nothing to the device."""
    with np.errstate(divide='ignore'):
        inv = np.float32(1.0) / np.float32(v)
    return x * float(inv)


def fma(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 ``a`` and ``c``, rounded once to float32,
    as XLA's CPU backend computes the JAX package's multiply-adds (it
    contracts them into fused multiply-adds).  The product of two float32
    values is exact in float64 and the sum is rounded to float64 and then
    to float32, so both devices give the same bits (a single rounding but
    for ties of the two roundings, about one case in 2^29)."""
    b32 = float(np.float32(b))
    return (a.double() * b32 + c.double()).float()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 whatever the caller's global setting: the
    JAX package's ``Precision.HIGHEST``.  On the card, TF32 (10 mantissa
    bits), which ``torch.backends.cuda.matmul.allow_tf32`` turns on, is
    turned off for this one call and the caller's setting restored (the
    flag the rest of the package sets; PyTorch refuses to read the matmul
    precision once it was set through both this flag and
    ``torch.set_float32_matmul_precision``).  The CPU computes float32
    products in float32."""
    if a.device.type != 'cuda':
        return a @ b
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = prev
