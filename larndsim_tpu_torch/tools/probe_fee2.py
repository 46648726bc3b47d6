"""Card probe P3: the FEE FSM kernel's structural features added one at a
time to a trivial scan, timed beside the real FSM kernel.

Counterpart of ``tools/probe_fee2.py``: the one-state scan
``s = 0.99 s + sig[t]`` (guard ``t < n_scan``) with the features named as
there, which ``csrc/probe_fee.cu`` turns into their Hopper counterparts:
``base``; ``prefetch`` (scalars and tick times staged in shared memory;
every feature but ``base`` has it); ``anyio`` (unused inputs and outputs
passed as pointers); ``vmouts`` / ``vmouts5`` (1 or 5 (n_c, max_adc, U)
output planes written every 256-tick chunk); ``bigscratch`` (227 KB of
shared memory a block); ``tailsplit`` (the guard only in the last chunk).
The kernel is built for each feature alone and for the combinations the
JAX probe's main() times (:data:`VARIANTS`).  The noise (5, n_scan_p, U)
is read and not used, as the JAX probe streams it and never reads it.

    python -m larndsim_tpu_torch.tools.probe_fee2 [--device cpu]

Every variant runs at the JAX probe's shapes (U 16384, n_scan 3805 padded
to 3840, zero signal), beside the real FSM kernel.  On the card unless ``--device cpu`` (the plain versions, host clock, said
in every line); without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import NamedTuple

import numpy as np
import torch

from .probe_fee import (CHUNK, MAX_ADC, N_SCAN, N_SCAN_P, N_TIMES, U,
                        fsm_reference_inputs, print_rows, time_variants)
from .probe_folded import resolve_device

#: the kernel's flag of each feature (csrc/probe_fee.cu); 'vmouts5' also
#: contains 'vmouts', as in the JAX probe
FLAGS = dict(anyio=2, vmouts=4, vmouts5=8, bigscratch=16, tailsplit=32)
PREFETCH = 1
#: the variants the kernel is built for: each feature alone, then the JAX
#: probe main()'s combinations
FEATURES = ('base', 'prefetch', 'anyio', 'vmouts', 'vmouts5', 'bigscratch',
            'tailsplit')
VARIANTS = FEATURES + ('vmouts+bigscratch', 'vmouts+tailsplit',
                       'vmouts+bigscratch+tailsplit')


def flags(feat: str) -> int:
    """The flag set of a feature string, read as the JAX probe reads it."""
    fl = sum(bit for name, bit in FLAGS.items() if name in feat)
    return fl | (PREFETCH if feat != 'base' else 0)


def costs(feat: str, n_pix: int, n_scan: int, n_scan_p: int,
          max_adc: int = MAX_ADC, n_times: int = N_TIMES) -> dict:
    """Bytes and operations of one variant (the guarded ticks' signal, all
    of the noise, which the kernel reads, the staged constants, the
    outputs written; 2 operations a tick) and its bound on this card."""
    from .perf_guard import bound
    fl = flags(feat)
    n_c = n_scan_p // CHUNK
    ticks = (max(n_scan, (n_c - 1) * CHUNK) if fl & FLAGS['tailsplit']
             else n_scan)
    n_bytes = (ticks + 5 * n_scan_p + 1) * n_pix * 4
    if fl & PREFETCH:
        n_bytes += (6 + n_times) * 4
    n_bytes += sum(int(np.prod(shape)) * 4 for shape, _ in
                   out_shapes(feat, n_pix, n_scan_p, max_adc)
                   if fl & FLAGS['vmouts'] and not fl & FLAGS['anyio'])
    return bound(n_bytes, 2 * ticks * n_pix)


class P3Result(NamedTuple):
    state: torch.Tensor   # (U,) final s
    outs: tuple           # the JAX probe's outputs, lanes merged into U


def out_shapes(feat: str, n_pix: int, n_scan_p: int,
               max_adc: int = MAX_ADC) -> list:
    """(shape, dtype) of the JAX probe's outputs, (U // 128, 128) lanes
    merged into U."""
    fl = flags(feat)
    n_c = n_scan_p // CHUNK
    if fl & FLAGS['anyio']:
        return [((max_adc, n_pix), torch.float32)] * 2 \
            + [((max_adc, n_pix), torch.int32)] * 2 \
            + [((1, n_pix), torch.int32)]
    if fl & FLAGS['vmouts']:
        return [((n_c, max_adc, n_pix), torch.float32)] \
            * (5 if fl & FLAGS['vmouts5'] else 1)
    return [((1, n_pix), torch.float32)]


def probe_fee2_plain(feat: str, sig, noise, scal, times, thrq, *,
                     n_scan: int, max_adc: int = MAX_ADC) -> P3Result:
    """Plain PyTorch version: a tick loop over (U,) vectors.  The state
    goes to the (1, U) output, or into every row of each ``vmouts`` plane
    at the end of every chunk; the ``anyio`` outputs are left unwritten."""
    fl = flags(feat)
    n_scan_p, n_pix = sig.shape
    n_c = n_scan_p // CHUNK
    dev = sig.device
    s = torch.zeros(n_pix, dtype=torch.float32, device=dev)
    outs = [torch.empty(shape, dtype=dt, device=dev)
            for shape, dt in out_shapes(feat, n_pix, n_scan_p, max_adc)]
    for c in range(n_c):
        guarded = not fl & FLAGS['tailsplit'] or c == n_c - 1
        for t in range(c * CHUNK, (c + 1) * CHUNK):
            if not guarded or t < n_scan:
                s = s * 0.99 + sig[t]
        if fl & FLAGS['vmouts'] and not fl & FLAGS['anyio']:
            for plane in outs:
                plane[c] = s
    if not fl & (FLAGS['anyio'] | FLAGS['vmouts']):
        outs[0][0] = s
    return P3Result(s, tuple(outs))


def probe_fee2(feat: str, sig, noise, scal, times, thrq, *, n_scan: int,
               max_adc: int = MAX_ADC) -> P3Result:
    """One P3 variant; the kernel on CUDA tensors.  ``sig`` (n_scan_p, U),
    ``noise`` (5, n_scan_p, U), ``scal`` (1, 6), ``times`` (1, n_times),
    ``thrq`` (1, U)."""
    if sig.device.type == 'cpu':
        return probe_fee2_plain(feat, sig, noise, scal, times, thrq,
                                n_scan=n_scan, max_adc=max_adc)
    fl = flags(feat)
    if fl not in {flags(v) for v in VARIANTS}:
        raise ValueError(f'the P3 kernel is built for {VARIANTS}, not '
                         f'{feat!r}')
    from ..kernels import binding
    return P3Result(*binding.probe_fee2(fl, sig, noise, scal, times, thrq,
                                        n_scan=n_scan, max_adc=max_adc))


def make_inputs(n_pix: int, n_scan_p: int, device, *, seed: int = 1,
                random_signal: bool = True) -> dict:
    """Signal (n_scan_p, U) standard normals (zeros with
    ``random_signal=False``, as the JAX probe's main() has it), noise
    (5, n_scan_p, U) standard normals, the zero constants."""
    gen = torch.Generator(device).manual_seed(seed)
    noise = torch.randn((5, n_scan_p, n_pix), generator=gen, device=device)
    sig = (torch.randn((n_scan_p, n_pix), generator=gen, device=device)
           if random_signal else
           torch.zeros((n_scan_p, n_pix), device=device))
    z = lambda *shape: torch.zeros(shape, device=device)
    return dict(sig=sig, noise=noise, scal=z(1, 6), times=z(1, N_TIMES),
                thrq=z(1, n_pix))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    dev = resolve_device(ap.parse_args(argv).device)
    inp = make_inputs(U, N_SCAN_P, dev, random_signal=False)
    rows = time_variants(
        lambda v, *a: probe_fee2(v, *a, n_scan=N_SCAN), VARIANTS,
        tuple(inp.values()), fsm_reference_inputs(U, N_SCAN, dev), dev)
    return print_rows('P3', rows, dev,
                      f'U={U}, n_scan={N_SCAN}, n_scan_p={N_SCAN_P}')


if __name__ == '__main__':
    main()
    sys.exit(0)
