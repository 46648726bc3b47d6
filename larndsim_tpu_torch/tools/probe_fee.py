"""Card probe P2: ablated variants of the FEE FSM's tick loop (non-physical
outputs), timed beside the real FSM kernel to attribute its per-tick cost.

Counterpart of ``tools/probe_fee.py``.  Every variant runs the recurrence
of ``csrc/probe_fee.cu`` (states a..g per pixel, the guard ``t < n_scan``,
the final ``a`` as the output) with parts taken away, named as in the JAX
probe's ``ablate`` string: ``full`` (nothing taken away), ``consts``,
``outs``, ``noguard``, ``nosig``, ``nonoise``, ``nostate``, ``intops``,
``anyred`` (see the CUDA source).  The kernel runs on K2's structure
(blocks of 64 pixels, a register ring of 16 ticks; ``anyred`` the JAX
tile of 1024 pixels and a ring of 4), so each variant's share of K2 says
what that part costs in the kernel the chain ships.  It is built for each
of these; the plain version (a PyTorch tick loop over (U,) vectors) also
takes their combinations.

    python -m larndsim_tpu_torch.tools.probe_fee [--device cpu]

Every variant runs at the JAX probe's shapes (U 16384, n_scan 3805 padded
to 3840, zero signal); its time on the card is printed beside the real FSM
kernel (``csrc/fee_fsm.cu``) at the same U and n_scan, as a share of it.  On the
card unless ``--device cpu`` (the plain versions, host clock, said in
every line); without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import torch

from .perf_guard import card_name, timed
from .probe_folded import resolve_device

TILE, CHUNK = 1024, 256
#: the probe shapes of the JAX probe's main()
U, N_SCAN, N_SCAN_P, MAX_ADC, N_TIMES = 16384, 3805, 3840, 30, 2049
#: the kernel's flag of each ablation (csrc/probe_fee.cu)
FLAGS = dict(consts=1, outs=2, noguard=4, nosig=8, nonoise=16, nostate=32,
             intops=64, anyred=128)
#: the variants the kernel is built for
VARIANTS = ('full', *FLAGS)


def flags(ablate: str) -> int:
    """The flag set of an ``ablate`` string; as in the JAX probe, a name
    counts wherever it appears ('full+consts' is 'consts')."""
    return sum(bit for name, bit in FLAGS.items() if name in ablate)


#: float32 operations per guarded (tick, pixel): the recurrence a..g
#: (a 2, the a > 0.5 test 1, b and c 2, d, e, f and g 2 each) and
#: anyred's test; nostate's five adds; intops' product, two adds and test
#: (its int32 counters are not counted)
_OPS = dict(full=13, anyred=14, nostate=5, intops=4)
#: noise rows a tick's body reads, where not all five
_NOISE_ROWS = dict(intops=2)


def costs(ablate: str, n_pix: int, n_scan: int, n_scan_p: int,
          max_adc: int = MAX_ADC, n_times: int = N_TIMES) -> dict:
    """Bytes and operations of one variant (each input row its body reads
    read once, each output written once; the guarded ticks only) and its
    bound on this card (``perf_guard.bound``)."""
    from .perf_guard import bound
    fl = flags(ablate)
    kind = ('nostate' if fl & FLAGS['nostate'] else
            'intops' if fl & FLAGS['intops'] else
            'anyred' if fl & FLAGS['anyred'] else 'full')
    ticks = n_scan_p if fl & FLAGS['noguard'] else n_scan
    n_bytes = (1 + 8 + 4) * n_pix * 4
    if not fl & FLAGS['nosig']:
        n_bytes += ticks * n_pix * 4
    if not fl & FLAGS['nonoise']:
        n_bytes += _NOISE_ROWS.get(kind, 5) * ticks * n_pix * 4
    if fl & FLAGS['consts']:
        n_bytes += (6 + n_times + 2 * n_pix) * 4
    if fl & FLAGS['outs']:
        n_bytes += 4 * max_adc * n_pix * 4
    return bound(n_bytes, _OPS[kind] * ticks * n_pix)


class P2Result(NamedTuple):
    out: torch.Tensor       # (1, U) final a: the JAX probe's output
    outs: tuple             # 4 (max_adc, U) planes with `outs`, else ()
    fstate: torch.Tensor    # (8, U) final float states a..g and 7
    istate: torch.Tensor    # (4, U) final int32 states (intops)


def probe_fee_plain(ablate: str, sig, noise, scal, times, thr, q0, *,
                    n_scan: int, max_adc: int = MAX_ADC) -> P2Result:
    """Plain PyTorch version: the JAX probe's tick body over (U,) vectors.
    ``sig`` (n_scan_p, U), ``noise`` (n_scan_p, 5, U); the constants are
    inputs of the ``consts`` variant that nothing reads."""
    fl = flags(ablate)
    n_scan_p, n_pix = sig.shape
    dev = sig.device
    fs = [torch.zeros(n_pix, dtype=torch.float32, device=dev)
          for _ in range(8)]
    ist = [torch.zeros(n_pix, dtype=torch.int32, device=dev)
           for _ in range(4)]
    # the JAX grid runs n_scan_p // CHUNK chunks of CHUNK ticks
    for t in range(n_scan_p // CHUNK * CHUNK):
        if not fl & FLAGS['noguard'] and t >= n_scan:
            break
        cur = fs[7] if fl & FLAGS['nosig'] else sig[t]
        rows = ([fs[7]] * 5 if fl & FLAGS['nonoise']
                else list(noise[t].unbind(0)))
        if fl & FLAGS['nostate']:
            fs[0] = cur + rows[0] + rows[1] + rows[2] + rows[3] + rows[4]
        elif fl & FLAGS['intops']:
            b0, i0, s0, lr0 = ist
            skipping, integrating = s0 > 0, i0 > 0
            ir = torch.where(integrating & ~skipping, i0 - 1, i0)
            latch = integrating & ~skipping & (ir == 0)
            a = fs[0] * 0.99 + cur
            fire = ~skipping & ~integrating & (a + rows[0] >= rows[1])
            ir = torch.where(fire, 7, ir)
            sr = torch.where(s0 > 0, s0 - 1, 0)
            sr = torch.where(latch, 3, sr)
            lr = torch.where(latch, t + 4, lr0)
            busy = torch.where(~skipping & ~integrating,
                               torch.clamp(b0 - 1, min=0), b0)
            busy = torch.where(latch, 9, busy)
            fs[0] = torch.where(latch, 0.0, a)
            ist = [busy.to(torch.int32), ir.to(torch.int32),
                   sr.to(torch.int32), lr.to(torch.int32)]
        else:
            a = fs[0] * 0.99 + cur
            b = torch.where(a > 0.5, fs[1] + rows[0], fs[1])
            cc = torch.where(a > 0.5, fs[2] + rows[1], fs[2])
            d = torch.where(b > cc, fs[3] + rows[2], fs[3])
            e = torch.where(d > 0, fs[4] + rows[3], fs[4])
            f = torch.where(e > 0, fs[5] + rows[4], fs[5])
            g = torch.where(f > 1e9, 0.0, fs[6] + 1.0)
            if fl & FLAGS['anyred']:
                hit = (b > 1e30).reshape(-1, TILE).any(dim=1)
                fs[7] = torch.where(hit.repeat_interleave(TILE),
                                    fs[7] + 1.0, fs[7])
            fs[:7] = [a, b, cc, d, e, f, g]
    planes = ()
    if fl & FLAGS['outs']:
        planes = tuple(torch.full((max_adc, n_pix), fill, dtype=dt,
                                  device=dev)
                       for fill, dt in ((0.0, torch.float32),
                                        (-1, torch.int32),
                                        (0.0, torch.float32),
                                        (-1, torch.int32)))
    return P2Result(fs[0][None].clone(), planes, torch.stack(fs),
                    torch.stack(ist))


def probe_fee(ablate: str, sig, noise, scal, times, thr, q0, *,
              n_scan: int, max_adc: int = MAX_ADC) -> P2Result:
    """One P2 variant; the kernel on CUDA tensors (see
    :func:`probe_fee_plain` for the arguments)."""
    if sig.device.type == 'cpu':
        return probe_fee_plain(ablate, sig, noise, scal, times, thr, q0,
                               n_scan=n_scan, max_adc=max_adc)
    fl = flags(ablate)
    if fl not in {flags(v) for v in VARIANTS}:
        raise ValueError(f'the P2 kernel is built for {VARIANTS}, not '
                         f'{ablate!r}')
    from ..kernels import binding
    return P2Result(*binding.probe_fee(fl, sig, noise, scal, times, thr, q0,
                                       n_scan=n_scan, max_adc=max_adc))


def make_inputs(n_pix: int, n_scan_p: int, device, *, seed: int = 1,
                random_signal: bool = True) -> dict:
    """The probe's inputs, drawn on ``device`` from ``seed``: signal
    (n_scan_p, U) standard normals (zeros, as the JAX probe's main() has
    them, with ``random_signal=False``), noise (n_scan_p, 5, U) standard
    normals, and the zero constants of ``consts``."""
    gen = torch.Generator(device).manual_seed(seed)
    noise = torch.randn((n_scan_p, 5, n_pix), generator=gen, device=device)
    sig = (torch.randn((n_scan_p, n_pix), generator=gen, device=device)
           if random_signal else
           torch.zeros((n_scan_p, n_pix), device=device))
    z = lambda *shape: torch.zeros(shape, device=device)
    return dict(sig=sig, noise=noise, scal=z(1, 6), times=z(1, N_TIMES),
                thr=z(1, n_pix), q0=z(1, n_pix))


def fsm_reference_inputs(n_pix: int, n_scan: int, device, seed: int = 11):
    """Arguments of ``ops.fee.fee_fsm`` (the real FSM, K2) at U and n_scan:
    a Module-0 detector's FSM constants (generated tree, loader defaults),
    a sparse drawn signal that fires, standard-normal noise."""
    from ..assets.geometry import write_module0
    from ..ops import fee
    from ..params import load_detector
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_module0(os.path.join(tmp, 'm0'), tiles=(1, 1),
                              pixels_per_tile=14)
        det = load_detector(paths['detector_properties'],
                            paths['pixel_layout'], device=device).params
    gen = torch.Generator(device).manual_seed(seed)
    sig = torch.rand((n_scan, n_pix), generator=gen, device=device) * 30000.0
    sig = torch.where(torch.rand((n_scan, n_pix), generator=gen,
                                 device=device) > 0.97, sig, 0.0)
    sig[det.time_ticks:] = 0.0
    s = fee.fsm_scalars(det, max_adc=MAX_ADC)
    return (sig, torch.randn((n_scan, 5, n_pix), generator=gen, device=device),
            torch.randn((n_pix,), generator=gen, device=device) * s.sigma_reset,
            torch.full((n_pix,), det.f32('discrimination_threshold'),
                       device=device),
            fee.tick_times(det), s)


def host_seconds(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def time_variants(call, variants, args, fsm_args, device) -> dict:
    """Time each variant ``call(v, *args)`` and the real FSM on ``device``:
    on the card, CUDA events (min and mean ms, and the share of the FSM's
    min); on the CPU, one host-clock run each."""
    from ..ops import fee
    rows = {}
    if device.type == 'cuda':
        ref = timed(fee.fee_fsm, *fsm_args)
        rows['fee_fsm (K2)'] = dict(min_ms=ref.min_ms, mean_ms=ref.mean_ms,
                                    share_of_k2=1.0)
        for v in variants:
            t = timed(call, v, *args)
            rows[v] = dict(min_ms=t.min_ms, mean_ms=t.mean_ms,
                           share_of_k2=t.min_ms / ref.min_ms)
    else:
        rows['fee_fsm (K2)'] = dict(
            cpu_wall_s=host_seconds(fee.fee_fsm, *fsm_args))
        for v in variants:
            rows[v] = dict(cpu_wall_s=host_seconds(call, v, *args))
    return rows


def print_rows(probe: str, rows: dict, device, shape: str) -> dict:
    where = (card_name() if device.type == 'cuda'
             else 'plain versions on the CPU, host clock (not a card time)')
    for name, r in rows.items():
        if 'min_ms' in r:
            msg = (f'{r["min_ms"]:9.3f} ms min, {r["mean_ms"]:9.3f} ms mean,'
                   f' {r["share_of_k2"]:7.3f} x K2')
        else:
            msg = f'{r["cpu_wall_s"]:9.3f} s'
        print(f'{probe} {name:>28}: {msg}  [{shape}; {where}]', flush=True)
    record = dict(probe=probe, shape=shape, device=where, rows=rows)
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    dev = resolve_device(ap.parse_args(argv).device)
    inp = make_inputs(U, N_SCAN_P, dev, random_signal=False)
    rows = time_variants(
        lambda v, *a: probe_fee(v, *a, n_scan=N_SCAN), VARIANTS,
        tuple(inp.values()), fsm_reference_inputs(U, N_SCAN, dev), dev)
    return print_rows('P2', rows, dev,
                      f'U={U}, n_scan={N_SCAN}, n_scan_p={N_SCAN_P}')


if __name__ == '__main__':
    main()
    sys.exit(0)
