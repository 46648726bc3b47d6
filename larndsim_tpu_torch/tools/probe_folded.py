"""Card probe P1: the data movement of the induced-current kernel's slab
windowing, one access pattern per case, each exact or not.

Counterpart of ``tools/probe_folded.py``, which bisected a Mosaic fault in
the folded variant of the TPU kernel with seven minimal kernels on an
(8, 32, 128) float32 slab holding ``arange``:

  a. window slab[0, 3:12, :] at a dynamic row offset (unaligned)
  b. window slab[0, 8:17, :] (aligned)
  c. roll of slab[:4, :9, :] by 91 along the last axis
  d. roll of slab[0] by 5 rows
  e. window slab[5, 3:12, :], both offsets dynamic
  f. two windows slab[:, q:q + 9, :] at q 0 and 2, copied asynchronously
     into fast memory (one TMA tensor load into shared memory here)
  g. two windows slab[:, q:q + 16, :] at q 0 and 8

Each case's output must equal the numpy value the JAX probe asserts.  The
kernels are ``csrc/probe_window.cu``; the plain versions are torch slicing,
``torch.roll`` and ``torch.stack``.  Like the JAX probe, ``main`` runs each
case in its own process: an illegal address poisons a CUDA context as a
Mosaic fault killed the TPU worker.

    python -m larndsim_tpu_torch.tools.probe_folded [CASE] [--device cpu]

On the card unless ``--device cpu`` (the plain versions, said in every
line); without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

CASES = ('a', 'b', 'c', 'd', 'e', 'f', 'g')
N_ROWS, N_SUB, LANES, GRP, N_Q = 8, 32, 128, 4, 9
#: which kernel each case launches
KERNEL = dict(a='probe_window', b='probe_window', e='probe_window',
              c='probe_roll', d='probe_roll', f='probe_async_copy',
              g='probe_async_copy')
#: the root of a checkout, for the per-case subprocesses
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def window_plain(slab, row: int, q0: int, n_q: int) -> torch.Tensor:
    return slab[row, q0:q0 + n_q].clone()


def roll_plain(x, shift: int, axis: int) -> torch.Tensor:
    return torch.roll(x, shift, axis)


def async_copy_plain(slab, q_step: int, q_sz: int,
                     n_windows: int) -> torch.Tensor:
    return torch.stack([slab[:, b * q_step:b * q_step + q_sz]
                        for b in range(n_windows)])


def window(slab, row: int, q0: int, n_q: int) -> torch.Tensor:
    """``slab[row, q0:q0 + n_q, :]``; the kernel on a CUDA tensor."""
    if slab.device.type == 'cpu':
        return window_plain(slab, row, q0, n_q)
    from ..kernels import binding
    return binding.probe_window(slab, row, q0, n_q)


def roll(x, shift: int, axis: int) -> torch.Tensor:
    """``torch.roll(x, shift, axis)``; the kernel on a CUDA tensor."""
    if x.device.type == 'cpu':
        return roll_plain(x, shift, axis)
    from ..kernels import binding
    return binding.probe_roll(x, shift, axis)


def async_copy(slab, q_step: int, q_sz: int, n_windows: int) -> torch.Tensor:
    """Windows ``slab[:, b * q_step:b * q_step + q_sz]`` stacked; the
    TMA kernel on a CUDA tensor."""
    if slab.device.type == 'cpu':
        return async_copy_plain(slab, q_step, q_sz, n_windows)
    from ..kernels import binding
    return binding.probe_async_copy(slab, q_step, q_sz, n_windows)


def slab_host() -> np.ndarray:
    return np.arange(N_ROWS * N_SUB * LANES,
                     dtype=np.float32).reshape(N_ROWS, N_SUB, LANES)


def case_call(case: str):
    """(function, its arguments as numpy or ints, the value the JAX probe
    asserts) of one case; the first argument is the array to move."""
    s = slab_host()
    if case in ('a', 'b', 'e'):
        row, q0 = (5, 3) if case == 'e' else (0, 3 if case == 'a' else 8)
        return window, (s, row, q0, N_Q), s[row, q0:q0 + N_Q]
    if case == 'c':
        x = np.ascontiguousarray(s[:GRP, :N_Q])
        return roll, (x, LANES - 37, 2), np.roll(x, LANES - 37, axis=2)
    if case == 'd':
        return roll, (s[0].copy(), 5, 0), np.roll(s[0], 5, axis=0)
    if case in ('f', 'g'):
        q_sz, q_step = (16, 8) if case == 'g' else (N_Q, 2)
        want = np.stack([s[:, :q_sz], s[:, q_step:q_step + q_sz]])
        return async_copy, (s, q_step, q_sz, 2), want
    raise ValueError(f'unknown case {case!r}; cases are {CASES}')


def run_case(case: str, device) -> np.ndarray:
    """Run one case on ``device``; raise unless it equals the JAX probe's
    numpy value.  Returns the output."""
    fn, (x, *rest), want = case_call(case)
    out = fn(torch.from_numpy(x).to(device), *rest)
    if out.device.type == 'cuda':
        torch.cuda.synchronize()
    got = out.cpu().numpy()
    np.testing.assert_array_equal(got, want, err_msg=f'case {case}')
    return got


def resolve_device(name: str) -> torch.device:
    """The probes' device: 'cuda' raises without a card (no fallback)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the probe runs on the card '
                           '(pass --device cpu for the plain versions)')
    return dev


def _foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                         'larndsim_tpu'))


def run_isolated(device: str = 'cuda', cases=CASES) -> list[dict]:
    """Each case in its own process, all started together; one record per
    case, in the order of ``cases``: ok, the process's launch counts, and
    the foreign modules it imported."""
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'larndsim_tpu_torch.tools.probe_folded',
         case, '--device', device], cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for case in cases]
    records = []
    for case, proc in zip(cases, procs):
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            raise
        lines = stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            tail = (stdout + stderr).strip().splitlines()
            rec = dict(case=case, ok=False, device=device,
                       error=tail[-1][:200] if tail else '(no output)')
        rec['rc'] = proc.returncode
        rec['ok'] = bool(rec.get('ok')) and proc.returncode == 0
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('case', nargs='?', choices=CASES,
                    help='run one case in this process')
    ap.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    opts = ap.parse_args(argv)
    dev = resolve_device(opts.device)
    mode = ('card kernels' if dev.type == 'cuda'
            else 'plain versions on the CPU')
    if opts.case:
        from ..kernels import binding
        binding.reset_launches()
        run_case(opts.case, dev)
        foreign = _foreign_modules()
        print(json.dumps(dict(case=opts.case, ok=not foreign, device=mode,
                              launches=binding.launches[KERNEL[opts.case]],
                              foreign=foreign)))
        return 0 if not foreign else 1
    records = run_isolated(opts.device)
    for rec in records:
        status = 'OK' if rec['ok'] else f'FAIL rc={rec["rc"]}'
        print(f'{rec["case"]}: {status} ({mode}) '
              f'{rec.get("error", "")}'.rstrip(), flush=True)
    return 0 if all(r['ok'] for r in records) else 1


if __name__ == '__main__':
    sys.exit(main())
