"""ctypes wrappers that launch the CUDA kernels on PyTorch's current stream.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches, raises if the launch reports an
error, and counts the launch in :data:`launches`.  Callers reach them
through the dispatching functions ``ops.current.induced_current`` and
``ops.fee.fee_fsm``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: kernel launches by kernel name since the last :func:`reset_launches`;
#: a run reads them to show that its main path went through the kernels
launches = {'induced_current': 0, 'fee_fsm': 0}

_SIGNATURES = {
    'induced_current_launch': [_P] * 12 + [_I] * 8 + [_F] * 5 + [_P],
    'fee_fsm_launch': [_P] * 10 + [_F] * 7 + [_I] * 7 + [_P],
}


def _lib() -> ctypes.CDLL:
    lib = build.load()
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f'{name}: on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected {shape}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: not contiguous')


def _raise_on(err: int, kernel: str) -> None:
    if err:
        raise RuntimeError(f'{kernel}: CUDA error {err} at launch')


def induced_current(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo,
                    tick_hi, scale, resp, lut) -> torch.Tensor:
    """Launch ``csrc/induced_current.cu``; see ops.current.induced_current."""
    dev = xs.device
    if dev.type != 'cuda':
        raise ValueError('induced_current kernel needs CUDA tensors, '
                         f'got {dev}')
    S, n_steps = xs.shape
    P = pxc.shape[1]
    t_sig = scale.shape[1]
    n_rows, ntp = resp.shape
    if n_rows != lut.zero_row + 1:
        raise ValueError(f'response has {n_rows} rows, expected '
                         f'{lut.zero_row + 1}')
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ('xs', xs, f32, (S, n_steps)), ('ys', ys, f32, (S, n_steps)),
            ('shift', shift, i32, (S, n_steps)),
            ('phase', phase, i32, (S, n_steps)),
            ('pxc', pxc, f32, (S, P)), ('pyc', pyc, f32, (S, P)),
            ('nstep', nstep, i32, (S,)), ('tick_lo', tick_lo, i32, (S,)),
            ('tick_hi', tick_hi, i32, (S,)),
            ('scale', scale, f32, (S, t_sig)),
            ('resp', resp, f32, (n_rows, ntp))):
        _check(name, t, dt, shape, dev)
    out = torch.empty((S, P, t_sig), dtype=f32, device=dev)
    if out.numel() == 0:
        return out
    err = _lib().induced_current_launch(
        xs.data_ptr(), ys.data_ptr(), shift.data_ptr(), phase.data_ptr(),
        pxc.data_ptr(), pyc.data_ptr(), nstep.data_ptr(),
        tick_lo.data_ptr(), tick_hi.data_ptr(), scale.data_ptr(),
        resp.data_ptr(), out.data_ptr(),
        S, P, n_steps, t_sig, ntp, lut.nx_r, lut.ny_r, lut.ratio,
        lut.inv_bin, lut.lim_x, lut.lim_y, lut.max_x, lut.max_y,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, 'induced_current')
    launches['induced_current'] += 1
    return out


def fee_fsm(sig_rows, noise, q_init, thresholds, tick_times, s):
    """Launch ``csrc/fee_fsm.cu``; see ops.fee.fee_fsm.

    Returns (integrals, ticks, n_adc, reset_start, latch_end).
    """
    dev = sig_rows.device
    if dev.type != 'cuda':
        raise ValueError(f'fee_fsm kernel needs CUDA tensors, got {dev}')
    n_scan, U = sig_rows.shape
    n_times = tick_times.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, t, dt, shape in (
            ('sig_rows', sig_rows, f32, (n_scan, U)),
            ('noise', noise, f32, (n_scan, 5, U)),
            ('q_init', q_init, f32, (U,)),
            ('thresholds', thresholds, f32, (U,)),
            ('tick_times', tick_times, f32, (n_times,))):
        _check(name, t, dt, shape, dev)
    m = s.max_adc
    integrals = torch.empty((U, m), dtype=f32, device=dev)
    ticks = torch.empty((U, m), dtype=f32, device=dev)
    n_adc = torch.empty((U,), dtype=i32, device=dev)
    reset_start = torch.empty((U, m), dtype=i32, device=dev)
    latch_end = torch.empty((U, m), dtype=i32, device=dev)
    if U == 0:
        return integrals, ticks, n_adc, reset_start, latch_end
    err = _lib().fee_fsm_launch(
        sig_rows.data_ptr(), noise.data_ptr(), q_init.data_ptr(),
        thresholds.data_ptr(), tick_times.data_ptr(),
        integrals.data_ptr(), ticks.data_ptr(), n_adc.data_ptr(),
        reset_start.data_ptr(), latch_end.data_ptr(),
        s.A, s.dt, s.C, s.sigma_uncorr, s.sigma_disc, s.sigma_reset,
        s.time_padding,
        U, n_scan, n_times, m, s.interval, s.reset_ticks, s.busy_ticks,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, 'fee_fsm')
    launches['fee_fsm'] += 1
    return integrals, ticks, n_adc, reset_start, latch_end
