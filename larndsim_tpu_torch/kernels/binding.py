"""ctypes wrappers that launch the CUDA kernels on PyTorch's current stream.

Each wrapper checks device, dtype, shape and contiguity, allocates the
outputs with ``torch.empty``, launches on the tensors' card (selected for
the call: a new thread's current card is card 0) and its current stream,
raises if the launch reports an error, and counts the launch in
:data:`launches` (under a lock: module and dispatch threads launch at
once).  Callers reach them
through the dispatching functions ``ops.current.induced_current``,
``ops.accumulate.sum_pixel_signals``, ``ops.fee.fee_fsm``,
``ops.fee.current_fractions`` and those of the card probes in ``tools/``
(``probe_folded``, ``probe_fee``, ``probe_fee2``).

The launch path is kept short, since every chain batch pays it a few
times: the library's signatures are set once per loaded library
(:func:`_lib`), and :func:`_launch` enters no device context where the
calling thread's current card already is the tensors' and passes the
current stream's raw handle (``tools/launch_cost.py`` times each step).
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: kernel launches by kernel name since the last :func:`reset_launches`;
#: a run reads them to show that its main path went through the kernels
launches = {'induced_current': 0, 'sum_pixel_signals': 0, 'fee_fsm': 0,
            'current_fractions': 0, 'probe_window': 0,
            'probe_roll': 0, 'probe_async_copy': 0, 'probe_fee': 0,
            'probe_fee2': 0}
_COUNT_LOCK = threading.Lock()

_U = ctypes.c_uint
_SIGNATURES = {
    'induced_current_launch': [_P] * 12 + [_I] * 8 + [_F] * 5 + [_P] * 2,
    'fee_fsm_launch': [_P] * 10 + [_F] * 7 + [_I] * 7 + [_P],
    'pixel_sum_launch': [_P] * 4 + [_I] * 4 + [_P],
    'current_fractions_launch': [_P] * 7 + [_F] + [_P] * 2 + [_I] * 6
    + [_P],
    'probe_window_launch': [_P] * 2 + [_I] * 5 + [_P],
    'probe_roll_launch': [_P] * 2 + [_I] * 4 + [_P],
    'probe_async_copy_launch': [_P] * 2 + [_I] * 3 + [_L] * 2 + [_I] * 3
    + [_P],
    'probe_fee_launch': [_U] + [_P] * 13 + [_I] * 5 + [_P],
    'probe_fee2_launch': [_U] + [_P] * 13 + [_I] * 5 + [_P],
}
#: what K1 counts of its tile choice when given a stats buffer
#: (csrc/induced_current.cu)
K1_TILING = ('pairs', 'r2_chunks', 'r1_chunks', 'halvings', 'max_slots',
             'max_span', 'window_floats')
#: pixels and ticks per grid step of the JAX FEE probes: U and the padded
#: tick count must be multiples of them
PROBE_TILE, PROBE_CHUNK = 1024, 256
#: shared memory a block may take on the card (bytes)
SMEM_MAX = 227 * 1024
#: a TMA box's largest dimension; the alignment, in bytes, of the global
#: address and strides of a TMA tensor map
TMA_BOX_MAX, TMA_ALIGN = 256, 16
#: shared memory of the TMA copy beyond its window: the slack that aligns
#: the window to 128 bytes, and its mbarrier (csrc/probe_window.cu)
TMA_SMEM_EXTRA = 128 + 8

#: the library whose launch functions' signatures are set
_bound = None


def _lib() -> ctypes.CDLL:
    """The kernels' library, its launch functions' ``argtypes`` and
    ``restype`` set once per loaded library (set on every launch, they
    took more host time than the launch itself)."""
    global _bound
    lib = build.load()
    if lib is not _bound:
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _bound = lib
    return lib


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    """One launch of kernel ``name``."""
    with _COUNT_LOCK:
        launches[name] += 1


def _launch(fn, dev: torch.device, *args) -> int:
    """``fn(*args, stream)`` with ``dev`` the current card and ``stream``
    its current stream (the ctypes call runs on the calling thread's
    current card; a new thread's is card 0)."""
    idx = dev.index
    if torch._C._cuda_getDevice() == idx:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


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
    """Raise on a launch function's return: a ``cudaError_t``, or the
    ``CUresult`` of a refused ``cuTensorMapEncodeTiled``, negated."""
    if err < 0:
        raise RuntimeError(f'{kernel}: cuTensorMapEncodeTiled error {-err} '
                           'encoding its tensor map')
    if err:
        raise RuntimeError(f'{kernel}: CUDA error {err} at launch')


def induced_current(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo,
                    tick_hi, scale, resp, lut, stats=None) -> torch.Tensor:
    """Launch ``csrc/induced_current.cu``; see ops.current.induced_current.
    ``stats``, an int32 tensor of :data:`K1_TILING`'s length on the card,
    gets the launch's tile choice added in (see
    :func:`induced_current_tiling`)."""
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
    if stats is not None:
        _check('stats', stats, i32, (len(K1_TILING),), dev)
    out = torch.empty((S, P, t_sig), dtype=f32, device=dev)
    if out.numel() == 0:
        return out
    err = _launch(
        _lib().induced_current_launch, dev, xs.data_ptr(), ys.data_ptr(),
        shift.data_ptr(), phase.data_ptr(),
        pxc.data_ptr(), pyc.data_ptr(), nstep.data_ptr(),
        tick_lo.data_ptr(), tick_hi.data_ptr(), scale.data_ptr(),
        resp.data_ptr(), out.data_ptr(),
        S, P, n_steps, t_sig, ntp, lut.nx_r, lut.ny_r, lut.ratio,
        lut.inv_bin, lut.lim_x, lut.lim_y, lut.max_x, lut.max_y,
        None if stats is None else stats.data_ptr())
    _raise_on(err, 'induced_current')
    _count('induced_current')
    return out


def induced_current_tiling(*args) -> tuple[torch.Tensor, dict]:
    """One launch of K1 on ``args`` (those of :func:`induced_current`)
    that also counts, on the card, the tile choice it made: the (segment,
    pixel) pairs with live steps, their chunks run at R 2 and at R 1 ticks
    a thread, the chunk halvings (windows that fit at no R), the most
    distinct response rows and the widest shift span that a chunk tabled,
    and the floats of the shared-memory windows.  Returns (output, counts
    by :data:`K1_TILING`)."""
    stats = torch.zeros(len(K1_TILING), dtype=torch.int32,
                        device=args[0].device)
    out = induced_current(*args, stats=stats)
    return out, dict(zip(K1_TILING, stats.tolist()))


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
    err = _launch(
        _lib().fee_fsm_launch, dev, sig_rows.data_ptr(), noise.data_ptr(),
        q_init.data_ptr(),
        thresholds.data_ptr(), tick_times.data_ptr(),
        integrals.data_ptr(), ticks.data_ptr(), n_adc.data_ptr(),
        reset_start.data_ptr(), latch_end.data_ptr(),
        s.A, s.dt, s.C, s.sigma_uncorr, s.sigma_disc, s.sigma_reset,
        s.time_padding,
        U, n_scan, n_times, m, s.interval, s.reset_ticks, s.busy_ticks)
    _raise_on(err, 'fee_fsm')
    _count('fee_fsm')
    return integrals, ticks, n_adc, reset_start, latch_end


def _csr_checks(kernel: str, signals, pairs, offsets) -> tuple:
    """Check the CSR of ``ops.accumulate.pixel_csr`` against the (S, P, T)
    signals; (device, U)."""
    dev = _cuda(signals, kernel)
    S, P, T = signals.shape
    if S * P >= 2 ** 31:
        raise ValueError(f'{kernel}: {S * P} entries overflow int32')
    U = offsets.shape[0] - 1
    for name, t, dt, shape in (
            ('signals', signals, torch.float32, (S, P, T)),
            ('pairs', pairs, torch.int32, (S * P, 2)),
            ('offsets', offsets, torch.int32, (U + 1,))):
        _check(name, t, dt, shape, dev)
    if pairs.data_ptr() % 8:
        raise ValueError(f'{kernel}: pairs not 8-byte aligned')
    return dev, U


def sum_pixel_rows(signals, pairs, offsets, n_ticks: int,
                   rows: int) -> torch.Tensor:
    """Launch ``csrc/pixel_sum.cu``; see ops.accumulate.sum_pixel_signals
    and ops.accumulate.pixel_csr (the CSR's (entry, start tick) ``pairs``
    and ``offsets``).  Returns the (rows, U) float32 tick-major sums, rows
    from n_ticks on zeros."""
    dev, U = _csr_checks('sum_pixel_signals', signals, pairs, offsets)
    if rows < 0 or n_ticks < 0:
        raise ValueError(f'rows {rows}, n_ticks {n_ticks}: negative')
    out = torch.empty((rows, U), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    err = _launch(_lib().pixel_sum_launch, dev, signals.data_ptr(),
                  pairs.data_ptr(), offsets.data_ptr(), out.data_ptr(), U,
                  signals.shape[2], n_ticks, rows)
    _raise_on(err, 'sum_pixel_signals')
    _count('sum_pixel_signals')
    return out


def current_fractions(signals, pairs, offsets, slot, reset_start,
                      latch_end, A, dt: float, *, max_adc: int,
                      max_tracks: int, n_adc_scan: int,
                      n_weights: int) -> torch.Tensor:
    """Launch ``csrc/current_fractions.cu``; see ops.fee.current_fractions,
    ops.accumulate.pixel_csr (the CSR's ``pairs`` and ``offsets``) and
    ops.fee.fraction_decay (the 0-d ``A``).  The kernel tables the
    weights dt * (1 - A^m) of m = 0 .. n_weights - 1 once per launch.  The first ``n_adc_scan`` slots are evaluated; with none the
    fractions are zeros and nothing is launched.  Returns (U, max_adc,
    max_tracks) float32."""
    dev, U = _csr_checks('current_fractions', signals, pairs, offsets)
    S, P, _ = signals.shape
    if not 0 <= n_adc_scan <= max_adc:
        raise ValueError(f'n_adc_scan {n_adc_scan} outside [0, {max_adc}]')
    f32, i32 = torch.float32, torch.int32
    for name, t, dtype, shape in (
            ('slot', slot, i32, (S, P)),
            ('reset_start', reset_start, i32, (U, max_adc)),
            ('latch_end', latch_end, i32, (U, max_adc)),
            ('A', A, f32, ())):
        _check(name, t, dtype, shape, dev)
    if n_adc_scan == 0:
        return torch.zeros((U, max_adc, max_tracks), dtype=f32, device=dev)
    out = torch.empty((U, max_adc, max_tracks), dtype=f32, device=dev)
    if out.numel() == 0:
        return out
    weights = torch.empty((max(n_weights, 0),), dtype=f32, device=dev)
    err = _launch(
        _lib().current_fractions_launch, dev, signals.data_ptr(),
        pairs.data_ptr(), offsets.data_ptr(), slot.data_ptr(),
        reset_start.data_ptr(), latch_end.data_ptr(), A.data_ptr(), dt,
        weights.data_ptr(), out.data_ptr(), weights.shape[0], U,
        signals.shape[2], max_adc, max_tracks, n_adc_scan)
    _raise_on(err, 'current_fractions')
    _count('current_fractions')
    return out


def _cuda(t: torch.Tensor, kernel: str) -> torch.device:
    if t.device.type != 'cuda':
        raise ValueError(f'{kernel} kernel needs CUDA tensors, got {t.device}')
    return t.device


def probe_window(slab, row: int, q0: int, n_q: int) -> torch.Tensor:
    """Launch ``csrc/probe_window.cu``: ``slab[row, q0:q0 + n_q, :]``."""
    dev = _cuda(slab, 'probe_window')
    n_rows, n_sub, lanes = slab.shape
    _check('slab', slab, torch.float32, (n_rows, n_sub, lanes), dev)
    if not (0 <= row < n_rows and 0 <= q0 and n_q > 0 and q0 + n_q <= n_sub):
        raise ValueError(f'window row {row}, rows [{q0}, {q0 + n_q}) outside '
                         f'the slab {tuple(slab.shape)}')
    out = torch.empty((n_q, lanes), dtype=torch.float32, device=dev)
    err = _launch(_lib().probe_window_launch, dev, slab.data_ptr(),
                  out.data_ptr(), n_sub, lanes, row, q0, n_q)
    _raise_on(err, 'probe_window')
    _count('probe_window')
    return out


def probe_roll(x, shift: int, axis: int) -> torch.Tensor:
    """Launch ``csrc/probe_window.cu``'s roll: ``torch.roll(x, shift, axis)``."""
    dev = _cuda(x, 'probe_roll')
    _check('x', x, torch.float32, tuple(x.shape), dev)
    axis %= x.dim()
    n = x.shape[axis]
    outer, inner = math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    err = _launch(_lib().probe_roll_launch, dev, x.data_ptr(),
                  out.data_ptr(), outer, n, inner, shift % n)
    _raise_on(err, 'probe_roll')
    _count('probe_roll')
    return out


def tma_window(shape, strides, data_ptr: int, q_step: int, q_sz: int,
               n_windows: int, itemsize: int = 4) -> int:
    """Check that each window ``slab[:, b * q_step:b * q_step + q_sz, :]``
    (b < ``n_windows``) of an (n_rows, n_sub, lanes) slab with ``strides``
    (elements) at ``data_ptr`` moves as one TMA box (lanes, q_sz, n_rows)
    into one block's shared memory: box dimensions of at most
    :data:`TMA_BOX_MAX`, lanes contiguous and a multiple of 16 bytes,
    address and strides multiples of :data:`TMA_ALIGN` bytes, the window
    inside the slab and within :data:`SMEM_MAX`.  Returns the shared
    memory a block takes; raises ValueError before any launch."""
    n_rows, n_sub, lanes = shape
    row_stride, sub_stride, lane_stride = strides
    if min(shape) <= 0 or q_sz <= 0 or n_windows <= 0 or q_step < 0:
        raise ValueError(f'{n_windows} windows of {q_sz} rows at step '
                         f'{q_step} of an empty slab {tuple(shape)}')
    if (n_windows - 1) * q_step + q_sz > n_sub:
        raise ValueError(f'{n_windows} windows of {q_sz} rows at step '
                         f'{q_step} overrun {n_sub} rows')
    box = (lanes, q_sz, n_rows)
    if max(box) > TMA_BOX_MAX:
        raise ValueError(f'TMA box {box} has a dimension above '
                         f'{TMA_BOX_MAX}')
    if lane_stride != 1 or lanes * itemsize % TMA_ALIGN:
        raise ValueError(f'TMA moves contiguous rows of a multiple of '
                         f'{TMA_ALIGN} bytes: lanes {lanes} at stride '
                         f'{lane_stride}')
    for name, v in (('address', data_ptr), ('row stride', row_stride *
                                            itemsize),
                    ('sub-row stride', sub_stride * itemsize)):
        if v % TMA_ALIGN:
            raise ValueError(f'TMA needs a {name} of a multiple of '
                             f'{TMA_ALIGN} bytes, got {v}')
    smem = n_rows * q_sz * lanes * itemsize + TMA_SMEM_EXTRA
    if smem > SMEM_MAX:
        raise ValueError(f'window of {smem} bytes with its barrier exceeds '
                         f'a block\'s {SMEM_MAX} bytes of shared memory')
    return smem


def probe_async_copy(slab, q_step: int, q_sz: int,
                     n_windows: int) -> torch.Tensor:
    """Launch ``csrc/probe_window.cu``'s TMA copy: window ``b`` is
    ``slab[:, b * q_step:b * q_step + q_sz, :]``, moved by one TMA tensor
    load; out (n_windows, n_rows, q_sz, lanes).  ``slab`` may be a strided
    view that :func:`tma_window` accepts; any other raises (nothing is
    copied first)."""
    dev = _cuda(slab, 'probe_async_copy')
    if slab.dtype != torch.float32 or slab.dim() != 3:
        raise TypeError(f'slab: {slab.dtype} of {slab.dim()} dimensions, '
                        'expected a 3-dimensional float32 tensor')
    tma_window(slab.shape, slab.stride(), slab.data_ptr(), q_step, q_sz,
               n_windows)
    n_rows, n_sub, lanes = slab.shape
    out = torch.empty((n_windows, n_rows, q_sz, lanes), dtype=torch.float32,
                      device=dev)
    err = _launch(
        _lib().probe_async_copy_launch, dev, slab.data_ptr(), out.data_ptr(),
        n_rows, n_sub, lanes, slab.stride(0), slab.stride(1), q_step, q_sz,
        n_windows)
    _raise_on(err, 'probe_async_copy')
    _count('probe_async_copy')
    return out


def _ptrs(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors or ())


def _fee_probe_shapes(sig, noise, noise_shape, kernel):
    dev = _cuda(sig, kernel)
    n_scan_p, U = sig.shape
    if U % PROBE_TILE or n_scan_p % PROBE_CHUNK:
        raise ValueError(f'{kernel}: U ({U}) must be a multiple of '
                         f'{PROBE_TILE} and the ticks ({n_scan_p}) of '
                         f'{PROBE_CHUNK}')
    _check('sig', sig, torch.float32, (n_scan_p, U), dev)
    _check('noise', noise, torch.float32, noise_shape(n_scan_p, U), dev)
    return dev, n_scan_p, U


def probe_fee(flags: int, sig, noise, scal, times, thr, q0, *, n_scan: int,
              max_adc: int):
    """Launch ``csrc/probe_fee.cu`` (P2).  ``flags`` as
    ``tools.probe_fee.flags`` gives them; ``scal`` (1, 6), ``times``
    (1, n_times), ``thr`` and ``q0`` (1, U) are read only with ``consts``.

    Returns (out (1, U), outs (4 (max_adc, U) planes, empty without
    ``outs``), fstate (8, U), istate (4, U)).
    """
    dev, n_scan_p, U = _fee_probe_shapes(
        sig, noise, lambda n, u: (n, 5, u), 'probe_fee')
    n_times = times.shape[1]
    for name, t, shape in (('scal', scal, (1, 6)),
                           ('times', times, (1, n_times)),
                           ('thr', thr, (1, U)), ('q0', q0, (1, U))):
        _check(name, t, torch.float32, shape, dev)
    f32, i32 = torch.float32, torch.int32
    out = torch.empty((1, U), dtype=f32, device=dev)
    planes = tuple(torch.empty((max_adc, U), dtype=dt, device=dev)
                   for dt in (f32, i32, f32, i32)) if flags & 2 else ()
    fstate = torch.empty((8, U), dtype=f32, device=dev)
    istate = torch.empty((4, U), dtype=i32, device=dev)
    err = _launch(
        _lib().probe_fee_launch, dev, flags, scal.data_ptr(),
        times.data_ptr(), thr.data_ptr(),
        q0.data_ptr(), sig.data_ptr(), noise.data_ptr(), out.data_ptr(),
        *(_ptrs(planes) or (None,) * 4), fstate.data_ptr(),
        istate.data_ptr(), U, n_scan_p // PROBE_CHUNK, n_scan, n_times,
        max_adc)
    _raise_on(err, f'probe_fee (flags {flags})')
    _count('probe_fee')
    return out, planes, fstate, istate


def probe_fee2(flags: int, sig, noise, scal, times, thrq, *, n_scan: int,
               max_adc: int):
    """Launch ``csrc/probe_fee.cu``'s P3 kernel.  ``flags`` as
    ``tools.probe_fee2.flags`` gives them; noise (5, n_scan_p, U).

    Returns (state (U,), outs): ``outs`` has the shapes of the JAX probe's
    outputs with its (U // 128, 128) lanes merged into U.
    """
    dev, n_scan_p, U = _fee_probe_shapes(
        sig, noise, lambda n, u: (5, n, u), 'probe_fee2')
    n_times = times.shape[1]
    for name, t, shape in (('scal', scal, (1, 6)),
                           ('times', times, (1, n_times)),
                           ('thrq', thrq, (1, U))):
        _check(name, t, torch.float32, shape, dev)
    f32, i32 = torch.float32, torch.int32
    n_c = n_scan_p // PROBE_CHUNK
    anyio, vmouts = flags & 2, flags & 4
    state = torch.empty((U,), dtype=f32, device=dev)
    planes = unused = None
    if anyio:
        unused = tuple(torch.empty(shape, dtype=dt, device=dev)
                       for shape, dt in (((max_adc, U), f32),
                                         ((max_adc, U), f32),
                                         ((max_adc, U), i32),
                                         ((max_adc, U), i32), ((1, U), i32)))
        outs = unused
    elif vmouts:
        # the planes as one (n_planes, n_c, max_adc, U) block
        planes = torch.empty((5 if flags & 8 else 1, n_c, max_adc, U),
                             dtype=f32, device=dev)
        outs = tuple(planes.unbind(0))
    else:
        outs = (state.view(1, U),)
    err = _launch(
        _lib().probe_fee2_launch, dev, flags, scal.data_ptr(),
        times.data_ptr(), sig.data_ptr(),
        noise.data_ptr(), thrq.data_ptr(), thrq.data_ptr(), state.data_ptr(),
        None if planes is None else planes.data_ptr(),
        *(_ptrs(unused) or (None,) * 5),
        U, n_c, n_scan, n_times, max_adc)
    _raise_on(err, f'probe_fee2 (flags {flags})')
    _count('probe_fee2')
    return state, outs
