"""Bytes and float32 operations of the port's two hand-written kernels,
K1 (the induced current, ``csrc/induced_current.cu``) and K2 (the FEE
state machine, ``csrc/fee_fsm.cu``), and the least time the card could
take for them.

A frozen copy of the counting of ``larndsim_tpu_torch/tools/perf_guard.py``
(``k1_costs``, ``fsm_costs``, ``bound``, ``ROW_OPS``, ``FSM_OPS``) with
the response-row table of ``ops/current.py`` (``row_table``) copied in,
so that it imports nothing of the port.  The peaks are the published ones
of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): a count of work
read against them reads the same whatever implements the work.
"""
from __future__ import annotations

import torch

#: HBM bandwidth of one H100 SXM [bytes/s]
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores [operations/s]
F32_OPS_PER_S = 67e12
#: per live (segment, pixel, step) of K1: the response row of the point
ROW_OPS = 10
#: float32 operations per (tick, pixel) of the FSM body (integrator 2,
#: charge 2, sum 1, ADC 2, latch test 3, fire test 5)
FSM_OPS = 15
#: a pixel centre this far away stands for no pixel (ops/current.py FAR)
FAR = 1e9


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time of the work on one H100: the larger of its bytes
    over the HBM bandwidth and its operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_table(xs, ys, phase, pxc, pyc, lut) -> torch.Tensor:
    """(S, P, n_steps) int32 response-row index of each (pixel, point):
    the LUT bin of |pixel centre - point|, or the zero row out of range."""
    x_dist = torch.clamp(torch.abs(pxc[:, :, None] - xs[:, None, :]),
                         max=lut.lim_x)
    y_dist = torch.clamp(torch.abs(pyc[:, :, None] - ys[:, None, :]),
                         max=lut.lim_y)
    i_idx = torch.round(x_dist * lut.inv_bin - 0.5).to(torch.int32)
    j_idx = torch.round(y_dist * lut.inv_bin - 0.5).to(torch.int32)
    ok = ((x_dist <= lut.max_x) & (y_dist <= lut.max_y)
          & (i_idx >= 0) & (i_idx < lut.nx_r)
          & (j_idx >= 0) & (j_idx < lut.ny_r))
    i_c = torch.clamp(i_idx, 0, lut.nx_r - 1)
    j_c = torch.clamp(j_idx, 0, lut.ny_r - 1)
    return torch.where(ok, (i_c * lut.ny_r + j_c) * lut.ratio
                       + phase[:, None, :], lut.zero_row).to(torch.int32)


def k1_work(args) -> tuple[int, torch.Tensor]:
    """Bytes and operations of the induced current on the inputs of one
    launch, the operations a 0-d tensor on the inputs' device (nothing
    waits for it): every input and the (S, P, t_sig) output once; one add
    per response value summed (live step, in-range pixel, tick in
    [tick_lo, t_sig) that the shifted row covers), one multiply per output
    tick from tick_lo on, and the row lookup of each live (segment, pixel,
    step)."""
    xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi, scale, resp, \
        lut = args[:12]
    S, n_steps = xs.shape
    P = pxc.shape[1]
    t_sig = scale.shape[1]
    ntp = resp.shape[1]
    live = (torch.arange(n_steps, device=xs.device)[None, :]
            < nstep[:, None].long())                               # (S, n)
    rows = row_table(xs, ys, phase, pxc, pyc, lut)                  # (S,P,n)
    pix_live = (rows != lut.zero_row).sum(dim=1)                    # (S, n)
    sh = shift.long()
    n_t = (torch.clamp(sh + ntp, max=t_sig)
           - torch.maximum(sh, tick_lo[:, None].long())).clamp(min=0)
    adds = (n_t * pix_live * live).sum()
    valid_pix = (pxc.abs() < FAR / 10).sum(dim=1)                   # (S,)
    muls = (valid_pix * (t_sig - tick_lo.long()).clamp(min=0)).sum()
    lookups = ((rows != lut.zero_row) & live[:, None, :]).sum()
    n_bytes = nbytes(xs, ys, shift, phase, pxc, pyc, nstep, tick_lo,
                     tick_hi, scale, resp) + S * P * t_sig * 4
    return n_bytes, adds + muls + ROW_OPS * lookups


def k1_costs(args) -> dict:
    """:func:`k1_work` as numbers."""
    n_bytes, ops = k1_work(args)
    return dict(bytes=n_bytes, ops=int(ops))


def fsm_costs(n_scan: int, n_pix: int, max_adc: int, n_times: int) -> dict:
    """K2 alone: signal rows, the five noise rows, q_init, thresholds and
    tick times in, the five outputs out; FSM_OPS a (tick, pixel)."""
    out = n_pix * max_adc * 4 * 4 + n_pix * 4
    n_in = (n_scan * 6 * n_pix + 2 * n_pix + n_times) * 4
    return dict(bytes=n_in + out, ops=FSM_OPS * n_scan * n_pix)
