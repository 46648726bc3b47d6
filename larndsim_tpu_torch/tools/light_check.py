"""The light chain on the card against its CPU run, on the same batch and
the same draws.

The light ops have no kernel of their own: they are plain PyTorch on every
device, held against the JAX package on the CPU (tests/test_torch_light.py).
On the card they are held against their own CPU run: a batch the CLI gave
``models.light.simulate_light_batch`` is run again on the card and on the
CPU, each time with draws made on the CPU from one seed and moved to the
batch's device (the Poisson counts at the rates each run computed).

Tolerances: trigger tables (ticks, types, channels), window start and
length equal; waveforms within one quantum (2^(16 - light_nbit) ADC) with
>= 99.9% of samples equal (cuFFT and pocketfft round differently, and a
rate a last bit apart can draw another Poisson count); contributor-point
truth records (trigger, channel, tick, segment id) equal with pe_current
at rtol 1e-4 / atol 1e-6.  LUT-smearing truth records (either route) are
float32 sums in another order on each side (cuBLAS, the CPU's BLAS, the
host route's blocks), ~1e-5 apart: those whose |pe| lies more than
``MARGIN`` from the record threshold are equal in (trigger, channel, tick,
segment id) with pe_current at rtol 1e-4 / atol 1e-5 (the JAX package's
tolerances between its two routes, tests/test_end_to_end.py:262-273); the
rest are counted.  Two runs on the card give the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..models import light as light_model
from ..ops.light import LightDraw
from ..parallel.devices import to_device


@contextlib.contextmanager
def first_batch(keep=None):
    """Within the block, keeps the arguments ``(args, kwargs)`` of the
    first light batch that triggers (``i_subbatch`` 0) in the yielded
    list; with ``keep``, the first that ``keep(args, kwargs)`` accepts."""
    seen: list = []
    orig = light_model.simulate_light_batch

    def spy(*args, **kwargs):
        if not seen and kwargs.get('i_subbatch', 0) == 0 \
                and (keep is None or keep(args, kwargs)):
            seen.append((args, kwargs))
        return orig(*args, **kwargs)
    light_model.simulate_light_batch = spy
    try:
        yield seen
    finally:
        light_model.simulate_light_batch = orig


#: LUT-smearing truth records whose |pe| lies within this of the record
#: threshold may be kept on one side only
MARGIN = 1e-3

#: Poisson counts up to this many are tried by the inversion below
POISSON_KMAX = 100


def poisson_by_inversion(rate: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Poisson counts at ``rate``: the inverse of the float64 Poisson CDF at
    the uniforms ``u`` (same shape), on ``rate``'s device.  Exact for rates
    below 30, the only counts ``ops.light.calc_stat_fluctuations`` keeps;
    capped at POISSON_KMAX.  A rate a last bit apart changes a count only
    where ``u`` lies that close to a step of the CDF (a sampler that
    consumes its stream as the data decide would shift every later
    draw)."""
    lam = rate.double()
    u = u.to(lam.device, torch.float64)
    log_lam = torch.log(lam)
    cdf = torch.zeros_like(lam)
    count = torch.zeros_like(lam)
    for k in range(POISSON_KMAX):
        cdf += torch.exp(k * log_lam - lam - math.lgamma(k + 1))
        count += cdf < u
    return count.to(rate.dtype)


def cpu_draw(seed: int, device) -> LightDraw:
    """Draws from a CPU generator seeded with ``seed``, moved to
    ``device`` (the Poisson counts by :func:`poisson_by_inversion` of CPU
    uniforms, at the rates the run computed)."""
    gen = torch.Generator().manual_seed(seed)
    return LightDraw(
        poisson=lambda rate: poisson_by_inversion(
            rate, torch.rand(tuple(rate.shape), generator=gen)),
        normal=lambda shape: torch.randn(shape, generator=gen).to(device),
        uniform=lambda shape: torch.rand(shape, generator=gen).to(device))


def rerun(args: tuple, kwargs: dict, device, seed: int, *,
          smearing: bool | None = None, truth_ids: int | None = None,
          threshold: float | None = None, truth_path: str | None = None):
    """``simulate_light_batch(*args, **kwargs)`` again on ``device`` with
    :func:`cpu_draw` draws; ``smearing`` / ``truth_ids`` / ``threshold`` /
    ``truth_path`` switch the LUT smearing, the number of truth
    contributors, the record threshold and the smearing truth's route.
    The records are computed in the call (no worker).  Returns the result
    with its waveforms on the host."""
    segs, light, sim, n_det, vox, lut, noise, _ = args
    if smearing is not None:
        light = light.replace(enable_lut_smearing=smearing)
    if truth_ids is not None:
        sim = dataclasses.replace(sim, max_mc_truth_ids=truth_ids)
    if threshold is not None:
        sim = dataclasses.replace(sim, mc_truth_threshold=threshold)
    kwargs = dict(kwargs, truth_executor=None)
    if kwargs.get('t0_det') is not None:        # mode 0's arrivals
        kwargs['t0_det'] = kwargs['t0_det'].to(device)
    if truth_path is not None:
        kwargs['truth_path'] = truth_path
    res = light_model.simulate_light_batch(
        to_device(segs, device), to_device(light, device), sim,
        n_det.to(device), vox.to(device), to_device(lut, device), noise,
        cpu_draw(seed, device), **kwargs)
    res.waveforms = res.waveforms.cpu().numpy()
    return res


def records_agree(got, want, threshold: float,
                  keys=('trig', 'op_channel', 'tick', 'segment_id')) -> dict:
    """LUT-smearing truth records (dicts of columns, or record arrays with
    the ``keys`` fields and ``pe_current``) beyond ``MARGIN`` of the
    threshold: equal in ``keys``, pe_current at rtol 1e-4 / atol 1e-5;
    raises AssertionError otherwise.  Returns the records compared and the
    records near the threshold on each side."""
    far_g = np.abs(np.abs(got['pe_current']) - threshold) > MARGIN
    far_w = np.abs(np.abs(want['pe_current']) - threshold) > MARGIN
    assert far_g.sum() == far_w.sum(), \
        f'{far_g.sum()} records against {far_w.sum()} beyond the margin'
    for k in keys:
        assert np.array_equal(got[k][far_g], want[k][far_w]), \
            f'truth {k} differs'
    np.testing.assert_allclose(got['pe_current'][far_g],
                               want['pe_current'][far_w], rtol=1e-4,
                               atol=1e-5)
    return dict(records=int(far_w.sum()),
                near=(int((~far_g).sum()), int((~far_w).sum())))


def compare(got, want, light, *, smeared_at: float | None = None) -> dict:
    """``got`` (card) against ``want`` (CPU) at the tolerances above, the
    trigger tables equal; raises AssertionError outside them.
    ``smeared_at``: the record threshold of LUT-smearing truth
    (:func:`records_agree`); None holds the records equal."""
    for name in ('trigger_idx', 'trigger_type', 'op_channel_idx'):
        assert np.array_equal(getattr(got, name), getattr(want, name)), \
            f'{name} differs: {getattr(got, name)} vs {getattr(want, name)}'
    assert (got.start_time, got.n_ticks) == (want.start_time, want.n_ticks)
    quant = 2.0 ** (16 - light.light_nbit)
    a, b = got.waveforms.astype(np.float64), want.waveforms.astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    err = float(d.max()) if d.size else 0.0
    equal = float((d == 0).mean()) if d.size else 1.0
    assert err <= quant, f'waveforms differ by {err} > one quantum {quant}'
    assert equal >= 0.999, f'only {equal:.5f} of the samples are equal'
    n_rec, near = 0, (0, 0)
    if want.truth_sparse is not None:
        g, w = got.truth_sparse, want.truth_sparse
        if smeared_at is not None:
            rec = records_agree(g, w, smeared_at)
            n_rec, near = rec['records'], rec['near']
        else:
            for k in ('trig', 'op_channel', 'tick', 'segment_id'):
                assert np.array_equal(g[k], w[k]), f'truth {k} differs'
            np.testing.assert_allclose(g['pe_current'], w['pe_current'],
                                       rtol=1e-4, atol=1e-6)
            n_rec = len(w['tick'])
    return dict(max_abs_err=err, equal_share=equal, records=n_rec,
                near=near, peak=float(np.abs(b).max()) if b.size else 0.0,
                triggers=len(want.trigger_idx))


def identical(a, b) -> bool:
    """Two runs' waveforms and truth records are the same bits."""
    same = np.array_equal(a.waveforms, b.waveforms)
    if a.truth_sparse is not None:
        same &= all(np.array_equal(a.truth_sparse[k], b.truth_sparse[k])
                    for k in a.truth_sparse)
    return bool(same)
