"""The light chain on the card against its CPU run, on the same batch and
the same draws.

The light ops have no kernel of their own: they are plain PyTorch on every
device, held against the JAX package on the CPU (tests/test_torch_light.py).
On the card they are held against their own CPU run: a batch the CLI gave
``models.light.simulate_light_batch`` is run again on the card and on the
CPU, each time with draws made on the CPU from one seed and moved to the
batch's device (the Poisson counts at the rates each run computed).

Tolerances: waveforms within one quantum (2^(16 - light_nbit) ADC) with
>= 99.9% of samples equal (cuFFT and pocketfft round differently, and a
rate a last bit apart can draw another Poisson count); truth records
(trigger, channel, tick, segment id) equal with pe_current at rtol 1e-4 /
atol 1e-6.  Two runs on the card give the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from ..models import light as light_model
from ..ops.light import LightDraw


@contextlib.contextmanager
def first_batch():
    """Within the block, keeps the arguments ``(args, kwargs)`` of the
    first light batch that triggers (``i_subbatch`` 0) in the yielded
    list."""
    seen: list = []
    orig = light_model.simulate_light_batch

    def spy(*args, **kwargs):
        if not seen and kwargs.get('i_subbatch', 0) == 0:
            seen.append((args, kwargs))
        return orig(*args, **kwargs)
    light_model.simulate_light_batch = spy
    try:
        yield seen
    finally:
        light_model.simulate_light_batch = orig


def to_device(obj, device):
    """A dataclass of tensors (segments, light params, LUT) with every
    tensor field on ``device``."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


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
          smearing: bool | None = None, truth_ids: int | None = None):
    """``simulate_light_batch(*args, **kwargs)`` again on ``device`` with
    :func:`cpu_draw` draws; ``smearing`` / ``truth_ids`` switch the LUT
    smearing and the number of truth contributors.  Returns the result
    with its waveforms on the host."""
    segs, light, sim, n_det, vox, lut, noise, _ = args
    if smearing is not None:
        light = light.replace(enable_lut_smearing=smearing)
    if truth_ids is not None:
        sim = dataclasses.replace(sim, max_mc_truth_ids=truth_ids)
    res = light_model.simulate_light_batch(
        to_device(segs, device), to_device(light, device), sim,
        n_det.to(device), vox.to(device), to_device(lut, device), noise,
        cpu_draw(seed, device), **kwargs)
    res.waveforms = res.waveforms.cpu().numpy()
    return res


def compare(got, want, light) -> dict:
    """``got`` (card) against ``want`` (CPU) at the tolerances above;
    raises AssertionError outside them."""
    quant = 2.0 ** (16 - light.light_nbit)
    a, b = got.waveforms.astype(np.float64), want.waveforms.astype(np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b)
    err = float(d.max()) if d.size else 0.0
    equal = float((d == 0).mean()) if d.size else 1.0
    assert err <= quant, f'waveforms differ by {err} > one quantum {quant}'
    assert equal >= 0.999, f'only {equal:.5f} of the samples are equal'
    n_rec = 0
    if want.truth_sparse is not None:
        g, w = got.truth_sparse, want.truth_sparse
        for k in ('trig', 'op_channel', 'tick', 'segment_id'):
            assert np.array_equal(g[k], w[k]), f'truth {k} differs'
        np.testing.assert_allclose(g['pe_current'], w['pe_current'],
                                   rtol=1e-4, atol=1e-6)
        n_rec = len(w['tick'])
    return dict(max_abs_err=err, equal_share=equal, records=n_rec,
                peak=float(np.abs(b).max()) if b.size else 0.0)


def identical(a, b) -> bool:
    """Two runs' waveforms and truth records are the same bits."""
    same = np.array_equal(a.waveforms, b.waveforms)
    if a.truth_sparse is not None:
        same &= all(np.array_equal(a.truth_sparse[k], b.truth_sparse[k])
                    for k in a.truth_sparse)
    return bool(same)
