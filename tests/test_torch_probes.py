"""The card probes' plain versions (``larndsim_tpu_torch/tools``) against
the JAX probes themselves (``tools/probe_*.py``), run in TPU interpret mode
on the CPU.

Tolerances: P1 outputs equal the numpy values each JAX case asserts.  P2's
``outs`` planes equal the JAX kernel's, and so does its final state where
the recurrence has no multiply-add (``nostate``, ``nosig``); elsewhere XLA's
CPU backend contracts ``a * 0.99 + sig`` into one fused multiply-add (the
interpreted kernel equals a numpy transcription with the product unrounded,
bit for bit), which differs from the port's two roundings by up to 1 f32
ULP a tick, decaying by 0.99 a tick: at most 1 / (1 - 0.99) = 100 ULP of
max |a|.  P3's state equals a numpy transcription of the one-state scan bit
for bit, and its outputs have the JAX call's shapes.  P2's byte counts
equal hand counts of the rows each variant's body reads.
"""
from __future__ import annotations

import os
import sys
import types

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from larndsim_tpu_torch.tools import probe_fee, probe_fee2, probe_folded

import torch_port_assets  # noqa: F401  (one torch thread per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: U, padded ticks, guarded ticks: two chunks of 256, the last one partial
U, N_SCAN_P, N_SCAN = 1024, 512, 400


@pytest.fixture(scope='module')
def jax_probes():
    """The JAX probe modules; they insert paths and set LARNDSIM_ASSETS at
    import, so both are restored, and the modules dropped, afterwards."""
    path, env, mods = list(sys.path), dict(os.environ), set(sys.modules)
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        import probe_fee as p2
        import probe_fee2 as p3
        import probe_folded as p1
        yield types.SimpleNamespace(p1=p1, p2=p2, p3=p3)
    finally:
        sys.path[:] = path
        os.environ.clear()
        os.environ.update(env)
        for name in set(sys.modules) - mods:
            if name.split('.')[0] in ('probe_folded', 'probe_fee',
                                      'probe_fee2', 'perf_guard'):
                del sys.modules[name]


def _inputs(seed: int, noise_first: bool):
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((N_SCAN_P, U), dtype=np.float32)
    shape = (5, N_SCAN_P, U) if noise_first else (N_SCAN_P, 5, U)
    return sig, rng.standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize('case', probe_folded.CASES)
def test_probe_folded_case(jax_probes, case):
    fn, args, want = probe_folded.case_call(case)
    np.testing.assert_array_equal(probe_folded.run_case(case, 'cpu'), want)
    with pltpu.force_tpu_interpret_mode():
        jax_probes.p1.run_case(case)     # asserts the same numpy value


@pytest.mark.parametrize('variant', probe_fee.VARIANTS)
def test_probe_fee_variant(jax_probes, variant):
    sig, noise = _inputs(5, noise_first=False)
    zeros = {k: np.zeros(shape, np.float32) for k, shape in (
        ('scal', (1, 6)), ('times', (1, probe_fee.N_TIMES)),
        ('thr', (1, U)))}
    with pltpu.force_tpu_interpret_mode():
        call = jax_probes.p2.make_call(variant, N_SCAN_P, U, 30, N_SCAN)
        lanes = (sig.reshape(N_SCAN_P, U // 128, 128),
                 noise.reshape(N_SCAN_P, 5, U // 128, 128))
        args = ((zeros['scal'], zeros['times'], zeros['thr'].reshape(
            1, U // 128, 128), zeros['thr'].reshape(1, U // 128, 128))
            if 'consts' in variant else ()) + lanes
        want = [np.asarray(o) for o in call(*args)]
    t = torch.from_numpy
    got = probe_fee.probe_fee(
        variant, t(sig), t(noise), t(zeros['scal']), t(zeros['times']),
        t(zeros['thr']), t(zeros['thr']), n_scan=N_SCAN)
    if probe_fee.flags(variant) & (probe_fee.FLAGS['nostate']
                                   | probe_fee.FLAGS['nosig']):
        np.testing.assert_array_equal(got.out.numpy(),
                                      want[0].reshape(1, U))
    else:
        ulp = np.spacing(np.abs(want[0]).max())
        np.testing.assert_allclose(got.out.numpy(), want[0].reshape(1, U),
                                   rtol=0, atol=ulp / (1 - 0.99))
    assert len(got.outs) == len(want) - 1
    for g, w in zip(got.outs, want[1:]):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.reshape(30, U))
    assert float(np.abs(want[0]).sum()) > 0 or 'nosig' in variant


def _numpy_scan(variant: str, sig: np.ndarray):
    """The one-state scan in numpy: (final state, state after each chunk)."""
    tail = 'tailsplit' in variant
    n_c = N_SCAN_P // 256
    s = np.zeros(U, np.float32)
    ends = []
    for c in range(n_c):
        for t in range(c * 256, (c + 1) * 256):
            if (tail and c < n_c - 1) or t < N_SCAN:
                s = s * np.float32(0.99) + sig[t]
        ends.append(s.copy())
    return s, np.stack(ends)


@pytest.mark.parametrize('variant', probe_fee2.VARIANTS)
def test_probe_fee2_variant(jax_probes, variant):
    sig, noise = _inputs(6, noise_first=True)
    t = torch.from_numpy
    got = probe_fee2.probe_fee2(
        variant, t(sig), t(noise), torch.zeros(1, 6),
        torch.zeros(1, probe_fee.N_TIMES), torch.zeros(1, U), n_scan=N_SCAN)
    state, ends = _numpy_scan(variant, sig)
    np.testing.assert_array_equal(got.state.numpy(), state)
    if 'vmouts' in variant:
        for plane in got.outs:
            np.testing.assert_array_equal(
                plane.numpy(), np.repeat(ends[:, None], 30, axis=1))
    elif 'anyio' not in variant:
        np.testing.assert_array_equal(got.outs[0].numpy(), state[None])
    with pltpu.force_tpu_interpret_mode():
        call = jax_probes.p3.make_call(variant, U, N_SCAN_P, N_SCAN)
        want = call(sig.reshape(N_SCAN_P, U // 128, 128),
                    noise.reshape(5, N_SCAN_P, U // 128, 128),
                    np.zeros((1, U // 128, 128), np.float32))
    merged = [(w.shape[:-2] + (w.shape[-2] * w.shape[-1],),
               np.dtype(w.dtype)) for w in want]
    assert [(tuple(o.shape), o.numpy().dtype) for o in got.outs] == merged


def test_probe_variant_names_parse_as_the_jax_probes_read_them():
    assert probe_fee.flags('full') == 0
    assert probe_fee.flags('full+consts') == probe_fee.flags('consts')
    assert len({probe_fee.flags(v) for v in probe_fee.VARIANTS}) == 9
    assert probe_fee2.flags('base') == 0
    assert probe_fee2.flags('vmouts5') == probe_fee2.flags('vmouts') | 8
    assert len({probe_fee2.flags(v) for v in probe_fee2.VARIANTS}) == 10
    with pytest.raises(ValueError):
        probe_folded.case_call('h')


def test_probe_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main in (probe_folded.main, probe_fee.main, probe_fee2.main):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main([])


def test_probe_entry_points_on_the_cpu_say_so(capsys):
    cpu = torch.device('cpu')
    fsm_args = probe_fee.fsm_reference_inputs(1024, 200, cpu)
    for mod, call, variants in (
            (probe_fee, probe_fee.probe_fee, ('full', 'intops', 'anyred')),
            (probe_fee2, probe_fee2.probe_fee2, ('base', 'vmouts+tailsplit'))):
        args = tuple(mod.make_inputs(1024, 256, cpu,
                                     random_signal=False).values())
        rows = probe_fee.time_variants(
            lambda v, *a: call(v, *a, n_scan=200), variants, args, fsm_args,
            cpu)
        assert list(rows) == ['fee_fsm (K2)', *variants]
        assert all(r['cpu_wall_s'] > 0 for r in rows.values())
        probe_fee.print_rows(mod.__name__, rows, cpu, 'U=1024, n_scan=200')
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 4 + 1 + 3 + 1
    assert all('plain versions on the CPU' in line for line in lines)
    assert probe_folded.main(['--device', 'cpu']) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7
    assert all(': OK (plain versions on the CPU)' in line for line in lines)


@pytest.mark.parametrize('variant', probe_fee.VARIANTS)
def test_probe_fee_costs_count_the_rows_each_body_reads(variant):
    """P2's bytes: the (1, U) output, 8 + 4 state planes, the signal row
    and the noise rows each tick's body reads (``intops`` the first two
    of five), the constants and output planes of their variants."""
    n_pix, n_scan, n_scan_p, adc, n_t = 1024, 400, 512, 30, 2049
    ticks = n_scan_p if variant == 'noguard' else n_scan
    rows = dict(nosig=5, nonoise=1, intops=3).get(variant, 6)
    want = (13 + rows * ticks) * n_pix * 4
    want += dict(consts=(6 + n_t + 2 * n_pix) * 4,
                 outs=4 * adc * n_pix * 4).get(variant, 0)
    assert probe_fee.costs(variant, n_pix, n_scan, n_scan_p, adc,
                           n_t)['bytes'] == want

