"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skipped where no CUDA device is present.  On a machine with
an NVIDIA Hopper card (JAX need not be installed there) run

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: induced current atol 2e-5 x peak; FSM integers exactly equal,
floats rtol 1e-5 / atol 1e-2; the CLI's data packets on the card agree
with its CPU run (plain versions) for >= 99% of packets; the card probes
P1-P3 (``larndsim_tpu_torch/tools``) equal their plain versions bit for
bit (P1 also the numpy values of the JAX probe), at a small shape and at
the probe shapes.
"""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from larndsim_tpu_torch.assets.make_input import write_input
from larndsim_tpu_torch.assets.response import make_response
from larndsim_tpu_torch.io.h5 import File
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.models.charge import pixel_centers
from larndsim_tpu_torch.ops import current, fee, pixelize
from larndsim_tpu_torch.ops.drift import drift
from larndsim_tpu_torch.ops.quench import quench
from larndsim_tpu_torch.params import physics
from larndsim_tpu_torch.segments import from_structured
from larndsim_tpu_torch.tools import probe_fee, probe_fee2, probe_folded

import torch_port_assets as tpa

pytestmark = pytest.mark.gpu


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _current_on(device, tree, ratio, smear):
    """The port's induced current of a small drifted batch on ``device``."""
    dm = tpa.load_port(tree, device)
    resp_dt = 0.1 / ratio
    n_t = 256 * ratio
    det = dm.params.replace(response_sampling=resp_dt,
                            time_window=n_t * resp_dt,
                            time_padding=n_t * resp_dt + 1.0)
    tracks = tpa.detector_tracks(dm.tpc_borders, seed=9, tracks_per_event=4)
    segs = drift(quench(from_structured(tracks, pad_to=32, device=device),
                        det, physics.BOX), det)
    pixels, _, _ = pixelize.get_pixels(segs, det, max_active=16, radius=1,
                                       max_neighboring=64)
    px, py = pixel_centers(torch.clamp(pixels, min=0), det)
    response = torch.from_numpy(make_response(
        n_xy=45, n_t=n_t, sampling=resp_dt)).to(device)
    valid = segs.valid.cpu().numpy()
    seg_np = {k: getattr(segs, k).cpu().numpy()[valid]
              for k in ('z_start', 'z_end', 'pixel_plane', 'long_diff',
                        't_start', 't0_start')}
    return current.current(
        segs, px, py, pixels >= 0, response, det, smear.to(device),
        n_steps=smear.shape[2], t_sig=2048,
        shift_band=current.host_shift_band(seg_np, det))


@pytest.mark.parametrize('ratio', [1, 2])
def test_induced_current_kernel(cuda, tmp_path, ratio):
    tree = tpa.write_tree(tmp_path)
    smear = torch.randn((3, 32, 512),
                        generator=torch.Generator().manual_seed(1))
    before = binding.launches['induced_current']
    got = _current_on(cuda, tree, ratio, smear)
    torch.cuda.synchronize()
    assert binding.launches['induced_current'] == before + 1
    want = _current_on(torch.device('cpu'), tree, ratio, smear)
    peak = want.abs().max().item()
    assert peak > 0
    err = (got.cpu() - want).abs().max().item()
    assert err <= 2e-5 * peak, (err, peak)


def test_fee_fsm_kernel(cuda, tmp_path):
    det = tpa.load_port(tpa.write_tree(tmp_path), cuda).params
    gen = torch.Generator(cuda).manual_seed(3)
    U, n_scan, max_adc, T = 3000, 800, 10, 700
    sig = torch.rand((n_scan, U), generator=gen, device=cuda) * 30000.0
    sig = torch.where(torch.rand((n_scan, U), generator=gen, device=cuda)
                      > 0.97, sig, 0.0)
    sig[T:] = 0.0
    noise = torch.randn((n_scan, 5, U), generator=gen, device=cuda)
    s = fee.fsm_scalars(det, max_adc=max_adc, time_padding=10.0)
    q_init = torch.randn((U,), generator=gen, device=cuda) * s.sigma_reset
    thr = torch.full((U,), det.f32('discrimination_threshold'), device=cuda)
    times = torch.linspace(0.0, 190.0, T + 1, device=cuda)
    before = binding.launches['fee_fsm']
    got = fee.fee_fsm(sig, noise, q_init, thr, times, s)
    torch.cuda.synchronize()
    assert binding.launches['fee_fsm'] == before + 1
    want = fee.fee_fsm_plain(sig, noise, q_init, thr, times, s)
    assert int(want[2].sum()) > 0 and int(want[2].max()) >= 2
    for name, a, b in zip(('integrals', 'ticks', 'n_adc', 'reset_start',
                           'latch_end'), want, got):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-2,
                                       err_msg=name)


def _data_packets(path):
    with File(path, 'r') as f:
        pk = np.array(f['packets'])
        assert len(f['mc_packets_assn']) == len(pk)
    pk = pk[pk['packet_type'] == 0]
    return collections.Counter(
        tuple(int(p[k]) for k in ('io_group', 'io_channel', 'chip_id',
                                  'channel_id', 'timestamp', 'dataword'))
        for p in pk)


def test_cli_on_card_matches_cpu(cuda, tmp_path):
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET)
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=2)
    kw = dict(detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
              step_scale=2.0)
    k1, k2 = binding.launches['induced_current'], binding.launches['fee_fsm']
    run_simulation(inp, str(tmp_path / 'cuda.h5'), device='cuda', **kw)
    assert binding.launches['induced_current'] > k1
    assert binding.launches['fee_fsm'] > k2
    run_simulation(inp, str(tmp_path / 'cpu.h5'), device='cpu', **kw)
    on_card = _data_packets(str(tmp_path / 'cuda.h5'))
    on_cpu = _data_packets(str(tmp_path / 'cpu.h5'))
    n = max(sum(on_card.values()), sum(on_cpu.values()))
    assert n > 0
    assert sum((on_card & on_cpu).values()) >= 0.99 * n


@pytest.mark.parametrize('case', probe_folded.CASES)
def test_probe_folded_case(cuda, case):
    kernel = probe_folded.KERNEL[case]
    before = binding.launches[kernel]
    probe_folded.run_case(case, cuda)
    assert binding.launches[kernel] == before + 1


#: (U, n_scan_p, n_scan): a small shape and the probe shapes
PROBE_SHAPES = [(1024, 512, 400), (probe_fee.U, probe_fee.N_SCAN_P,
                                   probe_fee.N_SCAN)]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _assert_same(g, w)
        else:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w), float((g.float() - w.float()).abs().max())


@pytest.mark.parametrize('shape', PROBE_SHAPES, ids=['small', 'probe'])
@pytest.mark.parametrize('variant', probe_fee.VARIANTS)
def test_probe_fee_variant(cuda, variant, shape):
    U, n_scan_p, n_scan = shape
    inp = probe_fee.make_inputs(U, n_scan_p, cuda)
    args = (inp['sig'], inp['noise'], inp['scal'], inp['times'], inp['thr'],
            inp['q0'])
    before = binding.launches['probe_fee']
    got = probe_fee.probe_fee(variant, *args, n_scan=n_scan)
    torch.cuda.synchronize()
    assert binding.launches['probe_fee'] == before + 1
    _assert_same(got, probe_fee.probe_fee_plain(variant, *args,
                                                n_scan=n_scan))


@pytest.mark.parametrize('shape', PROBE_SHAPES, ids=['small', 'probe'])
@pytest.mark.parametrize('variant', probe_fee2.VARIANTS)
def test_probe_fee2_variant(cuda, variant, shape):
    U, n_scan_p, n_scan = shape
    inp = probe_fee2.make_inputs(U, n_scan_p, cuda)
    args = (inp['sig'], inp['noise'], inp['scal'], inp['times'], inp['thrq'])
    before = binding.launches['probe_fee2']
    got = probe_fee2.probe_fee2(variant, *args, n_scan=n_scan)
    torch.cuda.synchronize()
    assert binding.launches['probe_fee2'] == before + 1
    want = probe_fee2.probe_fee2_plain(variant, *args, n_scan=n_scan)
    assert torch.equal(got.state, want.state)
    assert [(o.shape, o.dtype) for o in got.outs] == \
        [(o.shape, o.dtype) for o in want.outs]
    if 'anyio' not in variant:  # the anyio outputs are never written
        _assert_same(got.outs, want.outs)
