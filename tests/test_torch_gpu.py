"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: skipped where no CUDA device is present.  On a machine with
an NVIDIA Hopper card (JAX need not be installed there) run

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerances: the induced current equals its plain version bit for bit (max
|err| 0) on the same inputs on the card, and agrees with the CPU run of the
same batch at atol 2e-5 x peak (the host glue's float32 rounding differs
between the two devices); the FSM's integers and floats equal its plain
version's; the CLI's data packets on the card agree with its CPU run (plain
versions) for >= 99% of packets; the card probes P1-P3
(``larndsim_tpu_torch/tools``) equal their plain versions bit for bit (P1
also the numpy values of the JAX probe), at a small shape, at the probe
shapes and, for P2 / P3, at fewer ticks than P2's register ring holds;
P1's TMA copy also with 128 KiB windows and on a strided view, a view TMA
cannot map raises before any launch, a map cuTensorMapEncodeTiled refuses
raises, and a P1 launch from a new thread gives the main thread's bits.
The light chain (plain PyTorch on both devices): the ordered photon sum
gives the CPU's bits; a light batch at the slice's widths (96 channels,
16 us), run on the card and on the CPU with the same draws,
agrees at ``tools.light_check``'s tolerances (waveforms within one
quantum, >= 99.9% of samples equal; truth records equal, the LUT-smearing
truth's beyond 1e-3 of the threshold), and two card runs are identical;
the smearing truth's two routes agree on the card; its product stays
float32 (within rtol 1e-5 of float64, where TF32 is ~1e-3 off) when the
caller enables TF32; a host-route worker's error fails the CLI.  Event
grouping: the light of three events as one group call equals their solo
calls on the card (waveforms and contributor / host-route records bit for
bit, the device route's records at the truth tolerance above: the batched
float64 FFTs and the one product are where the bits could move), and the
grouped CLI on the card gives the ungrouped run's packets and
``light_wvfm``.  Phases on the card are ranges of the profiler's capture
beside their kernels, and each K1 launch starts after the host start of
its phase on the card's clock as the benchmark sets it; the memory log
reads the card's memory.  The threshold trigger (mode 0): a
mode-0 batch on the card against the CPU with the same draws (trigger
tables equal, the rest as above, every truth route), the smearing truth's
routes with several triggers against each other, the trigger scan on the
card against the host walk (forced and random triggers), and three events
as one mode-0 group call against their solo calls, bit for bit.
Multi-device dispatch: K1 launched from a new thread on each card's
tensors equals its plain version; the CLI with two contexts on card 0
(and, with two cards, the 2x2 over both) gives every dataset of the
one-context run, bit for bit.  The waveform sum (D1) equals its plain
version under ``torch.equal`` on random inputs and on a chain batch, and
makes no synchronising call; the current fractions (D2) agree with theirs
at rtol 1e-5 / atol 1e-6 (JAX's tolerance for the op; the sums run in
other orders) and two launches give the same bits; both bindings refuse a
wrong dtype or a non-contiguous tensor; the CLI on the card runs none of
the four plain versions, D1 once per K1 launch and D2 once per batch in
which a pixel latched.
"""
from __future__ import annotations

import collections
import dataclasses
import tempfile
import threading

import numpy as np
import pytest
import torch

from larndsim_tpu_torch.assets.make_input import write_input
from larndsim_tpu_torch.assets.response import make_response
from larndsim_tpu_torch.io.h5 import File
from larndsim_tpu_torch.kernels import binding
from larndsim_tpu_torch.models.charge import pixel_centers
from larndsim_tpu_torch.ops import accumulate, current, fee, pixelize
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


def _current_args(device, tree, ratio, smear):
    """The induced current's arguments for a small drifted batch on
    ``device``."""
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
    return current.current_inputs(
        segs, px, py, pixels >= 0, response, det, smear.to(device),
        n_steps=smear.shape[2], t_sig=2048,
        shift_band=current.host_shift_band(seg_np, det))


def _assert_kernel_is_plain(args):
    """The kernel equals its plain version on ``args`` bit for bit, in one
    launch; returns the kernel's output."""
    before = binding.launches['induced_current']
    got = current.induced_current(*args)
    torch.cuda.synchronize()
    assert binding.launches['induced_current'] == before + 1
    want = current.current_plain(*args)
    assert got.shape == want.shape
    assert torch.equal(got, want), float((got - want).abs().max())
    return got


@pytest.mark.parametrize('ratio', [1, 2])
def test_induced_current_kernel(cuda, tmp_path, ratio):
    tree = tpa.write_tree(tmp_path)
    smear = torch.randn((3, 32, 512),
                        generator=torch.Generator().manual_seed(1))
    got = _assert_kernel_is_plain(_current_args(cuda, tree, ratio, smear))
    want = current.induced_current(
        *_current_args(torch.device('cpu'), tree, ratio, smear))
    peak = want.abs().max().item()
    assert peak > 0
    err = (got.cpu() - want).abs().max().item()
    assert err <= 2e-5 * peak, (err, peak)


#: LUT geometry of the synthetic K1 cases: 45 x 45 bins of the Module-0
#: response, 4.434 mm pixels
BIN, NXY, PITCH = 0.04434, 45, 0.4434


def _k1_case(device, *, seed, S=6, P=9, n_steps=512, t_sig=2048, ratio=1,
             ntp=600, shifts=(0, 20), tick_lo=(0, 40), nstep=None,
             padding=(), rows=40):
    """Induced-current arguments made from ``seed`` with numpy: S segments
    of P pixels on a 3 x 3 grid, ``n_steps`` points each within the LUT's
    reach; ``shifts`` the (lowest, highest) shift, each at least once;
    ``tick_lo`` the range of first ticks (scale 0 below); ``nstep`` the live
    steps of each segment (random when None); ``padding`` segments whose
    pixels are all padding; ``rows`` the number of distinct (x, y) LUT bins
    that the points of a segment fall in (about 40 in production), or None
    for points anywhere within 2 cm."""
    rng = np.random.default_rng(seed)
    lut = current.LutGeometry(BIN, NXY, NXY, ratio)
    resp = rng.standard_normal((lut.zero_row + 1, ntp)).astype(np.float32)
    resp[-1] = 0.0
    base = rng.uniform(-20.0, 20.0, (S, 2)).astype(np.float32)
    pxc = (base[:, :1] + PITCH * (np.arange(P) % 3)).astype(np.float32)
    pyc = (base[:, 1:] + PITCH * (np.arange(P) // 3)).astype(np.float32)
    if rows is None:
        off = rng.uniform(-0.5, 1.4, (2, S, n_steps))
    else:  # bin centres of distinct (i, j) bins from the first pixel
        k = rng.permutation(NXY * NXY)[:rows]
        pick = k[rng.integers(0, rows, (S, n_steps))]
        pick[:, :rows] = k[None, :min(rows, n_steps)]
        off = np.stack([(pick // NXY + 0.5) * BIN, (pick % NXY + 0.5) * BIN])
    xs = (base[:, :1] + off[0]).astype(np.float32)
    ys = (base[:, 1:] + off[1]).astype(np.float32)
    shift = rng.integers(shifts[0], shifts[1] + 1, (S, n_steps))
    shift[:, 0], shift[:, -1] = shifts[1], shifts[0]
    phase = rng.integers(0, ratio, (S, n_steps))
    if nstep is None:
        nstep = rng.integers(1, n_steps + 1, S)
    nstep = np.asarray(nstep, np.int64)
    live = np.arange(n_steps)[None, :] < nstep[:, None]
    xs = np.where(live, xs, np.float32(current.FAR)).astype(np.float32)
    shift = np.where(live, shift, 0)
    phase = np.where(live, phase, 0)
    for s in padding:
        pxc[s] = pyc[s] = current.FAR
    lo = rng.integers(tick_lo[0], tick_lo[1] + 1, S)
    tick_hi = np.where(live, shift, 0).max(axis=1)
    charge = rng.uniform(0.5, 2.0, S).astype(np.float32)
    scale = charge[:, None] * (np.arange(t_sig)[None, :] >= lo[:, None])
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    f32, i32 = np.float32, np.int32
    return (t(xs, f32), t(ys, f32), t(shift, i32), t(phase, i32),
            t(pxc, f32), t(pyc, f32), t(nstep, i32), t(lo, i32),
            t(tick_hi, i32), t(scale, f32), t(resp, f32), lut)


#: the kernel's edge cases: ragged tick counts, tick_lo inside a tile and
#: on a tile edge, shifts at both clip edges (K0 = 128, span 256), segments
#: without steps, more steps than one chunk of 512, padding segments, points
#: anywhere within 2 cm, a segment whose 512 distinct rows overflow shared
#: memory (its steps tabled again in chunks of fewer steps) and one whose 60
#: rows shrink the tick tile, at ratios 1 and 2
K1_CASES = dict(
    ratio1=dict(seed=1),
    ratio2=dict(seed=2, ratio=2),
    ragged_t_sig=dict(seed=3, t_sig=1037, ntp=1200),
    tick_lo_in_tile=dict(seed=4, tick_lo=(300, 300)),
    tick_lo_at_tile_edge=dict(seed=5, tick_lo=(1024, 1024), shifts=(0, 0),
                              ntp=1500),
    clip_edges=dict(seed=6, shifts=(-128, 128), ntp=300, rows=30),
    nstep_0=dict(seed=7, nstep=[0, 5, 0, 512, 1, 0]),
    steps_past_chunk=dict(seed=8, n_steps=1100, t_sig=1500),
    padding_segments=dict(seed=9, padding=(0, 2, 5)),
    random_points=dict(seed=10, rows=None, ratio=2),
    rows_past_budget=dict(seed=11, S=2, rows=512, shifts=(0, 128),
                          nstep=[512, 512]),
    rows_past_budget_chunks=dict(seed=12, S=2, n_steps=1100, rows=512,
                                 shifts=(-64, 64), ratio=2),
    rows_shrink_tile=dict(seed=13, S=3, rows=60, shifts=(0, 40)),
)


@pytest.mark.parametrize('case', list(K1_CASES))
def test_induced_current_kernel_edges(cuda, case):
    kw = K1_CASES[case]
    out = _assert_kernel_is_plain(_k1_case(cuda, **kw))
    assert bool((out != 0).any())
    for s in kw.get('padding', ()):
        assert not bool(out[s].any())


#: FSM cases (U, n_scan, max_adc, T, signal probability): U not a multiple
#: of the block of 64 pixels, n_scan not a multiple of the 16 ticks loaded
#: ahead (kAhead), fewer tick times than ticks (T + 1 < n_scan), and a signal that
#: fills all max_adc slots of many pixels
FSM_CASES = dict(
    ragged=(3000, 803, 10, 700, 0.03),
    short=(70, 5, 4, 3, 0.5),
    full_slots=(257, 900, 3, 850, 0.5),
)


@pytest.mark.parametrize('case', list(FSM_CASES))
def test_fee_fsm_kernel(cuda, tmp_path, case):
    det = tpa.load_port(tpa.write_tree(tmp_path), cuda).params
    gen = torch.Generator(cuda).manual_seed(3)
    U, n_scan, max_adc, T, p = FSM_CASES[case]
    sig = torch.rand((n_scan, U), generator=gen, device=cuda) * 30000.0
    sig = torch.where(torch.rand((n_scan, U), generator=gen, device=cuda)
                      > 1.0 - p, sig, 0.0)
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
    if case != 'short':
        assert int(want[2].sum()) > 0 and int(want[2].max()) >= 2
    if case == 'full_slots':
        assert int((want[2] == max_adc).sum()) > 10
    for name, a, b in zip(fee.FeeResult._fields, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a - b).abs().max()))


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
    kw = dict(config='module0',
              detector_properties=paths['detector_properties'],
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


#: (q_sz, q_step, n_windows, n_sub) of the TMA copy: cases f and g, and
#: windows of 128 KiB (q_sz 32 of an (8, n_sub, 128) slab)
TMA_WINDOWS = [(9, 2, 2, 32), (16, 8, 2, 32), (32, 32, 3, 96)]


@pytest.mark.parametrize('window', TMA_WINDOWS, ids=['f', 'g', 'q32'])
def test_probe_async_copy_windows(cuda, window):
    q_sz, q_step, n_windows, n_sub = window
    slab = torch.randn((8, n_sub, 128), generator=torch.Generator(
        ).manual_seed(q_sz)).to(cuda)
    before = binding.launches['probe_async_copy']
    got = probe_folded.async_copy(slab, q_step, q_sz, n_windows)
    torch.cuda.synchronize()
    assert binding.launches['probe_async_copy'] == before + 1
    assert torch.equal(got, probe_folded.async_copy_plain(
        slab, q_step, q_sz, n_windows))


def test_probe_async_copy_moves_a_strided_view(cuda):
    """A view whose strides are multiples of 16 bytes is one tensor map:
    moved as it is."""
    big = torch.randn((8, 40, 132), generator=torch.Generator(
        ).manual_seed(3)).to(cuda)
    slab = big[:, 4:36, :128]
    assert not slab.is_contiguous()
    got = probe_folded.async_copy(slab, 8, 16, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, probe_folded.async_copy_plain(slab, 8, 16, 2))


def test_probe_async_copy_refuses_a_view_tma_cannot_map(cuda):
    """Rows of 130 floats (520 bytes) are no TMA stride: the wrapper
    raises before any launch and copies nothing first."""
    slab = torch.zeros((8, 32, 130), device=cuda)[:, :, :128]
    before = binding.launches['probe_async_copy']
    with pytest.raises(ValueError, match='multiple of 16 bytes'):
        probe_folded.async_copy(slab, 8, 16, 2)
    assert binding.launches['probe_async_copy'] == before


def test_probe_async_copy_raises_where_the_map_is_refused(cuda):
    """The launch function given the same 520-byte stride:
    cuTensorMapEncodeTiled refuses the tensor map, the launch returns its
    CUresult negated and the wrapper's check raises."""
    slab = torch.zeros((8, 32, 130), device=cuda)
    out = torch.empty((2, 8, 16, 128), device=cuda)
    err = binding._launch(
        binding._lib().probe_async_copy_launch, slab.device,
        slab.data_ptr(), out.data_ptr(), 8, 32, 128, 32 * 130, 130, 8, 16, 2)
    assert err < 0
    with pytest.raises(RuntimeError, match='cuTensorMapEncodeTiled'):
        binding._raise_on(err, 'probe_async_copy')


@pytest.mark.parametrize('case', ['a', 'c', 'g'])
def test_probe_launch_from_a_new_thread_gives_the_same_bits(cuda, case):
    """A P1 kernel launched from a thread of its own, on a stream of its
    own on card 0, equals the main thread's launch."""
    fn, (x, *rest), _ = probe_folded.case_call(case)
    x = torch.from_numpy(x).to('cuda:0')
    want = fn(x, *rest)
    out, errors = [], []

    def launch():
        try:
            with torch.cuda.stream(torch.cuda.Stream('cuda:0')):
                out.append(fn(x, *rest))
                torch.cuda.current_stream('cuda:0').synchronize()
        except BaseException as exc:
            errors.append(exc)
    t = threading.Thread(target=launch)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    torch.cuda.synchronize()
    assert torch.equal(out[0], want)


#: (U, n_scan_p, n_scan): a small shape, the probe shapes, and fewer ticks
#: than P2's ring holds
PROBE_SHAPES = [(1024, 512, 400), (probe_fee.U, probe_fee.N_SCAN_P,
                                   probe_fee.N_SCAN), (1024, 256, 7)]
PROBE_IDS = ['small', 'probe', 'short']


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _assert_same(g, w)
        else:
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w), float((g.float() - w.float()).abs().max())


@pytest.mark.parametrize('shape', PROBE_SHAPES, ids=PROBE_IDS)
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


@pytest.mark.parametrize('shape', PROBE_SHAPES, ids=PROBE_IDS)
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


def test_ordered_sum_on_card_is_the_cpu_sum(cuda):
    """Rows added in index order on both devices: the same bits, even where
    the order changes the rounding."""
    from larndsim_tpu_torch.ops.light import ordered_sum
    gen = torch.Generator().manual_seed(4)
    keys = torch.randint(0, 5000, (200_000,), generator=gen)
    keys[::7] = 6000                                  # dropped rows
    vals = torch.randn((200_000, 96), generator=gen) * torch.exp(
        torch.randn((200_000, 1), generator=gen) * 8)
    want = ordered_sum(keys, vals, 5000)
    got = ordered_sum(keys.to(cuda), vals.to(cuda), 5000)
    again = ordered_sum(keys.to(cuda), vals.to(cuda), 5000)
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


@pytest.fixture(scope='module')
def light_batch(cuda, tmp_path_factory):
    """The first triggering light batch of a CLI run on the card: the small
    tree with one 2x2 module's light keys (96 channels, beam trigger,
    16 us)."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.tools import light_check
    tmp = tmp_path_factory.mktemp('light')
    paths = tpa.write_tree(tmp / 'tree', light=True)
    inp = str(tmp / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=7)
    with light_check.first_batch() as seen:
        run_simulation(inp, str(tmp / 'out.h5'), config='module0',
                       detector_properties=paths['detector_properties'],
                       pixel_layout=paths['pixel_layout'],
                       simulation_properties=paths['simulation_properties'],
                       response_file=str(tmp / 'r.npy'), rand_seed=7,
                       step_scale=2.0, device='cuda')
    assert len(seen) == 1
    return seen[0]


LIGHT_ROUTES = dict(
    smearing=dict(smearing=True, truth_ids=0),
    contributor_truth=dict(smearing=False, truth_ids=16),
    smearing_truth_device=dict(smearing=True, truth_ids=50, threshold=0.1,
                               truth_path='device'),
    smearing_truth_host=dict(smearing=True, truth_ids=50, threshold=0.1,
                             truth_path='host'))


@pytest.mark.parametrize('route', list(LIGHT_ROUTES))
def test_light_batch_on_card_matches_cpu(light_batch, route):
    from larndsim_tpu_torch.tools import light_check
    args, kw = light_batch
    opts = LIGHT_ROUTES[route]
    card = light_check.rerun(args, kw, 'cuda', 5, **opts)
    again = light_check.rerun(args, kw, 'cuda', 5, **opts)
    cpu = light_check.rerun(args, kw, 'cpu', 5, **opts)
    assert card.waveforms.shape == (1, 96, 256)
    assert light_check.identical(card, again)
    rec = light_check.compare(card, cpu, args[1],
                              smeared_at=opts.get('threshold'))
    assert rec['peak'] > 64
    assert (rec['records'] > 0) == (opts['truth_ids'] > 0)


def test_smearing_truth_routes_agree_on_card(light_batch):
    from larndsim_tpu_torch.tools import light_check
    args, kw = light_batch
    dev, host = (light_check.rerun(args, kw, 'cuda', 5,
                                   **LIGHT_ROUTES[f'smearing_truth_{r}'])
                 for r in ('device', 'host'))
    rec = light_check.compare(dev, host, args[1], smeared_at=0.1)
    assert rec['records'] > 0 and rec['max_abs_err'] == 0


def test_truth_product_is_float32_under_tf32(cuda):
    """The device route's product keeps float32 when the caller turns TF32
    on, and leaves the caller's setting."""
    from larndsim_tpu_torch.ops import f32
    gen = torch.Generator().manual_seed(8)
    a = torch.randn((256, 16384), generator=gen)
    b = torch.randn((16384, 256), generator=gen)
    want = (a.double() @ b.double()).float()
    a, b = a.to(cuda), b.to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = (a @ b).cpu()
        got = f32.matmul(a, b).cpu()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    # |err| over the output's peak: TF32 rounds each term to 2^-11
    err = lambda x: float((x - want).abs().max() / want.abs().max())
    assert err(tf32) > 1e-4, ('TF32 was not in effect', err(tf32))
    assert err(got) < 1e-5, err(got)


def test_truth_route_under_tf32_matches_cpu(light_batch):
    from larndsim_tpu_torch.tools import light_check
    args, kw = light_batch
    opts = LIGHT_ROUTES['smearing_truth_device']
    cpu = light_check.rerun(args, kw, 'cpu', 5, **opts)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = light_check.rerun(args, kw, 'cuda', 5, **opts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert light_check.compare(card, cpu, args[1],
                               smeared_at=0.1)['records'] > 0


def test_host_route_worker_error_fails_the_cli(cuda, tmp_path, monkeypatch):
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.models import light as light_model
    paths = tpa.write_tree(tmp_path / 'tree', light=True,
                           sim_overrides=dict(max_light_truth_ids=50))
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=7)

    def broken(*args, **kwargs):
        raise RuntimeError('worker failed')
    monkeypatch.setattr(light_model, '_host_smeared_truth_sparse', broken)
    with pytest.raises(RuntimeError, match='worker failed'):
        run_simulation(inp, str(tmp_path / 'out.h5'), config='module0',
                       detector_properties=paths['detector_properties'],
                       pixel_layout=paths['pixel_layout'],
                       simulation_properties=paths['simulation_properties'],
                       response_file=str(tmp_path / 'r.npy'), rand_seed=7,
                       step_scale=2.0, device='cuda', truth_path='host',
                       truth_workers=2)


@pytest.mark.parametrize('route', list(LIGHT_ROUTES))
def test_light_group_on_card_equals_solo(light_batch, route):
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.segments import stack
    from larndsim_tpu_torch.tools import light_check
    (segs, light, sim, n_det, vox, lut, noise, _), _ = light_batch
    opts = LIGHT_ROUTES[route]
    light = light.replace(enable_lut_smearing=opts['smearing'])
    sim = dataclasses.replace(sim, max_mc_truth_ids=opts['truth_ids'],
                              mc_truth_threshold=opts.get('threshold', 0.1))
    path = opts.get('truth_path', 'device')
    # three events: the batch, and copies of it 0.3 and 0.6 us later
    events = [segs.replace(t0=segs.t0 + 0.3 * g) for g in range(3)]

    def draws():
        return [light_check.cpu_draw(10 + g, segs.t0.device)
                for g in range(3)]
    solos = [light_model.simulate_light_batch(
        e, light, sim, n_det, vox, lut, noise, d, truth_path=path)
        for e, d in zip(events, draws())]
    group = light_model.simulate_light_group(
        stack(events), light, sim, torch.stack([n_det] * 3),
        torch.stack([vox] * 3), lut, noise, draws(), truth_path=path)
    n_records = 0
    for s, g in zip(solos, group):
        assert g.waveforms.shape == (1, 96, 256)
        assert torch.equal(g.waveforms, s.waveforms)
        if s.truth_sparse is None:
            assert g.truth_sparse is None
        elif path == 'device' and opts['smearing']:
            n_records += light_check.records_agree(
                g.truth_sparse, s.truth_sparse, 0.1)['records']
        else:
            for k in s.truth_sparse:
                assert np.array_equal(g.truth_sparse[k], s.truth_sparse[k])
            n_records += len(s.truth_sparse['tick'])
    assert float(solos[0].waveforms.abs().max()) > 64
    assert (n_records > 0) == (opts['truth_ids'] > 0)


def test_grouped_cli_on_card_equals_ungrouped(cuda, tmp_path):
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.tools import light_check
    paths = tpa.write_tree(tmp_path / 'tree', detector_overrides=tpa.QUIET,
                           light=True, sim_overrides=dict(
                               max_light_truth_ids=50,
                               mc_truth_threshold=0.1))
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=4,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=7)
    outs = {}
    for g in (1, 3):
        outs[g] = str(tmp_path / f'g{g}.h5')
        run_simulation(inp, outs[g], config='module0',
                       detector_properties=paths['detector_properties'],
                       pixel_layout=paths['pixel_layout'],
                       simulation_properties=paths['simulation_properties'],
                       response_file=str(tmp_path / 'r.npy'), rand_seed=7,
                       step_scale=2.0, device='cuda', event_group_size=g)
    got = {}
    for g, path in outs.items():
        with File(path, 'r') as f:
            pk = np.array(f['packets'])
            got[g] = (collections.Counter(map(tuple, pk[pk['packet_type']
                                                        == 0].tolist())),
                      np.array(f['light_wvfm']),
                      np.array(f['light_wvfm_mc_assn']))
    assert sum(got[1][0].values()) > 0 and got[1][0] == got[3][0]
    assert np.array_equal(got[1][1], got[3][1])
    assert light_check.records_agree(
        got[3][2], got[1][2], 0.1, keys=('trigger_id', 'op_channel_id',
                                         'tick', 'event_id',
                                         'segment_id'))['records'] > 0


def test_trace_times_phases_on_the_card(cuda, tmp_path):
    """Phases on the card are ranges of a ``start_trace`` capture, nested
    as they ran, beside the kernels launched inside them; the table keeps
    wall, CPU and calls."""
    import json

    from larndsim_tpu_torch.utils import trace
    trace.reset()
    a = torch.randn((2048, 2048), device=cuda)
    torch.cuda.synchronize()
    trace.start_trace(str(tmp_path / 'trace'))
    with trace.phase('outer', cuda):
        with trace.phase('inner', cuda):
            for _ in range(20):
                b = a @ a
        b.sum()
    torch.cuda.synchronize()
    with open(trace.stop_trace()) as f:
        events = json.load(f)['traceEvents']
    spans = {e['name']: (e['ts'], e['ts'] + e['dur']) for e in events
             if e.get('cat') == 'user_annotation'
             and e.get('name') in ('outer', 'inner')}
    assert set(spans) == {'outer', 'inner'}
    assert spans['outer'][0] <= spans['inner'][0] \
        <= spans['inner'][1] <= spans['outer'][1]
    kernels = {e['args']['correlation'] for e in events
               if e.get('cat') == 'kernel'}
    launched = [e for e in events
                if e.get('cat') in ('cuda_runtime', 'cuda_driver')
                and e.get('args', {}).get('correlation') in kernels]
    inside = [e for e in launched
              if spans['inner'][0] <= e['ts'] <= spans['inner'][1]]
    assert len(inside) >= 20 and len(launched) > len(inside)
    rows = {r.split()[0]: r for r in trace.report().splitlines()}
    assert rows['inner'].endswith('1 calls)') and 'device' not in rows['inner']
    trace.reset()


def test_spans_and_kernels_share_the_card_clock(cuda, tmp_path):
    """A CLI call traced as the benchmark traces it: the port's phases as
    host ranges (``port_bench.harness.PhaseLog``), the card's activity
    under ``torch.profiler``, the card's clock set against the host's by
    one marker kernel on the idle card (``port_bench.trace_read``).  Every
    K1 launch starts on the card at or after the host start of the
    ``charge/current_pallas`` phase that launched it."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.utils import trace
    from port_bench import harness, trace_read
    paths = tpa.write_tree(tmp_path / 'tree')
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=3,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=2)
    kw = dict(config='module0',
              detector_properties=paths['detector_properties'],
              pixel_layout=paths['pixel_layout'],
              simulation_properties=paths['simulation_properties'],
              response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
              step_scale=2.0, light_simulated=False, device='cuda')
    run_simulation(inp, str(tmp_path / 'warm.h5'), **kw)
    phases = harness.PhaseLog(trace)
    launches = binding.launches['induced_current']
    with phases.recording(), \
            profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        marker_ns = time.time_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        window = [time.time_ns(), None]
        run_simulation(inp, str(tmp_path / 'out.h5'), **kw)
        torch.cuda.synchronize()
        window[1] = time.time_ns()
    launches = binding.launches['induced_current'] - launches
    events = prof.profiler.kineto_results.events()
    offset = trace_read.reduce(events, window, phases.ranges,
                               marker_ns)['clock_offset_ns']
    kernels = sorted(trace_read._start_ns(ev) for ev in events
                     if trace_read._is_device(ev)
                     and 'induced_current_kernel' in ev.name())
    spans = sorted(s for s, _, label in phases.ranges
                   if label == 'charge/current_pallas')
    # one K1 launch a phase
    assert len(kernels) == len(spans) == launches > 0, \
        (len(kernels), len(spans), launches)
    margins_us = [(start - span - offset) / 1e3
                  for start, span in zip(kernels, spans)]
    print(f'K1 start after its phase\'s host start, us: {margins_us}')
    assert min(margins_us) >= 0, margins_us
    assert {'cli/input', 'cli/batching', 'cli/segments', 'cli/accumulate',
            'export/final'} <= {label for _, _, label in phases.ranges}


def test_memlog_reads_the_card(cuda, tmp_path):
    from larndsim_tpu_torch.utils.memlog import MemoryLogger, read_memlog
    ml = MemoryLogger(device=cuda)
    ml.start()
    x = torch.empty(2 ** 26, device=cuda)
    ml.take_snapshot()
    ml.archive('loading')
    ml.store(str(tmp_path / 'mem.h5'))
    rec = read_memlog(str(tmp_path / 'mem.h5'))['loading']
    assert float(np.asarray(rec['gpu_mem_used'])[0]) >= x.numel() * 4
    assert float(np.asarray(rec['gpu_mem_free'])[0]) > 0


# ---------------------------------------------------------------------------
# the threshold trigger (mode 0)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def mode0_batch(cuda, tmp_path_factory):
    """The first light batch of a CLI run on the card in mode 0: the small
    tree with one module's light keys (96 channels, 16 us window) and the
    threshold trigger (groups of 6 at -2000 ADC)."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.tools import light_check
    tmp = tmp_path_factory.mktemp('mode0')
    paths = tpa.write_tree(tmp / 'tree', light=dict(light_trig_mode=0))
    inp = str(tmp / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=2,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=7)
    with light_check.first_batch() as seen:
        run_simulation(inp, str(tmp / 'out.h5'), config='module0',
                       detector_properties=paths['detector_properties'],
                       pixel_layout=paths['pixel_layout'],
                       simulation_properties=paths['simulation_properties'],
                       response_file=str(tmp / 'r.npy'), rand_seed=7,
                       step_scale=2.0, device='cuda')
    assert len(seen) == 1 and 't0_det' in seen[0][1]
    return seen[0]


@pytest.mark.parametrize('route', list(LIGHT_ROUTES))
def test_mode0_batch_on_card_matches_cpu(mode0_batch, route):
    """The mode-0 batch on the card against the CPU with the same draws:
    trigger tables equal, waveforms and records at light_check's
    tolerances; two card runs identical."""
    from larndsim_tpu_torch.tools import light_check
    args, kw = mode0_batch
    opts = LIGHT_ROUTES[route]
    card = light_check.rerun(args, kw, 'cuda', 5, **opts)
    again = light_check.rerun(args, kw, 'cuda', 5, **opts)
    cpu = light_check.rerun(args, kw, 'cpu', 5, **opts)
    assert len(card.trigger_idx) >= 2 and (card.trigger_type == 0).all()
    assert card.waveforms.shape == (len(card.trigger_idx), 96, 256)
    assert light_check.identical(card, again)
    rec = light_check.compare(card, cpu, args[1],
                              smeared_at=opts.get('threshold'))
    assert rec['peak'] > 64
    assert (rec['records'] > 0) == (opts['truth_ids'] > 0)
    if opts['truth_ids']:
        assert len(np.unique(card.truth_sparse['trig'])) > 1


def test_mode0_smearing_routes_agree_on_card(mode0_batch):
    """The device route's one product with every trigger's table against
    the host route's per-trigger tables, on the card."""
    from larndsim_tpu_torch.tools import light_check
    args, kw = mode0_batch
    dev, host = (light_check.rerun(args, kw, 'cuda', 5,
                                   **LIGHT_ROUTES[f'smearing_truth_{r}'])
                 for r in ('device', 'host'))
    rec = light_check.compare(dev, host, args[1], smeared_at=0.1)
    assert rec['records'] > 0 and rec['max_abs_err'] == 0
    assert rec['triggers'] >= 2


@pytest.mark.parametrize('signal', ['forced', 'pulses'])
def test_mode0_scan_on_card_matches_host_walk(cuda, tmp_path, signal):
    """The scan on the card against the host walk on the CPU: a threshold
    of 1e30 (every tick above: a trigger every dead time) and random
    pulses within and past the dead time, on one module and on two."""
    from larndsim_tpu_torch.ops import light as lo
    from larndsim_tpu_torch.params import load_light
    paths = tpa.write_tree(tmp_path, light=dict(light_trig_mode=0))
    light = load_light(paths['detector_properties'], device='cpu')
    light_card = load_light(paths['detector_properties'], device='cuda')
    dt = lo.digit_ticks(light)
    T = 4 * dt + 500
    rng = np.random.default_rng(9)
    n_trig = 0
    for modules in ({1: [0, 1]}, {1: [0], 2: [1]}):
        t2m = {t: m for m, tpcs in modules.items() for t in tpcs}
        for trial in range(3):
            sig = np.zeros((96, T), np.float32)
            if signal == 'pulses':
                for _ in range(10):
                    g = int(rng.integers(0, 16))
                    t = int(rng.integers(0, T - 120))
                    sig[g * 6:(g + 1) * 6, t:t + 100] = -400.0
                thr = np.full(16, -1500.0)
            else:
                sig += rng.standard_normal(sig.shape).astype(np.float32)
                thr = np.full(16, 1e30)
            got = lo.get_triggers(torch.from_numpy(sig).to(cuda), thr,
                                  np.arange(96), 0, light_card, modules, t2m)
            want = lo.get_triggers(torch.from_numpy(sig), thr,
                                   np.arange(96), 0, light, modules, t2m,
                                   device_scan=False)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            n_trig += len(want[0])
    assert n_trig > (20 if signal == 'forced' else 10)


@pytest.mark.parametrize('route', list(LIGHT_ROUTES))
def test_mode0_group_on_card_equals_solo(mode0_batch, route):
    """Three events (the batch and copies 0.3 and 0.6 us later: one window
    bucket) as one simulate_light_group_mode0 call against their solo
    calls on the card."""
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.segments import stack
    from larndsim_tpu_torch.tools import light_check
    (segs, light, sim, n_det, vox, lut, noise, _), kw = mode0_batch
    opts = LIGHT_ROUTES[route]
    light = light.replace(enable_lut_smearing=opts['smearing'])
    sim = dataclasses.replace(sim, max_mc_truth_ids=opts['truth_ids'],
                              mc_truth_threshold=opts.get('threshold', 0.1))
    path = opts.get('truth_path', 'device')
    events = [segs.replace(t0=segs.t0 + 0.3 * g) for g in range(3)]
    t0s = [kw['t0_det'] + 0.3 * g for g in range(3)]
    windows = [light_model.mode0_window(n_det.cpu(), t.cpu(), light)
               for t in t0s]
    assert len({w[0] for w in windows}) == 1

    def draws():
        return [light_check.cpu_draw(10 + g, segs.t0.device)
                for g in range(3)]
    mods = kw['module_to_tpcs']
    solos = [light_model.simulate_light_batch(
        e, light, sim, n_det, vox, lut, noise, d, truth_path=path,
        module_to_tpcs=mods, sim_window=w)
        for e, d, w in zip(events, draws(), windows)]
    group = light_model.simulate_light_group_mode0(
        stack(events), light, sim, torch.stack([n_det] * 3),
        torch.stack([vox] * 3), lut, noise, draws(), windows=windows,
        module_to_tpcs=mods, truth_path=path)
    n_records = 0
    for s, g in zip(solos, group):
        assert np.array_equal(g.trigger_idx, s.trigger_idx)
        assert len(s.trigger_idx) >= 2
        assert torch.equal(g.waveforms, s.waveforms)
        if s.truth_sparse is None:
            assert g.truth_sparse is None
            continue
        for k in s.truth_sparse:
            assert np.array_equal(g.truth_sparse[k], s.truth_sparse[k])
        n_records += len(s.truth_sparse['tick'])
    assert (n_records > 0) == (opts['truth_ids'] > 0)


# --------------------------------------------------------------------------
# module-to-module variation (the 2x2 configuration)
# --------------------------------------------------------------------------

def _mod2mod_kw(tmp):
    """The small four-module tree with 24 channels, LUT smearing and the
    2x2 "truth on" (K 50, threshold 0.1); an input with tracks in every
    TPC of every spill, inside the digitized window."""
    paths = tpa.write_tree_2x2(
        tmp / 'tree', detector_overrides=tpa.QUIET,
        light=dict(n_op_channel=24, light_window=(0.0, 16.0)),
        sim_overrides=dict(max_light_truth_ids=50, mc_truth_threshold=0.1))
    inp = str(tmp / 'in.h5')
    geo = tpa.load_port(dict(paths, pixel_layout=paths['pixel_layout'][0]))
    tpa.write_spills_2x2(inp, geo.tpc_borders, n_events=4,
                         tracks_per_event=16)
    return inp, dict(config='2x2',
                     detector_properties=paths['detector_properties'],
                     pixel_layout=paths['pixel_layout'],
                     simulation_properties=paths['simulation_properties'],
                     response_file=paths['response_file'],
                     light_lut_filename=paths['light_lut_filename'],
                     light_det_noise_filename=str(tmp / 'n.npy'),
                     rand_seed=7, step_scale=2.0)


def _cpu_made_draw(rand_seed, i_mod, event, i_subbatch, device):
    """Light draws made on the CPU from the batch's identity (the
    ``cli.simulate_pixels.light_draw`` of a card-against-CPU run: the two
    devices' generators give other streams)."""
    from larndsim_tpu_torch.tools import light_check
    return light_check.cpu_draw(
        rand_seed + 1000 * max(i_mod, 0) + 10 * int(event) + i_subbatch,
        device)


def _mod2mod_run(inp, out, kw, device):
    from larndsim_tpu_torch.cli import simulate_pixels as cli
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, 'light_draw', _cpu_made_draw)
        cli.run_simulation(inp, out, device=device, **kw)


@pytest.fixture(scope='module')
def mod2mod_card(cuda, tmp_path_factory):
    """A four-module CLI run on the card: its output, each module's
    launches, module 3's and module 1's first K1 / K2 arguments and module
    3's first triggering light batch."""
    from larndsim_tpu_torch.tools import light_check
    from larndsim_tpu_torch.tools.module_tracker import module_tracker
    tmp = tmp_path_factory.mktemp('mod2mod')
    inp, kw = _mod2mod_kw(tmp)
    out = str(tmp / 'cuda.h5')
    with module_tracker(capture=True) as t, light_check.first_batch(
            keep=lambda a, k: t['module'] == 3) as seen:
        _mod2mod_run(inp, out, kw, 'cuda')
    assert len(seen) == 1
    return dict(inp=inp, kw=kw, out=out, tmp=tmp, light=seen[0], **t)


def test_mod2mod_cli_on_card_matches_cpu(mod2mod_card):
    """Every module launches both kernels; packets on all eight io groups
    agree with the CPU run, the merged light_wvfm (both runs with the same
    CPU-made light draws) within one quantum."""
    r = mod2mod_card
    for m in (1, 2, 3, 4):
        assert r['launches'][m]['induced_current'] > 0, r['launches']
        assert r['launches'][m]['fee_fsm'] > 0, r['launches']
    cpu = str(r['tmp'] / 'cpu.h5')
    _mod2mod_run(r['inp'], cpu, r['kw'], 'cpu')
    on_card, on_cpu = _data_packets(r['out']), _data_packets(cpu)
    n = max(sum(on_card.values()), sum(on_cpu.values()))
    assert n > 0 and sum((on_card & on_cpu).values()) >= 0.99 * n
    assert {k[0] for k in on_card} == set(range(1, 9))
    with File(r['out'], 'r') as f, File(cpu, 'r') as g:
        a, b = np.array(f['light_wvfm']), np.array(g['light_wvfm'])
        assert a.shape == b.shape == (4, 24, 256)
        assert 'light_wvfm_mod0' not in f.keys()
        d = np.abs(a.astype(np.float64) - b)
        assert d.max() <= 64 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize('module', [1, 3])
def test_mod2mod_kernels_are_plain(mod2mod_card, module):
    """K1 and K2 on a module's first batch (module 3: 16 x 16-pixel tiles
    at 3.87975 mm and its own response) equal their plain versions."""
    r = mod2mod_card
    _assert_kernel_is_plain(r['k1'][module])
    args = r['k2'][module]
    got, want = fee.fee_fsm(*args), fee.fee_fsm_plain(*args)
    for name, a, b in zip(fee.FeeResult._fields, want, got):
        assert torch.equal(a, b), name


@pytest.mark.parametrize('route', list(LIGHT_ROUTES))
def test_mod2mod_light_batch_on_card_matches_cpu(mod2mod_card, route):
    """Module 3's first light batch (its 6 channels as the first module's
    ids, its own LUT and noise rows) on the card against the CPU with the
    same draws."""
    from larndsim_tpu_torch.tools import light_check
    args, kw = mod2mod_card['light']
    opts = LIGHT_ROUTES[route]
    card = light_check.rerun(args, kw, 'cuda', 5, **opts)
    again = light_check.rerun(args, kw, 'cuda', 5, **opts)
    cpu = light_check.rerun(args, kw, 'cpu', 5, **opts)
    assert card.waveforms.shape == (1, 6, 256)
    assert light_check.identical(card, again)
    rec = light_check.compare(card, cpu, args[1],
                              smeared_at=opts.get('threshold'))
    assert rec['peak'] > 0
    assert (rec['records'] > 0) == (opts['truth_ids'] > 0)


# --------------------------------------------------------------------------
# multi-device dispatch (n_devices)
# --------------------------------------------------------------------------

def _cards(count):
    if torch.cuda.device_count() < count:
        pytest.skip(f'needs {count} CUDA devices')
    return [torch.device('cuda', i) for i in range(count)]


def test_kernels_launch_on_their_card_from_a_new_thread(cuda, tmp_path):
    """K1 launched from a thread of its own (whose current card is card 0)
    on every card's tensors equals its plain version there: the wrapper
    selects the tensors' card and its stream."""
    tree = tpa.write_tree(tmp_path)
    smear = torch.randn((3, 32, 512),
                        generator=torch.Generator().manual_seed(1))
    for dev in _cards(torch.cuda.device_count()):
        args = _current_args(dev, tree, 1, smear)
        out, errors = [], []

        def launch():
            try:
                with torch.cuda.stream(torch.cuda.Stream(dev)):
                    out.append(current.induced_current(*args))
                    torch.cuda.current_stream(dev).synchronize()
            except BaseException as exc:
                errors.append(exc)
        t = threading.Thread(target=launch)
        t.start()
        t.join()
        assert not errors, errors
        assert out[0].device == dev
        assert torch.equal(out[0], current.current_plain(*args)), dev


def _ndev_module0(tmp_path):
    paths = tpa.write_tree(tmp_path / 'tree', light=True, sim_overrides=dict(
        max_light_truth_ids=50, mc_truth_threshold=0.1))
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=6,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=7)
    return inp, dict(config='module0',
                     detector_properties=paths['detector_properties'],
                     pixel_layout=paths['pixel_layout'],
                     simulation_properties=paths['simulation_properties'],
                     response_file=str(tmp_path / 'r.npy'), rand_seed=7,
                     step_scale=2.0, event_group_size=2)


def test_two_contexts_on_one_card_give_one_contexts_datasets(cuda, tmp_path):
    """Groups round-robin over two contexts on card 0 (each with its
    thread and stream): every dataset equal bit for bit to one context's,
    truth records included."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.tools.file_check import differences
    inp, kw = _ndev_module0(tmp_path)
    outs = {}
    for n in (1, 2):
        outs[n] = str(tmp_path / f'n{n}.h5')
        binding.reset_launches()
        run_simulation(inp, outs[n], device=['cuda:0'] * 2, n_devices=n,
                       **kw)
        assert binding.launches['induced_current'] > 0
    assert differences(outs[1], outs[2]) == []
    with File(outs[2], 'r') as f:
        assert len(f['light_wvfm_mc_assn']) > 0


def test_2x2_over_two_cards_gives_one_cards_datasets(cuda, tmp_path):
    """The four modules over two cards (two modules a card, each module on
    a thread and stream of its own) against one context on card 0."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    from larndsim_tpu_torch.tools.file_check import differences
    _cards(2)
    inp, kw = _mod2mod_kw(tmp_path)
    outs = {}
    for n, device in ((1, 'cuda:0'), (2, 'cuda')):
        outs[n] = str(tmp_path / f'n{n}.h5')
        with pytest.MonkeyPatch.context() as mp:
            from larndsim_tpu_torch.cli import simulate_pixels as cli
            mp.setattr(cli, 'light_draw', _cpu_made_draw)
            run_simulation(inp, outs[n], device=device, n_devices=n, **kw)
    assert differences(outs[1], outs[2]) == []


def test_ndlar_kernels_are_plain(cuda, tmp_path):
    """K1 and K2 at ND-LAr's shapes (the generated 35-module tree: 50 ns
    sampling, t_sig 4096, 6459 FSM ticks) on a batch of two tracks of 42
    segments, each equal to its plain version on the card."""
    from larndsim_tpu_torch.tools import perf_guard as pg
    w = pg.build_workload(cuda, str(tmp_path), pad_n=128, config='ndlar',
                          workload=dict(pg.NDLAR_WORKLOAD,
                                        tracks_per_event=2))
    assert w['shapes']['t_sig'] == 4096
    args = w['k1_args']
    got = current.induced_current(*args)
    assert float(got.abs().max()) > 0
    assert torch.equal(got, current.current_plain(*args))
    fsm_args = pg.op_calls(w)['fee_fsm'][1]
    assert fsm_args[0].shape[0] == 6459
    for a, b in zip(fee.fee_fsm(*fsm_args), fee.fee_fsm_plain(*fsm_args)):
        assert torch.equal(a, b)


def test_sim_step_cells_on_card_equal_sim_cell(cuda, tmp_path):
    """``parallel.mesh.make_sharded_sim_step`` on a 2 x 2 grid on card 0
    (beam trigger with noise, top-8 truth; each cell on a thread and
    stream of its own): each cell equals ``sim_cell`` run alone on the
    default stream with the same draws, bit for bit; K1 and K2 on each
    cell's inputs equal their plain versions, bit for bit."""
    from larndsim_tpu_torch import graft_entry as ge
    from larndsim_tpu_torch.models import charge as charge_model
    from larndsim_tpu_torch.models import light as light_model
    from larndsim_tpu_torch.parallel import mesh as tmesh
    from larndsim_tpu_torch.assets.light_lut import make_light_lut
    from larndsim_tpu_torch.ops.light import LightLUT
    from larndsim_tpu_torch.params import load_light
    from larndsim_tpu_torch.segments import to_structured
    with tempfile.TemporaryDirectory() as tmp:
        _, det, segs, response, band = ge._example_setup(tmp, n_segments=16,
                                                         device=cuda)
        paths = tpa.write_tree(tmp_path, light=dict(n_op_channel=12,
                                                    light_window=(0.0, 2.0)))
        light = load_light(paths['detector_properties'], device=cuda)
    lut = LightLUT.from_structured(make_light_lut((4, 6, 4), n_det_tpc=6),
                                   cuda)
    mesh = tmesh.make_mesh(4, 2, devices=['cuda:0'] * 4)
    shapes = ge.light_shapes(light)
    case = dict(add_noise=True, k_truth=8, trig_mode=1, max_trig=2)
    step = tmesh.make_sharded_sim_step(mesh, light, torch.arange(12),
                                       shift_band=band, **ge.STATICS,
                                       **shapes, **case)
    dets = tmesh.stack_module_params([det.replace(electron_lifetime=t)
                                      for t in (2.2e3, 1e3)])
    grid = tmesh.shard_segments([to_structured(segs)] * 4, mesh,
                                pad_to=segs.size)
    luts = [torch.stack([a, a]) for a in (lut.vis, lut.t0, lut.time_dist,
                                          lut.t0_avg)]
    noise = torch.ones((2, 12, 8), device=cuda) * 40.0

    def draws(m, e):
        gen = torch.Generator(cuda).manual_seed(2 * m + e)
        return (charge_model.generator_draw(gen, cuda),
                light_model.generator_draw(gen, cuda))
    kept = collections.defaultdict(dict)

    def keep(name, fn):
        def spy(*args):
            kept[threading.current_thread().name].setdefault(name, args)
            return fn(*args)
        return spy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(current, 'induced_current',
                   keep('k1', current.induced_current))
        mp.setattr(fee, 'fee_fsm', keep('k2', fee.fee_fsm))
        out = step(grid, dets, response, *luts,
                   [[draws(m, e) for e in range(2)] for m in range(2)],
                   noise_rows=noise)
    assert sorted(kept) == [f'cell-{m}-{e}' for m in range(2)
                            for e in range(2)]
    for cell in kept.values():
        _assert_kernel_is_plain(cell['k1'])
        for a, b in zip(fee.fee_fsm(*cell['k2']),
                        fee.fee_fsm_plain(*cell['k2'])):
            assert torch.equal(a, b)
    charge = dict(ge.STATICS, shift_band=band)
    for m in range(2):
        for e in range(2):
            want = tmesh.sim_cell(
                grid[m][e], tmesh.module_params(dets, m, cuda), response,
                light, torch.arange(12, device=cuda), [a[m] for a in luts],
                noise[m], draws(m, e), charge=charge, **shapes, **case)
            for k in ('adc', 'waveforms', 'trigger_idx', 'n_triggers',
                      'truth_ids', 'truth_contrib'):
                assert torch.equal(out[k][m][e], want[k]), (k, m, e)
    assert out['n_hits_total'] > 0


# --------------------------------------------------------------------------
# the charge chain's waveform sum (D1) and current fractions (D2)
# --------------------------------------------------------------------------

def _pixel_sum_case(device, seed, S=64, P=12, T=300, U=200, n_ticks=1500):
    """D1's arguments on random inputs: padding, empty pixels, windows
    clamped at both ends of the readout."""
    rng = np.random.default_rng(seed)
    pix = rng.integers(0, U // 2, (S, P)).astype(np.int32) * 2
    pix[rng.uniform(size=(S, P)) < 0.3] = -1
    pix[:, 0] = 7                       # a pixel with an entry a segment
    signals = rng.normal(size=(S, P, T)).astype(np.float32) * 1e3
    starts = np.round(rng.uniform(-45.0, 160.0, S), 2).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    return (t(signals), t(pix), t(starts), U), dict(n_ticks=n_ticks,
                                                    time_sampling=0.1)


@pytest.fixture(scope='module')
def chain_batch(cuda, tmp_path_factory):
    """D1's and D2's arguments as the chain makes them on the card: the
    guard's Module-0-shaped batch (1 event of 6 tracks, padded to 256)."""
    from larndsim_tpu_torch.tools import perf_guard as pg
    w = pg.build_workload(cuda, str(tmp_path_factory.mktemp('chain')),
                          pad_n=256, workload=dict(pg.WORKLOAD, n_events=1,
                                                   tracks_per_event=6))
    calls = pg.op_calls(w)
    return dict(d1=calls['sum_pixel_signals_with_csr'][1:],
                d2=calls['current_fractions_4_with_csr'][1:])


def _assert_pixel_sum_is_plain(args, kw):
    """The kernel equals the plain version bit for bit in the (U, n_ticks)
    form and in the rows form, with more rows than ticks (the chain's
    n_scan) and fewer, the CSR made in the call or given."""
    n_ticks = kw['n_ticks']
    base = dict(n_ticks=n_ticks, time_sampling=kw['time_sampling'])
    csr = accumulate.pixel_csr(args[1], args[2], args[3],
                               time_sampling=kw['time_sampling'])
    for extra in (None, kw.get('rows', n_ticks + 31) - n_ticks, -n_ticks // 3):
        rows = {} if extra is None else dict(rows=n_ticks + extra)
        for given in ({}, dict(csr=csr)):
            before = binding.launches['sum_pixel_signals']
            got = accumulate.sum_pixel_signals(*args, **base, **rows,
                                               **given)
            torch.cuda.synchronize()
            assert binding.launches['sum_pixel_signals'] == before + 1
            want = accumulate.sum_pixel_signals_plain(*args, **base, **rows)
            assert float(want.abs().max()) > 0
            assert got.shape == want.shape and torch.equal(got, want), \
                (extra, float((got - want).abs().max()))


@pytest.mark.parametrize('seed', [0, 1])
def test_pixel_sum_kernel_equals_plain(cuda, seed):
    _assert_pixel_sum_is_plain(*_pixel_sum_case(cuda, seed))


def test_pixel_sum_kernel_with_empty_groups(cuda):
    """The ids of a 200-pixel case on a 1024-pixel axis: the kernel's
    groups of 32 past pixel 199 hold no entry and are written as zeros."""
    (sig, pix, starts, _), kw = _pixel_sum_case(cuda, 2)
    _assert_pixel_sum_is_plain((sig, pix, starts, 1024), kw)


def test_pixel_sum_kernel_on_a_chain_batch(chain_batch):
    _assert_pixel_sum_is_plain(*chain_batch['d1'])


def test_pixel_sum_makes_no_synchronising_call(chain_batch):
    """The kernels' inputs are made on the card: the CSR, D1's rows and D2
    on that CSR read nothing to the host."""
    args, kw = chain_batch['d1']
    d2_args, d2_kw = chain_batch['d2']
    accumulate.sum_pixel_signals(*args, **kw)      # the library loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        csr = accumulate.pixel_csr(args[1], args[2], args[3],
                                   time_sampling=kw['time_sampling'])
        got = accumulate.sum_pixel_signals(*args, **kw, csr=csr)
        frac = fee.current_fractions(*d2_args, **d2_kw, csr=csr)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert torch.equal(got, accumulate.sum_pixel_signals_plain(*args, **kw))
    torch.testing.assert_close(
        frac, fee.current_fractions_plain(*d2_args, **d2_kw), rtol=1e-5,
        atol=1e-6)


def _fractions_case(device, det, seed, S=48, P=10, T=400, U=96, max_adc=5,
                    max_tracks=8):
    """D2's arguments on random inputs: every (pixel, slot) once, windows
    with r > e, unlatched slots (e = -1) and windows partly outside the
    entries' rows."""
    rng = np.random.default_rng(seed)
    pix = np.full((S, P), -1, np.int32)
    slot = np.full((S, P), -1, np.int32)
    used = set()
    for s in range(S):
        for p in range(P):
            u, k = int(rng.integers(U)), int(rng.integers(max_tracks))
            if (u, k) not in used:
                used.add((u, k))
                pix[s, p], slot[s, p] = u, k
    starts = np.round(rng.uniform(0.0, 40.0, S), 2).astype(np.float32)
    r = rng.integers(0, 700, (U, max_adc)).astype(np.int32)
    e = (r + rng.integers(-5, 300, (U, max_adc))).astype(np.int32)
    e[rng.uniform(size=(U, max_adc)) < 0.2] = -1
    signals = (rng.normal(size=(S, P, T)) * 1e3 + 300.0).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(device)
    res = fee.FeeResult(torch.zeros((U, max_adc), device=device),
                        torch.zeros((U, max_adc), device=device),
                        torch.zeros(U, dtype=torch.int32, device=device),
                        t(r), t(e))
    return (t(signals), t(pix), t(slot), t(starts), res, det), dict(
        max_adc=max_adc, max_tracks=max_tracks, n_adc_scan=max_adc - 1)


def _assert_fractions_match_plain(args, kw):
    """Within rtol 1e-5 / atol 1e-6 of the plain version; two launches,
    and a launch fed the CSR made beforehand, give the same bits."""
    csr = accumulate.pixel_csr(args[1], args[3], args[4].reset_start.shape[0],
                               time_sampling=args[5].time_sampling)
    before = binding.launches['current_fractions']
    got = fee.current_fractions(*args, **kw)
    again = fee.current_fractions(*args, **kw)
    shared = fee.current_fractions(*args, **kw, csr=csr)
    torch.cuda.synchronize()
    assert binding.launches['current_fractions'] == before + 3
    want = fee.current_fractions_plain(*args, **kw)
    assert float(want.max()) > 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, again) and torch.equal(got, shared)


@pytest.mark.parametrize('seed', [0, 1])
def test_current_fractions_kernel_matches_plain(cuda, tmp_path, seed):
    det = tpa.load_port(tpa.write_tree(tmp_path), cuda).params
    _assert_fractions_match_plain(*_fractions_case(cuda, det, seed))


def test_current_fractions_kernel_on_a_chain_batch(chain_batch):
    _assert_fractions_match_plain(*chain_batch['d2'])


def test_chain_kernels_refuse_wrong_inputs(cuda, tmp_path):
    det = tpa.load_port(tpa.write_tree(tmp_path), cuda).params
    (sig, pix, starts, U), kw = _pixel_sum_case(cuda, 3)
    pairs, offsets = accumulate.pixel_csr(pix, starts, U,
                                          time_sampling=kw['time_sampling'])
    n = kw['n_ticks']
    with pytest.raises(TypeError, match='signals'):
        binding.sum_pixel_rows(sig.double(), pairs, offsets, n, n)
    with pytest.raises(TypeError, match='offsets'):
        binding.sum_pixel_rows(sig, pairs, offsets.long(), n, n)
    with pytest.raises(ValueError, match='pairs'):
        binding.sum_pixel_rows(sig, pairs[:-1], offsets, n, n)
    odd = sig.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match='not contiguous'):
        binding.sum_pixel_rows(odd, pairs, offsets, n, n)
    with pytest.raises(ValueError, match='negative'):
        binding.sum_pixel_rows(sig, pairs, offsets, n, -1)
    (sig, pix, slot, starts, res, det), kw = _fractions_case(cuda, det, 4)
    pairs, offsets = accumulate.pixel_csr(pix, starts,
                                          res.reset_start.shape[0],
                                          time_sampling=det.time_sampling)
    A = fee.fraction_decay(det, cuda)
    good = (sig, pairs, offsets, slot, res.reset_start, res.latch_end, A,
            0.1)
    kw = dict(max_adc=kw['max_adc'], max_tracks=kw['max_tracks'],
              n_adc_scan=2, n_weights=fee.scan_ticks(det) + 2)
    for i, bad in ((0, sig.half()), (2, offsets.long()), (3, slot.long()),
                   (4, res.reset_start.t().contiguous().t())):
        args = list(good)
        args[i] = bad
        with pytest.raises((TypeError, ValueError)):
            binding.current_fractions(*args, **kw)
    with pytest.raises(ValueError, match='n_adc_scan'):
        binding.current_fractions(*good, **dict(kw, n_adc_scan=6))
    before = binding.launches['current_fractions']
    none = binding.current_fractions(*good, **dict(kw, n_adc_scan=0))
    assert binding.launches['current_fractions'] == before
    assert none.shape == (res.reset_start.shape[0], 5, 8) and not none.any()


def test_main_path_runs_the_four_kernels(cuda, tmp_path):
    """The CLI on the card with every plain version forbidden: D1 launches
    once per K1 launch, D2 once per batch in which a pixel latched."""
    from larndsim_tpu_torch.cli.simulate_pixels import run_simulation
    paths = tpa.write_tree(tmp_path / 'tree')
    inp = str(tmp_path / 'in.h5')
    write_input(inp, tpa.load_port(paths).tpc_borders, n_events=3,
                tracks_per_event=3, segments_per_track=6, segment_length=0.4,
                dEdx=8.0, seed=2)
    calls = collections.Counter()
    orig = fee.current_fractions

    def counted(*args, **kw):
        calls['latched' if kw['n_adc_scan'] > 0 else 'unlatched'] += 1
        return orig(*args, **kw)

    def forbidden(*args, **kw):
        raise AssertionError('a plain version ran on the card')
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((current, 'current_plain'),
                          (accumulate, 'sum_pixel_signals_plain'),
                          (fee, 'fee_fsm_plain'),
                          (fee, 'current_fractions_plain')):
            mp.setattr(mod, name, forbidden)
        mp.setattr(fee, 'current_fractions', counted)
        mp.setattr(binding, 'launches', dict(binding.launches))
        binding.reset_launches()
        run_simulation(inp, str(tmp_path / 'out.h5'), device='cuda',
                       config='module0',
                       detector_properties=paths['detector_properties'],
                       pixel_layout=paths['pixel_layout'],
                       simulation_properties=paths['simulation_properties'],
                       response_file=str(tmp_path / 'r.npy'), rand_seed=7,
                       step_scale=2.0)
        n = dict(binding.launches)
    assert n['induced_current'] > 0 and calls['latched'] > 0
    assert n['sum_pixel_signals'] == n['induced_current'], n
    assert n['current_fractions'] == calls['latched'], (n, calls)
