"""The benchmark's reference of the light readout: larnd-sim's beam-
triggered light chain (``light_sim.py``, ``lightLUT.py``) written plainly
for every (spill, module) of an input file.

For each module's beam trigger it finds the LUT voxel of each segment of
the event's first batch (``lightLUT.get_voxel``), the photons the
segment's quenched energy gives (Birks, as ``quenching.py``), the photons
each of the module's channels sees (visibility x efficiency), and then,
channel by channel: the smeared arrival series (each segment's LUT time
profile of 1 ns bins placed on the 1 ns ticks of the [0, 16] us window and
summed), the singlet / triplet scintillation, the Poisson fluctuations, the
SiPM's RLC response times the channel's gain, the padding around the
trigger's window, the detector noise from the synthetic amplitude spectrum
(``frozen/assets/light_lut.make_light_noise``, computed here, as the
program makes it where no noise file is given) with random phases, and the
ADC's interpolation onto its samples and quantisation.  An event whose
module holds no segment writes a row of zeros.

What it shares with the program: the input file, the YAMLs, the LUT files
and the random streams that ``rand_seed`` defines.  The program draws each
light batch's Poisson counts (the window's (channels, ticks) rates), its
normals (that shape) and its noise phases ((channels, frequencies)) in
that order from a generator seeded from (rand_seed, module, event, 0) in a
stream of its own; the reference makes the same generator and draws the
same shapes on the same device.

Arithmetic: float32 where larnd-sim's is, float64 where the program's is
(the kernel taps, the two convolutions and the noise's inverse transform),
so that the Poisson draws see the program's rates: on the CPU they draw
from one stream, where a rate one rounding apart would move every later
draw.  The arrival series is summed in float32 by ``index_add_``: in order
on the CPU, by atomic adds on the card, as larnd-sim sums it.

Behaviours of the program (and of larnd-sim's CLI) reproduced here:

- with module variation each module is simulated on the first module's
  channel ids: its gains and LUT columns are those of channels 0-95, its
  visibilities, efficiencies and TPC match its own channels', its noise
  rows its own;
- only an event's first batch triggers the beam: the segments of a batch
  past ``batch_size`` give no light, and a later TPC group's batch of the
  same event adds no row;
- a batch without segments writes a row of zeros, with no noise.

Departures from ``light_sim.py``, each the program's:

- the scintillation and SiPM convolutions are FFT convolutions in float64
  at a power-of-two length, where larnd-sim sums them directly in float32;
- the Poisson and the Gaussian draws both cover every tick (larnd-sim
  draws one or the other per tick);
- a division by a constant (the tick, the ADC's quantum, a frequency
  step) is a multiplication by its float32 reciprocal, as XLA folds it in
  the JAX package the program follows; the scalar constants of the taps
  are their float32 roundings;
- the simulated window is rounded up to a power of two of ticks (16,000
  -> 16,384), which the noise's length follows.

``precision='bf16'`` sums the arrival series in bfloat16: the control, a
precision below the chain's float32.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
import yaml

from . import charge, detector
from .frozen.assets.light_lut import make_light_noise

F32 = torch.float32
#: larnd-sim's light defaults (consts/light.py), where the YAML leaves a
#: key out
DEFAULTS = dict(
    light_tick_size=0.001, light_window=(1.0, 10.0),
    light_trig_window=(0.9, 1.66), light_digit_sample_spacing=0.01,
    light_nbit=10, light_det_noise_sample_spacing=0.01,
    singlet_fraction=0.3, tau_s=0.001, tau_t=1.530,
    light_response_time=0.055, light_oscillation_period=0.095,
    light_gain=-2.30, op_channel_efficiency=1.0, light_trig_mode=0,
    enable_lut_smearing=False, sipm_response_model=0)
#: the work function of a photon [MeV] and the scintillation prescale
#: (consts/light.py), which the quenching takes at their defaults
W_PH, SCINT_PRESCALE = 19.5e-6, 1.0
#: the padding of a TPC's box in the voxel lookup [cm]
VOXEL_PAD = 2e-2
#: the arrival series' precision: the configuration's, and the control's
PRECISIONS = ('float32', 'bf16')


def recip(v: float) -> float:
    """The float32 reciprocal of ``v``, the factor of a division by it."""
    return float(np.float32(1.0) / np.float32(v))


def f32(v: float) -> float:
    return float(np.float32(v))


@dataclasses.dataclass
class Light:
    """The light keys of a detector YAML."""
    c: dict                  # scalar constants and windows
    tpc_to_op: np.ndarray    # (n_tpc, channels a TPC)
    op_to_tpc: np.ndarray    # (n_op_channel,)
    efficiency: np.ndarray   # (n_op_channel,) float32
    gain: np.ndarray         # (n_op_channel,) float32

    @property
    def n_op_channel(self) -> int:
        return len(self.op_to_tpc)

    def window(self) -> tuple[int, int]:
        """(ticks simulated, ticks of the convolution kernels): the beam
        window rounded up to a power of two of at least 256 ticks."""
        lo, hi = self.c['light_window']
        tick = self.c['light_tick_size']
        n = int((hi + lo) / tick)
        n_ticks = max(256, 1 << math.ceil(math.log2(max(min(n, 50_000),
                                                        1))))
        conv = int(np.ceil((hi - lo) / tick))
        return n_ticks, max(min(conv, n_ticks), 1)

    def digit_samples(self) -> int:
        pre, post = self.c['light_trig_window']
        return int(np.ceil((post + pre)
                           / self.c['light_digit_sample_spacing']))

    def pads(self, n_ticks: int) -> tuple[int, int]:
        """Ticks before and after the window that hold the beam trigger's
        (at tick 0) digitised window."""
        tick = self.c['light_tick_size']
        pre = int(np.ceil(self.c['light_trig_window'][0] / tick))
        post = int(np.ceil(self.c['light_trig_window'][1] / tick))
        return pre, max(post - n_ticks, 0)


def load(det_yaml: str) -> Light:
    """The light keys of ``det_yaml`` at larnd-sim's defaults; only the
    beam trigger with LUT smearing and the RLC SiPM model are written
    here."""
    with open(det_yaml) as f:
        det = yaml.safe_load(f)
    c = {k: det.get(k, v) for k, v in DEFAULTS.items()}
    for k in ('light_window', 'light_trig_window'):
        c[k] = tuple(float(x) for x in c[k])
    if not (int(c['light_trig_mode']) == 1 and c['enable_lut_smearing']
            and int(c['sipm_response_model']) == 0):
        raise NotImplementedError(
            'the light reference has the beam trigger (light_trig_mode 1) '
            'with LUT smearing and the RLC SiPM response only')
    n = int(det['n_op_channel'])
    tpc_to_op = np.array(det['tpc_to_op_channel'], np.int64)
    op_to_tpc = np.zeros(n, np.int64)
    for tpc, chans in enumerate(tpc_to_op):
        op_to_tpc[chans] = tpc

    def per_channel(v):
        v = np.asarray(v, np.float64).ravel()
        return np.full(n, v[0]) if v.size == 1 else v
    return Light(c=c, tpc_to_op=tpc_to_op, op_to_tpc=op_to_tpc,
                 efficiency=per_channel(c['op_channel_efficiency'])
                 .astype(np.float32),
                 gain=per_channel(c['light_gain']).astype(np.float32))


def read_lut(path: str, device) -> dict:
    """A light LUT file's tables, float32 on ``device``: visibility (a
    voxel of none takes the least visibility seen, as larnd-sim's CLI
    sets it) and the arrival-time profiles."""
    arr = np.load(path)['arr']
    vis = np.array(arr['vis'], np.float32)
    seen = vis > 0
    if seen.any():
        vis[~seen] = vis[seen].min()
    return dict(vis=torch.from_numpy(vis).to(device),
                time_dist=torch.from_numpy(np.array(
                    arr['time_dist'], np.float32)).to(device))


@dataclasses.dataclass
class Pass:
    """One module's light (or the whole detector's, without module
    variation): its charge pass, its channels, the channels it is
    simulated on, its LUT and its noise spectra."""
    mod: charge.Module
    channels: np.ndarray     # its own absolute channel ids
    simulated: np.ndarray    # the ids it is simulated on
    lut_path: str


def passes(files: dict, run: dict, mods: list, light: Light) -> list:
    """The light passes of the charge passes ``mods`` (``charge.modules``):
    module ``m`` of ``n`` with module variation on channels ``(m - 1) *
    per`` onwards (``per``: ``n_op_channel / n``), simulated on the first
    module's, and its LUT by ``run['light_lut_id']``; else one pass over
    every channel."""
    luts = files['light_lut_filename']
    if len(mods) == 1 and mods[0].i_mod < 0:
        every = np.arange(light.n_op_channel)
        return [Pass(mods[0], every, every, detector.of_module(luts, 1))]
    per = light.n_op_channel // len(mods)
    first = light.tpc_to_op[:2].ravel()
    return [Pass(m, np.arange(per) + per * (m.i_mod - 1), first,
                 detector.of_module(luts, m.i_mod, run.get('light_lut_id')))
            for m in mods]


def generator(rand_seed: int, i_mod: int, event: int, device):
    """The light batch's generator: a stream apart from the charge
    batches' (``spawn_key`` 1), seeded from (rand_seed, its module, 0 for
    a detector without module variation, the event, 0: the event's first
    batch)."""
    seed = np.random.SeedSequence([rand_seed, max(i_mod, 0), int(event), 0],
                                  spawn_key=(1,)).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


# ------------------------------------------------------------ per segment

def photons(tracks: np.ndarray, det: detector.Detector, device):
    """Each segment's scintillation photons (Birks' recombination: the
    energy not taken by the freed electrons, over the photon's work
    function), float32."""
    dE = torch.from_numpy(np.ascontiguousarray(tracks['dE'], np.float32)) \
        .to(device)
    dEdx = torch.from_numpy(np.ascontiguousarray(tracks['dEdx'],
                                                 np.float32)).to(device)
    e_field = charge._t(det.c['e_field'], device)
    recomb = (1 + charge.BIRKS_KB * dEdx / (e_field * charge.LAR_DENSITY))
    recomb = recomb.reciprocal() * charge.BIRKS_AB
    electrons = recomb * dE / charge._t(charge.W_ION, device)
    return (dE / charge._t(W_PH, device) - electrons) * SCINT_PRESCALE


def voxels(seg: dict, det: detector.Detector, vox_div) -> torch.Tensor:
    """Each segment's LUT voxel (i, j, k): its midpoint's place in its
    TPC's box padded by :data:`VOXEL_PAD`, x counted from the anode in
    either drift direction, y from the top; a segment in no TPC takes the
    last TPC's box (it has no photons on any channel)."""
    dev = seg['x'].device
    n_tpc = det.n_tpcs
    plane = torch.where(seg['plane'] >= 0, seg['plane'], n_tpc - 1).long()
    b = torch.tensor(det.borders, dtype=F32, device=dev)[plane]
    forward = b[:, 2, 1] > b[:, 2, 0]
    lo = b[..., 0] - VOXEL_PAD
    hi = b[..., 1] + VOXEL_PAD
    width = hi - lo
    i = torch.where(forward, (seg['x'] - lo[:, 0]) / width[:, 0] * vox_div[0],
                    (hi[:, 0] - seg['x']) / width[:, 0] * vox_div[0])
    j = (hi[:, 1] - seg['y']) / width[:, 1] * vox_div[1]
    k = (seg['z'] - lo[:, 2]) / width[:, 2] * vox_div[2]
    return torch.stack([v.to(torch.int32).clamp(0, n - 1).long()
                        for v, n in zip((i, j, k), vox_div)], dim=-1)


def detected(seg: dict, n_ph: torch.Tensor, vox: torch.Tensor,
             light: Light, p: Pass, vis: torch.Tensor) -> torch.Tensor:
    """(segments, channels) photons on each of the pass's channels: the
    visibility of the segment's voxel from the channel's LUT column, times
    the channel's efficiency and the segment's photons; none from a TPC
    the channel does not see."""
    dev = n_ph.device
    n_lut = vis.shape[3]
    col = torch.from_numpy(np.arange(len(p.channels)) % n_lut).to(dev)
    v = vis[vox[:, 0, None], vox[:, 1, None], vox[:, 2, None], col]
    eff = torch.from_numpy(light.efficiency[p.channels]).to(dev)
    tpc = torch.from_numpy(light.op_to_tpc[p.channels]).to(dev)
    sees = (seg['plane'] >= 0)[:, None] & (tpc[None, :] == seg['plane'][:,
                                                                         None])
    return torch.where(sees, eff[None, :] * v * n_ph[:, None], 0.0)


# ------------------------------------------------------------ the chain

def arrival_series(t0, n_det, vox, time_dist, simulated, light: Light,
                   n_ticks: int, precision: str) -> torch.Tensor:
    """(channels, ticks) photons a us: each segment's photons spread over
    its voxel's time profile (bin ``b`` arriving ``b`` ns after the
    segment's time) and summed on the tick each bin falls on, in segment
    then bin order; a bin on a tick's edge goes to the tick it closes."""
    dev = n_det.device
    tick = light.c['light_tick_size']
    n_prof = time_dist.shape[4]
    col = torch.from_numpy(simulated % time_dist.shape[3]).to(dev)
    prof = time_dist[vox[:, 0, None], vox[:, 1, None], vox[:, 2, None], col]
    t = t0[:, None] + torch.arange(n_prof, dtype=F32, device=dev) * 1e-3
    at = t * recip(tick)
    itick = torch.ceil(at).to(torch.int32) - 1
    ok = (at > itick) & (itick >= 0) & (itick < n_ticks)       # (S, bins)
    rate = (n_det[..., None] * prof) * recip(tick)             # (S, C, bins)
    rows = rate.transpose(1, 2).reshape(-1, rate.shape[1])
    keep = ok.reshape(-1)
    dtype = torch.bfloat16 if precision == 'bf16' else F32
    out = torch.zeros((n_ticks, rate.shape[1]), dtype=dtype, device=dev)
    out.index_add_(0, itick.reshape(-1)[keep].long(), rows[keep].to(dtype))
    return out.float().t()


def convolve(signal: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """The causal convolution of each row with ``taps``, cut to the row's
    length: an FFT convolution in float64 at the power of two at or above
    the full length, rounded to float32."""
    n, k = signal.shape[-1], len(taps)
    size = int(2 ** np.ceil(np.log2(max(n + k - 1, 1))))
    t = torch.from_numpy(np.asarray(taps, np.float64)).to(signal.device)
    out = torch.fft.irfft(torch.fft.rfft(signal.double(), n=size, dim=-1)
                          * torch.fft.rfft(t, n=size), n=size, dim=-1)
    return out[..., :n].float()


def scintillation_taps(light: Light, n: int) -> np.ndarray:
    """The singlet and triplet emission over each tick, ``n`` taps."""
    c, tick = light.c, light.c['light_tick_size']
    k = np.arange(n, dtype=np.float64)
    singlet = f32(c['singlet_fraction'])
    tau_s, tau_t = f32(c['tau_s']), f32(c['tau_t'])
    taps = (singlet * np.exp(-k * tick / tau_s) * (1 - np.exp(-tick / tau_s))
            + (1 - singlet) * np.exp(-k * tick / tau_t)
            * (1 - np.exp(-tick / tau_t)))
    return taps.astype(np.float32)


def sipm_taps(light: Light, n: int) -> np.ndarray:
    """The SiPM's RLC impulse response over each tick, ``n`` taps."""
    c, tick = light.c, light.c['light_tick_size']
    t = np.arange(n, dtype=np.float64) * tick
    rt, op = f32(c['light_response_time']), f32(c['light_oscillation_period'])
    imp = np.exp(-t / rt) * np.sin(t / op) / (op * rt * rt) * (op * op
                                                               + rt * rt)
    return (imp * tick).astype(np.float32)


def fluctuate(rate: torch.Tensor, light: Light, gen) -> torch.Tensor:
    """Photoelectrons a tick drawn about each tick's mean, as a rate:
    Poisson below a mean of 30, a Gaussian rounded down above."""
    tick = light.c['light_tick_size']
    mean = rate * tick
    small = torch.poisson(torch.clamp(mean, min=1e-30), generator=gen)
    normal = torch.randn(mean.shape, generator=gen, device=mean.device)
    big = torch.clamp(torch.floor(normal * torch.sqrt(torch.clamp(mean, min=0))
                                  + mean), min=0.0)
    n = torch.where(mean < 30, small, big)
    return torch.where(mean > 0, n * recip(tick), 0.0)


def interp(x, xp, fp):
    """``fp``'s rows linearly interpolated at ``x`` over the knots ``xp``,
    0 outside them (numpy's ``interp`` with ``left = right = 0``)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, len(xp) - 1)
    dx = xp[i] - xp[i - 1]
    flat = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, fp[:, i - 1], fp[:, i - 1]
                    + ((x - xp[i - 1]) / torch.where(flat, 1.0, dx))
                    * (fp[:, i] - fp[:, i - 1]))
    return torch.where((x < xp[0]) | (x > xp[-1]), 0.0, f)


def _mean(x: torch.Tensor) -> torch.Tensor:
    return x.double().sum().float() * recip(x.numel())


def noise(spectra: torch.Tensor, n: int, light: Light, gen) -> torch.Tensor:
    """(channels, n) noise in ADC counts: the amplitude spectra resampled
    onto the ``n`` ticks' frequencies, scaled to the power the digitiser
    sees, with phases drawn uniformly, transformed back and rounded to the
    ADC's quantum."""
    c = light.c
    dev = spectra.device
    n_bins = spectra.shape[-1]
    step = 2 * (n_bins - 1) * c['light_det_noise_sample_spacing']
    have = torch.arange(n_bins, dtype=F32, device=dev) * recip(step)
    want = torch.arange(n // 2 + 1, dtype=F32, device=dev) * recip(
        n * c['light_tick_size'])
    amp = interp(want, have, spectra)
    scale = (torch.sqrt(_mean(torch.diff(have)) / _mean(torch.diff(want)))
             * c['light_digit_sample_spacing']) * recip(c['light_tick_size'])
    amp = (amp * scale).double()
    phase = ((2 * math.pi) * torch.rand(amp.shape, generator=gen,
                                        device=dev)).double()
    quantum = 2 ** (16 - int(c['light_nbit']))
    wave = torch.round(torch.fft.irfft(torch.complex(
        amp * torch.cos(phase), amp * torch.sin(phase)), dim=-1)) * quantum
    wave = wave.float()
    if wave.shape[-1] < n:
        wave = torch.nn.functional.pad(wave, (0, n - wave.shape[-1]))
    return wave[..., :n]


def digitize(signal: torch.Tensor, light: Light) -> torch.Tensor:
    """The beam trigger's ADC samples of the padded signal: each sample
    interpolated between the two ticks about it (none past the last but
    one tick), rounded to the ADC's quantum."""
    c = light.c
    n = signal.shape[-1]
    m = light.digit_samples()
    at = torch.arange(m, dtype=F32, device=signal.device) * (
        c['light_digit_sample_spacing'] / c['light_tick_size'])
    i0 = torch.floor(at).to(torch.int32)
    frac = at - i0
    v0 = torch.where((i0 >= 0) & (i0 <= n - 1),
                     signal[:, i0.clamp(0, n - 1).long()], 0.0)
    v1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= n - 1),
                     signal[:, (i0 + 1).clamp(0, n - 1).long()], 0.0)
    out = torch.where(i0 > n - 2, 0.0, v0 + (v1 - v0) * frac)
    quantum = 2 ** (16 - int(c['light_nbit']))
    return torch.round(out * recip(quantum)) * quantum


def waveform(t0, n_det, vox, lut: dict, spectra, gains, simulated,
             light: Light, gen, precision: str = 'float32') -> torch.Tensor:
    """One beam trigger's (channels, samples) float32 ADC waveform of a
    batch's segments: their times ``t0``, detected photons ``n_det`` and
    voxels ``vox``."""
    n_ticks, conv = light.window()
    series = arrival_series(t0, n_det, vox, lut['time_dist'], simulated,
                            light, n_ticks, precision)
    scint = convolve(series, scintillation_taps(light, conv + 1))
    pe = fluctuate(scint, light, gen)
    signal = gains[:, None] * convolve(pe, sipm_taps(light, conv + 1))
    front, back = light.pads(n_ticks)
    signal = torch.nn.functional.pad(signal, (front, back))
    signal = signal + noise(spectra, signal.shape[-1], light, gen)
    return digitize(signal, light)


def batches(tracks: np.ndarray, calls: list, groups: list,
            p: Pass) -> list:
    """The pass's light rows in the program's order: for each event, for
    each of the module's TPC groups (the charge :func:`charge.plan`'s
    ``calls`` and ``groups``), None (a row of zeros) where the group holds
    no segment, the rows of the group's first charge call where it is the
    event's first batch with segments, nothing for a later one."""
    mine = [g for g, (mod, _) in enumerate(groups) if mod is p.mod]
    first = {}
    for ev, g, rows, _ in calls:
        first.setdefault((ev, g), rows)
    out = []
    for ev in np.unique(tracks['event_id']).tolist():
        lit = False
        for g in mine:
            if (ev, g) not in first:
                out.append((ev, None))
            elif not lit:
                out.append((ev, first[(ev, g)]))
                lit = True
    return out


def run(tracks: np.ndarray, mods: list, files: dict, run_keys: dict,
        rand_seed: int, device, precision: str = 'float32',
        log=None) -> list:
    """The beam waveforms of every (spill, module) of an input's segments
    (``charge.read_segments``) for the charge passes ``mods``: for each
    light pass, its rows in the program's order, (event, (channels,
    samples) float32 array, or None for a row of zeros)."""
    if precision not in PRECISIONS:
        raise ValueError(f'precision {precision!r}: one of {PRECISIONS}')
    light = load(files['detector_properties'])
    calls, groups = charge.plan(tracks, mods)
    spectra_all = make_light_noise(light.n_op_channel).astype(np.float32)
    t0_all = torch.from_numpy(np.ascontiguousarray(tracks['t0'], np.float32))
    out = []
    for p in passes(files, run_keys, mods, light):
        t_pass = time.perf_counter()
        det = p.mod.det
        lut = read_lut(p.lut_path, device)
        seg = charge.quench_and_drift(tracks, det, device)
        n_ph = photons(tracks, det, device)
        vox = voxels(seg, det, lut['vis'].shape[:3])
        n_det = detected(seg, n_ph, vox, light, p, lut['vis'])
        rows_of = spectra_all[p.channels]
        spectra = torch.from_numpy(rows_of[p.simulated % len(rows_of)]) \
            .to(device)
        gains = torch.from_numpy(light.gain[p.simulated]).to(device)
        t0 = t0_all.to(device)
        made = []
        for ev, rows in batches(tracks, calls, groups, p):
            if rows is None:
                made.append((ev, None))
                continue
            take = torch.from_numpy(rows).to(device)
            wave = waveform(t0[take], n_det[take], vox[take], lut, spectra,
                            gains, p.simulated, light,
                            generator(rand_seed, p.mod.i_mod, ev, device),
                            precision)
            made.append((ev, wave.cpu().numpy()))
        out.append(made)
        if log:
            log(f'[reference] light of module {p.mod.i_mod}: '
                f'{sum(w is not None for _, w in made)} triggers, '
                f'{sum(w is None for _, w in made)} empty, '
                f'{time.perf_counter() - t_pass:.3f} s')
    return out
