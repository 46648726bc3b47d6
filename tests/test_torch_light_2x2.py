"""The 2x2 with light through the port, and the benchmark's plain light
reference (``port_bench/reference/light.py``) held to the port's light
chain, on the CPU.

The small four-module tree (``torch_port_assets.write_tree_2x2``: light
on, 384 channels, 96 a module, 48 a TPC, the beam trigger over a [0, 16]
us window at 1 ns with LUT smearing, two small LUTs; the configuration's
digitised window, 1000 samples of 16 ns a trigger) runs with module
variation and ``event_batch_size`` 2 (both TPCs of a module a batch), as
the benchmark's ``2x2`` configuration batches, on an input of two spills
in which module 3 holds no segment in the second:

* the phases of the light chain open nested as ``cli/simulate_pixels.py``
  opens them: ``light/incidence`` (the module's incidence, and each
  batch's rows inside ``light_batch``), ``light/signal`` and
  ``light/digitize`` inside ``light_batch``, ``light/pull`` after the
  charge call, ``export/light`` around the light rows' writes and
  ``export/light_merge`` inside ``export/final``; the phase table (self
  walls, under a clock that counts its reads) sums to the outermost
  phases' walls; a charge-only ND-LAr run opens none of them;
* every module writes a row a spill, module 3 a row of zeros for the
  spill it misses, and the merge of the modules' rows holds;
* the file's waveforms and light rows equal the reference's
  (``compare/light.py``: no sample and no row differs);
* at the tree's own batching (one TPC a batch) and the loader's default
  digitised window (256 samples of 10 ns) with every TPC hit, the file
  equals the reference too (a module's second TPC adds no row); with
  a module's first TPC empty in a spill, the module writes two rows there
  and the merge raises larnd-sim's ``ValueError``.

The reference's incidence (photons, voxels) and beam waveform equal the
port's ``calculate_light_incidence`` and ``simulate_light_group`` bit for
bit on seeded segments in each module (both layouts and both LUTs), with
the same draws; the bfloat16 control (the arrival series summed in
bfloat16) fails the configuration's light limits on both LUTs.  No tolerance: on the CPU the Poisson counts
come from one stream of draws, so a rate one rounding apart would move
every later draw and show at once.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from larndsim_tpu_torch.assets.geometry import write_ndlar
from larndsim_tpu_torch.assets.light_lut import load_light_lut, \
    make_light_noise
from larndsim_tpu_torch.assets.make_input import make_tracks, write_input
from larndsim_tpu_torch.cli import simulate_pixels as tcli
from larndsim_tpu_torch.io.h5 import File
from larndsim_tpu_torch.models import light as tlight
from larndsim_tpu_torch.ops import light as tlight_ops
from larndsim_tpu_torch.ops.drift import drift
from larndsim_tpu_torch.ops.quench import quench
from larndsim_tpu_torch.params import load_detector, load_light, load_sim
from larndsim_tpu_torch.params import physics
from larndsim_tpu_torch.segments import from_structured, stack
from larndsim_tpu_torch.utils import trace
from port_bench import assets
from port_bench.compare import light as compare_light
from port_bench.reference import charge as rcharge
from port_bench.reference import detector as rdetector
from port_bench.reference import light as rlight

import torch_port_assets as tpa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the benchmark's 2x2 configuration: its run keys and light limits
with open(os.path.join(ROOT, 'port_bench', 'configs', '2x2.json')) as _f:
    CONFIG = json.load(_f)
#: the configuration's light keys: the digitised window and its samples
LIGHT_KEYS = CONFIG['assets']['kwargs']['detector_overrides']
SAMPLES = round(sum(LIGHT_KEYS['light_trig_window'])
                / LIGHT_KEYS['light_digit_sample_spacing'])
IDS = dict(pixel_layout_id=[0, 0, 1, 0], response_id=[0, 0, 1, 0],
           light_lut_id=[0, 1, 1, 1])
LIGHT_LABELS = ('light/incidence', 'light/signal', 'light/digitize',
                'light/pull', 'export/light', 'export/light_merge')
#: where each label opens: the labels open around it
PARENTS = {'light/incidence': {None, 'light_batch'},
           'light/signal': {'light_batch'},
           'light/digitize': {'light_batch'},
           'light/pull': {None},
           'export/light': {None, 'export', 'export/flush', 'export/final'},
           'export/light_merge': {'export/final'}}
RAND_SEED = 2**31 + 5


class CountingClock:
    """A ``time`` for ``utils.trace`` whose ``perf_counter`` counts its
    reads, so that every phase's wall is a whole number of reads."""

    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()
        self.thread_time = time.thread_time
        self.time_ns = time.time_ns

    def perf_counter(self) -> float:
        with self._lock:
            self.t += 1.0
            return self.t


class PhaseRecorder:
    """Every phase opened, with the phase open around it, and the summed
    walls of the outermost ones under a :class:`CountingClock`."""

    def __init__(self, clock):
        self.clock, self.real = clock, trace.phase
        self.opened = []
        self.outer = 0.0

    @contextlib.contextmanager
    def phase(self, label, device=None):
        frames = getattr(trace._STACK, 'frames', None) or []
        parent = frames[-1] if frames else None
        self.opened.append((label, parent))
        t0 = self.clock.t
        with self.real(label, device):
            yield
        if parent is None:
            # the phase's first read is t0 + 1, its last the clock now
            self.outer += self.clock.t - t0 - 1


def _record(monkeypatch) -> PhaseRecorder:
    clock = CountingClock()
    rec = PhaseRecorder(clock)
    monkeypatch.setattr(trace, 'time', clock)
    monkeypatch.setattr(trace, 'phase', rec.phase)
    return rec


def _write_spills(path, borders, missing_tpcs=(4, 5)) -> np.ndarray:
    """Two spills, a track in every TPC of each, their times in the first
    1.5 us of the spill (inside the beam trigger's digitised window); the
    second spill without the tracks of ``missing_tpcs``."""
    seg, traj, vert = make_tracks(borders, n_events=2, tracks_per_event=8,
                                  segments_per_track=6, segment_length=0.4,
                                  dEdx=8.0, seed=7, every_tpc=True)
    spill = seg['event_id'].astype(np.float64) * 1.2e6
    for name in ('t0_start', 't0_end', 't0'):
        seg[name] = spill + (seg[name] - spill) * 0.15
    # track k of a spill lies in TPC k
    drop = (seg['event_id'] == 1) & np.isin(seg['file_traj_id'] % 8,
                                            missing_tpcs)
    seg = seg[~drop]
    with File(path, 'w') as f:
        f.create_dataset('segments', data=seg)
        f.create_dataset('trajectories', data=traj)
        f.create_dataset('vertices', data=vert)
    return seg


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """The small tree's files as the benchmark prepares them: a response
    file a pixel layout (the synthetic one the port makes for a missing
    file), which the reference reads."""
    files, _ = assets.prepare(dict(
        name='small_2x2', run=IDS, assets=dict(
            writer='write_2x2', kwargs=dict(
                tpa.SMALL_2X2, detector_overrides=LIGHT_KEYS,
                sim_overrides=dict(event_batch_size=2)))),
        cache=str(tmp_path_factory.mktemp('cache')))
    return files


@pytest.fixture(scope='module')
def borders(tree):
    return load_detector(tree['detector_properties'],
                         tree['pixel_layout'][0], device='cpu').tpc_borders


@pytest.fixture(scope='module')
def run_2x2(tree, borders, tmp_path_factory):
    """The CLI on the 2x2 with light, its phases recorded."""
    mp = pytest.MonkeyPatch()
    d = tmp_path_factory.mktemp('run')
    inp, out = str(d / 'in.h5'), str(d / 'out.h5')
    seg = _write_spills(inp, np.asarray(borders))
    rec = _record(mp)
    try:
        tcli.run_simulation(
            inp, out, config='2x2', mod2mod_variation=True,
            detector_properties=tree['detector_properties'],
            pixel_layout=tree['pixel_layout'],
            simulation_properties=tree['simulation_properties'],
            response_file=tree['response_file'],
            light_lut_filename=tree['light_lut_filename'],
            rand_seed=RAND_SEED, step_scale=4.0, device='cpu', **IDS)
        table = trace.summary()
    finally:
        mp.undo()
    return dict(input=inp, output=out, segments=seg, rec=rec, table=table)


def test_the_light_phases_open_where_stated(run_2x2):
    opened = run_2x2['rec'].opened
    for label in LIGHT_LABELS:
        parents = {p for name, p in opened if name == label}
        assert parents, f'{label} never opened'
        assert parents <= PARENTS[label], (label, parents)
    assert {p for name, p in opened if name == 'light/incidence'} \
        == {None, 'light_batch'}
    assert ('export/light', 'export/final') in opened
    # a light call a module a spill: two spills, four modules, one spill
    # of module 3 without segments
    assert sum(name == 'light_batch' for name, _ in opened) == 7
    assert sum(name == 'light/signal' for name, _ in opened) == 7
    assert sum(name == 'light/pull' for name, _ in opened) == 7
    # the module-level incidence once a module, each call's rows once
    assert sum(name == 'light/incidence' for name, _ in opened) == 4 + 7


def test_the_phase_table_sums_to_the_wall(run_2x2):
    table, rec = run_2x2['table'], run_2x2['rec']
    assert set(LIGHT_LABELS) <= set(table)
    assert all(s >= 0 for s, _ in table.values())
    assert sum(s for s, _ in table.values()) == rec.outer > 0


def test_every_module_writes_a_row_a_spill(run_2x2):
    with File(run_2x2['output'], 'r') as f:
        wvfm = np.asarray(f['light_wvfm'])
        n_trig = len(f['light_trig'])
        assert 'light_wvfm/light_wvfm_mod0' not in f
    assert SAMPLES == 1000
    assert wvfm.shape == (2, 384, SAMPLES) and n_trig == 2
    blocks = wvfm.reshape(2, 4, 96, SAMPLES)
    # module 3 holds no segment in spill 1: its row there is zeros
    assert not blocks[1, 2].any()
    assert all(blocks[ev, m].any() for ev in range(2) for m in range(4)
               if (ev, m) != (1, 2))


def test_the_files_light_equals_the_reference(run_2x2, tree):
    numbers = compare_light.compare(
        dict(input=run_2x2['input'], output=run_2x2['output'],
             rand_seed=RAND_SEED), tree, CONFIG, None, 'cpu', lambda m: None)
    assert numbers['n_wvfm_samples'] == 2 * 4 * 96 * SAMPLES
    assert numbers['wvfm_samples_differ'] == 0
    assert numbers['wvfm_adc_gap_max'] == 0
    assert numbers['light_rows_differ'] == 0


def test_a_charge_only_ndlar_run_opens_no_light_phase(tmp_path,
                                                      monkeypatch):
    paths = write_ndlar(str(tmp_path / 'tree'), detector_overrides=tpa.QUIET)
    dm = load_detector(paths['detector_properties'], paths['pixel_layout'],
                       device='cpu')
    inp = str(tmp_path / 'in.h5')
    write_input(inp, np.asarray(dm.tpc_borders), n_events=1,
                tracks_per_event=1, segments_per_track=4,
                segment_length=0.4, dEdx=8.0, seed=3)
    rec = _record(monkeypatch)
    tcli.run_simulation(
        inp, str(tmp_path / 'out.h5'), config='ndlar',
        detector_properties=paths['detector_properties'],
        pixel_layout=paths['pixel_layout'],
        simulation_properties=paths['simulation_properties'],
        response_file=str(tmp_path / '__missing__.npy'), rand_seed=7,
        step_scale=32.0, device='cpu')
    labels = {name for name, _ in rec.opened}
    assert 'charge_batch' in labels
    assert not {l for l in labels if l.startswith(('light', 'export/light'))}
    assert sum(s for s, _ in trace.summary().values()) == rec.outer


def _run_one_tpc_a_batch(tmp_path, borders, missing_tpcs):
    """The CLI on the small tree at its own batching (one TPC a batch)."""
    files, _ = assets.prepare(dict(
        name='small_2x2_one_tpc', run=IDS, assets=dict(
            writer='write_2x2', kwargs=tpa.SMALL_2X2)),
        cache=str(tmp_path / 'cache'))
    inp, out = str(tmp_path / 'in.h5'), str(tmp_path / 'out.h5')
    _write_spills(inp, np.asarray(borders), missing_tpcs)
    tcli.run_simulation(
        inp, out, config='2x2', mod2mod_variation=True,
        detector_properties=files['detector_properties'],
        pixel_layout=files['pixel_layout'],
        simulation_properties=files['simulation_properties'],
        response_file=files['response_file'],
        light_lut_filename=files['light_lut_filename'],
        rand_seed=RAND_SEED, step_scale=4.0, device='cpu', **IDS)
    return files, inp, out


def test_one_tpc_a_batch_equals_the_reference(tmp_path, borders):
    """Every TPC hit in both spills: a module's first TPC triggers, its
    second adds no row; the reference plans the rows alike."""
    files, inp, out = _run_one_tpc_a_batch(tmp_path, borders, ())
    with File(out, 'r') as f:
        # the loader's default window: 256 samples of 10 ns
        assert f['light_wvfm'].shape == (2, 384, 256)
    numbers = compare_light.compare(
        dict(input=inp, output=out, rand_seed=RAND_SEED), files, CONFIG,
        None, 'cpu', lambda m: None)
    assert numbers['wvfm_samples_differ'] == 0
    assert numbers['light_rows_differ'] == 0


def test_unequal_light_rows_raise_as_larnd_sim_does(tmp_path, borders):
    """One TPC a batch, module 3's first TPC empty in spill 1: its empty
    batch writes a zero row and its second TPC triggers, two rows where
    the other modules write one, and the merge refuses the file."""
    with pytest.raises(ValueError, match='number of triggers'):
        _run_one_tpc_a_batch(tmp_path, borders, (4,))


def _module(tree, m: int):
    """The port's and the reference's readings of module ``m``."""
    layout = tree['pixel_layout'][IDS['pixel_layout_id'][m - 1]]
    lut_path = tree['light_lut_filename'][IDS['light_lut_id'][m - 1]]
    det_model = load_detector(tree['detector_properties'], layout,
                              i_module=m, device='cpu')
    rdet = rdetector.load(tree['detector_properties'], layout,
                          tree['simulation_properties'], i_module=m)
    return det_model, rdet, lut_path


def _tracks(det_model, m: int, seed: int) -> np.ndarray:
    """Seeded straight tracks in module ``m``'s two TPCs, in the drift
    frame, their times in the beam trigger's digitised window."""
    b = np.asarray(det_model.tpc_borders)[2 * m - 2:2 * m]
    tracks = tpa.detector_tracks(b, seed=seed, tracks_per_event=4,
                                 segments_per_track=8)
    rng = np.random.default_rng(seed)
    shift = rng.uniform(0.0, 1.2, len(tracks)).astype(np.float32)
    for name in ('t0_start', 't0_end', 't0'):
        tracks[name] = tracks[name] * np.float32(0.1) + shift
    return tracks


def _port_light(tree, det_model, lut_path, tracks, m, draw_seed):
    """The port's incidence of module ``m``'s channels and its beam
    waveform, (photons, voxels, waveform (96, samples))."""
    det = det_model.params
    light = load_light(tree['detector_properties'], device='cpu')
    sim = load_sim(tree['simulation_properties'])
    lut = tlight_ops.LightLUT.from_structured(
        load_light_lut(lut_path, n_det_tpc=48), 'cpu')
    segs = drift(quench(from_structured(tracks, device='cpu'), det,
                        physics.BIRKS), det)
    inc, _, vox = tlight_ops.calculate_light_incidence(
        segs, det, light, lut.vis, lut.t0, n_channels=96,
        channel_offset=96 * (m - 1))
    noise = torch.from_numpy(make_light_noise(384)[96 * (m - 1):96 * m]) \
        .float()
    res = tlight.simulate_light_group(
        stack([segs]), light, sim, inc[None], vox[None], lut, noise,
        [tlight.generator_draw(torch.Generator().manual_seed(draw_seed),
                               'cpu')],
        op_channel=light.tpc_to_op_channel[:2].reshape(-1))[0]
    return inc, vox, res.waveforms[0]


def _reference_light(tree, rdet, lut_path, tracks, m, draw_seed,
                     precision='float32'):
    """The reference's counterparts of :func:`_port_light`."""
    keys = rlight.load(tree['detector_properties'])
    lut = rlight.read_lut(lut_path, 'cpu')
    seg = rcharge.quench_and_drift(tracks, rdet, 'cpu')
    p = rlight.Pass(rcharge.Module(m, rdet, None, (2 * m - 2, 2 * m - 1)),
                    np.arange(96) + 96 * (m - 1), np.arange(96), lut_path)
    vox = rlight.voxels(seg, rdet, lut['vis'].shape[:3])
    n_det = rlight.detected(seg, rlight.photons(tracks, rdet, 'cpu'), vox,
                            keys, p, lut['vis'])
    spectra = torch.from_numpy(rlight.make_light_noise(384).astype(
        np.float32)[p.channels][p.simulated % 96])
    wave = rlight.waveform(
        torch.from_numpy(np.ascontiguousarray(tracks['t0'], np.float32)),
        n_det, vox, lut, spectra, torch.from_numpy(keys.gain[p.simulated]),
        p.simulated, keys, torch.Generator().manual_seed(draw_seed),
        precision)
    return n_det, vox, wave


@pytest.mark.parametrize('m', [1, 2, 3, 4], ids=[
    'module1-lut0', 'module2-lut1', 'module3-layout1-lut1', 'module4-lut1'])
def test_the_reference_chain_equals_the_ports(tree, m):
    det_model, rdet, lut_path = _module(tree, m)
    tracks = _tracks(det_model, m, seed=10 + m)
    inc, vox, wave = _port_light(tree, det_model, lut_path, tracks, m, 99)
    r_inc, r_vox, r_wave = _reference_light(tree, rdet, lut_path, tracks, m,
                                            99)
    assert inc.shape == (len(tracks), 96) and (inc > 0).any()
    assert torch.equal(vox, r_vox)
    assert torch.equal(inc, r_inc)
    assert wave.shape == r_wave.shape == (96, SAMPLES)
    assert (wave != 0).float().mean() > 0.01
    assert torch.equal(wave, r_wave)


@pytest.mark.parametrize('m', [1, 2], ids=['lut0', 'lut1'])
def test_the_bf16_control_fails_the_light_limits(tree, m):
    det_model, rdet, lut_path = _module(tree, m)
    tracks = _tracks(det_model, m, seed=21)
    _, _, wave = _port_light(tree, det_model, lut_path, tracks, m, 5)
    _, _, control = _reference_light(tree, rdet, lut_path, tracks, m, 5,
                                     precision='bf16')
    numbers = compare_light.waveform_numbers(
        [wave.numpy()[None].astype(np.float64)],
        [[(0, control.numpy())]], (96, SAMPLES))
    limits = CONFIG['limits']
    assert numbers['wvfm_samples_differ'] > limits['wvfm_samples_differ'] \
        or numbers['wvfm_adc_gap_max'] > limits['wvfm_adc_gap_max']
