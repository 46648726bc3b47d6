"""Entry points: the charge step with an example batch, and a multi-device
dry run.

Counterpart of the JAX repository's ``__graft_entry__.py`` (:66-260) on
generated assets: ``entry()`` gives the charge-readout step (quench ->
drift -> pixelize -> induced current -> FEE, ``models.charge.charge_step``)
with a small example batch on the published Module-0 widths
(``assets.geometry.write_module0``); ``dryrun_multichip(n)`` runs the whole
simulation step (``parallel.mesh.make_sharded_sim_step``: charge, beam
light with noise, top-8 truth, two trigger slots) on an n-device
('modules', 'events') grid, with module parameters that vary along the
modules axis, then the production multi-device path: the CLI on the
generated 2x2 with module variation at ``n_devices`` n.  Both keep the JAX
version's checks.

    python -m larndsim_tpu_torch.graft_entry [N] [--device cpu|cuda]

(``--device cuda`` with one card: N contexts on it.)
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

#: the JAX entry's shapes (__graft_entry__.py:62-63): t_sig covers the
#: response window (189.1 us at 0.1 us: 1891 ticks, bucketed to 2048)
STATICS = dict(max_active=16, radius=1, max_nb=64, t_sig=2048, n_steps=32,
               n_unique_cap=512, max_adc=10, max_tracks=16)
#: the dry run's truth contributors and trigger slots (__graft_entry__.py:
#: 184-185)
K_TRUTH, MAX_TRIG = 8, 2


def _example_setup(directory: str, n_segments: int = 32, seed: int = 0,
                   device='cuda'):
    """The Module-0 tree with the light keys in ``directory``; its params,
    ``n_segments`` straight segments in TPC 0 quenched and drifted (JAX
    ``_example_setup``), the synthetic response and the induced current's
    shift band.  Returns (paths, det, segs, response, shift_band)."""
    from .assets.geometry import write_module0
    from .assets.response import make_response
    from .ops import current
    from .ops.drift import drift
    from .ops.quench import quench
    from .params import load_detector, physics
    from .segments import FLOAT_FIELDS, INT_FIELDS, from_structured

    paths = write_module0(os.path.join(directory, 'module0'), light=True)
    dm = load_detector(paths['detector_properties'], paths['pixel_layout'],
                       device=device)
    det = dm.params
    rng = np.random.default_rng(seed)
    borders = det.host['tpc_borders']
    dtype = np.dtype([(f, 'f8') for f in FLOAT_FIELDS]
                     + [(f, 'i8') for f in INT_FIELDS])
    tr = np.zeros(n_segments, dtype=dtype)
    for axis, name in enumerate('xyz'):
        lo, hi = sorted(borders[0, axis])
        start = rng.uniform(lo + 0.1, hi - 1.0, n_segments)
        tr[f'{name}_start'] = start
        tr[f'{name}_end'] = start + 0.5
        tr[name] = start + 0.25
    tr['dx'] = np.sqrt(3) * 0.5
    tr['dEdx'] = 10.0
    tr['dE'] = tr['dEdx'] * tr['dx']
    segs = drift(quench(from_structured(tr, device=device), det,
                        physics.BIRKS), det)
    band = current.host_shift_band(
        {k: getattr(segs, k).cpu().numpy() for k in (
            'pixel_plane', 'long_diff', 'z_start', 'z_end', 't_start',
            't0_start')}, det, mc_smear=True)
    n_t = int(round(det.f32('time_window') / det.f32('response_sampling')))
    response = torch.from_numpy(make_response(
        n_xy=45, n_t=n_t, bin_size=det.f32('response_bin_size'),
        sampling=det.f32('response_sampling'),
        pixel_pitch=det.f32('pixel_pitch'))).to(device)
    return paths, det, segs, response, band


def entry(device='cuda'):
    """The charge step and its example arguments on ``device``: ``fn(segs,
    det, response, draw) -> (adc, uniq, fractions)`` and ``(segs, det,
    response, draw)``, the draw from a seeded generator."""
    from .models.charge import charge_step, generator_draw
    with tempfile.TemporaryDirectory(prefix='graft_entry_') as tmp:
        _, det, segs, response, band = _example_setup(tmp, device=device)
    gen = torch.Generator(device).manual_seed(0)

    def fn(segs, det, response, draw):
        uniq, _, adc, _, fractions, _, _ = charge_step(
            segs, det, response, draw, shift_band=band, **STATICS)
        return adc, uniq, fractions

    return fn, (segs, det, response, generator_draw(gen, device))


def light_shapes(light) -> dict:
    """The beam stage's shapes of a light configuration, as the JAX dry
    run sizes them (__graft_entry__.py:163-176): n_ticks and conv_ticks
    (``models.light.window`` of the window's ticks), digit_samples, and
    the pads around a trigger at tick 0."""
    from .models import light as light_model
    n_ticks, conv_ticks = light_model.window(light, int(
        (light.light_window[1] + light.light_window[0])
        / light.light_tick_size))
    pad_front, pad_back = light_model._pads(light, np.zeros(1, int), n_ticks)
    return dict(n_ticks=n_ticks, conv_ticks=conv_ticks,
                digit_samples=light_model.digit_samples(light),
                pad_front=pad_front, pad_back=pad_back)


def dryrun_multichip(n_devices: int, device='cuda') -> dict:
    """One sharded simulation step over an n-device ('modules', 'events')
    grid (two module rows when n is even), each module row with its own
    electric field (and the one light LUT stacked along the module axis),
    the same segments in every cell;
    then the CLI on the generated 2x2 with module variation at
    ``n_devices`` n.  ``device`` as the CLI's (``parallel.devices.
    resolve_devices``: 'cuda' the visible cards, 'cpu' n contexts on the
    CPU, or a list such as ``['cuda:0'] * 4``).  Returns the step's
    outputs and the CLI's packet count."""
    from .assets.geometry import write_2x2
    from .assets.light_lut import make_light_lut, make_light_noise
    from .assets.make_input import write_input
    from .cli.simulate_pixels import run_simulation
    from .io.h5 import File
    from .models import light as light_model
    from .models.charge import generator_draw
    from .ops.light import LightLUT
    from .parallel.devices import resolve_devices
    from .parallel.mesh import (make_mesh, make_sharded_sim_step,
                                shard_segments, stack_module_params)
    from .params import load_detector, load_light
    from .segments import to_structured

    devices = resolve_devices(device, n_devices)
    if len(devices) < n_devices:
        raise RuntimeError(f'dryrun_multichip({n_devices}): only '
                           f'{len(devices)} devices')
    mesh = make_mesh(n_devices, n_modules=2 if n_devices % 2 == 0 else 1,
                     devices=devices)
    n_mod, n_ev = mesh.shape['modules'], mesh.shape['events']
    home = devices[0]
    with tempfile.TemporaryDirectory(prefix='dryrun_') as tmp:
        paths, det, segs, response, band = _example_setup(
            tmp, n_segments=8, device=home)
        light = load_light(paths['detector_properties'], device=home)
    C = light.n_op_channel
    lut = LightLUT.from_structured(make_light_lut(
        vox_div=(14, 26, 8), n_det_tpc=C // det.n_tpcs), home)
    # the module variation: each row its own electric field, as a number,
    # so that the tensor and its float64 host copy change together
    det_stack = stack_module_params([
        det.replace(e_field=det.host['e_field'] * (1.0 + 0.01 * i))
        for i in range(n_mod)])
    grid = shard_segments([to_structured(segs)] * (n_mod * n_ev), mesh,
                          pad_to=segs.size)

    def stack_lut(a):
        return torch.stack([a] * n_mod)

    noise = torch.as_tensor(np.asarray(make_light_noise(C), np.float32))
    shapes = light_shapes(light)
    step = make_sharded_sim_step(
        mesh, light, torch.arange(C), shift_band=band, **STATICS,
        **shapes, add_noise=True, k_truth=K_TRUTH, trig_mode=1,
        max_trig=MAX_TRIG)
    gens = [[torch.Generator(d).manual_seed(m * n_ev + e) for e, d in
             enumerate(row)] for m, row in enumerate(mesh.devices)]
    draws = [[(generator_draw(g, d), light_model.generator_draw(g, d))
              for g, d in zip(gens[m], mesh.devices[m])]
             for m in range(n_mod)]
    out = step(grid, det_stack, response, stack_lut(lut.vis),
               stack_lut(lut.t0), stack_lut(lut.time_dist),
               stack_lut(lut.t0_avg), draws,
               noise_rows=stack_lut(noise))
    cells = [(m, e) for m in range(n_mod) for e in range(n_ev)]
    adc = [out['adc'][m][e] for m, e in cells]
    wvfms = [out['waveforms'][m][e] for m, e in cells]
    ids = [out['truth_ids'][m][e] for m, e in cells]
    n_hits = out['n_hits_total']
    assert all(a.shape == (STATICS['n_unique_cap'], STATICS['max_adc'])
               for a in adc)
    assert all(w.shape == (MAX_TRIG, C, shapes['digit_samples'])
               for w in wvfms)
    assert all(i.shape == (C, K_TRUTH) for i in ids)
    assert sum(int(out['n_triggers'][m][e]) for m, e in cells) \
        == n_mod * n_ev
    assert max(int(i.max()) for i in ids) >= 0, 'no truth ids'
    assert int(n_hits) > 0, 'sharded charge step produced no ADC hits'
    assert any(bool((w.abs() > 0).any()) for w in wvfms), \
        'sharded light step silent'
    print(f'dryrun_multichip: mesh={mesh.shape} adc '
          f'{tuple(adc[0].shape)} x {len(adc)} cells, wvfm '
          f'{tuple(wvfms[0].shape)}, total_hits={int(n_hits)}', flush=True)

    # the production multi-device path: the CLI's module threads over the
    # same devices, each module's event groups round-robin over its share
    with tempfile.TemporaryDirectory(prefix='dryrun_cli_') as tmp:
        p = write_2x2(os.path.join(tmp, '2x2'))
        dm = load_detector(p['detector_properties'], p['pixel_layout'][0],
                           device='cpu')
        in_file = os.path.join(tmp, 'in.h5')
        write_input(in_file, dm.tpc_borders, n_events=1, tracks_per_event=2,
                    segments_per_track=4, dEdx=15.0, seed=3)
        out_file = os.path.join(tmp, 'out.h5')
        run_simulation(
            in_file, out_file, config='2x2',
            detector_properties=p['detector_properties'],
            pixel_layout=p['pixel_layout'],
            simulation_properties=p['simulation_properties'],
            response_file=p['response_file'],
            light_lut_filename=p['light_lut_filename'],
            light_det_noise_filename=os.path.join(tmp, '__missing__.npy'),
            mod2mod_variation=True, rand_seed=1, step_scale=32.0,
            event_group_size=2, n_devices=n_devices, device=devices)
        with File(out_file, 'r') as f:
            n_pkts = int(f['packets'].shape[0])
            assert n_pkts > 0, 'production multi-chip run wrote no packets'
            assert 'light_wvfm' in f
    print(f'dryrun_multichip: production CLI mod2mod over {n_devices} '
          f'devices ok ({n_pkts} packets)', flush=True)
    return dict(step=out, mesh=mesh, det_stack=det_stack, n_packets=n_pkts)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('n_devices', nargs='?', type=int, default=None)
    ap.add_argument('--device', default='cuda')
    opts = ap.parse_args(argv)
    dev = 'cuda:0' if opts.device == 'cuda' else opts.device
    fn, args = entry(dev)
    print('entry ok:', [tuple(o.shape) for o in fn(*args)])
    n = opts.n_devices or max(torch.cuda.device_count()
                              if opts.device == 'cuda' else 1, 1)
    dryrun_multichip(n, [dev] * n if opts.device == 'cuda'
                     and torch.cuda.device_count() < n else opts.device)


if __name__ == '__main__':
    main()
