"""Walls of the port's host runtime and of its charge chain, parent
against change, on the card.

    python -m larndsim_tpu_torch.tools.host_walls --parent DIR [SLICE ...]

``DIR`` is the parent checkout (an unpacked ``git archive``).  The slices
are ``chip_smoke.py``'s, their assets and inputs made once:

* ``truth_host_w1`` / ``truth_host_w4``: the truth slice (the
  Module-0-shaped detector with one 2x2 module's light keys, LUT smearing,
  :data:`slice_run.SMEAR_TRUTH`) by the host route at ``truth_workers`` 1 /
  4; ``ndlar_bench``: ND-LAr at bench's batching
  (:data:`slice_run.NDLAR_BENCH`).  Each run by the parent, the change,
  the change and the parent;
* ``charge``: the charge-only slice; ``2x2``: the 2x2 with module variation
  and its production truth (device route); ``ndlar_yaml``: ND-LAr at its
  YAML's batching (2500 segments, two TPCs a batch, ungrouped).  Each run
  by the parent, the change, the change with ``pipeline=True`` twice, the
  change, and the parent;
* ``chain``: the charge chain's waveform sum (D1) and current fractions
  (D2) alone and with their inputs made, on the charge-only slice's first
  batch and on ``tools.perf_guard``'s 2x2 and ND-LAr batches
  (``slice_run.kernels``), run by the parent, the change, the change and
  the parent.

Each run is a process of its own (``slice_run.run``: a one-spill warm-up,
then the timed run, its launch counters set to 0 before it).  One JSON line
per run: its wall, the self seconds of its phases, its peak device
memory and its launches (``chain``: its times); then one line per slice
with each side's walls.
Every run's datasets must equal the slice's first run's
(``tools.file_check``; ``chain``: the SHA-256 of D1's waveforms and D2's
fractions on each batch): the change moves no byte.  Exits 1 where one
differs.  With no slice named, all of them run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from . import slice_run
from .file_check import differences

#: each slice's runs in order: (tree, pipeline)
TURNS = (('parent', False), ('change', False), ('change', False),
         ('parent', False))
PIPELINE_ORDER = (('parent', False), ('change', False), ('change', True),
                  ('change', True), ('change', False), ('parent', False))
SLICES = ('truth_host_w1', 'truth_host_w4', 'charge', '2x2', 'ndlar_yaml',
          'ndlar_bench', 'chain')
#: the slices run with ``pipeline`` too
PIPELINED = ('charge', '2x2', 'ndlar_yaml')


def make_slices(directory: str, names, device: str = 'cuda') -> dict:
    """{slice: (input, run_simulation keywords)} for ``names``."""
    from ..assets.geometry import write_2x2, write_module0, write_ndlar
    from ..assets.make_input import write_input
    from ..params import load_detector

    def borders(paths, layout=None):
        return load_detector(paths['detector_properties'],
                             layout or paths['pixel_layout'],
                             device='cpu').tpc_borders

    common = dict(rand_seed=7, step_scale=1.0, device=device)
    out = {}
    if {'truth_host_w1', 'truth_host_w4', 'charge', 'chain'} & set(names):
        inp = os.path.join(directory, 'spills.h5')
        charge = write_module0(os.path.join(directory, 'module0'))
        write_input(inp, borders(charge), **slice_run.SPILLS)
        kw = dict(common, config='module0', response_file=os.path.join(
            directory, 'response_44.npy'))
        out['charge'] = inp, dict(kw, **{
            k: charge[k] for k in ('detector_properties', 'pixel_layout',
                                   'simulation_properties')})
        truth = write_module0(os.path.join(directory, 'module0_truth'),
                              light=True,
                              sim_overrides=slice_run.SMEAR_TRUTH)
        kw_t = dict(kw, truth_path='host', **{
            k: truth[k] for k in ('detector_properties', 'pixel_layout',
                                  'simulation_properties')})
        for n in (1, 4):
            out[f'truth_host_w{n}'] = inp, dict(kw_t, truth_workers=n)
        out['chain'] = out['charge']
    if '2x2' in names:
        paths = write_2x2(os.path.join(directory, '2x2'),
                          sim_overrides=slice_run.SMEAR_TRUTH)
        inp = os.path.join(directory, 'spills_2x2.h5')
        write_input(inp, borders(paths, paths['pixel_layout'][0]),
                    **slice_run.SPILLS_2X2)
        out['2x2'] = inp, dict(
            common, config='2x2', response_file=paths['response_file'],
            light_lut_filename=paths['light_lut_filename'],
            light_det_noise_filename=os.path.join(directory,
                                                  'noise_2x2.npy'),
            **{k: paths[k] for k in ('detector_properties', 'pixel_layout',
                                     'simulation_properties')})
    if {'ndlar_yaml', 'ndlar_bench'} & set(names):
        paths = write_ndlar(os.path.join(directory, 'ndlar'))
        inp = os.path.join(directory, 'ndlar_spills.h5')
        write_input(inp, borders(paths), **dict(
            slice_run.NDLAR_SPILLS, n_events=slice_run.NDLAR_TIMED))
        kw = dict(common, config='ndlar',
                  response_file=os.path.join(directory, 'response_38.npy'),
                  **{k: paths[k] for k in ('detector_properties',
                                           'pixel_layout',
                                           'simulation_properties')})
        out['ndlar_yaml'] = inp, kw
        # bench.py's derived simulation properties: the YAML's, batch_size
        # raised, and its event groups
        bench = slice_run.NDLAR_BENCH
        out['ndlar_bench'] = inp, dict(
            kw, event_group_size=bench['group'],
            simulation_properties=write_ndlar(
                os.path.join(directory, 'ndlar_bench'), sim_overrides=dict(
                    batch_size=bench['batch_size']))['simulation_properties'])
    return {name: out[name] for name in names}


def compare(parent: str, names, device: str = 'cuda') -> int:
    smi = 'cpu: a rehearsal, no measurement' if device == 'cpu' else \
        subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip()
    print(f'card: {smi}', flush=True)
    trees = dict(parent=parent, change=slice_run._ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (inp, kw) in make_slices(tmp, names, device).items():
            order = PIPELINE_ORDER if name in PIPELINED else TURNS
            first, walls = None, {}
            for i, (tree, pipeline) in enumerate(order):
                out = os.path.join(tmp, f'{name}_run{i}.h5')
                if name == 'chain':
                    res = slice_run.kernels(trees[tree], inp, out, kw)
                    res.pop('stdout')
                    shas = {b: (v['d1_sha'], v['d2_sha'])
                            for b, v in res.items()}
                    first = first or shas
                    diff = None if shas == first else (shas, first)
                    print(json.dumps(dict(slice=name, run=i, tree=tree,
                                          card=smi, equal_to_run0=not diff,
                                          **res)), flush=True)
                else:
                    res = slice_run.run(trees[tree], inp, out,
                                        dict(kw, pipeline=True) if pipeline
                                        else kw)
                    first = first or out
                    diff = differences(first, out)
                    side = f'{tree}{" pipeline" if pipeline else ""}'
                    walls.setdefault(side, []).append(res['wall'])
                    print(json.dumps(dict(
                        slice=name, run=i, tree=tree, pipeline=pipeline,
                        wall_s=res['wall'], launches=res['launches'],
                        phases_self_s=res['phases'],
                        peak_device_gib=res['peak_device_gib'],
                        equal_to_run0=not diff)), flush=True)
                if diff:
                    print(f'{name}: run {i} differs from run 0: {diff}',
                          file=sys.stderr)
                    return 1
            if walls:
                print(json.dumps(dict(slice=name, walls_s=walls, card=smi)),
                      flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--parent', required=True,
                    help='the parent checkout (an unpacked git archive)')
    ap.add_argument('--device', default='cuda',
                    help="'cpu' runs the plain kernel versions (a rehearsal "
                    'of the wiring, no measurement)')
    ap.add_argument('slices', nargs='*',
                    help=f'the slices to run, of {", ".join(SLICES)} '
                    '(default: all)')
    opts = ap.parse_args(argv)
    unknown = sorted(set(opts.slices) - set(SLICES))
    if unknown:
        ap.error(f'unknown slices {unknown}')
    if opts.device == 'cpu' and 'chain' in (opts.slices or SLICES):
        ap.error("the chain slice times the card's kernels: name the "
                 'slices to rehearse')
    return compare(os.path.abspath(opts.parent), opts.slices or SLICES,
                   opts.device)


if __name__ == '__main__':
    sys.exit(main())
