"""The stand-in detector assets of a configuration, made once per checkout.

A configuration file names its asset writer (``assets.writer``: one of the
frozen copies in ``reference/frozen/assets/geometry.py``) and the keys it
passes.  The writer's YAMLs, the response table (the synthetic response
the port would make for a missing file, written as the file a user keeps
on disk) and the TPC borders go into ``cache/<config>/`` beside this file
(git-ignored).  A run that finds the directory complete reads it; the
first run of a checkout makes it (into a temporary directory moved into
place when complete).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, 'cache')
MANIFEST = 'manifest.json'


def _write(directory: str, cfg: dict) -> dict:
    """Make the configuration's assets in ``directory``; returns the
    manifest (paths relative to it)."""
    from .reference import detector
    from .reference.frozen.assets import geometry
    from .reference.frozen.assets.response import make_response
    spec = cfg['assets']
    paths = getattr(geometry, spec['writer'])(directory,
                                              **spec.get('kwargs', {}))
    if isinstance(paths['pixel_layout'], list):
        raise ValueError(f'{cfg["name"]}: one pixel layout per detector '
                         'is what the benchmark reads')
    det = detector.load(paths['detector_properties'], paths['pixel_layout'],
                        paths['simulation_properties'])
    c = {k: float(np.float32(det.c[k])) for k in (
        'time_window', 'response_sampling', 'response_bin_size',
        'pixel_pitch')}
    paths['response_file'] = os.path.join(directory, 'response.npy')
    np.save(paths['response_file'], make_response(
        n_t=int(round(c['time_window'] / c['response_sampling'])),
        bin_size=c['response_bin_size'], sampling=c['response_sampling'],
        pixel_pitch=c['pixel_pitch']))
    np.save(os.path.join(directory, 'tpc_borders.npy'), det.borders)
    return {k: os.path.relpath(v, directory) for k, v in paths.items()}


def prepare(cfg: dict, cache: str = CACHE) -> tuple[dict, np.ndarray]:
    """The run_simulation file arguments of configuration ``cfg`` (made
    first where ``cache/<name>`` is not complete) and its TPC borders."""
    directory = os.path.join(cache, cfg['name'])
    manifest = os.path.join(directory, MANIFEST)
    if not os.path.isfile(manifest):
        tmp = f'{directory}.partial'
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        rel = _write(tmp, cfg)
        with open(os.path.join(tmp, MANIFEST), 'w') as f:
            json.dump(rel, f)
        shutil.rmtree(directory, ignore_errors=True)
        os.replace(tmp, directory)
    with open(manifest) as f:
        rel = json.load(f)
    kwargs = {k: os.path.join(directory, v) for k, v in rel.items()}
    return kwargs, np.load(os.path.join(directory, 'tpc_borders.npy'))
