"""The stand-in detector assets of a configuration, made once per checkout.

A configuration file names its asset writer (``assets.writer``: one of the
frozen copies in ``reference/frozen/assets/geometry.py``) and the keys it
passes.  The writer's YAMLs and light tables, a response table for each
pixel layout (the synthetic response the port would make for a missing
file, written as the file a user keeps on disk) and the TPC borders of
the whole detector go into ``cache/<config>/`` beside this file
(git-ignored).  A writer of several modules may return lists (pixel
layouts, light tables): the manifest keeps them as lists, and the
response of layout ``i`` is ``response_<i>.npy``, made for the first
module that uses it (``run.pixel_layout_id``, else module ``i + 1``); one
layout's is ``response.npy``.  A run that finds the directory complete
reads it; the first run of a checkout makes it (into a temporary
directory moved into place when complete).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, 'cache')
MANIFEST = 'manifest.json'


def _each(value, fn):
    return [fn(v) for v in value] if isinstance(value, list) else fn(value)


def _layout_users(det_yaml: str, n_layouts: int, ids) -> list[int]:
    """For each pixel layout, the first module that uses it."""
    from .reference import detector
    users = {}
    for m in detector.module_ids(det_yaml):
        users.setdefault(detector.of_module(list(range(n_layouts)), m, ids),
                         m)
    missing = [i for i in range(n_layouts) if i not in users]
    if missing:
        raise ValueError(f'no module uses pixel layouts {missing}')
    return [users[i] for i in range(n_layouts)]


def _write(directory: str, cfg: dict) -> dict:
    """Make the configuration's assets in ``directory``; returns the
    manifest (paths relative to it)."""
    from .reference import detector
    from .reference.frozen.assets import geometry
    from .reference.frozen.assets.response import make_response
    spec = cfg['assets']
    paths = getattr(geometry, spec['writer'])(directory,
                                              **spec.get('kwargs', {}))
    det_yaml, sim_yaml = (paths['detector_properties'],
                          paths['simulation_properties'])
    layouts = paths['pixel_layout']
    ids = cfg['run'].get('pixel_layout_id')
    if isinstance(layouts, list):
        users = _layout_users(det_yaml, len(layouts), ids)
        made = [(layout, m, os.path.join(directory, f'response_{i}.npy'))
                for i, (layout, m) in enumerate(zip(layouts, users))]
        paths['response_file'] = [path for *_, path in made]
    else:
        made = [(layouts, -1, os.path.join(directory, 'response.npy'))]
        paths['response_file'] = made[0][2]
    for layout, i_module, path in made:
        det = detector.load(det_yaml, layout, sim_yaml, i_module)
        c = {k: float(np.float32(det.c[k])) for k in (
            'time_window', 'response_sampling', 'response_bin_size',
            'pixel_pitch')}
        np.save(path, make_response(
            n_t=int(round(c['time_window'] / c['response_sampling'])),
            bin_size=c['response_bin_size'], sampling=c['response_sampling'],
            pixel_pitch=c['pixel_pitch']))
        if layout == detector.of_module(layouts, 1, ids):
            # every TPC's borders, through module 1's layout, as the
            # program's active volume takes them
            np.save(os.path.join(directory, 'tpc_borders.npy'), det.borders)
    return {k: _each(v, lambda p: os.path.relpath(p, directory))
            for k, v in paths.items()}


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
    kwargs = {k: _each(v, lambda p: os.path.join(directory, p))
              for k, v in rel.items()}
    return kwargs, np.load(os.path.join(directory, 'tpc_borders.npy'))
