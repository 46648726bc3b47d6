"""Synthetic light lookup-table generator.

A copy of ``larndsim_tpu.assets.light_lut`` (numpy only; held equal to the
original by tests/test_torch_host.py), so that the port runs without the
JAX package.

The reference consumes npz LUTs (``lightLUT_*.npz``) holding a structured
array 'arr' of shape (nx, ny, nz, ndet_tpc) with fields vis / t0 / t0_avg /
time_dist (cli/simulate_pixels.py:768-787).  The real files are external
data products; this builds a physically-plausible stand-in (solid-angle
visibility falloff from detector positions on the TPC walls, straight-line
photon arrival times, single-bump arrival-time profiles) so the light chain
runs end-to-end without them.  Loaders accept real files interchangeably.
"""
from __future__ import annotations

import numpy as np

#: group velocity of scintillation light in LAr, cm/ns
C_LIGHT_CM_NS = 30.0 / 1.38


def make_light_lut(vox_div=(14, 26, 8), n_det_tpc: int = 48,
                   tpc_size=(30.0, 60.0, 30.0), n_prof: int = 100,
                   seed: int = 0) -> np.ndarray:
    """Build a structured light LUT.

    Args:
        vox_div: voxel grid (module0 uses [14, 26, 8], module0.yaml).
        n_det_tpc: optical channels per TPC.
        tpc_size: TPC extent (x, y, z) in cm for geometry realism.
        n_prof: arrival-time profile bins (1 ns each, light_sim.py:90).
    """
    nx, ny, nz = vox_div
    dtype = np.dtype([('vis', 'f4'), ('t0', 'f4'), ('t0_avg', 'f4'),
                      ('time_dist', 'f4', (n_prof,))])
    arr = np.zeros((nx, ny, nz, n_det_tpc), dtype=dtype)

    # voxel centers in a generic TPC volume
    cx = (np.arange(nx) + 0.5) / nx * tpc_size[0]
    cy = (np.arange(ny) + 0.5) / ny * tpc_size[1]
    cz = (np.arange(nz) + 0.5) / nz * tpc_size[2]
    vox = np.stack(np.meshgrid(cx, cy, cz, indexing='ij'), axis=-1)

    # detectors stacked along y on the x=0 wall, half with a z offset
    rng = np.random.default_rng(seed)
    det_pos = np.zeros((n_det_tpc, 3))
    det_pos[:, 1] = (np.arange(n_det_tpc) + 0.5) / n_det_tpc * tpc_size[1]
    det_pos[:, 2] = np.where(np.arange(n_det_tpc) % 2 == 0,
                             0.25, 0.75) * tpc_size[2]

    d = np.linalg.norm(vox[..., None, :] - det_pos[None, None, None], axis=-1)
    d = np.maximum(d, 1.0)
    # inverse-square visibility with an effective detector area
    area = 15.0  # cm^2
    arr['vis'] = area / (4 * np.pi * d ** 2)
    arr['t0'] = d / C_LIGHT_CM_NS  # ns
    arr['t0_avg'] = arr['t0'] + 2.0

    # single-bump profile peaking near the direct arrival, normalized
    prof_t = np.arange(n_prof)
    peak = np.clip(arr['t0'][..., None], 0, n_prof - 10)
    prof = np.exp(-0.5 * ((prof_t - peak - 3) / 3.0) ** 2)
    arr['time_dist'] = prof / prof.sum(axis=-1, keepdims=True)
    return arr


_LUT_CACHE: dict = {}


def load_light_lut(path: str | None, **synth_kwargs) -> np.ndarray:
    """Load a light LUT npz, or build the synthetic stand-in.

    Cached per (path, synth args): the synthetic LUT generation is ~9 s for
    a 2x2-sized table and both it and file loads are deterministic, so the
    module loop and repeated runs in one process reuse one array (which
    also lets the device upload cache hit downstream).
    """
    import os
    key = (path if path and os.path.isfile(path) else None,
           tuple(sorted(synth_kwargs.items())))
    hit = _LUT_CACHE.get(key)
    if hit is not None:
        return hit
    if key[0]:
        arr = np.load(path)['arr']
    else:
        arr = make_light_lut(**synth_kwargs)
    if len(_LUT_CACHE) > 4:
        _LUT_CACHE.clear()
    _LUT_CACHE[key] = arr
    return arr


def make_light_noise(n_channels: int, n_bins: int = 192,
                     amplitude: float = 5.0, seed: int = 1) -> np.ndarray:
    """Synthetic noise amplitude spectra (stand-in for light_noise-*.npy)."""
    rng = np.random.default_rng(seed)
    f = np.arange(n_bins)
    base = amplitude * (1.0 / np.sqrt(1.0 + f))  # pink-ish
    return (base[None, :]
            * rng.uniform(0.5, 1.5, (n_channels, n_bins))).astype('f8')
