"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages load the same generated Module-0-shaped detector description
(``larndsim_tpu_torch.assets.geometry``).  The JAX ``DetectorParams`` reaches
the port through ``from_numpy``; segment batches cross as numpy arrays.
Inputs are made from seeds with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from larndsim_tpu_torch.assets.geometry import write_2x2, write_module0
from larndsim_tpu_torch.assets.make_input import make_tracks
from larndsim_tpu_torch.io.edep import swap_coordinates

# the tests run in several worker processes at once
torch.set_num_threads(1)

#: one 14 x 14-pixel tile per anode, 3 cm drift, 30 us readout window
SMALL = dict(tiles=(1, 1), pixels_per_tile=14, drift_length=3.0,
             time_interval=(0.0, 30.0), time_padding=10.0, time_window=8.9)

#: detector keys that make a run deterministic: no diffusion, no noise
QUIET = dict(long_diff=0.0, tran_diff=0.0, reset_noise_charge=0.0,
             uncorrelated_noise_charge=0.0, discriminator_noise=0.0)


#: the small four-module tree: 1 x 1 tiles of 14 x 14 pixels at 4.434 mm
#: (modules 1, 2, 4) and of 16 x 16 pixels at 3.87975 mm (module 3), both
#: 62.076 mm wide; small light LUTs
SMALL_2X2 = dict(tiles=(1, 1), pixels_per_tile=(14, 16), chip_pixels=(7, 8),
                 drift_length=3.0, time_interval=(0.0, 30.0),
                 time_padding=10.0, time_window=8.9,
                 lut_kw=dict(vox_div=(4, 6, 4)))


def write_tree_2x2(directory, **overrides) -> dict:
    """Write the small four-module tree (``assets.geometry.write_2x2``)
    into ``directory``; returns its paths by name."""
    kw = dict(SMALL_2X2)
    kw.update(overrides)
    return write_2x2(str(directory), **kw)


def write_spills_2x2(path, tpc_borders, n_events: int = 2, seed: int = 7,
                     tracks_per_event: int = 8) -> int:
    """An input with tracks in every TPC of every spill (so that the
    modules trigger alike), their times moved into the first 1.5 us of the
    spill (inside a beam trigger's digitized window); returns the segment
    count."""
    from larndsim_tpu_torch.assets.make_input import make_tracks
    from larndsim_tpu_torch.io.h5 import File
    seg, traj, vert = make_tracks(
        tpc_borders, n_events=n_events, tracks_per_event=tracks_per_event,
        segments_per_track=6, segment_length=0.4, dEdx=8.0, seed=seed,
        every_tpc=True)
    spill = seg['event_id'].astype(np.float64) * 1.2e6
    for name in ('t0_start', 't0_end', 't0'):
        seg[name] = spill + (seg[name] - spill) * 0.15
    with File(path, 'w') as f:
        f.create_dataset('segments', data=seg)
        f.create_dataset('trajectories', data=traj)
        f.create_dataset('vertices', data=vert)
    return len(seg)


def write_tree(directory, **overrides) -> dict:
    """Write the small tree's three YAMLs into ``directory``; returns
    their paths by name."""
    kw = dict(SMALL)
    kw.update(overrides)
    return write_module0(str(directory), **kw)


def load_jax(paths):
    from larndsim_tpu.params import load_detector
    return load_detector(paths['detector_properties'], paths['pixel_layout'])


def load_port(paths, device='cpu'):
    from larndsim_tpu_torch.params import load_detector
    return load_detector(paths['detector_properties'], paths['pixel_layout'],
                         device=device)


def port_params(det_jax, device='cpu'):
    """The port's DetectorParams carried over from a JAX DetectorParams."""
    from larndsim_tpu_torch.params.detector import LEAVES, STATICS, from_numpy
    return from_numpy({k: np.asarray(getattr(det_jax, k)) for k in LEAVES},
                      {k: getattr(det_jax, k) for k in STATICS}, device)


def port_light(light_jax, device='cpu'):
    """The port's LightParams carried over from a JAX LightParams."""
    from larndsim_tpu_torch.params.light import LEAVES, STATICS, from_numpy
    return from_numpy({k: np.asarray(getattr(light_jax, k)) for k in LEAVES},
                      {k: getattr(light_jax, k) for k in STATICS}, device)


def load_port_sim(paths):
    from larndsim_tpu_torch.params import load_sim
    return load_sim(paths['simulation_properties'])


def port_segments(segs_jax, device='cpu'):
    """The port's Segments with the JAX batch's values, field by field."""
    import dataclasses
    from larndsim_tpu_torch.segments import Segments
    return Segments(**{f.name: torch.from_numpy(
        np.array(getattr(segs_jax, f.name))).to(device)
        for f in dataclasses.fields(Segments)})


def detector_tracks(tpc_borders, seed: int = 3, **kw) -> np.ndarray:
    """Straight segmented tracks inside the TPCs, in detector coordinates
    (z is the drift axis)."""
    kw.setdefault('n_events', 1)
    kw.setdefault('tracks_per_event', 3)
    kw.setdefault('segments_per_track', 6)
    kw.setdefault('segment_length', 0.4)
    kw.setdefault('dEdx', 8.0)
    segments, _, _ = make_tracks(tpc_borders, seed=seed, **kw)
    return swap_coordinates(segments)


def assert_same_leaves(a, b, names):
    """Each named field of ``a`` (JAX) equals that of ``b`` (port)."""
    for name in names:
        np.testing.assert_array_equal(np.asarray(getattr(b, name)),
                                      np.asarray(getattr(a, name)),
                                      err_msg=name)
