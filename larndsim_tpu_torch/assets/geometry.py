"""Generator of a Module-0-shaped detector description.

Writes the three YAMLs the simulation reads (detector properties, pixel
layout, simulation properties) into a directory.  The defaults have the
published Module-0 widths: two TPCs sharing one module, each anode tiled
2 x 4 with LArPix tiles of 70 x 70 pixels at 4.434 mm pitch (100 chips of
7 x 7 pixels, 49 of 64 channels used), 30.27 cm drift, 200 us readout
window with 190 us time padding and a 189.1 us induction window.  The
readout mapping (chip ids, channels, io channels) is synthetic but
complete: every pixel maps to one (io_group, io_channel, chip, channel).
Smaller arguments give the small trees the CPU tests use.

Asked for (``light=``), the detector properties also carry the light keys
of one DUNE 2x2 module (:func:`light_properties`): 96 optical channels, 48
per TPC, the beam trigger and a 16 us window with LUT smearing.
"""
from __future__ import annotations

import os

import yaml

#: LArPix-v2 channels left unconnected on a tile (15 of 64), so that 49
#: remain for a 7 x 7 chip block
_UNUSED_CHANNELS = (6, 7, 8, 9, 22, 23, 24, 25, 38, 39, 40, 54, 55, 56, 57)


def pixel_layout(tiles=(2, 4), pixels_per_tile: int = 70,
                 chip_pixels: int = 7, pitch_mm: float = 4.434,
                 anode_z_mm: float = 304.31) -> dict:
    """Pixel-layout YAML content (the keys geometry/tiles.py reads)."""
    if pixels_per_tile % chip_pixels:
        raise ValueError('pixels_per_tile must be a multiple of chip_pixels')
    channels = [c for c in range(64) if c not in _UNUSED_CHANNELS]
    if chip_pixels ** 2 > len(channels):
        raise ValueError(f'a chip has at most {len(channels)} channels')
    n_chip = pixels_per_tile // chip_pixels
    chip_channel_to_position = {}
    for cx in range(n_chip):
        for cy in range(n_chip):
            chip = 11 + cx * n_chip + cy
            for k in range(chip_pixels ** 2):
                x = cx * chip_pixels + k // chip_pixels
                y = cy * chip_pixels + k % chip_pixels
                chip_channel_to_position[chip * 1000 + channels[k]] = [x, y]

    ntx, nty = tiles
    tile_w = pixels_per_tile * pitch_mm
    tile_indeces, tile_positions, tile_orientations = {}, {}, {}
    tile_chip_to_io = {}
    for tpc in range(2):
        # tpc 1 drifts toward +z from its anode, tpc 0 toward -z
        z = -anode_z_mm if tpc == 1 else anode_z_mm
        for ix in range(ntx):
            for iy in range(nty):
                tile = 1 + tpc * ntx * nty + ix * nty + iy
                tile_indeces[tile] = [tpc, ix, iy]
                tile_positions[tile] = [z, (iy - (nty - 1) / 2) * tile_w,
                                        (ix - (ntx - 1) / 2) * tile_w]
                tile_orientations[tile] = [0, 1, 1]
                # one io_group per anode, four io channels per tile
                io_group = tpc + 1
                base = ((ix * nty + iy) * 4) % 32 + 1
                tile_chip_to_io[tile] = {
                    11 + c: io_group * 1000 + base + (c * 4) // n_chip ** 2
                    for c in range(n_chip ** 2)}
    return dict(pixel_pitch=pitch_mm,
                chip_channel_to_position=chip_channel_to_position,
                tile_chip_to_io=tile_chip_to_io,
                tile_indeces=tile_indeces,
                tile_orientations=tile_orientations,
                tile_positions=tile_positions)


def light_properties(n_op_channel: int = 96, light_window=(0.0, 16.0),
                     enable_lut_smearing: bool = True,
                     light_trig_mode: int = 1) -> dict:
    """Light keys of one 2x2 module (the keys params/light.py reads).

    96 channels (module0.yaml; 2x2.yaml has 384 over 4 modules), the
    first half on TPC 0 and the second on TPC 1; the beam trigger (mode 1)
    with a [0, 16] us window (2x2.yaml) and LUT smearing (2x2 production).
    The per-group thresholds are read by the threshold trigger only (mode
    0): 6 channels a group, -2000 ADC each.  Keys not written stay at the
    loader defaults.
    """
    half = n_op_channel // 2
    return dict(
        n_op_channel=n_op_channel,
        tpc_to_op_channel=[list(range(half)),
                           list(range(half, n_op_channel))],
        light_trig_mode=light_trig_mode,
        light_window=[float(light_window[0]), float(light_window[1])],
        enable_lut_smearing=bool(enable_lut_smearing),
        op_channel_per_det=6,
        light_trig_threshold=[-2000.0] * (n_op_channel // 6),
    )


def detector_properties(tiles=(2, 4), drift_length: float = 30.27,
                        time_interval=(0.0, 200.0),
                        time_padding: float = 190.0,
                        time_window: float = 189.1, light=False,
                        **overrides) -> dict:
    """Detector-properties YAML content (the keys params/detector.py
    reads); keys not given stay at the loader defaults.  ``light`` True
    adds the light keys of :func:`light_properties`, a dict adds them with
    those arguments; ``overrides`` adds or replaces keys (e.g.
    ``long_diff=0``)."""
    ntx, nty = tiles
    tile_map = [[[1 + tpc * ntx * nty + ix * nty + iy for iy in range(nty)]
                 for ix in range(ntx)] for tpc in range(2)]
    props = dict(
        module_to_io_groups={1: [1, 2]},
        module_to_tpcs={1: [0, 1]},
        tile_map=tile_map,
        tpc_offsets=[[0.0, 0.0, 0.0]],
        drift_length=float(drift_length),
        time_interval=[float(time_interval[0]), float(time_interval[1])],
        time_padding=float(time_padding),
        time_window=float(time_window),
    )
    if light:
        props.update(light_properties(**(light if isinstance(light, dict)
                                         else {})))
    props.update(overrides)
    return props


def simulation_properties(**overrides) -> dict:
    """Simulation-properties YAML content: the SimParams defaults
    (spill mode), with ``overrides`` (keys of params/sim.load_sim)."""
    props = dict(is_spill_sim=True, max_adc_values=30,
                 max_tracks_per_pixel=50)
    props.update(overrides)
    return props


def write_module0(directory: str, *, tiles=(2, 4), pixels_per_tile: int = 70,
                  chip_pixels: int = 7, pitch_mm: float = 4.434,
                  drift_length: float = 30.27, time_interval=(0.0, 200.0),
                  time_padding: float = 190.0, time_window: float = 189.1,
                  light=False, detector_overrides: dict | None = None,
                  sim_overrides: dict | None = None) -> dict:
    """Write the three YAMLs into ``directory``; ``light`` as for
    :func:`detector_properties` (off by default).

    Returns a dict of paths: ``detector_properties``, ``pixel_layout``,
    ``simulation_properties``.
    """
    os.makedirs(directory, exist_ok=True)
    # each TPC's cathode plane 3.4 mm off the module centre
    anode_z_mm = drift_length * 10.0 + 3.4
    docs = dict(
        detector_properties=detector_properties(
            tiles, drift_length, time_interval, time_padding, time_window,
            light, **(detector_overrides or {})),
        pixel_layout=pixel_layout(tiles, pixels_per_tile, chip_pixels,
                                  pitch_mm, anode_z_mm),
        simulation_properties=simulation_properties(**(sim_overrides or {})),
    )
    paths = {}
    for name, doc in docs.items():
        path = os.path.join(directory, f'{name}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(doc, f, default_flow_style=None)
        paths[name] = path
    return paths
