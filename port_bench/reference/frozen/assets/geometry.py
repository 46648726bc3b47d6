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

:func:`write_2x2` writes the four-module tree of the 2x2 configuration
with module-to-module variation: eight TPCs, two pixel layouts (the
``2.4.16`` tiles of 70 x 70 pixels at 4.434 mm and the ``2.5.16`` tiles of
80 x 80 pixels at 3.87975 mm, both 310.38 mm wide), per-module detector
values, 384 optical channels and two light LUTs.

:func:`write_ndlar` writes an ND-LAr-shaped tree: 35 modules and 70 TPCs
on one ``3.0.40``-shaped layout of 80 x 80-pixel tiles at 3.87975 mm, 50 ns
sampling, no light keys.
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
    """Pixel-layout YAML content (the keys geometry/tiles.py reads).  A
    chip of up to 7 x 7 pixels leaves 15 of its 64 channels unconnected;
    one of 8 x 8 (the v2b tiles) uses all 64."""
    if pixels_per_tile % chip_pixels:
        raise ValueError('pixels_per_tile must be a multiple of chip_pixels')
    channels = [c for c in range(64) if c not in _UNUSED_CHANNELS]
    if chip_pixels == 8:
        channels = list(range(64))
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
                base = (ix * nty + iy) * 4 + 1
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
                     light_trig_mode: int = 1, n_tpcs: int = 2) -> dict:
    """Light keys of one 2x2 module (the keys params/light.py reads).

    96 channels (module0.yaml; 2x2.yaml has 384 over 4 modules, ``n_tpcs``
    8), an equal share on each TPC in order; the beam trigger (mode 1)
    with a [0, 16] us window (2x2.yaml) and LUT smearing (2x2 production).
    The per-group thresholds are read by the threshold trigger only (mode
    0): 6 channels a group, -2000 ADC each.  Keys not written stay at the
    loader defaults.
    """
    per = n_op_channel // n_tpcs
    return dict(
        n_op_channel=n_op_channel,
        tpc_to_op_channel=[list(range(t * per, (t + 1) * per))
                           for t in range(n_tpcs)],
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


#: the 2x2 configuration's indirection of its two layouts and responses
#: (PIXEL_LAYOUT_ID, RESPONSE_ID) over the four modules
LAYOUT_ID_2X2 = (0, 0, 1, 0)
#: electron lifetime per module [us]: module 3 apart, so that a per-module
#: value of the detector YAML is seen to act
LIFETIME_2X2 = (2.2e3, 2.2e3, 2.0e3, 2.2e3)


def write_2x2(directory: str, *, tiles=(2, 4), pixels_per_tile=(70, 80),
              chip_pixels=(7, 8), pitch_mm=(4.434, 3.87975),
              drift_length: float = 30.27, time_interval=(0.0, 200.0),
              time_padding: float = 190.0, time_window: float = 189.1,
              light=True, lut_kw: dict | None = None,
              detector_overrides: dict | None = None,
              sim_overrides: dict | None = None) -> dict:
    """Write a four-module 2x2 tree into ``directory``.

    Modules 1-4 hold TPCs (0, 1) ... (6, 7) and io groups (1, 2) ...
    (7, 8), on a 2 x 2 grid of ``tpc_offsets`` 5 cm apart.  Two pixel
    layouts of equal tile width: ``pixels_per_tile``, ``chip_pixels`` and
    ``pitch_mm`` give each one's (the defaults are the published 2.4.16 and
    2.5.16 widths).  Module ``m`` takes layout ``LAYOUT_ID_2X2[m - 1]`` in
    the 2x2 configuration, so the detector YAML lists per module a
    ``response_bin_size`` of a tenth of that layout's pitch and a
    ``lifetime`` (:data:`LIFETIME_2X2`); ``detector_overrides`` adds or
    replaces keys.  ``light`` adds the light keys of 384 channels, 96 a
    module and 48 a TPC (:func:`light_properties` with ``n_tpcs`` 8; a
    dict passes its arguments), and writes two light LUTs
    (``assets.light_lut.make_light_lut`` with ``lut_kw``): the second for a
    TPC of other dimensions, so that the two tables differ (the generator's
    ``seed`` changes nothing in them).

    Returns a dict of paths: ``detector_properties``, ``pixel_layout`` (the
    two layouts), ``simulation_properties``, ``response_file`` (two absent
    files: each module's synthetic response comes from its own pitch and
    bin size) and, with light, ``light_lut_filename`` (the two LUTs).
    """
    import numpy as np
    from .light_lut import make_light_lut
    os.makedirs(directory, exist_ok=True)
    anode_z_mm = drift_length * 10.0 + 3.4
    widths = [n * p for n, p in zip(pixels_per_tile, pitch_mm)]
    if abs(widths[0] - widths[1]) > 1e-6 * widths[0]:
        raise ValueError(f'the two layouts\' tiles differ in width: {widths}')
    # a module's footprint across the drift (x) and along it (z), in cm
    span = max(tiles[0] * widths[0] / 10.0, 2 * anode_z_mm / 10.0)
    half = (span + 5.0) / 2
    light_keys = {}
    if light:
        light_keys = dict(n_op_channel=384, n_tpcs=8)
        light_keys.update(light if isinstance(light, dict) else {})
    keys = dict(
        module_to_io_groups={m: [2 * m - 1, 2 * m] for m in range(1, 5)},
        module_to_tpcs={m: [2 * m - 2, 2 * m - 1] for m in range(1, 5)},
        tpc_offsets=[[sx * half, 0.0, sz * half]
                     for sx in (1.0, -1.0) for sz in (-1.0, 1.0)],
        response_bin_size=[round(pitch_mm[i] / 100.0, 9)
                           for i in LAYOUT_ID_2X2],
        lifetime=list(LIFETIME_2X2))
    keys.update(detector_overrides or {})
    det = detector_properties(tiles, drift_length, time_interval,
                              time_padding, time_window, light_keys or False,
                              **keys)
    docs = dict(
        detector_properties=det,
        simulation_properties=simulation_properties(**(sim_overrides or {})))
    paths = {}
    for name, doc in docs.items():
        paths[name] = os.path.join(directory, f'{name}.yaml')
        with open(paths[name], 'w') as f:
            yaml.safe_dump(doc, f, default_flow_style=None)
    paths['pixel_layout'] = []
    for i in range(2):
        path = os.path.join(directory, f'pixel_layout_{i}.yaml')
        with open(path, 'w') as f:
            yaml.safe_dump(pixel_layout(tiles, pixels_per_tile[i],
                                        chip_pixels[i], pitch_mm[i],
                                        anode_z_mm), f,
                           default_flow_style=None)
        paths['pixel_layout'].append(path)
    paths['response_file'] = [os.path.join(directory, f'__missing_{c}__.npy')
                              for c in 'ab']
    if light:
        paths['light_lut_filename'] = []
        kw = dict(n_det_tpc=48, **(lut_kw or {}))
        for i, size in enumerate(((30.0, 60.0, 30.0), (31.0, 62.0, 31.0))):
            path = os.path.join(directory, f'light_lut_{i}.npz')
            np.savez(path, arr=make_light_lut(tpc_size=size, seed=i, **kw))
            paths['light_lut_filename'].append(path)
    return paths


#: the generated ND-LAr tree's widths (:func:`write_ndlar`): tiles on an
#: anode, pixels a tile and a chip, pitch [mm], drift [cm], readout window,
#: padding and induction window [us], sampling [us], and the module grid
#: of the YAML's ``tpc_offsets`` (its first and third coordinates)
NDLAR = dict(tiles=(2, 10), pixels_per_tile=80, chip_pixels=8,
             pitch_mm=3.87975, drift_length=50.0, time_interval=(0.0, 320.0),
             time_padding=190.0, time_window=189.1, sampling=0.05,
             grid=(5, 7))


def write_ndlar(directory: str, *, detector_overrides: dict | None = None,
                sim_overrides: dict | None = None) -> dict:
    """Write an ND-LAr-shaped tree into ``directory``: the three YAMLs of
    the ``ndlar`` configuration (``ndlar-module.yaml``,
    ``multi_tile_layout-3.0.40.yaml``, ``NDLAr_LBNF_sim.yaml``), made
    from :func:`pixel_layout`, :func:`detector_properties` and
    :func:`simulation_properties`.

    From the repository's records: 35 modules of two TPCs sharing a
    cathode, 70 TPCs; 40 tiles a module (20 an anode: the layout name's
    last field, as the 16 of ``2.4.16`` counts 2 x (2 x 4) tiles); tiles
    of 80 x 80 pixels at 3.87975 mm (``response_38``'s pitch; 8 x 8-pixel
    chips, all 64 channels), so 128,000 pixels an anode and 8,960,000
    pixel ids; ``time_sampling`` = ``response_sampling`` = 0.05 us and a
    ``response_bin_size`` of a tenth of the pitch; no light keys, so the
    loader turns light off; ``batch_size`` 2500 and ``event_batch_size``
    2 in the simulation properties.

    Assumed, the real files not being in the repository (:data:`NDLAR`):
    the tiles 2 x 10 on an anode (62.076 cm across, 310.38 cm high); a 5 x
    7 module grid at a pitch of the modules' larger footprint plus 5 cm; a drift length of 50 cm; a ``time_interval`` of
    [0, 320] us (the ``ndlar-module.yaml`` value the survey cites), which
    the loader turns into 6401 ticks at 50 ns (the 3200 ticks of the JAX
    guard are 320 us at 0.1 us); ``time_padding`` 190 us and
    ``time_window`` 189.1 us, Module-0's, so that a signal window spans
    4096 ticks and the response 3782.

    ``detector_overrides`` and ``sim_overrides`` add or replace keys of
    the detector and simulation properties.  Returns a dict of paths:
    ``detector_properties``, ``pixel_layout``, ``simulation_properties``.
    """
    os.makedirs(directory, exist_ok=True)
    g = NDLAR
    anode_z_mm = g['drift_length'] * 10.0 + 3.4
    n_x, n_z = g['grid']
    n_mod = n_x * n_z
    # a module's footprint across the drift (x) and along it (z), in cm
    pitch = max(g['tiles'][0] * g['pixels_per_tile'] * g['pitch_mm'] / 10.0,
                2 * anode_z_mm / 10.0) + 5.0
    keys = dict(
        module_to_io_groups={m: [2 * m - 1, 2 * m]
                             for m in range(1, n_mod + 1)},
        module_to_tpcs={m: [2 * m - 2, 2 * m - 1]
                        for m in range(1, n_mod + 1)},
        tpc_offsets=[[(ix - (n_x - 1) / 2) * pitch, 0.0,
                      (iz - (n_z - 1) / 2) * pitch]
                     for ix in range(n_x) for iz in range(n_z)],
        time_sampling=g['sampling'], response_sampling=g['sampling'],
        response_bin_size=round(g['pitch_mm'] / 100.0, 9))
    keys.update(detector_overrides or {})
    sim = dict(batch_size=2500, event_batch_size=2)
    sim.update(sim_overrides or {})
    docs = {
        'ndlar-module': detector_properties(
            g['tiles'], g['drift_length'], g['time_interval'],
            g['time_padding'], g['time_window'], False, **keys),
        'multi_tile_layout-3.0.40': pixel_layout(
            g['tiles'], g['pixels_per_tile'], g['chip_pixels'],
            g['pitch_mm'], anode_z_mm),
        'NDLAr_LBNF_sim': simulation_properties(**sim),
    }
    paths = {}
    for (key, doc), name in zip(docs.items(), (
            'detector_properties', 'pixel_layout', 'simulation_properties')):
        paths[name] = os.path.join(directory, f'{key}.yaml')
        with open(paths[name], 'w') as f:
            yaml.safe_dump(doc, f, default_flow_style=None)
    return paths
