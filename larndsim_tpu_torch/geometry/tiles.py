"""Pixel-tile layout parsing and TPC geometry derivation.

A copy of ``larndsim_tpu.geometry.tiles``, so that the port runs without
the JAX package (tests/test_torch_host.py holds it against the original).
It consumes the same pixel-layout and detector-properties YAML files as
the reference simulator and derives the identical geometry quantities
(reference semantics: larnd-sim consts/detector.py:198-379), as immutable
numpy products and dense index tensors in place of per-pixel dict lookups
(cf. fee.py:227-260 in the reference).

All lengths are in cm, times in microseconds.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np
import yaml

from .. import units
from ..utils import trace

try:
    _YamlLoader = yaml.CSafeLoader
except AttributeError:  # libyaml not available
    _YamlLoader = yaml.SafeLoader


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """Host-side geometry derived from one pixel-layout YAML.

    Attributes mirror the quantities derived by the reference loader
    (consts/detector.py:303-356) plus dense readout-mapping tensors.
    """

    pixel_pitch: float                    # cm
    n_pixels: tuple[int, int]             # full-anode pixel grid (x, y)
    n_pixels_per_tile: tuple[int, int]
    tile_borders: np.ndarray              # (2, 2) cm, centered on tile
    tile_map: tuple                       # [anode][tile_x][tile_y] -> tile id
    tile_positions: dict[int, list]       # mm, as in the YAML
    tile_orientations: dict[int, list]
    tile_indeces: dict[int, list]
    tile_chip_to_io: dict[int, dict[int, int]]
    # Dense readout maps indexed [tile_id, x_in_tile, y_in_tile]:
    chip_id_map: np.ndarray               # int32, -1 where unmapped
    channel_id_map: np.ndarray            # int32, -1 where unmapped
    io_group_map: np.ndarray              # int32 (pre module remap), -1 invalid
    io_channel_map: np.ndarray            # int32, -1 invalid


def _rotate_in_tile(pix_x: np.ndarray, pix_y: np.ndarray, orientation,
                    n_pixels_per_tile) -> tuple[np.ndarray, np.ndarray]:
    """Apply a tile orientation to in-tile pixel indices.

    Matches reference `fee.rotate_tile` (fee.py:40-63): orientation[2] flips
    x, orientation[1] flips y.
    """
    x_axis, y_axis = orientation[2], orientation[1]
    rx = np.where(x_axis < 0, n_pixels_per_tile[0] - pix_x - 1, pix_x)
    ry = np.where(y_axis < 0, n_pixels_per_tile[1] - pix_y - 1, pix_y)
    return rx, ry


# The grammar PyYAML's ``safe_dump`` writes a pixel layout in: the six
# top-level keys, each a block mapping of integer keys (``pixel_pitch`` a
# number), whose values are flow collections (``[0, 69]``, ``{11: 1001,
# ...}``, wrapped onto lines of four spaces) or block ones (``- 0`` lines,
# ``11: 1001`` lines).  A token is taken only where ``int()`` or
# ``float()`` of it is what PyYAML's SafeLoader makes of it: no octal,
# sign, underscore, exponent without a dot, or integer past int64.
_INT = rb'-?(?:0|[1-9][0-9]{0,17})'
_NUM = rb'(?:-?[0-9]+\.[0-9]+(?:[eE][-+][0-9]+)?|' + _INT + rb')'
_SEP = rb',(?: |\n    )'


def _block_mapping(value: bytes) -> re.Pattern:
    return re.compile(rb'(?:  ' + _INT + rb':' + value + rb')+')


_LISTS = _block_mapping(
    rb'(?: \[' + _NUM + rb'(?:' + _SEP + _NUM + rb')*\]\n'
    rb'|\n(?:  - ' + _NUM + rb'\n)+)')
_PAIR = _INT + rb': ' + _INT
_SECTIONS = {
    b'chip_channel_to_position': _block_mapping(
        rb'(?: \[' + _INT + rb', ' + _INT + rb'\]\n'
        rb'|\n  - ' + _INT + rb'\n  - ' + _INT + rb'\n)'),
    b'tile_chip_to_io': _block_mapping(
        rb'(?: \{' + _PAIR + rb'(?:' + _SEP + _PAIR + rb')*\}\n| \{\}\n'
        rb'|\n(?:    ' + _PAIR + rb'\n)+)'),
    b'tile_indeces': _LISTS,
    b'tile_orientations': _LISTS,
    b'tile_positions': _LISTS,
}
_PITCH = re.compile(rb' (' + _NUM + rb')\n')
_TOP = re.compile(rb'^(?=\S)', re.M)
_KEY = re.compile(rb'^  (' + _INT + rb'):', re.M)
_TOKEN = re.compile(rb'-?[0-9]+(?:\.[0-9]+(?:[eE][-+][0-9]+)?)?')
#: every byte but those of an integer read as a space (``fromstring``)
_INT_BYTES = bytes(c if c in b'0123456789-' else 32 for c in range(256))


def _int_keyed(body: bytes, value) -> dict | None:
    """A block mapping's entries, each value ``value`` of its tokens;
    None where a key repeats or a value is None."""
    parts = _KEY.split(body)
    out = {int(k): value(_TOKEN.findall(v))
           for k, v in zip(parts[1::2], parts[2::2])}
    if 2 * len(out) != len(parts) - 1 or None in out.values():
        return None
    return out


def _pairs(tokens: list) -> dict | None:
    out = dict(zip(map(int, tokens[::2]), map(int, tokens[1::2])))
    return out if 2 * len(out) == len(tokens) else None


def _numbers(tokens: list) -> list:
    return [float(t) if b'.' in t else int(t) for t in tokens]


def _fast_fields(raw: bytes) -> dict | None:
    """The layout's fields read from its text by the grammar above, or
    None where the text leaves it (a repeated key included), so that
    PyYAML reads the file instead."""
    parts = _TOP.split(raw)
    if parts[0] or len(parts) != 2 + len(_SECTIONS):
        return None
    bodies = {}
    for part in parts[1:]:
        name, _, body = part.partition(b':')
        if name in bodies:
            return None
        if name == b'pixel_pitch':
            match = _PITCH.fullmatch(body)
            if match is None:
                return None
            bodies[name] = match[1]
        elif (name in _SECTIONS and body[:1] == b'\n'
              and _SECTIONS[name].fullmatch(body, 1)):
            bodies[name] = body[1:]
        else:
            return None
    table = np.fromstring(
        bodies[b'chip_channel_to_position'].replace(b'- ', b'  ')
        .translate(_INT_BYTES).decode('ascii'),
        dtype=np.int64, sep=' ').reshape(-1, 3)
    fields = dict(pixel_pitch=_numbers([bodies[b'pixel_pitch']])[0],
                  keys=table[:, 0], positions=table[:, 1:],
                  tile_chip_to_io=_int_keyed(bodies[b'tile_chip_to_io'],
                                             _pairs))
    for name in ('tile_indeces', 'tile_orientations', 'tile_positions'):
        fields[name] = _int_keyed(bodies[name.encode()], _numbers)
    if (np.unique(fields['keys']).size != fields['keys'].size
            or any(v is None for v in fields.values())):
        return None
    return fields


def _yaml_fields(tile_layout: dict) -> dict:
    """The same fields from the document PyYAML made of the file, taken
    in the order the loader always took them."""
    pixel_pitch = tile_layout['pixel_pitch']
    chip_channel_to_position = tile_layout['chip_channel_to_position']
    return dict(
        pixel_pitch=pixel_pitch,
        tile_chip_to_io=tile_layout['tile_chip_to_io'],
        positions=np.array(list(chip_channel_to_position.values())),
        tile_indeces=tile_layout['tile_indeces'],
        tile_orientations=tile_layout['tile_orientations'],
        tile_positions=tile_layout['tile_positions'],
        keys=np.fromiter(chip_channel_to_position.keys(), dtype=np.int64))


def load_tile_layout(pixel_file: str, tile_map) -> TileLayout:
    """Parse a pixel-layout YAML into a :class:`TileLayout`.

    A file in the grammar PyYAML writes layouts in is read straight into
    arrays (tallied ``layout_parse/fast``); any other goes through
    PyYAML (``layout_parse/yaml``).  Both give the same layout.

    Args:
        pixel_file: pixel-layout YAML path.
        tile_map: [anode][tile_x][tile_y] -> tile id nested lists; this lives
            in the *detector properties* YAML (consts/detector.py:347).
    """
    with open(pixel_file, 'rb') as pf:
        fields = _fast_fields(pf.read())
    if fields is not None:
        trace.tally('layout_parse/fast')
    else:
        trace.tally('layout_parse/yaml')
        with open(pixel_file) as pf:
            fields = _yaml_fields(yaml.load(pf, Loader=_YamlLoader))
    return _build_layout(tile_map, **fields)


def _build_layout(tile_map, *, pixel_pitch, tile_chip_to_io, positions,
                  tile_indeces, tile_orientations, tile_positions,
                  keys) -> TileLayout:
    """The :class:`TileLayout` of a layout's fields: ``keys`` the
    ``chip_channel_to_position`` keys and ``positions`` their values, in
    the file's order; the rest as the YAML has them."""
    pixel_pitch = pixel_pitch * units.mm / units.cm
    xs = positions[:, 0] * pixel_pitch
    ys = positions[:, 1] * pixel_pitch
    tile_borders = np.zeros((2, 2))
    tile_borders[0] = [-(xs.max() + pixel_pitch) / 2, (xs.max() + pixel_pitch) / 2]
    tile_borders[1] = [-(ys.max() + pixel_pitch) / 2, (ys.max() + pixel_pitch) / 2]

    ntiles_x = len(tile_map[0])
    ntiles_y = len(tile_map[0][0])
    nppt = (len(np.unique(positions[:, 0])), len(np.unique(positions[:, 1])))
    n_pixels = (nppt[0] * ntiles_x, nppt[1] * ntiles_y)

    # Dense (chip, channel) map per in-tile pixel position.  The YAML keys are
    # chip*1000 + channel -> [x, y] (consts/detector.py:307-308).
    max_tile = max(int(t) for t in tile_indeces.keys())
    chip_id_map = np.full((max_tile + 1, nppt[0], nppt[1]), -1, np.int32)
    channel_id_map = np.full_like(chip_id_map, -1)
    io_group_map = np.full_like(chip_id_map, -1)
    io_channel_map = np.full_like(chip_id_map, -1)

    chips = (keys // 1000).astype(np.int32)
    channels = (keys % 1000).astype(np.int32)
    pos_x = positions[:, 0].astype(np.int64)
    pos_y = positions[:, 1].astype(np.int64)

    for tile_id in tile_indeces:
        tid = int(tile_id)
        orientation = tile_orientations[tile_id]
        # A physical pixel (px, py) in the tile reads out through the chip
        # located at the *rotated* coordinate (fee.py:230-232), so fill the
        # map at the inverse image of each connection entry.  The rotation is
        # an involution (pure flips), hence self-inverse.
        rx, ry = _rotate_in_tile(pos_x, pos_y, orientation, nppt)
        chip_id_map[tid, rx, ry] = chips
        channel_id_map[tid, rx, ry] = channels
        chip_io = tile_chip_to_io.get(tile_id, {})
        io_vals = np.full(chips.max() + 1, -1, np.int64)
        for chip, io in chip_io.items():
            io_vals[int(chip)] = int(io)
        packed = io_vals[chip_id_map[tid]]
        valid = (chip_id_map[tid] >= 0) & (packed >= 0)
        io_group_map[tid] = np.where(valid, packed // 1000, -1)
        io_channel_map[tid] = np.where(valid, packed % 1000, -1)

    return TileLayout(
        pixel_pitch=float(pixel_pitch),
        n_pixels=n_pixels,
        n_pixels_per_tile=nppt,
        tile_borders=tile_borders,
        tile_map=tile_map,
        tile_positions=tile_positions,
        tile_orientations=tile_orientations,
        tile_indeces=tile_indeces,
        tile_chip_to_io=tile_chip_to_io,
        chip_id_map=chip_id_map,
        channel_id_map=channel_id_map,
        io_group_map=io_group_map,
        io_channel_map=io_channel_map,
    )


def derive_tpc_borders(detprop: dict[str, Any], layout: TileLayout) -> np.ndarray:
    """Compute TPC bounding boxes `(n_tpc, 3, 2)` in cm.

    Reproduces the reference derivation (consts/detector.py:319-345): tiles
    are grouped per anode by their TPC index; the drift direction is +1 for
    anode index 1 and -1 otherwise; tpc_offsets from the detector-properties
    YAML have their x and z axes swapped.
    """
    drift_length = detprop['drift_length']
    tpc_offsets = np.array(detprop['tpc_offsets'], dtype=np.float64)
    tpc_offsets[:, [2, 0]] = tpc_offsets[:, [0, 2]]

    tile_indeces = layout.tile_indeces
    tpc_ids = np.unique(np.array(list(tile_indeces.values()))[:, 0], axis=0)

    anodes: dict[int, list] = {}
    for tpc_id in tpc_ids:
        anodes[tpc_id] = [layout.tile_positions[tile]
                          for tile in tile_indeces
                          if tile_indeces[tile][0] == tpc_id]

    borders = np.empty((tpc_offsets.shape[0] * tpc_ids.shape[0], 3, 2))
    for it, offset in enumerate(tpc_offsets):
        for ia, anode in enumerate(anodes):
            tiles = np.vstack(anodes[anode]) * units.mm / units.cm
            drift_direction = 1 if anode == 1 else -1
            x_border = (tiles[:, 2].min() + layout.tile_borders[0][0] + offset[0],
                        tiles[:, 2].max() + layout.tile_borders[0][1] + offset[0])
            y_border = (tiles[:, 1].min() + layout.tile_borders[1][0] + offset[1],
                        tiles[:, 1].max() + layout.tile_borders[1][1] + offset[1])
            z_border = (tiles[:, 0].min() + offset[2],
                        tiles[:, 0].max() + drift_length * drift_direction + offset[2])
            borders[it * 2 + ia] = (x_border, y_border, z_border)
    return borders


def electron_mobility(efield: float, temperature: float) -> float:
    """BNL electron-mobility parameterization, cm^2/kV/us.

    References: https://lar.bnl.gov/properties/trans.html;
    DOI:10.1016/j.nima.2016.01.073.  Same parameterization as the reference
    (consts/detector.py:137-161).
    """
    a0, a1, a2, a3, a4, a5 = 551.6, 7158.3, 4440.43, 4.29, 43.63, 0.2053
    num = a0 + a1 * efield + a2 * efield ** 1.5 + a3 * efield ** 2.5
    denom = 1 + (a1 / a0) * efield + a4 * efield ** 2 + a5 * efield ** 3
    temp_corr = (temperature / 89.0) ** -1.5
    return num / denom * temp_corr * units.V / units.kV
