"""The port's pixel-layout reader (``geometry.tiles.load_tile_layout``).

A layout in the grammar PyYAML writes layouts in is read straight into
arrays; any other file goes through PyYAML.  Both are held to the JAX
package's loader, which parses every file with PyYAML: every
``TileLayout`` field equal (arrays exactly and with their dtype, the
``tile_*`` dicts with the types of their keys and values), the TPC borders
equal, and the trace's tally names the path each read took.

Identity: every layout the port's writers make (the small tree, Module-0,
the 2x2's two, ND-LAr's), as written (flow leaves) and re-dumped with
``default_flow_style=False`` (block leaves).  Fallback: one valid layout
with one edit per case outside the grammar; the outcome, a layout or the
error raised, equals the JAX loader's.
"""
from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
import yaml

from larndsim_tpu.geometry import tiles as jtiles
from larndsim_tpu_torch.assets import geometry as writers
from larndsim_tpu_torch.geometry import tiles
from larndsim_tpu_torch.utils import trace

import torch_port_assets as tpa


def _layouts(kind, directory):
    """(detector properties, pixel layout) of one writer's tree."""
    if kind == 'small':
        paths = tpa.write_tree(directory)
    elif kind == 'module0':
        paths = writers.write_module0(str(directory))
    elif kind == 'ndlar':
        paths = writers.write_ndlar(str(directory))
    else:
        paths = writers.write_2x2(str(directory), light=False)
        paths['pixel_layout'] = paths['pixel_layout'][int(kind[-1])]
    return paths['detector_properties'], paths['pixel_layout']


def _typed(value):
    """``value`` with the type of every key and leaf beside it."""
    if isinstance(value, dict):
        return [(_typed(k), _typed(v)) for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        return (type(value).__name__, [_typed(v) for v in value])
    return type(value).__name__, value


def _assert_same_layout(got, want):
    for f in dataclasses.fields(tiles.TileLayout):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert _typed(a) == _typed(b), f.name


def _outcome(fn, *args):
    """('value', what ``fn`` returns) or ('error', its type and message)."""
    try:
        return 'value', fn(*args)
    except Exception as e:  # the error itself is the outcome compared
        return 'error', (type(e), str(e))


def _read(path, tile_map):
    """The port's outcome of reading ``path`` and the tallies it left."""
    trace.reset()
    got = _outcome(tiles.load_tile_layout, path, tile_map)
    return got, trace.tallies()


@pytest.mark.parametrize('style', ['flow', 'block'])
@pytest.mark.parametrize('kind', ['small', 'module0', '2x2_0', '2x2_1',
                                  'ndlar'])
def test_fast_read_equals_pyyaml(tmp_path, kind, style):
    det_file, pixel_file = _layouts(kind, tmp_path / 'tree')
    with open(det_file) as f:
        detprop = yaml.safe_load(f)
    if style == 'block':
        with open(pixel_file) as f:
            doc = yaml.safe_load(f)
        pixel_file = str(tmp_path / 'block.yaml')
        with open(pixel_file, 'w') as f:
            yaml.safe_dump(doc, f, default_flow_style=False)
        with open(pixel_file) as f:
            assert re.search(r'^  - ', f.read(), re.M)
    tile_map = detprop['tile_map']
    (kind_got, got), tallies = _read(pixel_file, tile_map)
    assert kind_got == 'value', got
    assert tallies == {'layout_parse/fast': 1}
    want = jtiles.load_tile_layout(pixel_file, tile_map)
    _assert_same_layout(got, want)
    np.testing.assert_array_equal(tiles.derive_tpc_borders(detprop, got),
                                  jtiles.derive_tpc_borders(detprop, want))


def _first(pattern, repl):
    """An edit of the first match of ``pattern`` (multiline)."""
    return lambda text: re.sub(pattern, repl, text, count=1, flags=re.M)


EDITS = {
    'comment_line': lambda text: '# a layout\n' + text,
    'quoted_key': _first(r'^  (\d+): \[', r"  '\1': ["),
    'octal': _first(r'^(tile_positions:\n  \d+: \[)[^,]*', r'\g<1>010'),
    'plus_sign': _first(r'^(tile_positions:\n  \d+: \[)[^,]*', r'\g<1>+5'),
    'underscore': _first(r'^(tile_positions:\n  \d+: \[)[^,]*',
                         r'\g<1>1_000'),
    'exponent_without_dot': _first(r'^(tile_positions:\n  \d+: \[)[^,]*',
                                   r'\g<1>1e5'),
    'anchor_alias': _first(r'^(tile_orientations:\n  (\d+): )(\[.*\])\n'
                           r'  (\d+): .*',
                           r'\1&o \3\n  \4: *o'),
    'crlf': lambda text: text.replace('\n', '\r\n'),
    'duplicate_position_key': _first(
        r'^(chip_channel_to_position:\n  (\d+): .*\n)  \d+:', r'\1  \2:'),
    'duplicate_top_level_key': lambda text: text + 'pixel_pitch: 5.0\n',
    'unknown_top_level_key': lambda text: text + 'tile_kind: 1\n',
    'tab_indent': _first(r'^  (\d+): \[', r'\t\1: ['),
}


@pytest.mark.parametrize('edit', sorted(EDITS))
def test_text_outside_the_grammar_goes_through_pyyaml(tmp_path, edit):
    det_file, pixel_file = _layouts('small', tmp_path / 'tree')
    with open(det_file) as f:
        detprop = yaml.safe_load(f)
    with open(pixel_file, newline='') as f:
        text = f.read()
    edited = EDITS[edit](text)
    assert edited != text
    path = str(tmp_path / 'edited.yaml')
    with open(path, 'w', newline='') as f:
        f.write(edited)
    tile_map = detprop['tile_map']
    got, tallies = _read(path, tile_map)
    assert tallies == {'layout_parse/yaml': 1}
    want = _outcome(jtiles.load_tile_layout, path, tile_map)
    assert got[0] == want[0], (got, want)
    if want[0] == 'error':
        assert got[1] == want[1]
        return
    _assert_same_layout(got[1], want[1])
    got_b = _outcome(tiles.derive_tpc_borders, detprop, got[1])
    want_b = _outcome(jtiles.derive_tpc_borders, detprop, want[1])
    assert got_b[0] == want_b[0]
    if want_b[0] == 'error':
        assert got_b[1] == want_b[1]
    else:
        np.testing.assert_array_equal(got_b[1], want_b[1])
