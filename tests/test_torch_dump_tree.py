"""The port's host tools: the edep-sim converter
(``larndsim_tpu_torch.cli.dump_tree``)
against the JAX package's, both run under the fake-ROOT shim of
tests/test_dump_tree.py.

Each case converts the same fake events with both converters; the
``segments``, ``trajectories`` and ``vertices`` datasets must be equal
(dtype, shape and every field bit for bit) through h5py and through the
port's reader, and the port's are chunked, appendable datasets.
"""
from __future__ import annotations

import sys

import h5py
import numpy as np
import pytest

from larndsim_tpu.cli import dump_tree as jdump
from larndsim_tpu_torch.cli import dump_tree as tdump
from larndsim_tpu_torch.io import h5

from test_dump_tree import _install_fake_root, _mk_events, _register

NAMES = ('segments', 'trajectories', 'vertices')


def _both_events_active(events):
    events[1].SegmentDetectors = events[0].SegmentDetectors
    events[1].Trajectories = events[0].Trajectories
    events[1].Primaries = events[0].Primaries
    return events


#: name -> (events, spill map, spill period, dump keywords)
CASES = {
    'spill_map': (_mk_events, {'1 7': 4, '1 8': 5}, 1.2, {}),
    'spill_counter': (lambda: _both_events_active(_mk_events()),
                      {'1 7': 40, '1 8': 41}, 1.2, {}),
    'keep_all_dets': (_mk_events, None, None, dict(keep_all_dets=True)),
    'appends_every_row': (lambda: _both_events_active(_mk_events()), None,
                          None, dict(write_batch=1)),
    'first_event': (_mk_events, None, None, dict(n_events=1,
                                                 write_batch=1)),
}


def _equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    for name in want.dtype.names:
        assert np.asarray(got[name]).tobytes() == \
            np.asarray(want[name]).tobytes(), f'{what}.{name}'


@pytest.mark.parametrize('case', sorted(CASES))
def test_dump_tree_matches_jax(monkeypatch, tmp_path, case):
    make, spill_map, period, kw = CASES[case]
    _install_fake_root(monkeypatch)
    src = f'torch_{case}.root'
    _register(src, make(), spill_map=spill_map, spill_period=period)
    out_j, out_t = str(tmp_path / 'jax.h5'), str(tmp_path / 'port.h5')
    jdump.dump(src, out_j, **kw)
    tdump.dump(src, out_t, **kw)
    port = h5.File(out_t, 'r')
    jax_by_port = h5.File(out_j, 'r')
    with h5py.File(out_j, 'r') as fj, h5py.File(out_t, 'r') as ft:
        for name in NAMES:
            want = fj[name][()]
            assert len(want) > 0, name
            _equal(ft[name][()], want, name)
            _equal(port[name], want, name)
            _equal(jax_by_port[name], want, name)
            assert ft[name].maxshape == (None,), name
            assert ft[name].chunks is not None, name


def test_dump_tree_without_root_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ROOT', None)
    with pytest.raises(ImportError, match='PyROOT'):
        tdump.dump('x.root', 'y.h5')


def test_list_config_keys_matches_jax(capsys):
    from larndsim_tpu import config as jconfig
    from larndsim_tpu_torch import config as tconfig
    from larndsim_tpu_torch.cli import list_config_keys
    assert list(tconfig.list_config_keys()) == list(jconfig.list_config_keys())
    list_config_keys.main()
    assert capsys.readouterr().out.strip() == str(
        list(jconfig.list_config_keys()))
