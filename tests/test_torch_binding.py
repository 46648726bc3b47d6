"""The ctypes binding of the port's CUDA kernels
(``larndsim_tpu_torch.kernels``), and the launch-cost tool, on the CPU.

Every launch function the binding declares matches an ``extern "C"``
function of ``csrc/*.cu`` argument by argument (the sources parsed here:
this machine has no nvcc); the signatures are set once per loaded library,
however often the wrappers ask for it (a stub library counts the
assignments); P1's TMA window check refuses, before any launch, every
window a tensor map or a block cannot hold; the ``__global__`` names the
profiler reads are the sources'; and ``tools/launch_cost.py`` runs each
tree's package in turns (its numbers here are the host clock's, a
rehearsal of the wiring, no card time).
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil

import pytest

from larndsim_tpu_torch.kernels import binding, build
from larndsim_tpu_torch.tools import launch_cost

#: an ``extern "C"`` function of the kernels' library and its parameters
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def _extern_functions() -> dict:
    found = {}
    for path in build.sources():
        with open(path) as f:
            for name, params in _EXTERN.findall(f.read()):
                found[name] = [p.strip() for p in params.split(',')]
    return found


def _ctype(param: str):
    """The ctypes type a C parameter declaration is passed as."""
    decl = param.rsplit(None, 1)[0] if '*' not in param else param
    if '*' in decl or 'cudaStream_t' in decl:
        return ctypes.c_void_p
    for c_name, ct in (('long long', ctypes.c_longlong),
                       ('unsigned', ctypes.c_uint),
                       ('float', ctypes.c_float), ('int', ctypes.c_int)):
        if c_name in decl:
            return ct
    raise ValueError(f'no ctypes type for {param!r}')


def test_every_launch_function_is_declared():
    assert set(_extern_functions()) == set(binding._SIGNATURES)


@pytest.mark.parametrize('name', sorted(binding._SIGNATURES))
def test_signature_matches_the_source(name):
    params = _extern_functions()[name]
    assert len(binding._SIGNATURES[name]) == len(params), params
    assert binding._SIGNATURES[name] == [_ctype(p) for p in params], params


class _StubFunction:
    def __init__(self, name, counts):
        object.__setattr__(self, 'name', name)
        object.__setattr__(self, 'counts', counts)

    def __setattr__(self, key, value):
        if key == 'argtypes':
            self.counts[self.name] += 1
        object.__setattr__(self, key, value)


class _StubLibrary:
    """A library whose functions count the ``argtypes`` set on them."""

    def __init__(self):
        self.counts = dict.fromkeys(binding._SIGNATURES, 0)
        for name in binding._SIGNATURES:
            setattr(self, name, _StubFunction(name, self.counts))


def test_signatures_are_set_once_per_load(monkeypatch):
    monkeypatch.setattr(binding, '_bound', None)
    for _ in range(2):   # a second load (another library) binds anew
        lib = _StubLibrary()
        monkeypatch.setattr(build, 'load', lambda lib=lib: lib)
        for _ in range(100):
            assert binding._lib() is lib
        assert lib.counts == dict.fromkeys(binding._SIGNATURES, 1)
        for name, argtypes in binding._SIGNATURES.items():
            fn = getattr(lib, name)
            assert fn.argtypes == argtypes and fn.restype is ctypes.c_int


#: (shape, strides, address, q_step, q_sz, n_windows): cases f and g, a
#: 128 KiB window, a view with 528-byte rows, the largest window of 8
#: rows of 128 lanes that fits with its barrier (57 rows do not: 'smem'
#: below)
GOOD_WINDOWS = [((8, 32, 128), (4096, 128, 1), 0, 2, 9, 2),
                ((8, 32, 128), (4096, 128, 1), 256, 8, 16, 2),
                ((8, 96, 128), (12288, 128, 1), 512, 32, 32, 3),
                ((8, 32, 128), (40 * 132, 132, 1), 16, 8, 16, 2),
                ((8, 64, 128), (8192, 128, 1), 0, 0, 56, 1)]


@pytest.mark.parametrize('window', GOOD_WINDOWS,
                         ids=['f', 'g', 'q32', 'strided', 'largest'])
def test_tma_window_takes_the_window_and_its_barrier(window):
    shape, _, _, _, q_sz, _ = window
    smem = binding.tma_window(*window)
    assert smem == shape[0] * q_sz * shape[2] * 4 + binding.TMA_SMEM_EXTRA
    assert smem <= binding.SMEM_MAX


BAD_WINDOWS = {
    'overrun': (((8, 32, 128), (4096, 128, 1), 0, 9, 16, 3), 'overrun'),
    'empty': (((8, 32, 128), (4096, 128, 1), 0, 8, 0, 2), 'empty'),
    'box_lanes': (((2, 8, 320), (2560, 320, 1), 0, 0, 4, 1), 'box'),
    'box_rows': (((300, 4, 32), (128, 32, 1), 0, 0, 2, 1), 'box'),
    'lanes_strided': (((8, 32, 128), (8192, 256, 2), 0, 0, 8, 1),
                      'contiguous'),
    'lanes_bytes': (((8, 32, 126), (4032, 126, 1), 0, 0, 8, 1),
                    'contiguous'),
    'address': (((8, 32, 128), (4096, 128, 1), 4, 0, 8, 1), 'address'),
    'row_stride': (((8, 32, 128), (4097, 128, 1), 0, 0, 8, 1),
                   'row stride'),
    'sub_stride': (((8, 32, 128), (32 * 130, 130, 1), 0, 0, 8, 1),
                   'sub-row stride'),
    'smem': (((8, 64, 128), (8192, 128, 1), 0, 0, 57, 1), 'shared memory'),
}


@pytest.mark.parametrize('name', sorted(BAD_WINDOWS))
def test_tma_window_refuses(name):
    window, match = BAD_WINDOWS[name]
    with pytest.raises(ValueError, match=match):
        binding.tma_window(*window)


def test_kernel_names_are_the_sources_globals():
    """The names ``chip_smoke.py --profile`` picks the port's kernels out
    of the profiler's table by: one a ``__global__`` function, the charge
    chain's four among them."""
    names = build.kernel_names()
    n_global = 0
    for path in build.sources():
        with open(path) as f:
            n_global += f.read().count('__global__')
    assert len(names) == len(set(names)) == n_global
    assert {'induced_current_kernel', 'pixel_rows_kernel', 'fee_fsm_kernel',
            'fractions_kernel', 'weight_table_kernel',
            'probe_async_copy_kernel', 'probe_fee_kernel'} <= set(names)


def test_launch_cost_runs_each_tree_in_turns(tmp_path, capsys):
    """The parent-against-change wiring on the CPU: four processes, each
    timing its own tree's package (a copy stands for the parent)."""
    parent = tmp_path / 'parent'
    shutil.copytree(os.path.dirname(os.path.dirname(binding.__file__)),
                    parent / 'larndsim_tpu_torch',
                    ignore=shutil.ignore_patterns('build', '__pycache__'))
    sides = launch_cost.compare(str(parent), 'cpu')
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r['tree'] for r in lines[:4]] == list(launch_cost.TURNS)
    assert lines[0]['package'] == str(parent / 'larndsim_tpu_torch')
    assert lines[1]['package'] == os.path.dirname(
        os.path.dirname(binding.__file__))
    assert set(sides) == set(launch_cost.CASES)
    for side in sides.values():
        for tree in ('parent', 'change'):
            assert len(side[tree]['host_us']) == 2
            assert all(us > 0 for us in side[tree]['host_us'])
