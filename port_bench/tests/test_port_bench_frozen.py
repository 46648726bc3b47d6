"""The frozen copies in ``port_bench/`` against their originals in the
port, at small sizes: the stand-in asset writers, the K1 / K2 cost
counting and the HDF5 reader; and the reference's reading of the
configuration against the port's."""
import os

import numpy as np
import pytest
import torch

from port_bench import costs
from port_bench.reference import detector
from port_bench.reference.frozen.assets import geometry as frozen_geometry
from port_bench.reference.frozen.io import h5 as frozen_h5

@pytest.mark.parametrize('writer,kw', [
    ('write_module0', dict(light=True)),
    ('write_2x2', dict(light=False)),
    ('write_ndlar', {})])
def test_asset_writers_equal_the_ports(tmp_path, writer, kw):
    from larndsim_tpu_torch.assets import geometry
    a = getattr(geometry, writer)(str(tmp_path / 'a'), **kw)
    b = getattr(frozen_geometry, writer)(str(tmp_path / 'b'), **kw)
    assert a.keys() == b.keys()
    for key in a:
        pa = a[key] if isinstance(a[key], list) else [a[key]]
        pb = b[key] if isinstance(b[key], list) else [b[key]]
        for x, y in zip(pa, pb):
            assert os.path.basename(x) == os.path.basename(y)
            if os.path.isfile(x):
                with open(x, 'rb') as fx, open(y, 'rb') as fy:
                    assert fx.read() == fy.read(), x


def test_response_and_noise_equal_the_ports():
    from larndsim_tpu_torch.assets.light_lut import make_light_noise
    from larndsim_tpu_torch.assets.response import make_response
    from port_bench.reference.frozen.assets import light_lut, response
    kw = dict(n_t=300, bin_size=0.0387975, sampling=0.05,
              pixel_pitch=0.387975)
    np.testing.assert_array_equal(make_response(**kw),
                                  response.make_response(**kw))
    np.testing.assert_array_equal(make_light_noise(96),
                                  light_lut.make_light_noise(96))


def _k1_args(seed=0, S=6, n_steps=9, P=5, t_sig=40, ntp=12):
    from larndsim_tpu_torch.ops.current import LutGeometry
    g = torch.Generator().manual_seed(seed)
    lut = LutGeometry.__new__(LutGeometry)
    lut.nx_r, lut.ny_r, lut.ratio = 4, 4, 2
    lut.inv_bin, lut.lim_x, lut.lim_y = 10.0, 0.5, 0.5
    lut.max_x, lut.max_y = 0.4, 0.4
    lut.zero_row = lut.nx_r * lut.ny_r * lut.ratio
    xs = torch.rand(S, n_steps, generator=g)
    ys = torch.rand(S, n_steps, generator=g)
    shift = torch.randint(-5, t_sig, (S, n_steps), generator=g,
                          dtype=torch.int32)
    phase = torch.randint(0, lut.ratio, (S, n_steps), generator=g,
                          dtype=torch.int32)
    pxc = torch.rand(S, P, generator=g)
    pyc = torch.rand(S, P, generator=g)
    pxc[0, -1] = 1e9
    nstep = torch.randint(0, n_steps + 1, (S,), generator=g,
                          dtype=torch.int32)
    tick_lo = torch.randint(0, 10, (S,), generator=g, dtype=torch.int32)
    tick_hi = torch.full((S,), t_sig, dtype=torch.int32)
    scale = torch.rand(S, t_sig, generator=g)
    resp = torch.rand(lut.zero_row + 1, ntp, generator=g)
    return (xs, ys, shift, phase, pxc, pyc, nstep, tick_lo, tick_hi, scale,
            resp, lut)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_cost_counting_equals_the_ports(seed):
    from larndsim_tpu_torch.ops import current
    from larndsim_tpu_torch.tools import perf_guard
    args = _k1_args(seed)
    assert costs.k1_costs(args) == perf_guard.k1_costs(args)
    rows = (args[0], args[1], args[3], args[4], args[5], args[11])
    np.testing.assert_array_equal(costs.row_table(*rows).numpy(),
                                  current.row_table(*rows).numpy())
    assert costs.fsm_costs(2032, 512, 30, 2002) == perf_guard.fsm_costs(
        2032, 512, 30, 2002, drawn=False)
    assert costs.ROW_OPS == perf_guard.ROW_OPS
    assert costs.FSM_OPS == perf_guard.FSM_OPS
    assert costs.HBM_BYTES_PER_S == perf_guard.HBM_BYTES_PER_S
    # the published float32 peak, not the port's one-operation-a-slot rate
    assert costs.F32_OPS_PER_S == perf_guard.F32_FLOP_PER_S


def test_reader_equals_the_ports(tmp_path):
    from larndsim_tpu_torch.io.h5 import File
    path = str(tmp_path / 'f.h5')
    rng = np.random.default_rng(0)
    rows = np.zeros(5000, dtype=[('a', 'i4'), ('b', 'f8'), ('c', 'u1', (3,))])
    rows['a'] = rng.integers(0, 100, len(rows))
    rows['b'] = rng.normal(size=len(rows))
    with File(path, 'w') as f:
        f.create_dataset('rows', data=rows[:100], maxshape=(None,))
        f['rows'].append(rows[100:])
        f.create_dataset('grid', data=rng.normal(size=(7, 9, 11)))
    with File(path, 'r') as fa, frozen_h5.File(path, 'r') as fb:
        assert sorted(fa.keys()) == sorted(fb.keys())
        for name in fa.keys():
            a, b = np.asarray(fa[name]), np.asarray(fb[name])
            assert a.dtype == b.dtype
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize('writer,kw', [('write_ndlar', {}),
                                       ('write_module0', {})])
def test_the_references_detector_equals_the_ports(tmp_path, writer, kw):
    from larndsim_tpu_torch.assets import geometry
    from larndsim_tpu_torch.io.export import pixel_readout_coords
    from larndsim_tpu_torch.params import load_detector, load_sim
    p = getattr(geometry, writer)(str(tmp_path), **kw)
    sim_yaml = p.get('simulation_properties') or str(tmp_path / 'sim.yaml')
    if not os.path.isfile(sim_yaml):
        with open(sim_yaml, 'w') as f:
            f.write('{batch_size: 100, event_batch_size: 1}\n')
    ref = detector.load(p['detector_properties'], p['pixel_layout'],
                        sim_yaml)
    port = load_detector(p['detector_properties'], p['pixel_layout'],
                         device='cpu')
    prm = port.params
    np.testing.assert_array_equal(ref.borders, np.asarray(port.tpc_borders))
    assert ref.n_pixels == tuple(prm.n_pixels)
    assert ref.ticks == prm.time_ticks
    assert ref.fee_ticks() == (prm.integrate_ticks, prm.reset_ticks,
                               prm.busy_ticks)
    assert ref.c['clock_reset_period'] == prm.clock_reset_period
    for key, name in (('v_drift', 'v_drift'), ('pixel_pitch', 'pixel_pitch'),
                      ('lifetime', 'electron_lifetime'),
                      ('time_padding', 'time_padding'),
                      ('response_bin_size', 'response_bin_size')):
        assert ref.c[key] == prm.host[name], key
    sim = load_sim(sim_yaml)
    assert ref.sim['batch_size'] == sim.batch_size
    assert ref.sim['event_batch_size'] == sim.event_batch_size
    nx, ny = prm.n_pixels
    ids = np.arange(0, nx * ny * prm.n_tpcs, 97, dtype=np.int64)
    *mine, ok_mine = ref.readout(ids)
    *theirs, ok = pixel_readout_coords(ids, port)
    np.testing.assert_array_equal(ok_mine, ok)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(np.asarray(a)[ok], np.asarray(b)[ok])
