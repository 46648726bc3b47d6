"""``tools/host_walls.py``'s slices: the ND-LAr run at bench's batching and
the charge chain's kernel slice, which times the card and is refused on
the CPU."""
from __future__ import annotations

import pytest
import yaml

from larndsim_tpu_torch.tools import host_walls, slice_run


def test_slices_at_bench_batching_and_the_chain(tmp_path):
    """``ndlar_bench`` is ``ndlar_yaml`` at bench.py's derived batching
    (the YAML's simulation properties with batch_size 10000, event groups
    of 32) on the same input; ``chain`` runs on the charge-only slice."""
    slices = host_walls.make_slices(
        str(tmp_path), ['ndlar_yaml', 'ndlar_bench', 'chain', 'charge'],
        'cpu')
    (inp_y, kw_y), (inp_b, kw_b) = slices['ndlar_yaml'], slices['ndlar_bench']
    assert inp_b == inp_y
    assert kw_b['event_group_size'] == slice_run.NDLAR_BENCH['group']
    assert 'event_group_size' not in kw_y
    with open(kw_y['simulation_properties']) as f:
        sim_y = yaml.safe_load(f)
    with open(kw_b['simulation_properties']) as f:
        sim_b = yaml.safe_load(f)
    assert sim_b == dict(sim_y,
                         batch_size=slice_run.NDLAR_BENCH['batch_size'])
    assert sim_y['batch_size'] != sim_b['batch_size']
    assert {k: v for k, v in kw_b.items()
            if k not in ('event_group_size', 'simulation_properties')} == \
        {k: v for k, v in kw_y.items() if k != 'simulation_properties'}
    assert slices['chain'] == slices['charge']


def test_chain_slice_needs_the_card(tmp_path, capsys):
    """A CPU rehearsal names its slices: ``chain`` (by name or by default)
    times the card's kernels and is refused before anything runs."""
    for slices in ([], ['chain']):
        with pytest.raises(SystemExit):
            host_walls.main(['--parent', str(tmp_path), '--device', 'cpu',
                             *slices])
        assert 'chain slice' in capsys.readouterr().err
    assert set(host_walls.PIPELINED) < set(host_walls.SLICES)
