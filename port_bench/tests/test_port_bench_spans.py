"""The readers of the CLI's and the output's spans on synthetic phase
tables: each sums its own labels' self walls a spill, leaves every other
label out, and finds nothing to read (None) where its labels are absent,
as in a program without the spans."""
import os

import pytest

from port_bench import harness

#: one call's self walls of a program with the spans, seconds
SPANS = {'cli/input': 0.5, 'cli/quench_drift': 0.25, 'cli/detector': 1.0,
         'cli/batching': 0.125, 'cli/segments': 0.375,
         'cli/accumulate': 0.0625, 'charge_batch': 2.0,
         'charge/get_pixels': 4.0, 'export': 0.75, 'export/flush': 0.5,
         'export/sync': 0.25, 'export/timestamp': 0.125,
         'export/final': 0.0625, 'truth/h5': 1.5, 'truth/drain': 8.0,
         'light_batch': 16.0}
#: the same call of a program without them
PARENT = {'charge_batch': 2.0, 'charge/get_pixels': 4.0, 'export': 0.75,
          'export/flush': 0.5, 'truth/h5': 1.5, 'truth/drain': 8.0}
#: reader -> its value on two calls of SPANS, 16 spills each
WANT = {'cli.input_s_per_event': 2 * 0.75 / 32,
        'cli.detector_s_per_event': 2 * 1.0 / 32,
        'cli.loop_s_per_event': 2 * 0.5625 / 32,
        'io.output_s_per_event': 2 * 3.1875 / 32}


def _metric(name):
    return harness.reader(name, os.path.join(harness.HERE, 'metrics'))


def _window(phases):
    return harness.Window([dict(wall_s=40.0, events=16, phases=phases)
                           for _ in range(2)])


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_sums_its_spans(name):
    assert _metric(name)(_window(SPANS)) == WANT[name]


@pytest.mark.parametrize('name', sorted(WANT))
def test_reader_without_its_spans(name):
    """Without the spans the CLI's readers find nothing; the output's
    reads the labels the program had, as ``io.s_per_event`` does."""
    got = _metric(name)(_window(PARENT))
    if name == 'io.output_s_per_event':
        assert got == _metric('io.s_per_event')(_window(PARENT)) \
            == 2 * 2.75 / 32
    else:
        assert got is None
    assert _metric(name)(_window({'light_batch': 1.0})) is None
    assert _metric(name)(harness.Window([])) is None


def test_the_spans_split_the_remainder():
    """The new readers and the remainder together read what the remainder
    read without the spans, with the output's old labels counted once."""
    split = sum(_metric(n)(_window(SPANS)) for n in WANT) \
        + _metric('cli.self_s_per_event')(_window(SPANS)) \
        - _metric('io.s_per_event')(_window(SPANS))
    before = harness.Window([dict(wall_s=40.0, events=16, phases=dict(
        PARENT, light_batch=16.0)) for _ in range(2)])
    assert split == pytest.approx(
        _metric('cli.self_s_per_event')(before), rel=1e-12)
