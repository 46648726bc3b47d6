"""Detector parameters as a frozen dataclass of tensors.

Counterpart of ``larndsim_tpu.params.detector``.  Numeric quantities that
scale the math are float32 tensor leaves on one device; quantities that fix
shapes or control flow are plain Python values.  The YAML's float64 values
are kept beside the tensors in ``host``, so host code never reads a leaf
back from the device.

:class:`DetectorFiles` is one simulation call's table of the detector files
it reads: each file is parsed once a call, and every later load that names
it builds from the same host objects.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch
import yaml

from ..geometry import tiles as tiles_mod
from ..utils import trace

try:
    _YamlLoader = yaml.CSafeLoader
except AttributeError:
    _YamlLoader = yaml.SafeLoader

#: Sentinel for segments outside every TPC (consts/detector.py:67)
DEFAULT_PLANE_INDEX = 0x0000BEEF

#: Float leaves of DetectorParams, in declaration order.
LEAVES = (
    'tpc_borders', 'pixel_pitch', 'e_field', 'temperature', 'v_drift',
    'electron_lifetime', 'long_diff', 'tran_diff', 'time_padding',
    'time_window', 'response_sampling', 'response_bin_size',
    'discrimination_threshold', 'gain', 'buffer_risetime', 'v_cm', 'v_ref',
    'v_pedestal', 'reset_noise_charge', 'uncorrelated_noise_charge',
    'discriminator_noise')

#: Shape / control-flow fields of DetectorParams.
STATICS = (
    'n_pixels', 'n_pixels_per_tile', 'n_tpcs', 'time_interval',
    'time_sampling', 'sampled_points', 'time_ticks', 'clock_cycle',
    'adc_hold_delay', 'adc_busy_delay', 'reset_cycles', 'adc_counts',
    'clock_reset_period', 'rollover_cycles', 'event_rate',
    'non_beam_event_gap', 'drift_length')


def _pick(bucket, i_module: int) -> float:
    """Scalar-or-per-module-list YAML value (consts/detector.py:182-196)."""
    if not isinstance(bucket, list):
        return float(bucket)
    if i_module < 1 or i_module > len(bucket):
        return float(bucket[0])
    return float(bucket[i_module - 1])


@dataclasses.dataclass(frozen=True)
class DetectorParams:
    """Device-facing detector constants (float32 tensor leaves + statics)."""

    tpc_borders: torch.Tensor          # (n_tpc, 3, 2) cm
    pixel_pitch: torch.Tensor          # cm
    e_field: torch.Tensor              # kV/cm
    temperature: torch.Tensor          # K
    v_drift: torch.Tensor              # cm/us
    electron_lifetime: torch.Tensor    # us
    long_diff: torch.Tensor            # cm^2/us
    tran_diff: torch.Tensor            # cm^2/us
    time_padding: torch.Tensor         # us
    time_window: torch.Tensor          # us
    response_sampling: torch.Tensor    # us
    response_bin_size: torch.Tensor    # cm
    discrimination_threshold: torch.Tensor  # e-
    gain: torch.Tensor                 # mV/e-
    buffer_risetime: torch.Tensor      # us
    v_cm: torch.Tensor                 # mV
    v_ref: torch.Tensor                # mV
    v_pedestal: torch.Tensor           # mV
    reset_noise_charge: torch.Tensor   # e-
    uncorrelated_noise_charge: torch.Tensor  # e-
    discriminator_noise: torch.Tensor  # e-
    #: host float64 copies of every leaf (``tpc_borders`` as numpy)
    host: dict = dataclasses.field(repr=False)
    n_pixels: tuple[int, int] = (0, 0)
    n_pixels_per_tile: tuple[int, int] = (0, 0)
    n_tpcs: int = 0
    time_interval: tuple[float, float] = (0.0, 200.0)
    time_sampling: float = 0.1
    sampled_points: int = 40
    time_ticks: int = 2001
    clock_cycle: float = 0.1
    adc_hold_delay: int = 15
    adc_busy_delay: int = 9
    reset_cycles: int = 1
    adc_counts: int = 256
    clock_reset_period: int = 10_000_000
    rollover_cycles: int = 2 ** 31
    event_rate: float = 100_000.0
    non_beam_event_gap: float = 0.0
    drift_length: float = 0.0

    # Derived FEE tick counts (reference fee.py:590, :620, :647)
    @property
    def integrate_ticks(self) -> int:
        return round((3 + self.adc_hold_delay) * self.clock_cycle
                     / self.time_sampling)

    @property
    def reset_ticks(self) -> int:
        return round(self.reset_cycles * self.clock_cycle / self.time_sampling)

    @property
    def busy_ticks(self) -> int:
        return round(self.adc_busy_delay * self.clock_cycle
                     / self.time_sampling)

    @property
    def device(self) -> torch.device:
        return self.tpc_borders.device

    def f32(self, name: str) -> float:
        """A scalar leaf as its float32 value, read from the host copy."""
        return float(np.float32(self.host[name]))

    def replace(self, **changes) -> 'DetectorParams':
        """Copy with some fields changed; float leaves given as numbers
        update both the tensor and its host copy."""
        host = dict(self.host)
        for k, v in list(changes.items()):
            if k in LEAVES and not isinstance(v, torch.Tensor):
                host[k] = (np.asarray(v, np.float64) if k == 'tpc_borders'
                           else float(v))
                changes[k] = torch.tensor(np.asarray(v), dtype=torch.float32,
                                          device=self.device)
        return dataclasses.replace(self, host=host, **changes)


def card_or(device, what: str = 'the detector parameters') -> torch.device:
    """``device`` as a torch device: the card unless the caller names
    another; raises when it names the card and there is none."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'no CUDA device for {what} '
                           "(pass device='cpu' for the CPU)")
    return device


def from_numpy(leaves: dict, statics: dict, device='cuda') -> DetectorParams:
    """Build the port's params from numpy leaves and static fields.

    ``leaves`` maps every name of :data:`LEAVES` to an array (as taken
    from the JAX ``DetectorParams``); ``statics`` maps the names of
    :data:`STATICS`.  The host copies are the float32 leaf values.
    """
    device = card_or(device)
    tens = {k: torch.tensor(np.asarray(leaves[k], np.float32),
                            device=device) for k in LEAVES}
    host = {k: float(np.asarray(leaves[k], np.float32))
            for k in LEAVES if k != 'tpc_borders'}
    host['tpc_borders'] = np.asarray(leaves['tpc_borders'], np.float64)
    return DetectorParams(host=host, **tens,
                          **{k: statics[k] for k in STATICS})


@dataclasses.dataclass(frozen=True)
class DetectorModel:
    """Host-side detector description: device params + readout maps."""

    params: DetectorParams
    layout: tiles_mod.TileLayout
    tile_map: tuple
    module_to_io_groups: dict[int, list[int]]
    module_to_tpcs: dict[int, list[int]]
    tpc_to_module: dict[int, int]
    mod_ids: list[int]
    tpc_borders: np.ndarray


def _read_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.load(f, Loader=_YamlLoader)


def _read_layout(detprop: dict, pixel_file: str):
    """A pixel layout's :class:`TileLayout` and the TPC borders it gives
    under the detector properties ``detprop``."""
    layout = tiles_mod.load_tile_layout(pixel_file, detprop['tile_map'])
    return layout, tiles_mod.derive_tpc_borders(detprop, layout)


class DetectorFiles:
    """The detector files of one simulation call, each read once.

    ``get(kind, key, read)`` returns ``read()``'s result the first time a
    ``(kind, key)`` is asked for and the same object every later time, and
    tallies each ask in the trace as ``<label>_read/<kind>`` or
    ``<label>_reused/<kind>``.  It holds host objects only (no device
    tensor), and shares them between the loads of every module: nothing
    downstream writes into them.  Module threads may share a table: each
    key is read under its own lock, by the first thread that asks.  Made
    for a call and dropped with it, so that every call reads its files
    anew."""

    def __init__(self, label: str = 'detector_files'):
        self.label = label
        self._lock = threading.Lock()
        self._slots: dict = {}

    def get(self, kind: str, key, read):
        with self._lock:
            slot = self._slots.setdefault((kind, key), [threading.Lock()])
        with slot[0]:
            fresh = len(slot) == 1
            if fresh:
                slot.append(read())
        trace.tally(f'{self.label}_{"read" if fresh else "reused"}/{kind}')
        return slot[1]

    def detprop(self, path: str) -> dict:
        """The detector-properties YAML at ``path``, as a dict."""
        return self.get('detprop', path, lambda: _read_yaml(path))


def get_module_ids(detprop_file: str, *,
                   files: DetectorFiles | None = None) -> list[int]:
    """Module ids declared in a detector-properties YAML (read through
    ``files``, where given)."""
    files = DetectorFiles() if files is None else files
    return list(files.detprop(detprop_file)['module_to_tpcs'].keys())


# Defaults mirroring the reference module-global fallbacks
# (consts/detector.py:14-135); used when a key is absent from the YAML.
_DEFAULTS = dict(
    temperature=87.17, e_field=0.5, lifetime=2.2e3,
    long_diff=4.0e-6, tran_diff=8.8e-6,
    time_padding=10.0, time_window=8.9,
    response_sampling=0.1, response_bin_size=0.04434,
    discrimination_threshold=7e3, adc_hold_delay=15, adc_busy_delay=9,
    reset_cycles=1, clock_cycle=0.1, larpix_gain=4e-3, buffer_risetime=0.1,
    v_cm=288.0, v_ref=1300.0, v_pedestal=580.0, adc_counts=256,
    reset_noise_charge=900.0, uncorrelated_noise_charge=500.0,
    discriminator_noise=650.0, event_rate=100_000.0, non_beam_event_gap=0.0,
)


def load_detector(detprop_file: str, pixel_file: str | list[str],
                  i_module: int = -1, device='cuda', *,
                  files: DetectorFiles | None = None) -> DetectorModel:
    """Build a :class:`DetectorModel` from detector-properties and
    pixel-layout YAMLs, with every leaf on ``device``; with ``files``, each
    YAML is read through that table, once for all the loads that name it."""
    device = card_or(device)
    if isinstance(pixel_file, list):
        pixel_file = pixel_file[i_module - 1]
    files = DetectorFiles() if files is None else files
    detprop = files.detprop(detprop_file)
    layout, tpc_borders = files.get(
        'layout', (detprop_file, pixel_file),
        lambda: _read_layout(detprop, pixel_file))
    return _build(detprop, layout, tpc_borders, i_module, device)


def _build(detprop: dict, layout: tiles_mod.TileLayout,
           tpc_borders: np.ndarray, i_module: int,
           device: torch.device) -> DetectorModel:
    """Module ``i_module``'s :class:`DetectorModel` from the parsed
    files: its per-module values picked, its leaves on ``device``."""
    get = lambda k, d=None: detprop.get(k, _DEFAULTS[k] if d is None else d)
    temperature = float(get('temperature'))
    e_field = _pick(get('e_field'), i_module)
    v_drift = e_field * tiles_mod.electron_mobility(e_field, temperature)
    lifetime = _pick(get('lifetime'), i_module)

    time_interval = tuple(detprop['time_interval'])
    time_sampling = float(detprop.get('time_sampling', 0.1))
    time_ticks = int(round(time_interval[1] - time_interval[0])
                     / time_sampling) + 1

    clock_cycle = float(get('clock_cycle'))
    pps_cycles = int(1e6 / clock_cycle)
    use_pps = bool(detprop.get('use_pps_rollover', True))
    rollover = int(detprop.get('rollover_cycles', 2 ** 31))
    clock_reset_period = int(detprop.get(
        'clock_reset_period', pps_cycles if use_pps else rollover))

    host = dict(
        pixel_pitch=float(layout.pixel_pitch),
        e_field=float(e_field),
        temperature=temperature,
        v_drift=float(v_drift),
        electron_lifetime=float(lifetime),
        long_diff=float(get('long_diff')),
        tran_diff=float(get('tran_diff')),
        time_padding=float(get('time_padding')),
        time_window=float(get('time_window')),
        response_sampling=_pick(get('response_sampling'), i_module),
        response_bin_size=_pick(get('response_bin_size'), i_module),
        discrimination_threshold=_pick(get('discrimination_threshold'),
                                       i_module),
        gain=float(get('larpix_gain')),
        buffer_risetime=float(get('buffer_risetime')),
        v_cm=float(get('v_cm')),
        v_ref=float(get('v_ref')),
        v_pedestal=float(get('v_pedestal')),
        reset_noise_charge=float(get('reset_noise_charge')),
        uncorrelated_noise_charge=float(get('uncorrelated_noise_charge')),
        discriminator_noise=float(get('discriminator_noise')),
    )
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32,
                                 device=device)
    host['tpc_borders'] = np.asarray(tpc_borders, np.float64)
    params = DetectorParams(
        host=host,
        **{k: f32(host[k]) for k in LEAVES},
        n_pixels=layout.n_pixels,
        n_pixels_per_tile=layout.n_pixels_per_tile,
        n_tpcs=int(tpc_borders.shape[0]),
        time_interval=(float(time_interval[0]), float(time_interval[1])),
        time_sampling=time_sampling,
        sampled_points=int(detprop.get('sampled_points', 40)),
        time_ticks=time_ticks,
        clock_cycle=clock_cycle,
        adc_hold_delay=int(get('adc_hold_delay')),
        adc_busy_delay=int(get('adc_busy_delay')),
        reset_cycles=int(get('reset_cycles')),
        adc_counts=int(get('adc_counts')),
        clock_reset_period=clock_reset_period,
        rollover_cycles=rollover,
        event_rate=float(get('event_rate')),
        non_beam_event_gap=float(get('non_beam_event_gap')),
        drift_length=float(detprop['drift_length']),
    )

    module_to_tpcs = {int(k): list(v)
                      for k, v in detprop['module_to_tpcs'].items()}
    return DetectorModel(
        params=params,
        layout=layout,
        tile_map=layout.tile_map,
        module_to_io_groups={int(k): list(v) for k, v in
                             detprop['module_to_io_groups'].items()},
        module_to_tpcs=module_to_tpcs,
        tpc_to_module={tpc: mod for mod, tpcs in module_to_tpcs.items()
                       for tpc in tpcs},
        mod_ids=list(module_to_tpcs.keys()),
        tpc_borders=tpc_borders,
    )
