"""The reference's reading of a configuration's YAMLs: the detector, its
pixel layout and the simulation's batching, as larnd-sim's documented
keys and defaults define them (``larndsim/consts/detector.py``, ``sim.py``,
``fee.py``).  Plain numpy; nothing of the program is imported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import yaml

MV = 1e-9           # the simulator's millivolt, in its megavolts per e
#: larnd-sim's module-global defaults, used where a YAML leaves a key out
DEFAULTS = dict(
    temperature=87.17, e_field=0.5, lifetime=2.2e3, long_diff=4.0e-6,
    tran_diff=8.8e-6, time_padding=10.0, time_window=8.9,
    response_sampling=0.1, response_bin_size=0.04434,
    discrimination_threshold=7e3, adc_hold_delay=15, adc_busy_delay=9,
    reset_cycles=1, clock_cycle=0.1, larpix_gain=4e-3, buffer_risetime=0.1,
    v_cm=288.0, v_ref=1300.0, v_pedestal=580.0, adc_counts=256,
    reset_noise_charge=900.0, uncorrelated_noise_charge=500.0,
    discriminator_noise=650.0)
SIM_DEFAULTS = dict(
    batch_size=10_000, event_batch_size=1, spill_period=1.2e6,
    max_events_per_file=1000, max_tracks_per_pixel=50, min_step_size=0.001,
    mc_sample_multiplier=1, association_count_to_store=20,
    max_adc_values=30, is_spill_sim=True)


def _load(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _per_module(value, i_module: int) -> float:
    if isinstance(value, list):
        return float(value[i_module - 1] if 1 <= i_module <= len(value)
                     else value[0])
    return float(value)


def mobility(e_field: float, temperature: float) -> float:
    """Electron mobility in liquid argon [cm^2 / kV / us]: the BNL
    parametrisation (Li et al., NIM A 816 (2016) 160), as larnd-sim
    evaluates it."""
    a0, a1, a2, a3, a4, a5 = 551.6, 7158.3, 4440.43, 4.29, 43.63, 0.2053
    num = a0 + a1 * e_field + a2 * e_field ** 1.5 + a3 * e_field ** 2.5
    den = 1 + (a1 / a0) * e_field + a4 * e_field ** 2 + a5 * e_field ** 3
    return num / den * (temperature / 89.0) ** -1.5 * 1e-6 / 1e-3


@dataclasses.dataclass
class Detector:
    """Everything the reference needs of one module's configuration."""
    c: dict                  # scalar constants (float64 as written)
    borders: np.ndarray      # (n_tpc, 3, 2) cm
    n_pixels: tuple          # (nx, ny) pixels of an anode
    per_tile: tuple          # (nx, ny) pixels of a tile
    tile_map: np.ndarray     # (anode, tile x, tile y) -> tile id
    chip: np.ndarray         # (tile, in-tile x, in-tile y) -> chip id
    channel: np.ndarray
    io_local: np.ndarray     # -> io group within the module (1, 2), or -1
    io_channel: np.ndarray
    module_io: dict          # module -> its io groups
    sim: dict

    @property
    def n_tpcs(self) -> int:
        return self.borders.shape[0]

    @property
    def ticks(self) -> int:
        lo, hi = self.c['time_interval']
        return int(round(hi - lo) / self.c['time_sampling']) + 1

    def fee_ticks(self) -> tuple[int, int, int]:
        """(integration, reset, busy) windows in ticks."""
        clock, dt = self.c['clock_cycle'], self.c['time_sampling']
        return (round((3 + self.c['adc_hold_delay']) * clock / dt),
                round(self.c['reset_cycles'] * clock / dt),
                round(self.c['adc_busy_delay'] * clock / dt))

    def scan_ticks(self) -> int:
        integ, _, busy = self.fee_ticks()
        return self.ticks + integ + busy + 4

    def readout(self, pixel_ids: np.ndarray):
        """Pixel ids -> (io_group, io_channel, chip, channel, mapped)."""
        nx, ny = self.n_pixels
        tx, ty = self.per_tile
        ix, iy = pixel_ids % nx, (pixel_ids // nx) % ny
        plane = pixel_ids // (nx * ny)
        module = plane // 2 + 1
        tile = self.tile_map[plane % 2, ix // tx, iy // ty]
        at = (tile, ix % tx, iy % ty)
        local = self.io_local[at]
        group = np.array([self.module_io[int(m)][int(g) - 1]
                          if int(m) in self.module_io and g >= 1 else -1
                          for m, g in zip(module, local)], np.int64)
        ok = (self.chip[at] >= 0) & (group >= 0)
        return group, self.io_channel[at], self.chip[at], self.channel[at], ok


def module_ids(det_yaml: str) -> list[int]:
    """The modules the detector YAML declares, in its order."""
    return [int(m) for m in _load(det_yaml)['module_to_tpcs']]


def of_module(value, i_module: int, ids=None):
    """Module ``i_module``'s file of a per-module list, as larnd-sim picks
    it: entry ``ids[i_module - 1]`` (a configuration's ``*_ID`` list), or
    entry ``i_module - 1`` without one; a file that is not a list serves
    every module."""
    if not isinstance(value, list):
        return value
    return value[ids[i_module - 1] if ids is not None else i_module - 1]


def load(det_yaml: str, layout_yaml: str, sim_yaml: str,
         i_module: int = -1) -> Detector:
    det, lay, sim = _load(det_yaml), _load(layout_yaml), _load(sim_yaml)

    def get(k):
        return det.get(k, DEFAULTS[k])
    c = {k: _per_module(get(k), i_module) if k in (
        'e_field', 'lifetime', 'response_sampling', 'response_bin_size',
        'discrimination_threshold') else float(get(k)) for k in DEFAULTS}
    c['time_interval'] = tuple(float(x) for x in det['time_interval'])
    c['time_sampling'] = float(det.get('time_sampling', 0.1))
    c['drift_length'] = float(det['drift_length'])
    c['v_drift'] = c['e_field'] * mobility(c['e_field'], c['temperature'])
    use_pps = bool(det.get('use_pps_rollover', True))
    c['clock_reset_period'] = int(det.get(
        'clock_reset_period', int(1e6 / c['clock_cycle']) if use_pps
        else int(det.get('rollover_cycles', 2 ** 31))))

    # the pixel layout
    pitch = float(lay['pixel_pitch']) * 1.0 / 10.0        # mm -> cm
    c['pixel_pitch'] = pitch
    pos = np.array(list(lay['chip_channel_to_position'].values()))
    keys = np.array(list(lay['chip_channel_to_position'].keys()), np.int64)
    half = np.array([(pos[:, 0].max() * pitch + pitch) / 2,
                     (pos[:, 1].max() * pitch + pitch) / 2])
    per_tile = (len(np.unique(pos[:, 0])), len(np.unique(pos[:, 1])))
    tile_map = np.array(det['tile_map'])
    n_pixels = (per_tile[0] * tile_map.shape[1],
                per_tile[1] * tile_map.shape[2])
    n_tiles = max(int(t) for t in lay['tile_indeces']) + 1
    shape = (n_tiles,) + per_tile
    chip, channel, io_local, io_channel = (np.full(shape, -1, np.int64)
                                           for _ in range(4))
    for tile, orient in lay['tile_orientations'].items():
        t = int(tile)
        # a pixel reads out through the chip at its flipped position
        x = np.where(orient[2] < 0, per_tile[0] - pos[:, 0] - 1, pos[:, 0])
        y = np.where(orient[1] < 0, per_tile[1] - pos[:, 1] - 1, pos[:, 1])
        chip[t, x, y] = keys // 1000
        channel[t, x, y] = keys % 1000
        io = lay['tile_chip_to_io'].get(tile, {})
        packed = np.array([io.get(int(ch), -1) for ch in chip[t].ravel()],
                          np.int64).reshape(per_tile)
        io_local[t] = np.where(packed >= 0, packed // 1000, -1)
        io_channel[t] = np.where(packed >= 0, packed % 1000, -1)

    # the TPCs: each offset's anodes, the drift along z
    offsets = np.array(det['tpc_offsets'], np.float64)[:, [2, 1, 0]]
    anode_of = {int(t): v[0] for t, v in lay['tile_indeces'].items()}
    anodes = sorted(set(anode_of.values()))
    borders = np.empty((len(offsets) * len(anodes), 3, 2))
    for it, off in enumerate(offsets):
        for ia, anode in enumerate(anodes):
            tiles = np.array([lay['tile_positions'][t] for t in anode_of
                              if anode_of[t] == anode], np.float64) * 1.0 / 10.0
            sign = 1 if anode == 1 else -1
            borders[it * 2 + ia] = (
                (tiles[:, 2].min() - half[0] + off[0],
                 tiles[:, 2].max() + half[0] + off[0]),
                (tiles[:, 1].min() - half[1] + off[1],
                 tiles[:, 1].max() + half[1] + off[1]),
                (tiles[:, 0].min() + off[2],
                 tiles[:, 0].max() + c['drift_length'] * sign + off[2]))
    s = {k: type(v)(sim.get(k, v)) for k, v in SIM_DEFAULTS.items()}
    return Detector(c=c, borders=borders, n_pixels=n_pixels,
                    per_tile=per_tile, tile_map=tile_map, chip=chip,
                    channel=channel, io_local=io_local,
                    io_channel=io_channel,
                    module_io={int(k): list(v) for k, v in
                               det['module_to_io_groups'].items()},
                    sim=s)
