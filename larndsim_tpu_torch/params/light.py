"""Light-readout parameters as a frozen dataclass of tensors.

Counterpart of ``larndsim_tpu.params.light``: the same YAML surface as the
reference loader (consts/light.py:63-170).  Gains, efficiencies, channel
maps and the scintillation / SiPM constants are tensor leaves on one
device; tick sizes, windows and modes (which set shapes and control flow)
are plain Python values.  The YAML's float64 values of the five scalar
leaves and the SiPM impulse are kept beside the tensors in ``host``, so
host code (the float64 truth kernel) never reads a leaf back.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import yaml

from .detector import card_or

try:
    _YamlLoader = yaml.CSafeLoader
except AttributeError:
    _YamlLoader = yaml.SafeLoader

#: Default conversion from PE/us to ADC (consts/light.py:35)
DEFAULT_LIGHT_GAIN = -2.30

#: Tensor leaves of LightParams, in declaration order, with their dtypes.
LEAVES = dict(
    op_channel_efficiency=torch.float32, op_channel_to_tpc=torch.int32,
    tpc_to_op_channel=torch.int32, light_gain=torch.float32,
    light_trig_threshold=torch.float32, singlet_fraction=torch.float32,
    tau_s=torch.float32, tau_t=torch.float32,
    light_response_time=torch.float32,
    light_oscillation_period=torch.float32, impulse_model=torch.float32)

#: Scalar leaves whose float64 values host code reads from ``host``.
HOST_SCALARS = ('tau_s', 'tau_t', 'singlet_fraction', 'light_response_time',
                'light_oscillation_period')

#: Shape / control-flow fields of LightParams.
STATICS = (
    'light_simulated', 'enable_lut_smearing', 'n_op_channel',
    'scint_prescale', 'w_ph', 'light_tick_size', 'light_window',
    'sipm_response_model', 'light_det_noise_sample_spacing',
    'impulse_tick_size', 'op_channel_per_trig', 'light_trig_mode',
    'light_trig_window', 'light_digit_sample_spacing', 'light_nbit')


@dataclasses.dataclass(frozen=True)
class LightParams:
    """Device-facing light-simulation constants (tensor leaves + statics)."""

    op_channel_efficiency: torch.Tensor     # (n_op_channel,)
    op_channel_to_tpc: torch.Tensor         # (n_op_channel,) int32
    tpc_to_op_channel: torch.Tensor         # (n_tpc, n_per_tpc) int32
    light_gain: torch.Tensor                # (n_op_channel,) ADC*us/PE
    light_trig_threshold: torch.Tensor      # (n_op_channel / per trig group,)
    singlet_fraction: torch.Tensor
    tau_s: torch.Tensor                     # us
    tau_t: torch.Tensor                     # us
    light_response_time: torch.Tensor       # us (RLC model)
    light_oscillation_period: torch.Tensor  # us (RLC model)
    impulse_model: torch.Tensor             # (n_impulse,) measured impulse
    #: float64 host copies of HOST_SCALARS, and the impulse as numpy
    host: dict = dataclasses.field(repr=False)
    light_simulated: bool = True
    enable_lut_smearing: bool = False
    n_op_channel: int = 0
    scint_prescale: float = 1.0
    w_ph: float = 19.5e-6                   # MeV
    light_tick_size: float = 0.001          # us
    light_window: tuple[float, float] = (1.0, 10.0)
    sipm_response_model: int = 0
    light_det_noise_sample_spacing: float = 0.01
    impulse_tick_size: float = 0.001
    op_channel_per_trig: int = 6
    light_trig_mode: int = 0
    light_trig_window: tuple[float, float] = (0.9, 1.66)
    light_digit_sample_spacing: float = 0.01
    light_nbit: int = 10

    @property
    def device(self) -> torch.device:
        return self.op_channel_efficiency.device

    def replace(self, **changes) -> 'LightParams':
        return dataclasses.replace(self, **changes)


def _build(leaves: dict, host: dict, statics: dict, device) -> LightParams:
    tens = {k: torch.tensor(np.asarray(leaves[k]), dtype=dt, device=device)
            for k, dt in LEAVES.items()}
    return LightParams(host=host, **tens, **statics)


def from_numpy(leaves: dict, statics: dict, device='cuda') -> LightParams:
    """Build the port's light params from numpy leaves and static fields.

    ``leaves`` maps every name of :data:`LEAVES` to an array (as taken from
    the JAX ``LightParams``); ``statics`` maps the names of
    :data:`STATICS`.  The host copies are the float32 leaf values.
    """
    device = card_or(device, 'the light parameters')
    host = {k: float(np.asarray(leaves[k], np.float32)) for k in HOST_SCALARS}
    host['impulse_model'] = np.asarray(leaves['impulse_model'],
                                       np.float32).astype(np.float64)
    return _build(leaves, host, {k: statics[k] for k in STATICS}, device)


def load_light(detprop_file: str, asset_root: str | None = None,
               device='cuda') -> LightParams:
    """Build :class:`LightParams` from a detector-properties YAML, with
    every leaf on ``device`` (the card unless the caller names another).

    Falls back to ``light_simulated=False`` if the light keys are absent,
    matching the reference (consts/light.py:167-170).
    """
    device = card_or(device, 'the light parameters')
    with open(detprop_file) as df:
        detprop = yaml.load(df, Loader=_YamlLoader)

    try:
        n_op_channel = int(detprop['n_op_channel'])
        eff = np.array(detprop.get('op_channel_efficiency',
                                   np.ones(n_op_channel)))
        if eff.size == 1:
            eff = np.full(n_op_channel, eff.item())

        tpc_to_op = np.array(detprop['tpc_to_op_channel'], dtype=np.int32)
        op_to_tpc = np.zeros(n_op_channel, np.int32)
        for itpc, chans in enumerate(tpc_to_op):
            op_to_tpc[chans] = itpc

        light_gain = np.array(detprop.get('light_gain', [DEFAULT_LIGHT_GAIN]),
                              dtype=np.float64)
        if light_gain.size == 1:
            light_gain = np.full(n_op_channel, light_gain.item())

        sipm_model = int(detprop.get('sipm_response_model', 0))
        impulse = np.array([1.0, 0.0])
        impulse_file = str(detprop.get('impulse_model', ''))
        if impulse_file and sipm_model == 1:
            candidates = [impulse_file]
            if asset_root:
                candidates.append(os.path.join(asset_root, impulse_file))
                candidates.append(os.path.join(
                    asset_root, os.path.basename(impulse_file)))
            for cand in candidates:
                if os.path.isfile(cand):
                    impulse = np.load(cand)
                    break
            else:
                sipm_model = 0

        op_per_trig = int(detprop.get('op_channel_per_det', 6))
        thr = detprop['light_trig_threshold']
        if isinstance(thr, (int, float)):
            thr = np.full(n_op_channel // op_per_trig, float(thr))
        else:
            thr = np.array(thr, dtype=float)

        scalars = dict(
            singlet_fraction=float(detprop.get('singlet_fraction', 0.3)),
            tau_s=float(detprop.get('tau_s', 0.001)),
            tau_t=float(detprop.get('tau_t', 1.530)),
            light_response_time=float(
                detprop.get('light_response_time', 0.055)),
            light_oscillation_period=float(
                detprop.get('light_oscillation_period', 0.095)))
        leaves = dict(op_channel_efficiency=eff, op_channel_to_tpc=op_to_tpc,
                      tpc_to_op_channel=tpc_to_op, light_gain=light_gain,
                      light_trig_threshold=thr, impulse_model=impulse,
                      **scalars)
        host = dict(scalars, impulse_model=np.asarray(
            impulse, np.float32).astype(np.float64))
        statics = dict(
            light_simulated=bool(detprop.get('light_simulated', True)),
            enable_lut_smearing=bool(detprop.get('enable_lut_smearing',
                                                 False)),
            n_op_channel=n_op_channel,
            light_tick_size=float(detprop.get('light_tick_size', 0.001)),
            light_window=tuple(detprop.get('light_window', (1.0, 10.0))),
            sipm_response_model=sipm_model,
            light_det_noise_sample_spacing=float(
                detprop.get('light_det_noise_sample_spacing', 0.01)),
            impulse_tick_size=float(detprop.get('impulse_tick_size', 0.001)),
            op_channel_per_trig=op_per_trig,
            light_trig_mode=int(detprop.get('light_trig_mode', 0)),
            light_trig_window=tuple(detprop.get('light_trig_window',
                                                (0.9, 1.66))),
            light_digit_sample_spacing=float(
                detprop.get('light_digit_sample_spacing', 0.01)),
            light_nbit=int(detprop.get('light_nbit', 10)),
        )
        return _build(leaves, host, statics, device)
    except KeyError:
        scalars = dict(singlet_fraction=0.3, tau_s=0.001, tau_t=1.530,
                       light_response_time=0.055,
                       light_oscillation_period=0.095)
        impulse = np.array([1.0, 0.0])
        leaves = dict(op_channel_efficiency=np.ones(0),
                      op_channel_to_tpc=np.zeros(0),
                      tpc_to_op_channel=np.zeros((0, 0)),
                      light_gain=np.zeros(0), light_trig_threshold=np.zeros(0),
                      impulse_model=impulse, **scalars)
        host = dict(scalars, impulse_model=impulse)
        return _build(leaves, host, dict(
            light_simulated=False,
            light_trig_mode=int(detprop.get('light_trig_mode', 0))), device)
