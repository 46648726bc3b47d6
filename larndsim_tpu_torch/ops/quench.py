"""Recombination (quenching): dE/dEdx -> electrons and photons.

Counterpart of ``larndsim_tpu.ops.quench`` (reference quenching.py:11-44):
Box model (Baller 2013 JINST 8 P08005) or Birks model (Amoruso et al NIM A
523 (2004) 275), elementwise over the segment batch.
"""
from __future__ import annotations

import torch

from ..params import physics
from ..params.detector import DetectorParams
from ..segments import Segments
from .f32 import div


def quench(segs: Segments, det: DetectorParams, mode: int,
           w_ph: float = 19.5e-6, scint_prescale: float = 1.0) -> Segments:
    """Apply recombination and compute the photon yield.

    Args:
        mode: ``physics.BOX`` or ``physics.BIRKS``.
        w_ph: ion+excitation work function [MeV] (consts/light.py:20).
        scint_prescale: scintillation prescale (consts/light.py:18).
    """
    lar_density = 1.38  # g/cm^3 (consts/detector.py:19)
    dEdx = segs.dEdx
    dE = segs.dE

    if mode == physics.BOX:
        csi = physics.BOX_BETA * dEdx / (det.e_field * lar_density)
        # log(alpha + csi)/csi, clamped at 0; the csi->0 limit is
        # log(alpha) < 0 so the clamp also covers the 0/0 case
        recomb = torch.clamp(torch.log(physics.BOX_ALPHA + csi)
                             / torch.where(csi == 0, 1.0, csi), min=0.0)
        recomb = torch.where(csi == 0, 0.0, recomb)
    elif mode == physics.BIRKS:
        recomb = physics.BIRKS_Ab / (1 + physics.BIRKS_kb * dEdx
                                     / (det.e_field * lar_density))
    else:
        raise ValueError('mode must be physics.BOX or physics.BIRKS')

    n_electrons = div(recomb * dE, physics.W_ION)
    n_photons = (div(dE, w_ph) - n_electrons) * scint_prescale
    return segs.replace(n_electrons=n_electrons.float(),
                        n_photons=n_photons.float())
