"""Simulation/batching options (host-side, all static).

Same YAML keys and defaults as the reference (consts/sim.py:12-94).
"""
from __future__ import annotations

import dataclasses

import yaml

try:
    _YamlLoader = yaml.CSafeLoader
except AttributeError:
    _YamlLoader = yaml.SafeLoader


@dataclasses.dataclass(frozen=True)
class SimParams:
    batch_size: int = 10_000          # track segments per device batch
    event_batch_size: int = 1         # TPCs per host batch
    write_batch_size: int = 1         # host batches per HDF5 flush
    event_separator: str = 'event_id'
    is_spill_sim: bool = True
    spill_period: float = 1.2e6       # us
    tracks_dset_name: str = 'segments'
    max_events_per_file: int = 1000
    max_tracks_per_pixel: int = 50
    min_step_size: float = 0.001      # cm
    mc_sample_multiplier: int = 1
    association_count_to_store: int = 20
    max_adc_values: int = 30
    max_mc_truth_ids: int = 0
    mc_truth_threshold: float = 0.1   # pe/us
    mod2mod_variation: bool = False
    #: bug-compatibility: reproduce the reference's ACTIVE multi-trigger
    #: light digitization (light_sim.py:498 ignores trigger_idx) instead
    #: of the intended per-trigger windows — enables byte-level golden
    #: comparison on mode-0 multi-trigger paths (PARITY.md)
    ref_exact_light_digitize: bool = False
    #: bug-compatibility: reproduce the reference's STAGED light-truth
    #: thresholding — per-(output tick, input tick) convolution increments
    #: below mc_truth_threshold are dropped inside the scintillation stage
    #: (light_sim.py:175, no abs) and the SiPM stage (light_sim.py:327,
    #: abs), and digitization skips samples whose left neighbor is below
    #: threshold (light_sim.py:528) — instead of thresholding each
    #: contributor's final convolved value once.  O(n_ticks * conv_ticks)
    #: per contributor: intended for golden-comparison runs at validation
    #: scale, not production
    ref_exact_truth_staging: bool = False


def load_sim(simprop_file: str) -> SimParams:
    with open(simprop_file) as df:
        simprop = yaml.load(df, Loader=_YamlLoader)
    d = SimParams()
    return SimParams(
        batch_size=int(simprop.get('batch_size', d.batch_size)),
        event_batch_size=int(simprop.get('event_batch_size', d.event_batch_size)),
        write_batch_size=int(simprop.get('write_batch_size', d.write_batch_size)),
        event_separator=simprop.get('event_separator', d.event_separator),
        is_spill_sim=bool(simprop.get('is_spill_sim', d.is_spill_sim)),
        spill_period=float(simprop.get('spill_period', d.spill_period)),
        tracks_dset_name=simprop.get('tracks_dset_name', d.tracks_dset_name),
        max_events_per_file=int(simprop.get('max_events_per_file', d.max_events_per_file)),
        max_tracks_per_pixel=int(simprop.get('max_tracks_per_pixel', d.max_tracks_per_pixel)),
        min_step_size=float(simprop.get('min_step_size', d.min_step_size)),
        mc_sample_multiplier=int(simprop.get('mc_sample_multiplier', d.mc_sample_multiplier)),
        association_count_to_store=int(
            simprop.get('association_count_to_store', d.association_count_to_store)),
        max_adc_values=int(simprop.get('max_adc_values', d.max_adc_values)),
        max_mc_truth_ids=int(simprop.get('max_light_truth_ids', d.max_mc_truth_ids)),
        mc_truth_threshold=float(simprop.get('mc_truth_threshold', d.mc_truth_threshold)),
        ref_exact_light_digitize=bool(
            simprop.get('ref_exact_light_digitize',
                        d.ref_exact_light_digitize)),
        ref_exact_truth_staging=bool(
            simprop.get('ref_exact_truth_staging',
                        d.ref_exact_truth_staging)),
    )
