"""Configuration registry: keyword -> bundle of property/asset files.

A copy of ``larndsim_tpu.config`` (the same keywords and file bundles,
tests/test_torch_host.py holds the two equal), so that the port runs
without the JAX package.  Bare filenames resolve against an asset root (a
larnd-sim source tree): the ``LARNDSIM_ASSETS`` environment variable, else
``<repo>/assets_data``.  Absolute paths and paths containing '/' are used
as they are (reference config/config.py:55-67).
"""
from __future__ import annotations

import os
import pathlib

_REPO_ROOT = pathlib.Path(__file__).parents[2]

# keyword -> category -> filename(s).  Mirrors config/config.yaml.
CONFIG_MAP: dict[str, dict] = {
    'module0': dict(
        SIM_PROPERTIES='singles_sim_mod2mod_variation.yaml',
        PIXEL_LAYOUT='multi_tile_layout-2.3.16.yaml',
        DET_PROPERTIES='module0.yaml',
        RESPONSE='response_44.npy',
        LIGHT_LUT='lightLUT_Mod0_06052024_time_norm.npz',
        LIGHT_DET_NOISE='light_noise-module0.npy',
        LIGHT_SIMULATED=True,
    ),
    '2x2_no_modvar': dict(
        SIM_PROPERTIES='2x2_NuMI_sim_no_modvar.yaml',
        DET_PROPERTIES='2x2_no_modvar.yaml',
        PIXEL_LAYOUT='multi_tile_layout-2.4.16.yaml',
        RESPONSE='response_44.npy',
        LIGHT_LUT='lightLUT_Mod123_06052024_time_norm.npz',
        LIGHT_DET_NOISE='4Mod_LNoise_Mod1_2fftx192_MR5-ish.npy',
        LIGHT_SIMULATED=True,
        MOD2MOD_VARIATION=False,
    ),
    'ndlar': dict(
        SIM_PROPERTIES='NDLAr_LBNF_sim.yaml',
        PIXEL_LAYOUT='multi_tile_layout-3.0.40.yaml',
        DET_PROPERTIES='ndlar-module.yaml',
        RESPONSE='response_38.npy',
        LIGHT_SIMULATED=False,
        LIGHT_LUT='',
        LIGHT_DET_NOISE='',
    ),
}

# Derived 2x2 variants (anchor/override structure as in config.yaml)
CONFIG_MAP['2x2_mpvmpr_no_modvar'] = {
    **CONFIG_MAP['2x2_no_modvar'], 'SIM_PROPERTIES': 'singles_sim_no_modvar.yaml'}
CONFIG_MAP['2x2_non_beam_no_modvar'] = {
    **CONFIG_MAP['2x2_mpvmpr_no_modvar'],
    'DET_PROPERTIES': '2x2_non_beam_no_modvar.yaml'}
CONFIG_MAP['2x2'] = {
    **CONFIG_MAP['2x2_no_modvar'],
    'SIM_PROPERTIES': '2x2_NuMI_sim.yaml',
    'DET_PROPERTIES': '2x2.yaml',
    'PIXEL_LAYOUT': ['multi_tile_layout-2.4.16.yaml', 'multi_tile_layout-2.5.16.yaml'],
    'PIXEL_LAYOUT_ID': [0, 0, 1, 0],
    'RESPONSE': ['response_44_v2a_50ns.npy', 'response_38_v2b_50ns.npy'],
    'RESPONSE_ID': [0, 0, 1, 0],
    'LIGHT_LUT': ['lightLUT_Mod0_06052024_time_norm.npz',
                  'lightLUT_Mod123_06052024_time_norm.npz'],
    'LIGHT_LUT_ID': [0, 1, 1, 1],
    'MOD2MOD_VARIATION': True,
}
CONFIG_MAP['2x2_old_response'] = {
    **CONFIG_MAP['2x2'],
    'DET_PROPERTIES': '2x2_old_response.yaml',
    'RESPONSE': ['response_44.npy', 'response_38.npy'],
}
CONFIG_MAP['2x2_mpvmpr'] = {**CONFIG_MAP['2x2'],
                            'SIM_PROPERTIES': 'singles_sim.yaml'}
CONFIG_MAP['2x2_mpvmpr_old_response'] = {**CONFIG_MAP['2x2_old_response'],
                                         'SIM_PROPERTIES': 'singles_sim.yaml'}

_CATEGORY_DIRS = dict(
    SIM_PROPERTIES='simulation_properties',
    PIXEL_LAYOUT='pixel_layouts',
    DET_PROPERTIES='detector_properties',
    RESPONSE='bin',
    LIGHT_LUT='bin',
    LIGHT_DET_NOISE='bin',
)


def asset_root() -> str | None:
    """Locate a larnd-sim asset tree (YAMLs + binary LUTs)."""
    env = os.environ.get('LARNDSIM_ASSETS')
    if env and os.path.isdir(env):
        return env
    local = _REPO_ROOT / 'assets_data'
    return str(local) if local.is_dir() else None


def list_config_keys():
    return CONFIG_MAP.keys()


def _resolve_one(category: str, name: str) -> str:
    if not name or '/' in name:
        return name
    root = asset_root()
    if root is None:
        return name
    cand = os.path.join(root, _CATEGORY_DIRS.get(category, ''), name)
    if os.path.exists(cand):
        return cand
    # fall back to a flat asset dir
    flat = os.path.join(root, name)
    return flat if os.path.exists(flat) else cand


def get_config(keyword: str) -> dict:
    """Resolve a config keyword into a dict of concrete file paths."""
    if keyword not in CONFIG_MAP:
        raise KeyError(
            f'Key {keyword} not in supported keywords {list(CONFIG_MAP)}')
    out = {}
    for key, val in CONFIG_MAP[keyword].items():
        if key not in _CATEGORY_DIRS:
            out[key] = val
        elif isinstance(val, list):
            out[key] = [_resolve_one(key, v) for v in val]
        else:
            out[key] = _resolve_one(key, val)
    return out
