"""Configuration objects: detector and light params (tensors), sim options,
physics."""
from . import physics
from .detector import (DEFAULT_PLANE_INDEX, DetectorFiles, DetectorModel,
                       DetectorParams, from_numpy, get_module_ids,
                       load_detector)
from .light import LightParams, load_light
from .sim import SimParams, load_sim

__all__ = [
    'physics', 'DEFAULT_PLANE_INDEX', 'DetectorFiles', 'DetectorModel',
    'DetectorParams', 'from_numpy', 'get_module_ids', 'load_detector',
    'LightParams', 'load_light', 'SimParams', 'load_sim',
]
