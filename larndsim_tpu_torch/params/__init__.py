"""Configuration objects: detector params (tensors), sim options, physics."""
from . import physics
from .detector import (DEFAULT_PLANE_INDEX, DetectorModel, DetectorParams,
                       from_numpy, get_module_ids, load_detector)
from .sim import SimParams, load_sim

__all__ = [
    'physics', 'DEFAULT_PLANE_INDEX', 'DetectorModel', 'DetectorParams',
    'from_numpy', 'get_module_ids', 'load_detector', 'SimParams',
    'load_sim',
]
