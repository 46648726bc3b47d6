"""The physics constants that the frozen response writer reads."""
