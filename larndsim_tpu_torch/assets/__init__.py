"""Synthetic assets: response LUT and Module-0-shaped geometry."""
