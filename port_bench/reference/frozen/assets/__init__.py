"""Synthetic assets: response LUT, light LUT and noise, Module-0-shaped
geometry."""
