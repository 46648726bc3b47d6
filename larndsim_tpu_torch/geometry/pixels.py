"""Pixel-id codecs.

A copy of ``larndsim_tpu.geometry.pixels``, so that the port runs without
the JAX package (tests/test_torch_host.py holds the two equal).  Linear
pixel id = x + Nx * (y + Ny * plane), the reference encoding
(pixels_from_track.py:13-41), so that output files and threshold / gain
npz keys are interchangeable.  Works on numpy arrays and torch tensors.
"""
from __future__ import annotations


def pixel2id(pixel_x, pixel_y, pixel_plane, n_pixels: tuple[int, int]):
    """Encode (x, y, plane) -> linear id."""
    return pixel_x + n_pixels[0] * (pixel_y + n_pixels[1] * pixel_plane)


def id2pixel(pid, n_pixels: tuple[int, int]):
    """Decode linear id -> (x, y, plane)."""
    nx, ny = n_pixels
    return pid % nx, (pid // nx) % ny, pid // (nx * ny)
