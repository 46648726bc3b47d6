"""Geometry: tile layouts and TPC borders (host numpy)."""
