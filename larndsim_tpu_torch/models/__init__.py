"""Simulation pipelines."""
