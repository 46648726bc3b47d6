"""Frozen copies of what the benchmark takes from the port's files: the
HDF5 reader and writer (with the LZF codec it loads, built into
``build/`` beside it) and the stand-in asset writers.  They import
nothing of the port, so a later change to the port cannot move the
benchmark's inputs or the way it reads the outputs.
"""
