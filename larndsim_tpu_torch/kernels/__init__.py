"""Build and ctypes binding of the CUDA kernels in ``csrc/``.

Nothing here runs at import: :func:`build.load` compiles the sources
with nvcc at first use.
"""
