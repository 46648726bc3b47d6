"""larndsim_tpu_torch: the charge and light chains of larndsim_tpu in PyTorch.

Port of the JAX package ``larndsim_tpu`` to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (``csrc/``).  The package imports torch and
numpy, never jax; the JAX package stays the reference it is tested
against (``tests/test_torch_*.py``).
"""

__version__ = '0.1.0'
