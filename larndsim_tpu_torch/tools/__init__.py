"""Measurement entry points of the port, each run as
``python -m larndsim_tpu_torch.tools.<name>``: the per-op guard
(``perf_guard``) and the card probes of the two kernels (``probe_folded``
of the induced-current kernel's windowing; ``probe_fee`` and ``probe_fee2``
of the FEE FSM's tick loop)."""
