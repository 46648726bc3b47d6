"""Which module the CLI's module loop runs, and what each module launched.

With module-to-module variation, ``cli.simulate_pixels.run_simulation``
runs the modules in turn, loading each one's detector model first
(``load_detector(..., i_module=m)``).  :func:`module_tracker` follows those
calls, so that a check on the card (``chip_smoke.py``'s ``mod2mod`` phase,
tests/test_torch_gpu.py) can count each module's kernel launches and keep
the inputs of a given module's first K1 / K2 call.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def module_tracker(capture: bool = False):
    """Within the block, follows the CLI's module loop: ``t['module']`` is
    the module being run, ``t['launches'][m]`` each module's kernel
    launches (``kernels.binding.launches`` counted from its start) and,
    with ``capture``, ``t['k1'][m]`` / ``t['k2'][m]`` the arguments of
    each module's first K1 / K2 call."""
    from ..cli import simulate_pixels as cli
    from ..kernels import binding
    from ..ops import current, fee
    t = dict(module=None, launches={}, start={}, k1={}, k2={})

    def close():
        if t['module'] is not None:
            t['launches'][t['module']] = {
                k: v - t['start'].get(k, 0)
                for k, v in binding.launches.items()}

    def load(*args, i_module=-1, **kwargs):
        if i_module > 0:
            close()
            t['module'], t['start'] = i_module, dict(binding.launches)
        return orig_load(*args, i_module=i_module, **kwargs)

    def keeping(fn, table):
        def spy(*args):
            table.setdefault(t['module'], args)
            return fn(*args)
        return spy

    orig_load = cli.load_detector
    orig_k1, orig_k2 = current.induced_current, fee.fee_fsm
    cli.load_detector = load
    if capture:
        current.induced_current = keeping(orig_k1, t['k1'])
        fee.fee_fsm = keeping(orig_k2, t['k2'])
    try:
        yield t
        close()
    finally:
        cli.load_detector = orig_load
        current.induced_current, fee.fee_fsm = orig_k1, orig_k2
