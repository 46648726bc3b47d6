"""Which module the CLI's module loop runs, and what each module launched.

With module-to-module variation, ``cli.simulate_pixels.run_simulation``
runs the modules in turn, loading each one's detector model first
(``load_detector(..., i_module=m)``), or, with ``n_devices`` > 1, at once
on threads named ``module-{m}`` (their dispatch threads
``module-{m}-ctx{k}...``).  :func:`module_tracker` follows both, so that a
check on the card (``chip_smoke.py``'s ``mod2mod`` and ``ndev`` phases,
tests/test_torch_gpu.py) can count each module's kernel launches and keep
the inputs of a given module's first K1 / K2 call.
"""
from __future__ import annotations

import contextlib
import re
import threading
import time

_THREAD = re.compile(r'module-(\d+)')


@contextlib.contextmanager
def module_tracker(capture: bool = False):
    """Within the block, follows the CLI's module loop: ``t['module']`` is
    the module the loop runs in turn, ``t['launches'][m]`` each module's
    kernel launches (each counted by ``kernels.binding`` where it launches,
    and given to the module of the launching thread, or to the module run
    in turn), ``t['wall'][m]`` the seconds from a module thread's start
    (its ``load_detector``) to its last file write (submitted to its write
    gate: the module's last act) and, with ``capture``, ``t['k1'][m]`` /
    ``t['k2'][m]`` the arguments of each module's first K1 / K2 call."""
    from ..cli import simulate_pixels as cli
    from ..kernels import binding
    from ..ops import current, fee
    t = dict(module=None, launches={}, wall={}, k1={}, k2={})
    lock = threading.Lock()
    started = {}

    def module() -> int | None:
        m = _THREAD.match(threading.current_thread().name)
        return int(m.group(1)) if m else t['module']

    def table(m) -> dict:
        return t['launches'].setdefault(m, dict.fromkeys(binding.launches,
                                                         0))

    def load(*args, i_module=-1, **kwargs):
        if i_module > 0:
            with lock:
                table(i_module)
                if _THREAD.match(threading.current_thread().name):
                    started[i_module] = time.perf_counter()
                else:
                    t['module'] = i_module
        return orig_load(*args, i_module=i_module, **kwargs)

    def submit(gate, fn):
        m = _THREAD.match(threading.current_thread().name)
        if m and int(m.group(1)) in started:
            t['wall'][int(m.group(1))] = (time.perf_counter()
                                          - started[int(m.group(1))])
        return orig_submit(gate, fn)

    def count(name):
        orig_count(name)
        m = module()
        if m is not None:
            with lock:
                table(m)[name] += 1

    def keeping(fn, kept):
        def spy(*args):
            m = module()
            with lock:
                kept.setdefault(m, args)
            return fn(*args)
        return spy

    orig_load, orig_count = cli.load_detector, binding._count
    orig_submit = cli._WriteGate.submit
    orig_k1, orig_k2 = current.induced_current, fee.fee_fsm
    cli.load_detector = load
    binding._count = count
    cli._WriteGate.submit = submit
    if capture:
        current.induced_current = keeping(orig_k1, t['k1'])
        fee.fee_fsm = keeping(orig_k2, t['k2'])
    try:
        yield t
    finally:
        cli.load_detector = orig_load
        binding._count = orig_count
        cli._WriteGate.submit = orig_submit
        current.induced_current, fee.fee_fsm = orig_k1, orig_k2
