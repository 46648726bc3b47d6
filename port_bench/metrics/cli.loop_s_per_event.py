"""Self wall seconds a spill of the CLI's batch loop around the charge
chain (``cli/batching``: the batcher and each (event, TPC group) mask,
``utils/batching.py``; ``cli/segments``: a charge call's segments;
``cli/accumulate``: its rows decoded and accumulated)."""

LABELS = ('cli/batching', 'cli/segments', 'cli/accumulate')


def read(win):
    if not win.events or not win.has_phase(lambda label: label in LABELS):
        return None
    return win.phase_s(lambda label: label in LABELS) / win.events
