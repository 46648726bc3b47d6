"""Self wall seconds a spill of the CLI's input work (``cli/input``: the
edep-sim file read, the event times, the active volume; and each module's
``cli/quench_drift``: ``cli/simulate_pixels.py``)."""

LABELS = ('cli/input', 'cli/quench_drift')


def read(win):
    if not win.events or not win.has_phase(lambda label: label in LABELS):
        return None
    return win.phase_s(lambda label: label in LABELS) / win.events
