"""Seconds a spill of the calls' wall that no phase of the port covers:
the CLI's per-file loading, planning, batching and module loop
(``cli/simulate_pixels.py``), and whatever no phase times."""


def read(win):
    if not win.events:
        return None
    return (win.wall_s - win.phase_s(lambda label: True)) / win.events
