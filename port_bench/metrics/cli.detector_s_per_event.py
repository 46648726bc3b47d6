"""Self wall seconds a spill of the CLI's detector models (``cli/detector``:
the first layout's geometry, and each module's ``load_detector``, response,
pixel tables and dispatch contexts: ``cli/simulate_pixels.py``,
``params/``, ``assets/``)."""

LABEL = 'cli/detector'


def read(win):
    if not win.events or not win.has_phase(lambda label: label == LABEL):
        return None
    return win.phase_s(lambda label: label == LABEL) / win.events
