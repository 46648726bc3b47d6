"""Self wall seconds a spill of the HDF5 output (``export``,
``export/flush``, ``truth/h5``: ``io/export.py``, ``io/h5.py``,
``io/lzf.py``)."""

LABELS = ('export', 'export/flush', 'truth/h5')


def read(win):
    if not win.events or not win.has_phase(lambda label: label in LABELS):
        return None
    return win.phase_s(lambda label: label in LABELS) / win.events
