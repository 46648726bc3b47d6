"""Self wall seconds a spill of the whole HDF5 output: ``export`` and every
``export/*`` label (the flushes, the sync and timestamp packets, the final
datasets and the close) and ``truth/h5`` (``io/export.py``, ``io/h5.py``,
``io/lzf.py``)."""


def _output(label):
    return label in ('export', 'truth/h5') or label.startswith('export/')


def read(win):
    if not win.events or not win.has_phase(_output):
        return None
    return win.phase_s(_output) / win.events
