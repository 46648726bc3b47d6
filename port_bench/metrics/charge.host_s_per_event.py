"""Self wall seconds a spill of the charge chain's phases
(``charge_batch``, ``charge/*``: ``models/charge.py``, ``ops/``)."""


def _charge(label):
    return label == 'charge_batch' or label.startswith('charge/')


def read(win):
    if not win.events or not win.has_phase(_charge):
        return None
    return win.phase_s(_charge) / win.events
