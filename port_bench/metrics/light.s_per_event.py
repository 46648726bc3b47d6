"""Self wall seconds a spill of the light chain: ``light_batch`` and every
``light/*`` label (the incidence and each batch's rows, the signal, the
digitisation and the waveforms' copy to the host: ``models/light.py``,
``ops/light.py`` and the CLI's light calls)."""


def _light(label):
    return label == 'light_batch' or label.startswith('light/')


def read(win):
    if not win.events or not win.has_phase(_light):
        return None
    return win.phase_s(_light) / win.events
