"""Self wall seconds a spill of the light truth outside its HDF5 writes:
every ``truth/*`` label but ``truth/h5`` (which ``io.s_per_event``
reads): ``truth/stage`` (the contributors' dense series and their product
with the transfer table, ``models/light.py``), ``truth/pull`` (the kept
records found on the card and copied to the host), ``truth/records``
(their assembly into ``light_wvfm_mc_assn`` records,
``cli/simulate_pixels.py``) and ``truth/drain`` (a module's last records
queued at its end); on the host route also ``truth/worker``, whose
threads overlap the calling one."""


def _truth(label):
    return label.startswith('truth/') and label != 'truth/h5'


def read(win):
    if not win.events or not win.has_phase(_truth):
        return None
    return win.phase_s(_truth) / win.events
