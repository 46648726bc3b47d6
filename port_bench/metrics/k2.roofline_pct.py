"""K2's share of its roofline, in percent: the summed least time of every
launch in the window (``costs.fsm_costs``) over the summed device time of
``fee_fsm_kernel`` in the profiler's trace."""

KERNEL = 'fee_fsm_kernel'


def read(win):
    if not win.bound_s or not win.bound_s['k2_launches']:
        return None
    device_s = win.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    return 100.0 * win.bound_s['k2'] / device_s
