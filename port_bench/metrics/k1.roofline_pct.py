"""K1's share of its roofline, in percent: the summed least time of every
launch in the window (``costs.k1_costs``: bytes over 3.35 TB/s or float32
operations over 67 TFLOP/s, the larger) over the summed device time of
``induced_current_kernel`` in the profiler's trace."""

KERNEL = 'induced_current_kernel'


def read(win):
    if not win.bound_s or not win.bound_s['k1_launches']:
        return None
    device_s = win.kernel_s(KERNEL)
    if device_s <= 0:
        return None
    return 100.0 * win.bound_s['k1'] / device_s
