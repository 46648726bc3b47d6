"""The card's idle share of the traced window, in percent: one minus the
union of its kernel, copy and set intervals over the window's length."""


def read(win):
    if not win.trace or win.trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - win.trace['busy_s'] / win.trace['window_s'])
