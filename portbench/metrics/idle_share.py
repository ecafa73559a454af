"""``idle_share.<kind>``: the share of the traced window, in %, in which no
operation ran on the device."""


def read(trace, name):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
