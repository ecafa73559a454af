"""``kernels_roofline.<kind>``: the port's kernels' share of their roofline,
in %: the sum of each launch's least time (``portbench/counts``) over the
sum of their device times in the trace. Launches that the counts cannot
size are left out (named on standard error)."""


def read(trace, name):
    device_s = sum(sec for _, _, sec in trace.port)
    if not trace.port or trace.least_s is None or device_s <= 0:
        return None
    return 100.0 * trace.least_s / device_s
