"""``torch_dev_ms.<kind>``: device milliseconds per call of everything that
is not one of the port's kernels: plain torch kernels (relabels, gate
matrices, the linear layer, the loss, Adam), copies and fills."""

from portbench import yardstick


def read(trace, name):
    if not trace.device:
        return None
    other = sum(sec for op, sec in trace.device if yardstick.port_kernel(op) is None)
    return other / trace.calls * 1e3
