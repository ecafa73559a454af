"""``mfu.<kind>``: the whole call's share of the card's float32 peak, in %:
the operations of the circuit as written (``portbench/counts``; a training
step counts three forwards) over the traced calls' wall time times 67
TFLOP/s. It reads the same work whatever implements it."""

from portbench import yardstick


def read(trace, name):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * trace.ops_per_call * trace.calls / trace.window_s / yardstick.PEAK_FP32_S
