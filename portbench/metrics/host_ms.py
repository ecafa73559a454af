"""``host_ms.<kind>``: host milliseconds per call in the calls into the port
(a training step's forward and backward, an evaluation's call), each begun
on an empty queue: the benchmark's own spans."""


def read(trace, name):
    if not trace.host_s:
        return None
    return sum(trace.host_s) / len(trace.host_s) * 1e3
