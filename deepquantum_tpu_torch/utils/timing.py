"""Wall-clock timing helpers.

PyTorch counterpart of ``deepquantum_tpu/utils/timing.py``. CUDA work is
asynchronous, so where the process has started CUDA the clock is read
after a ``torch.cuda.synchronize``: the time then covers the work the call
queued on the card, not only its launches.
"""

from __future__ import annotations

import time
from functools import wraps

import torch

__all__ = ['record_time', 'Time']


def _now() -> float:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def record_time(func):
    """Decorator printing the wall-clock time of each call."""
    @wraps(func)
    def wrapper(*args, **kwargs):
        t0 = _now()
        out = func(*args, **kwargs)
        print(f'{func.__name__}: {_now() - t0:.6f}s')
        return out
    return wrapper


class Time:
    """Context manager printing the elapsed wall-clock time (``elapsed``, in
    seconds, stays on the object)."""

    def __init__(self, name: str = ''):
        self.name = name

    def __enter__(self):
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        self.elapsed = _now() - self.t0
        print(f'{self.name}: {self.elapsed:.6f}s')
