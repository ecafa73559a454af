"""Photonic utilities (reference src/deepquantum/photonic/utils.py): sample
files, the permanent's chunk size, and the quadrature conventions."""

from __future__ import annotations

import pickle

from ..config import set_hbar, set_kappa

__all__ = ['set_hbar', 'set_kappa', 'save_sample', 'load_sample', 'mem_to_chunksize',
           'set_perm_chunksize']

_PERM_CHUNKSIZE = {}


def save_sample(sample: dict, filename: str) -> None:
    """Write measurement samples (keys by their repr) to a pickle file
    (reference photonic/utils.py:23)."""
    with open(filename, 'wb') as f:
        pickle.dump({repr(k): v for k, v in sample.items()}, f)


def load_sample(filename: str) -> dict:
    """Read samples written by ``save_sample`` (reference photonic/utils.py:36)."""
    with open(filename, 'rb') as f:
        return pickle.load(f)


def mem_to_chunksize(device: str = 'cuda', dtype=None) -> int:
    """The permanent's subset-chunk size recorded for (device, dtype) by
    ``set_perm_chunksize``, 2^16 by default (reference photonic/utils.py:49)."""
    return _PERM_CHUNKSIZE.get((device, dtype), 1 << 16)


def set_perm_chunksize(device: str, dtype, size: int) -> None:
    """Record a permanent chunk size for (device, dtype) (reference
    photonic/utils.py:98), kept for the JAX package's API: only
    ``mem_to_chunksize`` reads it, and it changes nothing the port
    computes. The knob that the permanent's Ryser twin reads is
    ``photonic.qmath.set_perm_chunksize(nmode, chunksize)``."""
    _PERM_CHUNKSIZE[(device, dtype)] = size
