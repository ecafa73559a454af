"""Qubit state container.

PyTorch counterpart of ``deepquantum_tpu/state.py``: a pure state (2^n, 1)
complex tensor on an explicit device, built from 'zeros', 'equal',
'ghz' (or 'entangle'/'GHZ') or an explicit array, which is
amplitude-encoded (truncated or zero-padded to 2^n, then normalised); a
2-D array (B, 2^n) gives a batch (B, 2^n, 1). With ``den_mat`` it holds
the density matrix |s><s| (2^n, 2^n) of such a state (a batch (B, 2^n,
2^n)), or a given (..., 2^n, 2^n) matrix as it is. ``kind`` keeps the name
of a named state (None for an array). An MPS is ``mps.MatrixProductState``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import cdtype, resolve_device
from .ops.qmath import amplitude_encoding

__all__ = ['QubitState']


class QubitState:
    """A pure state of ``nqubit`` qubits, shape (2^n, 1) or a batch
    (B, 2^n, 1), or with ``den_mat`` a density matrix (2^n, 2^n) or a batch
    of them."""

    def __init__(self, nqubit: int = 1, state: Any = 'zeros', den_mat: bool = False,
                 device=None) -> None:
        self.nqubit = nqubit
        self.den_mat = den_mat
        self.kind = state if isinstance(state, str) else None
        device = resolve_device(device)
        dim = 2 ** nqubit
        if isinstance(state, str):
            s = torch.zeros((dim, 1), dtype=cdtype(), device=device)
            if state == 'zeros':
                s[0, 0] = 1
            elif state == 'equal':
                s.fill_(dim ** -0.5)
            elif state in ('entangle', 'GHZ', 'ghz'):
                s[0, 0] = 2 ** -0.5
                s[-1, 0] = 2 ** -0.5
            else:
                raise ValueError(f'Unknown init state: {state}')
        else:
            data = state if torch.is_tensor(state) else torch.as_tensor(np.asarray(state))
            data = data.to(device=device, dtype=cdtype())
            if den_mat and data.dim() >= 2 and tuple(data.shape[-2:]) == (dim, dim):
                self.state = data
                return
            s = amplitude_encoding(data, nqubit)
        self.state = s @ s.mH if den_mat else s

    def to(self, dtype=None, device=None) -> 'QubitState':
        self.state = self.state.to(device=device, dtype=dtype)
        return self

    @property
    def shape(self):
        return self.state.shape
