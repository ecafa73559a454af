"""Photonic state containers.

PyTorch counterpart of ``deepquantum_tpu/photonic/state.py``. ``FockState``
holds basis photon numbers (hashable, a dict key); ``GaussianState`` holds
(cov, mean) in xxpp ordering. Both keep host numpy arrays, which a circuit
moves to its device when it runs. Dense Fock tensors (``basis=False``),
``BosonicState`` and the cat / GKP constructors are not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import config

__all__ = ['FockState', 'GaussianState']


class FockState:
    """A Fock basis state: one photon number per mode."""

    def __init__(self, state: Any, nmode: int | None = None, cutoff: int | None = None,
                 basis: bool = True, den_mat: bool = False) -> None:
        if not basis or den_mat:
            raise NotImplementedError('FockState: dense Fock tensors (basis=False) and density '
                                      'matrices are not ported yet; basis mode only')
        self.basis = True
        self.den_mat = False
        if isinstance(state, FockState):
            state = state.state
        state = np.asarray(state, dtype=np.int64).reshape(-1)
        if nmode is None:
            nmode = len(state)
        if len(state) < nmode:
            state = np.concatenate([np.zeros(nmode - len(state), dtype=np.int64), state])
        state = state[:nmode]
        if cutoff is None:
            cutoff = int(state.sum()) + 1
        self.state = state
        self.nmode = nmode
        self.cutoff = cutoff

    def __hash__(self):
        return hash(tuple(self.state.tolist()))

    def __eq__(self, other):
        if not isinstance(other, FockState):
            return NotImplemented
        return self.nmode == other.nmode and list(self.state) == list(other.state)

    def __repr__(self):
        return '|' + ''.join(str(int(i)) for i in self.state) + '>'

    __str__ = __repr__


class GaussianState:
    """Gaussian state: covariance (batch, 2n, 2n) and mean (batch, 2n, 1) in
    xxpp, float64 on the host; 'vac' is the vacuum."""

    def __init__(self, state: Any = 'vac', nmode: int | None = None,
                 cutoff: int | None = None) -> None:
        if isinstance(state, str) and state == 'vac':
            if nmode is None:
                nmode = 1
            cov = np.eye(2 * nmode) * config.HBAR / (4 * config.KAPPA ** 2)
            mean = np.zeros((2 * nmode, 1))
        else:
            cov = np.asarray(state[0], dtype=np.float64)
            mean = np.asarray(state[1], dtype=np.float64)
            if nmode is None:
                nmode = cov.shape[-1] // 2
        self.cov = cov.reshape(-1, 2 * nmode, 2 * nmode)
        self.mean = mean.reshape(-1, 2 * nmode, 1)
        self.nmode = nmode
        self.cutoff = 5 if cutoff is None else cutoff

    def check_purity(self, rtol: float = 3e-4, atol: float = 3e-4) -> bool:
        """Purity from the log-determinant of the scaled covariance."""
        sign, log_det = np.linalg.slogdet(4 * config.KAPPA ** 2 / config.HBAR * self.cov)
        return bool((sign > 0).all() and np.allclose(log_det, 0, rtol=rtol, atol=atol))

    @property
    def is_pure(self) -> bool:
        return self.check_purity()
