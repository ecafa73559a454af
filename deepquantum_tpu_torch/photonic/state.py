"""Photonic state containers.

PyTorch counterpart of ``deepquantum_tpu/photonic/state.py``. ``FockState``
holds basis photon numbers (hashable, a dict key); ``GaussianState`` holds
(cov, mean) in xxpp ordering; ``BosonicState`` a weighted sum of Gaussians
(cov, complex mean, complex weight), with the cat, GKP and Fock
constructors and the tensor product ``combine_bosonic_states``. All keep
host numpy arrays in float64 / complex128, which a circuit moves to its
device when it runs. Dense Fock tensors (``basis=False``) wait for the
Fock slice.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .. import config

__all__ = ['FockState', 'GaussianState', 'BosonicState', 'CatState', 'GKPState', 'FockStateBosonic',
           'combine_bosonic_states']


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


def _vac_cov(nmode: int) -> np.ndarray:
    return np.eye(2 * nmode) * config.HBAR / (4 * config.KAPPA ** 2)


class BosonicState:
    """A weighted sum of Gaussian states: cov (1, ncomb, 2n, 2n) float64,
    mean (1, ncomb, 2n, 1) and weight (1, ncomb) complex128, in xxpp; 'vac'
    is the vacuum (one component)."""

    def __init__(self, state: Any = 'vac', nmode: int | None = None,
                 cutoff: int | None = None) -> None:
        if isinstance(state, str) and state == 'vac':
            if nmode is None:
                nmode = 1
            cov, mean, weight = _vac_cov(nmode), np.zeros((2 * nmode, 1)), np.ones(1)
        else:
            cov, mean, weight = (np.asarray(s) for s in state[:3])
            if nmode is None:
                nmode = cov.shape[-1] // 2
        weight = weight.reshape(1, -1).astype(np.complex128)
        cov = cov.reshape(-1, 2 * nmode, 2 * nmode).astype(np.float64)
        if cov.shape[0] == 1 and weight.shape[-1] > 1:      # one covariance for all components
            cov = np.repeat(cov, weight.shape[-1], axis=0)
        self.cov = cov.reshape(1, -1, 2 * nmode, 2 * nmode)
        self.mean = mean.reshape(1, -1, 2 * nmode, 1).astype(np.complex128)
        self.weight = weight
        self.nmode = nmode
        self.cutoff = 5 if cutoff is None else cutoff

    @property
    def ncomb(self) -> int:
        return self.weight.shape[-1]


def CatState(r: float = None, theta: float = None, p: int = 1,
             cutoff: int | None = None) -> BosonicState:
    """One-mode cat state |alpha> + e^(i pi p) |-alpha>, alpha = r e^(i theta),
    as four weighted Gaussians (arXiv:2103.05530 Sec. IV B)."""
    hbar, kappa = config.HBAR, config.KAPPA
    if r is None:
        r = float(np.random.rand())
    if theta is None:
        theta = float(np.random.rand() * 2 * np.pi)
    re, im = r * np.cos(theta), r * np.sin(theta)
    means = np.stack([np.array([re, im], dtype=complex), -np.array([re, im], dtype=complex),
                      1j * np.array([im, -re], dtype=complex),
                      -1j * np.array([im, -re], dtype=complex)]) * (hbar ** 0.5 / kappa)
    temp = np.exp(-2 * r ** 2)
    w0 = 0.5 / (1 + temp * np.cos(p * np.pi)) + 0j
    weights = np.array([w0, w0, np.exp(-1j * np.pi * p) * temp * w0,
                        np.exp(1j * np.pi * p) * temp * w0])
    covs = np.stack([_vac_cov(1)] * 4)
    return BosonicState([covs, means.reshape(4, 2, 1), weights], nmode=1, cutoff=cutoff or 5)


def _gkp_weight(k, l, theta, phi, epsilon):
    """c_(k, l)(theta, phi) of the finite-energy GKP state
    (arXiv:2103.05530 Eq. 43 / B1), for integer grids k, l."""
    k = k.astype(np.int64)
    l = l.astype(np.int64)
    k2, l2, k4, l4 = k % 2, l % 2, k % 4, l % 4
    ct, st = np.cos(theta), np.sin(theta)
    cases = [((k2 == 0) & (l2 == 0), 1.0), ((k4 == 0) & (l2 == 1), ct),
             ((k4 == 2) & (l2 == 1), -ct), ((k4 == 3) & (l4 == 0), st * np.cos(phi)),
             ((k4 == 1) & (l4 == 0), st * np.cos(phi)), ((k4 == 3) & (l4 == 2), -st * np.cos(phi)),
             ((k4 == 1) & (l4 == 2), -st * np.cos(phi)), ((k4 == 3) & (l4 == 3), -st * np.sin(phi)),
             ((k4 == 1) & (l4 == 1), -st * np.sin(phi)), ((k4 == 3) & (l4 == 1), st * np.sin(phi)),
             ((k4 == 1) & (l4 == 3), st * np.sin(phi))]
    result = np.zeros(len(k))
    for mask, value in cases:
        result[mask] = value
    exp_eps = np.exp(-2 * epsilon)
    return result * np.exp(-0.25 * np.pi * (l ** 2 + k ** 2) * (1 - exp_eps) / (1 + exp_eps))


def GKPState(theta: float = None, phi: float = None, amp_cutoff: float = 0.1,
             epsilon: float = 0.05, cutoff: int | None = None) -> BosonicState:
    """Finite-energy one-mode GKP state cos(theta / 2) |0> + e^(-i phi)
    sin(theta / 2) |1>: the grid's Gaussians whose |weight| exceeds
    ``amp_cutoff``."""
    hbar, kappa = config.HBAR, config.KAPPA
    if theta is None:
        theta = float(np.random.rand() * 2 * np.pi)
    if phi is None:
        phi = float(np.random.rand() * 2 * np.pi)
    exp_eps = np.exp(-2 * epsilon)
    z_max = int(np.ceil(np.sqrt(-4 / np.pi * np.log(amp_cutoff) * (1 + exp_eps) / (1 - exp_eps))))
    coords = np.arange(-z_max, z_max + 1)
    gx, gy = np.meshgrid(coords, coords, indexing='ij')
    means = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1).astype(np.float64)
    weights = _gkp_weight(means[:, 0], means[:, 1], theta, phi, epsilon)
    keep = np.abs(weights) > amp_cutoff
    weights = weights[keep].astype(complex)
    weights = weights / weights.sum()
    means = means[keep] * np.exp(-epsilon) / (1 + exp_eps) * (np.pi * hbar / 2) ** 0.5 / kappa + 0j
    covs = np.stack([_vac_cov(1) * (1 - exp_eps) / (1 + exp_eps)] * len(weights))
    return BosonicState([covs, means.reshape(-1, 2, 1), weights], nmode=1, cutoff=cutoff or 5)


def combine_bosonic_states(states: list, cutoff: int | None = None) -> BosonicState:
    """Tensor product of Bosonic states over the cartesian product of their
    components (the first state's index slowest): block-diagonal
    covariances and stacked means in xxpp, the Kronecker product of the
    weights. Built by broadcasting, one placement per state, not a loop
    over the product."""
    if cutoff is None:
        cutoff = states[0].cutoff
    nmode = sum(s.nmode for s in states)
    ncombs = [s.ncomb for s in states]
    total = int(np.prod(ncombs))
    # the component index of each state in every combination, itertools.product order
    picks = np.unravel_index(np.arange(total), ncombs)
    cov = np.zeros((total, 2 * nmode, 2 * nmode))
    mean = np.zeros((total, 2 * nmode, 1), dtype=np.complex128)
    weight = np.ones(total, dtype=np.complex128)
    off = 0
    for s, pick in zip(states, picks):
        k = s.nmode
        idx = np.concatenate([np.arange(off, off + k), nmode + np.arange(off, off + k)])
        cov[:, idx[:, None], idx[None, :]] = s.cov[0][pick]
        mean[:, idx] = s.mean[0][pick]
        weight = weight * s.weight[0][pick]
        off += k
    return BosonicState([cov, mean, weight], nmode, cutoff)


def FockStateBosonic(n: int, r: float = 0.05, cutoff: int | None = None) -> BosonicState:
    """One-mode Fock state |n> as a combination of n + 1 centred Gaussians
    (arXiv:2103.05530 Sec. IV C); r^2 < 1 / n."""
    from scipy.special import comb
    if not r ** 2 < 1 / n:
        raise ValueError('FockStateBosonic: r^2 >= 1 / n is not a physical state')
    m = np.arange(n + 1)
    weight = (1 - n * r ** 2) / (1 - (n - m) * r ** 2) * comb(n, m) * (-1.0) ** (n - m)
    weight = (weight / weight.sum()).astype(complex)
    mean = np.zeros((n + 1, 2, 1), dtype=complex)
    cov = _vac_cov(1)[None] * ((1 + (n - m) * r ** 2) / (1 - (n - m) * r ** 2)).reshape(-1, 1, 1)
    return BosonicState([cov, mean, weight], 1, n + 1 if cutoff is None else cutoff)
