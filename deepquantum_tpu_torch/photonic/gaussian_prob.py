"""Fock-basis probabilities of Gaussian states (hafnian / torontonian path).

PyTorch counterpart of ``deepquantum_tpu/photonic/gaussian_prob.py``: the
Q-function matrices from (cov, mean) in the ladder representation, then per
final state a sub-matrix hafnian (``pnrd``) or torontonian (``threshold``).
Each outcome is one call, so a full table issues one small launch sequence
per outcome.
"""

from __future__ import annotations

import itertools
from math import factorial

import numpy as np
import torch

from ..config import cdtype
from .hafnian_ import hafnian
from .qmath import fock_combinations, quadrature_to_ladder
from .state import GaussianState
from .torontonian_ import torontonian

__all__ = ['fock_probs_gaussian', 'probs_gaussian_helper']


def _q_mats(cov, mean):
    nmode = cov.shape[-1] // 2
    eye = torch.eye(2 * nmode, dtype=cdtype(), device=cov.device)
    cov_ladder = quadrature_to_ladder(cov)
    mean_ladder = quadrature_to_ladder(mean)
    q = cov_ladder + eye / 2
    q_inv = torch.linalg.inv(q)
    det_q = torch.linalg.det(q)
    x_mat = eye.reshape(2, nmode, 2 * nmode).flip(0).reshape(2 * nmode, 2 * nmode)
    o_mat = eye - q_inv
    a_mat = x_mat @ o_mat
    gamma = (mean_ladder.conj().mT @ q_inv).reshape(-1)
    p_vac = torch.exp(-0.5 * (mean_ladder.conj().mT @ q_inv @ mean_ladder).reshape(())) \
        / torch.sqrt(det_q)
    return a_mat, o_mat, gamma, p_vac


def _prob_one_state(final_state, a_mat, o_mat, gamma, p_vac, detector, purity, loop):
    """Probability of one Fock basis outcome; the shapes follow the state."""
    nmode = len(final_state)
    fs = np.asarray(final_state, np.int64)
    idx_half = np.repeat(np.arange(nmode), fs)
    idx_double = np.concatenate([idx_half, idx_half + nmode])
    if detector == 'pnrd':
        sub_gamma = gamma[idx_double]
        if purity:
            sub_mat = a_mat[:nmode, :nmode][idx_half[:, None], idx_half[None, :]]
            sub_gamma = sub_gamma[: len(idx_half)]
        else:
            sub_mat = a_mat[idx_double[:, None], idx_double[None, :]]
        n = len(sub_gamma)
        if n == 1:
            sub_mat = sub_gamma.reshape(1, 1)
        else:
            sub_mat = sub_mat - torch.diag(torch.diagonal(sub_mat)) + torch.diag(sub_gamma)
        haf = hafnian(sub_mat, loop=loop)
        if purity:
            haf = haf.abs() ** 2
        norm = float(np.prod([factorial(int(x)) for x in fs]))
        prob = p_vac * haf / norm
    else:  # threshold
        sub_mat = o_mat[idx_double[:, None], idx_double[None, :]]
        # an undisplaced state (loop is a host-side fact) takes the
        # click-probability torontonian, without the augmented solve
        sub_gamma = gamma[idx_double] if loop else None
        prob = p_vac * torontonian(sub_mat, sub_gamma)
    return prob.real.abs()


def probs_gaussian_helper(final_states, cov, mean, detector='pnrd', purity=None, loop=None):
    """Probabilities of the given final states for one (cov, mean), stacked."""
    if purity is None or loop is None:
        mean_np = mean.detach().cpu().numpy()
        if purity is None:
            purity = GaussianState([cov.detach().cpu().numpy(), mean_np]).is_pure
        if loop is None:
            loop = bool(np.any(mean_np != 0))
    a_mat, o_mat, gamma, p_vac = _q_mats(cov, mean)
    return torch.stack([_prob_one_state(fs, a_mat, o_mat, gamma, p_vac, detector, bool(purity),
                                        bool(loop)) for fs in final_states])


def fock_probs_gaussian(cov, mean, cutoff: int, detector: str = 'pnrd'):
    """All-outcome probabilities of (cov, mean) tensors.

    pnrd: every Fock state with per-mode occupation < cutoff;
    threshold: every binary click pattern.
    Returns (probs[..., nstates], basis list of tuples).
    """
    nmode = cov.shape[-1] // 2
    if detector == 'pnrd':
        basis = []
        for n in range(nmode * (cutoff - 1) + 1):
            basis += [tuple(s) for s in fock_combinations(nmode, n, cutoff)]
    else:
        basis = [tuple(s) for s in itertools.product((0, 1), repeat=nmode)]
    single = cov.ndim == 2
    covs = cov.reshape(-1, 2 * nmode, 2 * nmode)
    means = mean.reshape(-1, 2 * nmode, 1)
    probs = torch.stack([probs_gaussian_helper(basis, covs[i], means[i], detector)
                         for i in range(covs.shape[0])])
    return (probs[0] if single else probs), basis
