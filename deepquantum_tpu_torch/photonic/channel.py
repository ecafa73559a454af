"""Photonic channels: photon loss.

PyTorch counterpart of ``deepquantum_tpu/photonic/channel.py``. Loss couples
a mode to a vacuum ancilla through a beam splitter, a_out = sqrt(T) a_in +
sqrt(1 - T) b_vac, with the parameter theta and T = cos^2(theta / 2). A
Gaussian (or Bosonic) state takes the X / Y map cov -> X cov X^T + Y,
mean -> X mean on the mode's (x, p) pair. A Fock density matrix takes the
Kraus operators of the beam splitter with a vacuum ancilla input
(``loss_kraus``, arXiv:1012.4266 Eq. 2.4), applied as one superoperator on
the mode's row and column wires (``loss_superop``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..config import rdtype
from . import gates as PG

__all__ = ['loss_xy', 'loss_kraus', 'loss_superop', 'transmittance_to_theta']


def transmittance_to_theta(t) -> float:
    """T = cos^2(theta / 2) -> theta."""
    return float(2 * np.arccos(np.sqrt(t)))


def loss_xy(p):
    """The one-mode (X, Y) of loss theta = p[..., 0] in xxpp, each
    (..., 2, 2): X = cos(theta / 2) I, Y = (1 - cos^2(theta / 2)) times the
    vacuum covariance."""
    cos = torch.cos(p[..., 0].to(rdtype()) / 2)[..., None, None]
    eye = torch.eye(2, dtype=rdtype(), device=p.device)
    return eye * cos, eye * (1 - cos ** 2) * (config.HBAR / (4 * config.KAPPA ** 2))


def loss_kraus(p, cutoff: int):
    """The Kraus operators of loss theta = p[..., 0] on a Fock mode, (...,
    k, m, n) with k the photons lost: the 'h' beam splitter's Fock tensor
    with the ancilla's input in vacuum."""
    t4 = PG.bs_fock_from_unitary(PG.bs_single_unitary(p[..., :1], 'h'), cutoff)
    return t4[..., 0].transpose(-3, -2)


def loss_superop(p, cutoff: int):
    """The loss channel as one (c^2, c^2) matrix on a mode's (row, column)
    wire pair of a density matrix: S[(m, m'), (n, n')] = sum_k K_k[m, n]
    conj(K_k[m', n'])."""
    kraus = loss_kraus(p, cutoff)
    s = torch.einsum('...kmn,...kab->...manb', kraus, kraus.conj())
    return s.reshape(s.shape[:-4] + (cutoff * cutoff, cutoff * cutoff))
