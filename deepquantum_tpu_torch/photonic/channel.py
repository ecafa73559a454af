"""Photonic channels: photon loss.

PyTorch counterpart of ``deepquantum_tpu/photonic/channel.py``. Loss couples
a mode to a vacuum ancilla through a beam splitter, a_out = sqrt(T) a_in +
sqrt(1 - T) b_vac, with the parameter theta and T = cos^2(theta / 2). A
Gaussian (or Bosonic) state takes the X / Y map cov -> X cov X^T + Y,
mean -> X mean on the mode's (x, p) pair. The Kraus operators on Fock
density matrices (``loss_kraus``) wait for the Fock slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..config import rdtype

__all__ = ['loss_xy', 'transmittance_to_theta']


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
