"""Wigner functions of Gaussian and Bosonic states.

PyTorch counterpart of ``deepquantum_tpu/photonic/wigner.py``, the
continuous-variable half: ``cv_to_wigner`` evaluates one mode's Wigner
function as the weighted sum of its components' Gaussians (complex means
by analytic continuation) on a grid. The plot imports matplotlib only when
``plot=True``. ``fock_to_wigner`` and the Fock-tensor statistics wait for
the Fock slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import cdtype

__all__ = ['cv_to_wigner']


def _grid(xrange, prange, npoints):
    xlist = [-xrange, xrange] if isinstance(xrange, int) else list(xrange)
    plist = [-prange, prange] if isinstance(prange, int) else list(prange)
    nx, npts = (npoints, npoints) if isinstance(npoints, int) else (npoints[0], npoints[1])
    return np.linspace(xlist[0], xlist[1], nx), np.linspace(plist[0], plist[1], npts)


def cv_to_wigner(state, wire, xrange=10, prange=10, npoints=100, plot: bool = True,
                 k: int = 0, normalize: bool = True):
    """Wigner function of mode ``wire`` of a Gaussian state [cov, mean] or
    a Bosonic state [cov, mean, weight], on an npoints x npoints grid of
    (x, p): (batch, nx, np), real; ``normalize`` scales each to integrate
    to 1 on the grid."""
    cov, mean = state[0], state[1]
    if cov.ndim == 2:
        cov = cov[None]
    if mean.ndim == 2:
        mean = mean[None]
    if cov.ndim == 3:
        cov = cov[:, None]
    if mean.ndim == 3:
        mean = mean[:, None]
    weight = state[2] if len(state) > 2 else torch.ones(cov.shape[:2], dtype=cdtype(),
                                                        device=cov.device)
    xvec, pvec = _grid(xrange, prange, npoints)
    gx, gp = np.meshgrid(xvec, pvec, indexing='ij')
    coords = torch.as_tensor(np.stack([gx.reshape(-1), gp.reshape(-1)], axis=1),
                             device=cov.device).to(cov.dtype)                   # (P, 2)
    nmode = cov.shape[-1] // 2
    idx = np.array([wire, wire + nmode])
    cov = cov[..., idx[:, None], idx]                                           # (B, K, 2, 2)
    mean = mean[..., idx, 0].to(cdtype())                                       # (B, K, 2)
    cov_inv = torch.linalg.inv(cov)
    det = torch.linalg.det(2 * math.pi * cov)
    m_re, m_im = mean.real.to(cov.dtype), mean.imag.to(cov.dtype)
    inv_im = (cov_inv @ m_im[..., None])[..., 0]
    exp_real = torch.exp((m_im * inv_im).sum(-1) / 2)                          # (B, K)
    diff = coords[None, :, None, :] - m_re[:, None]                             # (B, P, K, 2)
    quad = torch.einsum('bpki,bkij,bpkj->bpk', diff, cov_inv, diff)
    phase = torch.einsum('bpki,bki->bpk', diff, inv_im)
    amp = (exp_real / torch.sqrt(det))[:, None] * torch.exp(-quad / 2)
    vals = (weight[:, None] * amp * torch.exp(1j * phase.to(cdtype()))).sum(-1)
    w = vals.real.reshape(-1, len(xvec), len(pvec))
    if normalize:
        total = w.sum((1, 2)) * (xvec[1] - xvec[0]) * (pvec[1] - pvec[0])
        w = w / total.reshape(-1, 1, 1)
    if plot:
        _plot_wigner(w.detach().cpu().numpy(), xvec, pvec, k)
    return w


def _plot_wigner(w, xvec, pvec, k=0):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots()
    cs = ax.contourf(xvec, pvec, w[k].T, levels=60, cmap='RdBu_r')
    ax.set_xlabel('x')
    ax.set_ylabel('p')
    fig.colorbar(cs)
    plt.show()
