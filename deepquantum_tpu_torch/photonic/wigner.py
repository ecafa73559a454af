"""Wigner functions and photon statistics of Fock, Gaussian and Bosonic states.

PyTorch counterpart of ``deepquantum_tpu/photonic/wigner.py``.
``cv_to_wigner`` evaluates one mode's Wigner function as the weighted sum
of its components' Gaussians (complex means by analytic continuation) on a
grid. On Fock tensors everything goes through one mode's reduced density
matrix (``reduced_dm``): for a pure state the mode's axis moved to the
front, (c, c^(n-1)), times its adjoint, so that no c^n x c^n matrix is
formed (the JAX package forms psi psi^H before its partial trace);
``fock_to_wigner`` then runs the iterative Laguerre recurrence (the qutip
method) on the grid. The plot imports matplotlib only when ``plot=True``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from ..config import cdtype, rdtype
from ..ops.qmath import partial_trace

__all__ = ['cv_to_wigner', 'fock_to_wigner', 'reduced_dm', 'quadrature_mean_fock',
           'photon_number_mean_var_fock']


def reduced_dm(state, wire: int, nmode: int, cutoff: int, den_mat: bool = False):
    """The (batch, c, c) reduced density matrix of mode ``wire`` of a Fock
    tensor (leading batch axes allowed; a density matrix with
    ``den_mat``)."""
    c = cutoff
    if den_mat:
        rho = state.reshape(-1, c ** nmode, c ** nmode)
        return partial_trace(rho, nmode, [i for i in range(nmode) if i != wire], c)
    psi = state.reshape((-1,) + (c,) * nmode)
    t = psi.movedim(wire + 1, 1).reshape(psi.shape[0], c, -1)
    return t @ t.mH


def photon_number_mean_var_fock(state, nmode: int, cutoff: int, wires, den_mat: bool = False):
    """Photon-number mean and variance of each of ``wires`` of a Fock
    tensor: (nwire, batch) each, as the JAX package returns them."""
    c = cutoff
    if den_mat:
        rho = state.reshape(-1, c ** nmode, c ** nmode)
        prob = rho.diagonal(dim1=-2, dim2=-1).real.reshape((-1,) + (c,) * nmode)
    else:
        prob = state.reshape((-1,) + (c,) * nmode).abs() ** 2
    n_op = torch.arange(c, dtype=prob.dtype, device=prob.device)
    means, variances = [], []
    for w in wires:
        p_w = prob.sum(tuple(j + 1 for j in range(nmode) if j != w))
        mean = (n_op * p_w).sum(-1)
        means.append(mean)
        variances.append((n_op ** 2 * p_w).sum(-1) - mean ** 2)
    return torch.stack(means), torch.stack(variances)


def quadrature_mean_fock(state, nmode: int, cutoff: int, wires, den_mat: bool = False):
    """<x> of each of ``wires`` of a Fock tensor, (nwire, batch):
    sqrt(hbar) / (2 kappa) <a + a^dagger> from the reduced density matrix's
    first off-diagonal."""
    factor = torch.arange(1, cutoff, dtype=rdtype(), device=state.device).sqrt()
    scale = config.HBAR ** 0.5 / (2 * config.KAPPA)
    means = [scale * 2 * (factor * reduced_dm(state, w, nmode, cutoff, den_mat)
                          .diagonal(offset=1, dim1=-2, dim2=-1).real).sum(-1) for w in wires]
    return torch.stack(means)


def fock_to_wigner(state, wire: int, nmode: int, cutoff: int, den_mat: bool = False,
                   xrange=10, prange=10, npoints=100, plot: bool = True, k: int = 0):
    """Wigner function of mode ``wire`` of a Fock tensor on an npoints x
    npoints grid of (x, p): (batch, nx, np), real, by the iterative
    Laguerre method on the mode's reduced density matrix."""
    rdm = reduced_dm(state, wire, nmode, cutoff, den_mat)
    c = cutoff
    xvec, pvec = _grid(xrange, prange, npoints)
    coef = 2 * config.KAPPA ** 2 / config.HBAR
    gx, gp = np.meshgrid(xvec, pvec, indexing='ij')
    alpha_np = coef ** 0.5 * (gx + 1j * gp) / 2 ** 0.5
    alpha = torch.as_tensor(alpha_np, device=rdm.device).to(rdm.dtype)
    w_list = [None] * c
    w_list[0] = torch.as_tensor(coef * np.exp(-2 * np.abs(alpha_np) ** 2) / np.pi,
                                device=rdm.device).to(rdm.dtype)
    w = rdm[:, 0, 0, None, None] * w_list[0]
    for i in range(1, c):
        w_list[i] = 2 * alpha * w_list[i - 1] / np.sqrt(i)
        w = w + 2 * (rdm[:, 0, i, None, None] * w_list[i]).real
    for i in range(1, c):
        sqrt_i = i ** 0.5
        temp = w_list[i]
        w_list[i] = (2 * alpha.conj() * temp - sqrt_i * w_list[i - 1]) / sqrt_i
        w = w + rdm[:, i, i, None, None] * w_list[i]
        for j in range(i + 1, c):
            temp2 = (2 * alpha * w_list[j - 1] - sqrt_i * temp) / j ** 0.5
            temp = w_list[j]
            w_list[j] = temp2
            w = w + 2 * (rdm[:, i, j, None, None] * w_list[j]).real
    w = w.real
    if plot:
        _plot_wigner(w.detach().cpu().numpy(), xvec, pvec, k)
    return w


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
