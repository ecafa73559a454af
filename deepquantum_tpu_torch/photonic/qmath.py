"""Photonic math: quadrature conversions, the permanent, Fock utilities.

PyTorch counterpart of ``deepquantum_tpu/photonic/qmath.py``. The permanent
keeps the JAX package's routes: closed forms up to n = 3, and from n = 4 the
Ryser sweep of ``ops/permanent_kernel.py`` (the hand-written CUDA kernel on
a CUDA tensor, the chunked mask-matmul twin on a CPU tensor).
``takagi``, ``williamson``, ``schur_anti_symm_even``, ``sqrtm_herm`` and
``ladder_ops`` are not ported yet.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..config import cdtype, resolve_device
from ..ops.permanent_kernel import MAX_N, MIN_N, permanent_cuda_batch

__all__ = ['xxpp_to_xpxp', 'xpxp_to_xxpp', 'quadrature_to_ladder', 'ladder_to_quadrature',
           'permanent', 'permanent_batch', 'sub_matrix', 'fock_combinations',
           'photon_number_mean_var']


def _as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor stays where it is; anything else lands on ``device`` (the
    default device when None)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    return x if dtype is None else x.to(dtype)


def xxpp_to_xpxp(matrix):
    """xxpp ordering -> xpxp ordering."""
    nmode = matrix.shape[-2] // 2
    idx = np.arange(2 * nmode).reshape(2, nmode).T.flatten()
    if matrix.shape[-1] == 2 * nmode:
        return matrix[..., idx[:, None], idx]
    return matrix[..., idx, :]


def xpxp_to_xxpp(matrix):
    """xpxp ordering -> xxpp ordering."""
    nmode = matrix.shape[-2] // 2
    idx = np.arange(2 * nmode).reshape(nmode, 2).T.flatten()
    if matrix.shape[-1] == 2 * nmode:
        return matrix[..., idx[:, None], idx]
    return matrix[..., idx, :]


def _omega(nmode: int, device) -> torch.Tensor:
    eye = torch.eye(nmode, dtype=cdtype(), device=device)
    return torch.cat([torch.cat([eye, 1j * eye], -1), torch.cat([eye, -1j * eye], -1)], -2)


def quadrature_to_ladder(tensor, symplectic: bool = False, device=None):
    """xxpp -> (a, a^dagger) ordering, for a matrix or a column vector."""
    tensor = _as_tensor(tensor, cdtype(), device)
    nmode = tensor.shape[-2] // 2
    omega = _omega(nmode, tensor.device)
    if tensor.shape[-1] == 2 * nmode:
        if symplectic:
            return omega @ tensor @ omega.mH / 2
        return omega @ tensor @ omega.mH * config.KAPPA ** 2 / config.HBAR
    return omega @ tensor * config.KAPPA / config.HBAR ** 0.5


def ladder_to_quadrature(tensor, symplectic: bool = False, device=None):
    """(a, a^dagger) ordering -> xxpp, for a matrix or a column vector."""
    tensor = _as_tensor(tensor, cdtype(), device)
    nmode = tensor.shape[-2] // 2
    eye = torch.eye(nmode, dtype=cdtype(), device=tensor.device)
    omega = torch.cat([torch.cat([eye, eye], -1), torch.cat([-1j * eye, 1j * eye], -1)], -2)
    if tensor.shape[-1] == 2 * nmode:
        if symplectic:
            return (omega @ tensor @ omega.mH).real / 2
        return (omega @ tensor @ omega.mH).real * config.HBAR / (4 * config.KAPPA ** 2)
    return (omega @ tensor).real * config.HBAR ** 0.5 / (2 * config.KAPPA)


def _closed_form(mats: torch.Tensor) -> torch.Tensor:
    """Permanents of (..., n, n) matrices for n <= 3."""
    n = mats.shape[-1]
    m = mats
    if n == 0:
        return torch.ones(mats.shape[:-2], dtype=mats.dtype, device=mats.device)
    if n == 1:
        return m[..., 0, 0]
    if n == 2:
        return m[..., 0, 0] * m[..., 1, 1] + m[..., 0, 1] * m[..., 1, 0]
    return (m[..., 0, 0] * m[..., 1, 1] * m[..., 2, 2] + m[..., 0, 1] * m[..., 1, 2] * m[..., 2, 0]
            + m[..., 0, 2] * m[..., 1, 0] * m[..., 2, 1] + m[..., 0, 0] * m[..., 1, 2] * m[..., 2, 1]
            + m[..., 0, 1] * m[..., 1, 0] * m[..., 2, 2] + m[..., 0, 2] * m[..., 1, 1] * m[..., 2, 0])


def permanent_batch(mats, device=None) -> torch.Tensor:
    """Permanents of a (B, n, n) stack by the Ryser formula, as ``cdtype()``.

    n <= 3: closed forms. 4 <= n <= 26: one Ryser sweep in float64 whatever
    the input type: the CUDA kernel on a CUDA tensor, its plain twin on a
    CPU tensor. n > 26 raises."""
    mats = _as_tensor(mats, None, device)
    if not mats.is_complex():
        mats = mats.to(cdtype())
    if mats.ndim != 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f'permanent_batch: expected (B, n, n), got {tuple(mats.shape)}')
    n = mats.shape[-1]
    if n < MIN_N:
        return _closed_form(mats).to(cdtype())
    if n > MAX_N:
        raise ValueError(f'permanent: n = {n} is beyond the Ryser sweep (n <= {MAX_N})')
    return permanent_cuda_batch(mats)


def permanent(mat, device=None) -> torch.Tensor:
    """Permanent of one n x n matrix (see ``permanent_batch``)."""
    mat = _as_tensor(mat, None, device)
    return permanent_batch(mat[None])[0]


def sub_matrix(u, input_state, output_state, device=None) -> torch.Tensor:
    """Repeat the columns of u by the input photon numbers and its rows by
    the output photon numbers (host ints -> static gather indices)."""
    u = _as_tensor(u, None, device)
    input_state = np.asarray(input_state)
    output_state = np.asarray(output_state)
    col_idx = np.repeat(np.arange(len(input_state)), input_state)
    row_idx = np.repeat(np.arange(len(output_state)), output_state)
    return u[row_idx[:, None], col_idx[None, :]]


@lru_cache(maxsize=None)
def fock_combinations(nmode: int, nphoton: int, cutoff: int | None = None) -> list:
    """All photon-number basis states of nmode modes with nphoton photons in
    total, optionally capped per mode by cutoff."""
    result = []

    def backtrack(state, remaining, mode):
        if mode == nmode:
            if remaining == 0:
                result.append(list(state))
            return
        top = remaining if cutoff is None else min(remaining, cutoff - 1)
        for k in range(top + 1):
            state.append(k)
            backtrack(state, remaining - k, mode + 1)
            state.pop()

    backtrack([], nphoton, 0)
    return result


def photon_number_mean_var(cov, mean, device=None):
    """Mean and variance of the photon number per mode from cov and mean in
    xxpp."""
    cov = _as_tensor(cov, None, device)
    mean = _as_tensor(mean, None, cov.device)
    nmode = cov.shape[-1] // 2
    coef = config.KAPPA ** 2 / config.HBAR
    exp, var = [], []
    for i in range(nmode):
        idx = np.array([i, i + nmode])
        cov_i = cov[..., idx[:, None], idx]
        mean_i = mean[..., idx, :]
        tr = torch.diagonal(cov_i, dim1=-2, dim2=-1).sum(-1)
        exp.append(coef * (tr + (mean_i.squeeze(-1) ** 2).sum(-1)) - 0.5)
        tr2 = torch.diagonal(cov_i @ cov_i, dim1=-2, dim2=-1).sum(-1)
        quad = (mean_i.mT @ cov_i @ mean_i).squeeze(-1).squeeze(-1)
        var.append(coef ** 2 * (tr2 + 2 * quad) * 2 - 0.25)
    return torch.stack(exp, -1), torch.stack(var, -1)
