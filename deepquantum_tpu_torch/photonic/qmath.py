"""Photonic math: quadrature conversions, the permanent, Fock utilities.

PyTorch counterpart of ``deepquantum_tpu/photonic/qmath.py``. The permanent
keeps the JAX package's routes: closed forms up to n = 3, and from n = 4 the
Ryser sweep of ``ops/permanent_kernel.py`` (the hand-written CUDA kernel on
a CUDA tensor, the chunked mask-matmul twin on a CPU tensor).
``takagi`` and ``williamson`` run on the host in numpy / scipy, as the JAX
package's do at build time, and return tensors on the caller's device;
``sqrtm_herm`` and ``schur_anti_symm_even`` are ``torch.linalg.eigh``
functions; ``ladder_ops`` gives the truncated a and a^dagger.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..config import cdtype, rdtype, resolve_device
from ..ops.permanent_kernel import MAX_N, MIN_N, perm_chunksize_dict, permanent_cuda_batch

__all__ = ['ladder_ops', 'xxpp_to_xpxp', 'xpxp_to_xxpp', 'quadrature_to_ladder',
           'ladder_to_quadrature', 'permanent', 'permanent_batch', 'sub_matrix', 'fock_combinations',
           'photon_number_mean_var', 'shift_func', 'sqrtm_herm', 'schur_anti_symm_even',
           'takagi', 'williamson', 'perm_chunksize_dict', 'set_perm_chunksize']


def set_perm_chunksize(nmode: int, chunksize: int) -> None:
    """The subset chunk of the permanent's plain Ryser twin for n x n
    matrices (reference photonic/qmath.py set_perm_chunksize); the CUDA
    kernel plans its own work from the card."""
    perm_chunksize_dict[nmode] = int(chunksize)


def _as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """A tensor stays where it is; anything else lands on ``device`` (the
    default device when None)."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    return x if dtype is None else x.to(dtype)


def ladder_ops(cutoff: int, device=None):
    """The annihilation and creation operators truncated at ``cutoff``, (a,
    a^dagger), each (cutoff, cutoff) in the current complex dtype."""
    a = torch.diag(torch.arange(1, cutoff, dtype=torch.float64).sqrt(), 1)
    a = a.to(device=resolve_device(device), dtype=cdtype())
    return a, a.mH


def shift_func(lst: list, nstep: int) -> list:
    """Rotate a list left by nstep."""
    if len(lst) <= 1:
        return lst
    nstep = nstep % len(lst)
    return lst[nstep:] + lst[:nstep]


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


def sqrtm_herm(mat, device=None) -> torch.Tensor:
    """Square root of a positive-semidefinite hermitian matrix (or stack),
    through its eigendecomposition, negative eigenvalues clipped to 0."""
    mat = _as_tensor(mat, None, device)
    w, v = torch.linalg.eigh(mat)
    w = w.clamp(min=0)
    return (v * torch.sqrt(w).to(v.dtype)[..., None, :]) @ v.mH


def schur_anti_symm_even(mat, device=None):
    """Real Schur form of a real antisymmetric matrix of even size:
    A = O T O^T with O orthogonal and T block-diagonal in 2 x 2 blocks
    [[0, l], [-l, 0]], l >= 0. Built from the eigenbasis of the hermitian
    -iA: the conjugate pairs (+-l, u, conj(u)) give one block each, with
    the columns of O the normalised real and imaginary parts of u.
    Returns (T, O)."""
    mat = _as_tensor(mat, None, device)
    n = mat.shape[-1]
    ctype = torch.complex128 if mat.dtype == torch.float64 else torch.complex64
    lambd, u = torch.linalg.eigh(-1j * mat.to(ctype))
    pos = lambd[n // 2:].to(mat.dtype)             # ascending: the top half is >= 0
    idx1 = torch.arange(0, n, 2, device=mat.device)
    idx2 = torch.arange(1, n, 2, device=mat.device)
    mat_t = torch.zeros_like(mat)
    mat_t[idx1, idx2] = pos
    mat_t[idx2, idx1] = -pos
    mat_o = torch.zeros_like(mat)
    mat_o[:, idx1] = u[:, n // 2:].real.to(mat.dtype)
    mat_o[:, idx2] = u[:, n // 2:].imag.to(mat.dtype)
    return mat_t, mat_o / torch.linalg.norm(mat_o, dim=0, keepdim=True)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _target(x, device):
    """Where a host routine's result goes: the input tensor's device, else
    ``device`` (the default device when None)."""
    return x.device if torch.is_tensor(x) and device is None else resolve_device(device)


def takagi(a, device=None):
    """Takagi decomposition of a complex symmetric matrix, a = u diag(s) u^T
    with u unitary and s >= 0 ascending. The SVD construction: with
    a = U S V^H, Q = U^H conj(V) is block-diagonal over groups of equal
    singular values and complex-symmetric on each nonzero block, so
    u = U sqrtm(Q^T) block by block. Host numpy / scipy; returns (u, s) as
    (``cdtype()``, ``rdtype()``) tensors on the input's device (or
    ``device``)."""
    import scipy.linalg

    dev = _target(a, device)
    a = _host(a).astype(np.complex128)
    size = a.shape[0]
    u_l, s, v_h = np.linalg.svd(a)
    q = u_l.conj().T @ v_h.T
    factor = np.eye(size, dtype=np.complex128)
    start = 0
    for stop in range(1, size + 1):
        if stop == size or not np.isclose(s[stop], s[start], rtol=1e-8, atol=1e-10):
            if s[start] > 1e-12:                  # a zero block keeps the identity
                blk = slice(start, stop)
                qb = q[blk, blk].T
                factor[blk, blk] = scipy.linalg.sqrtm((qb + qb.T) / 2)
            start = stop
    u = u_l @ factor
    order = np.argsort(s)
    u, s = u[:, order], s[order]
    if not np.allclose(u @ np.diag(s) @ u.T, a, atol=1e-8 * max(1.0, np.abs(a).max())):
        raise RuntimeError('Takagi decomposition failed')
    return (torch.as_tensor(u, device=dev).to(cdtype()),
            torch.as_tensor(s, device=dev).to(rdtype()))


def _sqrtm_psd_np(mat: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(mat)
    return (v * np.sqrt(np.clip(w, 0, None))[None, :]) @ v.T


def williamson(cov, device=None):
    """Williamson decomposition cov = S diag(d, d) S^T in xxpp: (the
    symplectic S, the symplectic eigenvalues d), from the real Schur form
    of cov^(-1/2) Omega cov^(-1/2). Host numpy / scipy; returns
    ``rdtype()`` tensors on the input's device (or ``device``)."""
    from scipy.linalg import schur

    dev = _target(cov, device)
    cov_np = _host(cov).astype(np.float64)
    n = cov_np.shape[-1] // 2
    omega = np.block([[np.zeros((n, n)), np.eye(n)], [-np.eye(n), np.zeros((n, n))]])
    sqrt_cov = _sqrtm_psd_np(cov_np)
    inv_sqrt = np.linalg.inv(sqrt_cov)
    t, q = schur(inv_sqrt @ omega @ inv_sqrt, output='real')
    x = t[2 * np.arange(n), 2 * np.arange(n) + 1]       # the 2 x 2 blocks [[0, x], [-x, 0]]
    d = 1 / np.abs(x)
    perm = np.zeros((2 * n, 2 * n))
    first = 2 * np.arange(n) + (x <= 0)                 # a positive block first
    perm[first, np.arange(n)] = 1
    perm[4 * np.arange(n) + 1 - first, np.arange(n) + n] = 1
    s = sqrt_cov @ q @ perm @ np.diag(1 / np.sqrt(np.concatenate([d, d])))
    return (torch.as_tensor(s, device=dev).to(rdtype()),
            torch.as_tensor(d, device=dev).to(rdtype()))
