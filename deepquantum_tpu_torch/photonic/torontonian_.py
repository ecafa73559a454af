"""Torontonian (Bristol thesis Eq. 3.54), with the displaced (loop) variant.

PyTorch counterpart of ``deepquantum_tpu/photonic/torontonian_.py``. The
inclusion-exclusion sum over the 2^m mode subsets cancels by many orders of
magnitude, so every route computes in complex128 whatever the input type
and the dtype policy only decides the type of the result. Routes, by the
size 2m of the matrix (the JAX package's thresholds):

- 2m < 6: the plain formula (det and solve per size group);
- 2m >= 6 and m <= 14: per-subset determinants (and quadratic forms) from
  ``tor_kernel.py`` (the CUDA kernel K8 / K9 on a CUDA tensor, its twin on a
  CPU tensor), then the signed sum of the epilogue in plain torch;
- m > 14: the plain formula, on either device.

``torontonian_batch`` is the JAX package's vmapped torontonian written out:
a (B, 2m, 2m) stack goes through the same routes as one matrix, so on the
kernel route it is ONE wrapper call (``batched_launches``) and one epilogue
over (B, S), and the plain formula runs vectorised over B. ``torontonian``
is its B = 1 case, a (2m, 2m) wrapper call (``launches``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..config import cdtype
from .hafnian_ import padded_powerset_indices, subset_index_groups
from .qmath import _as_tensor
from .tor_kernel import MAX_MODES, tor_dets_cuda, tor_dets_quads_cuda

__all__ = ['torontonian', 'torontonian_batch']


def _torontonian_plain(o_mat: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """sum_Z (-1)^(m-|Z|) exp(gamma_Z^T (I - O_Z)^{-1} conj(gamma_Z) / 2)
    / sqrt(det(I - O_Z)) with det and solve per size group, at the matrix's
    own complex precision; O is (..., 2m, 2m), gamma (..., 2m)."""
    size = o_mat.shape[-1]
    m = size // 2
    tor = torch.full(o_mat.shape[:-2], float((-1) ** m), dtype=o_mat.dtype, device=o_mat.device)
    for k, y_sets in subset_index_groups(m).items():
        idx = np.sort(np.concatenate([y_sets, y_sets + m], axis=1), axis=1)
        submats = o_mat[..., idx[:, :, None], idx[:, None, :]]
        subgammas = gamma[..., idx]
        cov_q_inv = torch.eye(2 * k, dtype=o_mat.dtype, device=o_mat.device) - submats
        x = torch.linalg.solve(cov_q_inv, subgammas.conj()[..., None])[..., 0]
        coeffs = torch.exp((subgammas * x).sum(-1) / 2) / torch.sqrt(torch.linalg.det(cov_q_inv))
        tor = tor + (-1) ** (m - k) * coeffs.sum(-1)
    return tor


@lru_cache(maxsize=None)
def _padded_tor_indices(m: int, device: torch.device):
    """The powerset scaffold of the torontonian as tensors on ``device``:
    sorted (y, y + m) rows of every nonempty mode subset padded to 2m
    ((S, 2m) int64), the validity column ((S, 2m, 1) float32) and the
    inclusion-exclusion sign ((S,) float64), grouped by size."""
    idx, valid, sign = padded_powerset_indices(
        m, lambda y_sets, k: np.sort(np.concatenate([y_sets, y_sets + m], axis=1), axis=1))
    with torch.inference_mode(False):     # cached across calls, autograd-tracked ones too
        return (torch.as_tensor(idx, device=device), torch.as_tensor(valid, device=device),
                torch.as_tensor(sign, dtype=torch.float64, device=device))


def _tor_epilogue(det, sign, m: int, quad=None) -> torch.Tensor:
    """Signed inclusion-exclusion sum over the per-subset determinants (and
    quadratic forms) of the last axis: sum sign * exp(quad / 2) / sqrt(det)
    + (-1)^m, in complex128; the square root takes the principal branch."""
    term = 1 / torch.sqrt(det)
    if quad is not None:
        term = torch.exp(quad / 2) * term
    return (term * sign).sum(-1) + float((-1) ** m)


def _torontonian(o_mat: torch.Tensor, gamma) -> torch.Tensor:
    """The torontonian of a (2m, 2m) matrix or of each matrix of a
    (B, 2m, 2m) stack (gamma (2m,) or (B, 2m), or None), in complex128."""
    size = o_mat.shape[-1]
    m = size // 2
    if size >= 6 and m <= MAX_MODES:
        idx, valid, sign = _padded_tor_indices(m, o_mat.device)
        if gamma is None:
            det, sign = tor_dets_cuda(o_mat, idx, valid, sign)
            return _tor_epilogue(det, sign, m)
        det, quad, sign = tor_dets_quads_cuda(o_mat, gamma.to(o_mat.dtype), idx, valid, sign)
        return _tor_epilogue(det, sign, m, quad=quad)
    o128 = o_mat.to(torch.complex128)
    if gamma is None:
        g128 = torch.zeros(o_mat.shape[:-1], dtype=torch.complex128, device=o_mat.device)
    else:
        g128 = gamma.to(torch.complex128)
    return _torontonian_plain(o128, g128)


def _inputs(o_mat, gamma, device):
    o_mat = _as_tensor(o_mat, None, device)
    if not o_mat.is_complex():
        o_mat = o_mat.to(cdtype())
    if gamma is not None:
        gamma = _as_tensor(gamma, None, o_mat.device)
    return o_mat, gamma


def torontonian(o_mat, gamma=None, device=None) -> torch.Tensor:
    """Torontonian of a 2m x 2m matrix; with ``gamma`` the displaced (loop)
    variant. Computed in complex128, returned as ``cdtype()``."""
    o_mat, gamma = _inputs(o_mat, gamma, device)
    return _torontonian(o_mat, gamma).to(cdtype())


def torontonian_batch(o_mat, gamma=None, device=None) -> torch.Tensor:
    """Torontonians of a (B, 2m, 2m) stack of equal-size matrices (with
    ``gamma`` (B, 2m), the displaced variant), in one pass over the stack:
    one kernel wrapper call where ``torontonian`` makes one. Computed in
    complex128, returned as ``cdtype()``."""
    o_mat, gamma = _inputs(o_mat, gamma, device)
    if o_mat.ndim != 3:
        raise ValueError(f'torontonian_batch: expected a (B, 2m, 2m) stack, got '
                         f'{tuple(o_mat.shape)}')
    if o_mat.shape[0] == 0:
        return torch.zeros(0, dtype=cdtype(), device=o_mat.device)
    return _torontonian(o_mat, gamma).to(cdtype())
