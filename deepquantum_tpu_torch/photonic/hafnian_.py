"""Subset scaffolds shared with the torontonian, and the plain hafnian.

PyTorch counterpart of ``deepquantum_tpu/photonic/hafnian_.py``: the
power-trace method (Björklund et al., arXiv:2108.01622 Eq. B3),

  haf(A) = sum over subsets Z of the m mode pairs of
           (-1)^(m-|Z|) * [z^m] exp(P_Z(z)),   P_Z(z) = sum_j p_j z^j,
  p_j    = tr((X A_Z)^j) / (2j)  (+ v^T (X A_Z)^(j-1) X v / 2 with loops,
                                  v = diag(A_Z)),

where X swaps the two rows of each mode pair and the z^m coefficient comes
from the power-series exponential recurrence. The JAX package has no TPU
kernel for the hafnian, so there is none here: each subset size is one batch
of plain torch products, in complex128 on either device. ``hafnian_batch``
(the JAX package's vmapped hafnian) evaluates a stack of equal-size
matrices in the same calls, the stack a leading axis of every product.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..config import cdtype
from .qmath import _as_tensor

__all__ = ['hafnian', 'hafnian_batch', 'subset_index_groups', 'padded_powerset_indices']


@lru_cache(maxsize=None)
def subset_index_groups(n: int):
    """Nonempty subsets of range(n) grouped by size, as numpy index arrays
    (size k -> array of shape (C(n, k), k)). Shared with the torontonian."""
    return {k: np.array(list(itertools.combinations(range(n), k)), dtype=np.int64)
            for k in range(1, n + 1)}


def padded_powerset_indices(m: int, rows_builder):
    """Row indices for EVERY nonempty subset of m modes, zero-padded to the
    common length 2m, with the (2m, 1) validity column of each subset and its
    inclusion-exclusion sign, as numpy arrays. Subsets are grouped by size,
    smallest first. ``rows_builder(pair_sets, k)`` maps a (S_k, k) array of
    mode subsets to their (S_k, 2k) matrix rows."""
    subsets = subset_index_groups(m)
    count = (1 << m) - 1
    idx = np.zeros((count, 2 * m), np.int64)
    sign = np.zeros(count, np.float32)
    mask = np.zeros((count, 2 * m, 1), np.float32)
    s = 0
    for k, pair_sets in subsets.items():
        rows = rows_builder(pair_sets, k)
        e = s + len(rows)
        idx[s:e, :2 * k] = rows
        sign[s:e] = 1.0 if (m - k) % 2 == 0 else -1.0
        mask[s:e, :2 * k] = 1.0
        s = e
    return idx, mask, sign


def _exp_series_coeff(p: torch.Tensor) -> torch.Tensor:
    """[z^m] of exp(sum_j p[..., j-1] z^j) for p of static last length m, by
    the recurrence e_k = (1/k) sum_j j p_j e_(k-j)."""
    m = p.shape[-1]
    jp = p * torch.arange(1, m + 1, dtype=p.real.dtype, device=p.device)
    e = [torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)]
    for k in range(1, m + 1):
        acc = torch.zeros_like(e[0])
        for j in range(1, k + 1):
            acc = acc + jp[..., j - 1] * e[k - j]
        e.append(acc / k)
    return e[m]


def _pair_swap_rows(a: torch.Tensor) -> torch.Tensor:
    """Left-multiply by X = direct sum of [[0, 1], [1, 0]] blocks: swap the
    two rows of every interleaved mode pair."""
    s = a.shape[-2]
    perm = np.arange(s).reshape(-1, 2)[:, ::-1].reshape(-1).tolist()
    return a[..., perm, :]


def _subset_coeff(sub: torch.Tensor, m: int, loop: bool) -> torch.Tensor:
    """[z^m] exp(P_Z) for a batch of subset submatrices (S, 2k, 2k)."""
    xa = _pair_swap_rows(sub)
    pw = xa
    if loop:
        v = torch.diagonal(sub, dim1=-2, dim2=-1)                  # (S, 2k)
        xv = _pair_swap_rows(v[..., None])[..., 0] / 2
        u = v
    terms = []
    for j in range(1, m + 1):
        t = torch.diagonal(pw, dim1=-2, dim2=-1).sum(-1) / (2 * j)
        if loop:
            t = t + (u * xv).sum(-1)
            u = (u[..., None, :] @ xa)[..., 0, :]
        terms.append(t)
        if j < m:
            pw = pw @ xa
    return _exp_series_coeff(torch.stack(terms, -1))


def _hafnian_plain(matrix: torch.Tensor, loop: bool) -> torch.Tensor:
    """Power-trace hafnian of (..., 2m, 2m) matrices at their own complex
    precision: per subset size one batch of products over every matrix."""
    m = matrix.shape[-1] // 2
    total = torch.zeros(matrix.shape[:-2], dtype=matrix.dtype, device=matrix.device)
    for k, pair_sets in subset_index_groups(m).items():
        # mode pair p -> interleaved rows and columns (2p, 2p + 1)
        rows = np.stack([2 * pair_sets, 2 * pair_sets + 1], axis=2).reshape(len(pair_sets), 2 * k)
        subs = matrix[..., rows[:, :, None], rows[:, None, :]]
        sign = 1 if (m - k) % 2 == 0 else -1
        total = total + sign * _subset_coeff(subs, m, loop).sum(-1)
    return total


def hafnian_batch(matrix, loop: bool = False, device=None) -> torch.Tensor:
    """(Loop) hafnians of a (B, n, n) stack of symmetric matrices, computed
    in complex128 and returned as ``cdtype()``: (B,)."""
    matrix = _as_tensor(matrix, torch.complex128, device)
    size = matrix.shape[-1]
    if size % 2 == 1:
        if not loop:
            return torch.zeros(matrix.shape[:-2], dtype=cdtype(), device=matrix.device)
        # odd loop hafnian: border with a unit diagonal entry
        padded = torch.zeros(matrix.shape[:-2] + (size + 1, size + 1), dtype=matrix.dtype,
                             device=matrix.device)
        padded[..., 0, 0] = 1
        padded[..., 1:, 1:] = matrix
        matrix = padded
        size += 1
    if size == 0:
        return torch.ones(matrix.shape[:-2], dtype=cdtype(), device=matrix.device)
    return _hafnian_plain(matrix, loop).to(cdtype())


def hafnian(matrix, loop: bool = False, device=None) -> torch.Tensor:
    """(Loop) hafnian of a symmetric matrix, computed in complex128 and
    returned as ``cdtype()``."""
    matrix = _as_tensor(matrix, None, device)
    return hafnian_batch(matrix[None], loop)[0]
