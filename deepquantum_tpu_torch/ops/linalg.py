"""Numerically safe linear algebra with hand-written gradients.

PyTorch counterpart of ``deepquantum_tpu/ops/linalg.py``. An SVD's
backward divides by differences of singular values and blows up on the
(nearly) degenerate spectra that truncated MPS sweeps produce. ``svd_safe``
is an autograd Function whose backward is the regularised formula of the
reference (``safe_inverse``: x / (x^2 + eps)). Torch hands ``backward``
the conjugate-Wirtinger cotangents that formula was written for, so it is
used as it stands (the JAX package conjugates in and out for its own VJP
convention).

``qr_stable`` is the MPS sweeps' gauge factorisation A = Q R with Q an
isometry. Its gradient is exact for any function of (Q, R) that depends on
them only through the quantity Q R and Q's isometry (a gauge-invariant
function, as every MPS amplitude is), including at rank-deficient A, where
Q is not a differentiable function of A. Under autograd a square Q (m <= n)
is held fixed, and so is the complete, square Q of a rank-deficient tall
A: then Q Q^H = I, and R = Q^H A factors every matrix near A.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ['svd_safe', 'safe_inverse', 'qr_stable', 'rank_tol', 'undefined_gradient',
           'is_zero', 'deferred_rank_checks']


def safe_inverse(x, epsilon: float = 1e-12):
    """x / (x^2 + eps): a bounded inverse."""
    return x / (x ** 2 + epsilon)


def _diag(v: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(v)


class _SVD(torch.autograd.Function):
    """Reduced SVD a = U diag(s) V^H, s real; the backward regularised."""

    @staticmethod
    def forward(ctx, a):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        ctx.save_for_backward(u, s, vh)
        return u, s, vh

    @staticmethod
    def backward(ctx, du, ds, dvh):
        u, s, vh = ctx.saved_tensors
        dtype = u.dtype
        du = torch.zeros_like(u) if du is None else du
        dvh = torch.zeros_like(vh) if dvh is None else dvh
        ds = torch.zeros_like(s) if ds is None else ds
        uh = u.mH
        v = vh.mH
        dv = dvh.mH
        m, n, ns = u.shape[-2], v.shape[-2], s.shape[-1]
        f = s.unsqueeze(-2) ** 2 - s.unsqueeze(-1) ** 2
        f = safe_inverse(f)
        f = (f * (1 - torch.eye(ns, dtype=f.dtype, device=f.device))).to(dtype)
        j = f * (uh @ du)
        k = f * (vh @ dv)
        l = _diag((vh @ dv).diagonal(dim1=-2, dim2=-1))
        s_c = _diag(s.to(dtype))
        s_inv = _diag(safe_inverse(s).to(dtype))
        da = u @ (_diag(ds.to(dtype)) + (j + j.mH) @ s_c + s_c @ (k + k.mH)
                  + s_inv @ (l.mH - l) / 2) @ vh
        if m > ns:
            eye = torch.eye(m, dtype=dtype, device=u.device)
            da = da + (eye - u @ uh) @ du @ s_inv @ vh
        if n > ns:
            eye = torch.eye(n, dtype=dtype, device=u.device)
            da = da + u @ s_inv @ dvh @ (eye - v @ vh)
        return da


def svd_safe(a: torch.Tensor):
    """Reduced SVD (U, s, V^H) of a matrix or a stack, s real, with the
    regularised backward."""
    return _SVD.apply(a)


def rank_tol(dtype: torch.dtype) -> float:
    """Singular values (or R's diagonal) below this share of the largest
    entry count as zero: a few hundred roundoffs of the type (real or
    complex)."""
    return 1e-12 if dtype in (torch.complex128, torch.float64) else 1e-5


_DEFERRED: contextvars.ContextVar = contextvars.ContextVar('deferred_rank_checks', default=None)


@contextlib.contextmanager
def deferred_rank_checks():
    """Inside, ``is_zero`` reads nothing on the host: it records each test
    as a device flag in the yielded list and answers False. The caller
    reads the flags once at the end and, if one is set, runs again outside
    (a host read per test stalls a host-bound loop of small factors)."""
    flags: list = []
    token = _DEFERRED.set(flags)
    try:
        yield flags
    finally:
        _DEFERRED.reset(token)


def is_zero(small: torch.Tensor, large: torch.Tensor) -> bool:
    """Whether any of ``small`` is zero beside ``large`` (``rank_tol``):
    a host read, or under ``deferred_rank_checks`` a recorded flag and
    False."""
    flag = (small <= rank_tol(small.dtype) * large).any()
    flags = _DEFERRED.get()
    if flags is None:
        return bool(flag)
    flags.append(flag)
    return False


class _Undefined(torch.autograd.Function):
    """Identity whose backward raises: marks a value whose derivative the
    factorisation that made it cannot give."""

    @staticmethod
    def forward(ctx, x, why):
        ctx.why = why
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(ctx.why)


def undefined_gradient(x: torch.Tensor, why: str) -> torch.Tensor:
    """``x`` unchanged; a backward pass through it raises ``why``."""
    return _Undefined.apply(x, why)


def qr_stable(mat: torch.Tensor, max_cols: int | None = None):
    """A = Q R with Q (m, k) an isometry, for any aspect ratio and rank.

    Without a gradient: ``torch.linalg.qr`` (reduced). Under autograd:
    where m <= n, Q (square, unitary) is held fixed and R = Q^H A; where
    m > n and R is regular, ``torch.linalg.qr`` and its own backward; where
    m > n and A is rank-deficient (R's diagonal against its largest entry,
    ``is_zero``), the
    complete Q (m, m), held fixed, and R = Q^H A (m, n), whose extra rows
    are zero. A rank-deficient A's reduced Q has columns outside its range
    that nothing fixes, and growth of A in a direction they miss (an Rzz's
    derivative at angle 0) would find no channel. Where the complete Q
    would have more than ``max_cols`` columns, the reduced one is kept and
    a backward pass through R raises."""
    m, n = mat.shape[-2], mat.shape[-1]
    grad = mat.requires_grad and torch.is_grad_enabled()
    if not grad:
        return torch.linalg.qr(mat)
    if m <= n:
        q = torch.linalg.qr(mat.detach())[0]
        return q, q.mH @ mat
    q, r = torch.linalg.qr(mat)
    if not is_zero(r.diagonal(dim1=-2, dim2=-1).abs(),
                   r.abs().amax(dim=(-2, -1)).unsqueeze(-1)):
        return q, r
    if max_cols is not None and m > max_cols:
        q = q.detach()
        return q, undefined_gradient(
            q.mH @ mat, f'the gradient at a rank-deficient ({m}, {n}) factor needs {m} '
            f'columns, more than the {max_cols} allowed: start from generic parameters, or '
            f'raise the bond')
    q = torch.linalg.qr(mat.detach(), mode='complete')[0]
    return q, q.mH @ mat
