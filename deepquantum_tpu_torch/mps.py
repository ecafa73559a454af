"""Matrix product state backend (TEBD).

PyTorch counterpart of ``deepquantum_tpu/mps.py``. An MPS is a list of
(chi_l, d, chi_r) tensors on one device plus an orthogonality center (-1:
none). A k-site gate becomes an MPO (projected on its gate family's fixed
split bases, ``mpo_bases``), is contracted into the sites it spans, and
the bonds are truncated back to ``chi`` by a centre sweep of SVDs. QR and
SVD are ``qr_stable`` / ``svd_safe`` (ops/linalg.py), so gradients flow
through truncation. Every core function is pure: (tensors, center) in,
(tensors, center) out.

Sampling (``sample_mps``, ``measure_mps``) is exact ancestral sampling:
the right environments once, then a walk over the sites drawing every
shot's value of a site at once with ``torch.multinomial`` from an explicit
generator.
"""

from __future__ import annotations

from collections import Counter
from typing import Any

import numpy as np
import torch

from .config import cdtype, resolve_device
from .ops.linalg import is_zero, qr_stable, rank_tol, svd_safe, undefined_gradient
from .ops.qmath import inner_product_mps

__all__ = ['MatrixProductState', 'apply_gate_mps', 'measure_mps', 'sample_mps',
           'orthogonalize_left2right', 'orthogonalize_right2left', 'center_orthogonalization',
           'gate_to_mpo', 'mpo_bases', 'apply_mpo', 'full_tensor', 'bitstring_amplitude',
           'bitstring_prob']


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x)


def _truncate(mat: torch.Tensor, dc: int):
    """The truncated SVD (U[:, :dc], s[:dc], V^H[:dc]). Where a gradient is
    wanted and a kept singular value is zero, the kept singular vectors are
    any of many and the derivative of the truncation is not defined: a
    backward pass through them raises."""
    u, s, vh = svd_safe(mat)
    u, s, vh = u[:, :dc], s[:dc], vh[:dc, :]
    if mat.requires_grad and torch.is_grad_enabled() and is_zero(s[-1], s[0]):
        why = (f'the gradient of a truncation to {dc} that keeps a zero singular value '
               f'({tuple(mat.shape)}) is not defined: start from generic parameters')
        s = undefined_gradient(s, why)
    return u, s, vh


def orthogonalize_left2right(tensors: list, site: int, dc: int = -1,
                             normalize: bool = False, cap: int | None = None) -> list:
    """T_site = U R: tensor[site] <- U, tensor[site + 1] <- R tensor[site + 1]
    (QR, or a truncated SVD keeping ``dc`` values when 0 < dc < bond).
    ``cap``: the largest bond a rank-deficient factor's gradient may open
    (``qr_stable``'s ``max_cols``)."""
    tensors = list(tensors)
    t = tensors[site]
    l, d, r = t.shape
    mat = t.reshape(l * d, r)
    if 0 < dc < r:
        u, s, vh = _truncate(mat, dc)
        rmat = s[:, None].to(u.dtype) * vh
    else:
        u, rmat = qr_stable(mat, cap)
    tensors[site] = u.reshape(l, d, -1)
    if normalize:
        rmat = rmat / _norm(rmat)
    tensors[site + 1] = torch.einsum('ab,bcd->acd', rmat, tensors[site + 1])
    return tensors


def orthogonalize_right2left(tensors: list, site: int, dc: int = -1,
                             normalize: bool = False, cap: int | None = None) -> list:
    """T_site = L V^H: tensor[site] <- V^H, tensor[site - 1] <- tensor[site - 1] L."""
    tensors = list(tensors)
    t = tensors[site]
    l, d, r = t.shape
    mat = t.reshape(l, d * r)
    if 0 < dc < l:
        u, s, vh = _truncate(mat, dc)
        lmat = u * s[None, :].to(u.dtype)
    else:
        q, rmat = qr_stable(mat.mH, cap)
        vh = q.mH
        lmat = rmat.mH
    tensors[site] = vh.reshape(-1, d, r)
    if normalize:
        lmat = lmat / _norm(lmat)
    tensors[site - 1] = torch.einsum('abc,cd->abd', tensors[site - 1], lmat)
    return tensors


def center_orthogonalization(tensors: list, center: int, c: int, dc: int = -1,
                             normalize: bool = False, cap: int | None = None) -> tuple[list, int]:
    """Move the orthogonality center from ``center`` (-1: none) to ``c``."""
    n = len(tensors)
    if c == -1:
        c = n - 1
    if center < 0:
        for site in range(0, c):
            tensors = orthogonalize_left2right(tensors, site, dc, normalize, cap)
        for site in range(n - 1, c, -1):
            tensors = orthogonalize_right2left(tensors, site, dc, normalize, cap)
    elif center < c:
        for site in range(center, c):
            tensors = orthogonalize_left2right(tensors, site, dc, normalize, cap)
    elif center > c:
        for site in range(center, c, -1):
            tensors = orthogonalize_right2left(tensors, site, dc, normalize, cap)
    if normalize:
        tensors = list(tensors)
        tensors[c] = tensors[c] / _norm(tensors[c])
    return tensors, c


def _operator_split_form(matrix: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """A k-site gate (d^k, d^k) as (d*d, ..., d*d): each site's (out, in)
    pair on one axis."""
    u = matrix.reshape([d] * (2 * k))
    order = list(np.arange(2 * k).reshape(2, k).T.flatten())
    return u.permute(order).reshape([d * d] * k)


def mpo_bases(matrices: list, k: int, qudit: int = 2) -> list:
    """Orthonormal left bases of a k-site gate family's MPO splits, from
    matrices of the family (a fixed gate: its one matrix; a parameterised
    one: its matrix at a few generic parameter values). Split j keeps the
    span of every matrix's left factors, so a bond is the family's operator
    Schmidt rank (2 for a CNOT, an Rzz or a crx at any angle), not the rank
    at one value: an Rzz at 0 is a product but its derivative is not, and
    its MPO keeps the channel the derivative flows through. Made without
    autograd; (n_left * d * d, rank) each."""
    d = qudit
    tol = rank_tol(matrices[0].dtype)
    curs = [_operator_split_form(m, k, d) for m in matrices]
    bases = []
    nleft = 1
    with torch.no_grad():
        for _ in range(k - 1):
            stack = torch.cat([c.reshape(nleft * d * d, -1) for c in curs], dim=1)
            u, s, _ = torch.linalg.svd(stack, full_matrices=False)
            rank = max(int((s > tol * s[0]).sum()), 1)
            q = u[:, :rank]
            bases.append(q)
            curs = [q.mH @ c.reshape(nleft * d * d, -1) for c in curs]
            nleft = rank
    return bases


def gate_to_mpo(matrix: torch.Tensor, wires_sorted: list[int], qudit: int = 2,
                bases: list | None = None) -> tuple[list, int]:
    """Factorise a k-site gate (its qudits in ``wires_sorted`` order) into
    MPO tensors (i, out, in, j), identity tensors filling the gaps between
    non-adjacent wires; returns (tensors, first site).

    Each split projects on a fixed orthonormal basis Q (``mpo_bases``): the
    left tensor is Q, the rest Q^H times the gate, exact and linear in the
    gate, so its gradient needs no SVD. ``bases`` default to this matrix's
    own, whose bonds are its rank at this value (nonzero singular values
    only: the JAX package's QR keeps 4 channels, and the dead ones leave
    every R of the next sweep singular); a parameterised gate passes its
    family's."""
    k = len(wires_sorted)
    d = qudit
    if bases is None:
        bases = mpo_bases([matrix], k, d)
    cur = _operator_split_form(matrix, k, d)
    main = []
    nleft = 1
    for q in bases:
        rank = q.shape[-1]
        main.append(q.reshape(nleft, d * d, rank))
        cur = q.mH @ cur.reshape(nleft * d * d, -1)
        nleft = rank
    main.append(cur.reshape(nleft, d * d, 1))
    tensors = []
    prev = None
    for w, t in zip(wires_sorted, main):
        if prev is not None:
            for _ in range(prev + 1, w):
                chi = tensors[-1].shape[-1]
                ident = torch.eye(chi * d, dtype=matrix.dtype, device=matrix.device)
                tensors.append(ident.reshape(chi, d, chi, d).permute(0, 1, 3, 2))
        nl, _, nr = t.shape
        tensors.append(t.reshape(nl, d, d, nr))
        prev = w
    return tensors, wires_sorted[0]


def apply_mpo(tensors: list, mpo: list, sites: list[int]) -> list:
    """Contract MPO tensors into the MPS sites they act on."""
    tensors = list(tensors)
    for t_op, site in zip(mpo, sites):
        x = torch.einsum('iabj,kbl->ikajl', t_op, tensors[site])
        s = x.shape
        tensors[site] = x.reshape(s[0] * s[1], s[2], s[3] * s[4])
    return tensors


def apply_gate_mps(state, matrix: torch.Tensor, wires_sorted: list[int], chi: int,
                   normalize: bool = True, qudit: int = 2, mpo=None) -> tuple[list, int]:
    """Apply a gate: move the center to the gate's nearer end, contract its
    MPO (``mpo``: the gate's ``gate_to_mpo`` made before), sweep to the far
    end, and sweep back truncating to ``chi``. Under autograd a
    rank-deficient factor may open a bond up to ``chi`` (``qr_stable``),
    so that the gradient is exact there too; where that is not enough, a
    backward pass raises rather than return a wrong gradient."""
    if isinstance(state, tuple):
        tensors, center = state
    else:
        tensors, center = state, -1
    mpo, left = gate_to_mpo(matrix, wires_sorted, qudit) if mpo is None else mpo
    right = left + len(mpo) - 1
    if center < 0:
        end1, end2 = left, right
    else:
        end1, end2 = (left, right) if abs(left - center) < abs(right - center) else (right, left)
    sites = list(range(left, right + 1))
    tensors, c = center_orthogonalization(tensors, center, end1, -1, normalize, chi)
    tensors = apply_mpo(tensors, mpo, sites)
    tensors, c = center_orthogonalization(tensors, c, end2, -1, normalize, chi)
    tensors, c = center_orthogonalization(tensors, c, end1, chi, normalize, chi)
    return tensors, c


def full_tensor(tensors: list) -> torch.Tensor:
    """Contract the MPS into the flat dense state (d^n,)."""
    psi = tensors[0]
    for t in tensors[1:]:
        psi = torch.einsum('abc,cde->abde', psi, t)
        s = psi.shape
        psi = psi.reshape(s[0], s[1] * s[2], s[3])
    return psi.reshape(-1)


def bitstring_amplitude(tensors: list, bits) -> torch.Tensor:
    """<bits|mps> for a sequence of n site values."""
    bits = [int(b) for b in bits]
    env = tensors[0][:, bits[0], :]
    for i, t in enumerate(tensors[1:], 1):
        env = env @ t[:, bits[i], :]
    return env.reshape(())


def bitstring_prob(tensors: list, bits) -> torch.Tensor:
    """|<bits|mps>|^2."""
    return bitstring_amplitude(tensors, bits).abs() ** 2


class MatrixProductState:
    """An MPS of ``nsite`` qudits on ``device``: ``tensors`` a list of
    (chi_l, d, chi_r) tensors, ``center`` the orthogonality center (-1:
    none). ``state`` is 'zeros' / 'vac', or a list whose entries are site
    values (ints) or site tensors. ``chi`` defaults to 10 * nsite."""

    def __init__(self, nsite: int = 1, state: Any = 'zeros', chi: int | None = None,
                 qudit: int = 2, normalize: bool = True, device=None) -> None:
        self.nsite = nsite
        self.chi = 10 * nsite if chi is None else chi
        self.qudit = qudit
        self.normalize = normalize
        self.device = resolve_device(device)
        self.center = -1
        self.set_tensors(state)

    def set_tensors(self, state) -> None:
        if isinstance(state, str) and state in ('zeros', 'vac'):
            state = [0] * self.nsite
        if not isinstance(state, list):
            raise TypeError('an MPS state is a list of site values or site tensors')
        state = list(state) + [0] * (self.nsite - len(state))
        tensors = []
        for s in state:
            if isinstance(s, (int, np.integer)):
                t = torch.zeros((1, self.qudit, 1), dtype=cdtype(), device=self.device)
                t[0, int(s), 0] = 1
            else:
                t = torch.as_tensor(s).to(device=self.device, dtype=cdtype())
            tensors.append(t)
        self.tensors = tensors

    def center_orthogonalization(self, c: int, dc: int = -1, normalize: bool = False) -> None:
        self.tensors, self.center = center_orthogonalization(self.tensors, self.center, c, dc,
                                                             normalize)

    def orthogonalize_left2right(self, site: int, dc: int = -1, normalize: bool = False) -> None:
        self.tensors = orthogonalize_left2right(self.tensors, site, dc, normalize)

    def orthogonalize_right2left(self, site: int, dc: int = -1, normalize: bool = False) -> None:
        self.tensors = orthogonalize_right2left(self.tensors, site, dc, normalize)

    def orthogonalize_n1_n2(self, n1: int, n2: int, dc: int = -1, normalize: bool = False) -> None:
        """Sweep the orthogonalisation from site n1 to n2."""
        if n1 < n2:
            for site in range(n1, n2):
                self.tensors = orthogonalize_left2right(self.tensors, site, dc, normalize)
        else:
            for site in range(n1, n2, -1):
                self.tensors = orthogonalize_right2left(self.tensors, site, dc, normalize)
        self.center = n2

    def normalize_central_tensor(self) -> None:
        if self.center < 0:
            return
        self.tensors = list(self.tensors)
        t = self.tensors[self.center]
        self.tensors[self.center] = t / _norm(t)

    def full_tensor(self) -> torch.Tensor:
        return full_tensor(self.tensors).reshape([self.qudit] * self.nsite)

    def inner(self, other, form: str = 'norm') -> torch.Tensor:
        other_t = other.tensors if isinstance(other, MatrixProductState) else other
        return inner_product_mps(self.tensors, other_t)

    def apply_mpo(self, mpo: list, sites: list[int]) -> None:
        self.tensors = apply_mpo(self.tensors, mpo, sites)

    def check_center_orthogonality(self, prt: bool = False):
        """Per site, sum |M^H M - I| left of the center and |M M^H - I|
        right of it (None at the center); None without a center."""
        if self.center < 0:
            return None
        err = [None] * self.nsite
        for i in range(self.center):
            m = self.tensors[i].reshape(-1, self.tensors[i].shape[-1])
            eye = torch.eye(m.shape[1], dtype=m.dtype, device=m.device)
            err[i] = float((m.mH @ m - eye).abs().sum())
        for i in range(self.nsite - 1, self.center, -1):
            m = self.tensors[i].reshape(self.tensors[i].shape[0], -1)
            eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
            err[i] = float((m @ m.mH - eye).abs().sum())
        if prt:
            print(err)
        return err


def sample_mps(state, shots: int = 1024, generator: torch.Generator | None = None):
    """(shots, n) site values of an MPS drawn by exact ancestral sampling,
    on its device.

    The right environments R_i of sites i.. are built once from the right;
    then, site by site, every shot's conditional distribution over the
    site's value is p(b) ~ a_b R_{i+1} a_b^H with a_b its left environment
    times the site tensor, and ``torch.multinomial`` draws all shots' values
    at once from ``generator``. The site shapes differ, so the sites are a
    Python loop."""
    if isinstance(state, tuple):
        tensors = state[0]
    elif isinstance(state, MatrixProductState):
        tensors = state.tensors
    else:
        tensors = state
    n = len(tensors)
    with torch.no_grad():
        tensors = [t.detach() for t in tensors]
        dev = tensors[0].device
        renvs = [None] * (n + 1)
        renvs[n] = torch.ones((1, 1), dtype=tensors[-1].dtype, device=dev)
        for i in range(n - 1, -1, -1):
            t = tensors[i]
            renvs[i] = torch.einsum('adb,be,cde->ac', t, renvs[i + 1], t.conj())
        env = torch.ones((shots, 1), dtype=tensors[0].dtype, device=dev)
        bits = []
        rows = torch.arange(shots, device=dev)
        for i, t in enumerate(tensors):
            amp = torch.einsum('sa,adb->sdb', env, t)
            pd = torch.einsum('sdb,bc,sdc->sd', amp, renvs[i + 1], amp.conj()).real
            pd = pd.clamp_min(0)
            b = torch.multinomial(pd, 1, replacement=True, generator=generator)[:, 0]
            bits.append(b)
            env = amp[rows, b]
            env = env / torch.linalg.vector_norm(env, dim=-1, keepdim=True)
        return torch.stack(bits, dim=1)


def measure_mps(state, shots: int = 1024, wires=None, with_prob: bool = False,
                generator: torch.Generator | None = None) -> dict:
    """Sample bitstrings of an MPS by exact ancestral sampling
    (``sample_mps``). Returns {bitstring: count} on the sorted ``wires``
    (all by default); ``with_prob`` adds each full bitstring's probability
    (None for a marginal)."""
    tensors = state[0] if isinstance(state, tuple) else \
        state.tensors if isinstance(state, MatrixProductState) else state
    n = len(tensors)
    samples = sample_mps(tensors, shots, generator).cpu().numpy()
    if wires is not None:
        samples = samples[:, sorted(wires)]
    result = dict(Counter(''.join(map(str, row)) for row in samples.tolist()))
    if with_prob:
        full = wires is None or len(wires) == n
        for bstr in result:
            p = float(bitstring_prob(tensors, bstr)) if full else None
            result[bstr] = (result[bstr], p)
    return result
