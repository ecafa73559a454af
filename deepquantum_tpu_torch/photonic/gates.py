"""Photonic gate library: creation-operator unitaries, symplectic transforms
and Fock matrices.

PyTorch counterpart of ``deepquantum_tpu/photonic/gates.py``. A gate is up
to three pure functions of its parameter vector p (a 1-D real tensor; the
results live on p's device):

- ``*_unitary(p)``: k x k matrix on creation operators (passive gates only)
- ``*_xp(p)``: affine symplectic (matrix, vector) in xxpp ordering
- ``*_fock(p, cutoff)``: the (cutoff,)*2k transformation tensor on Fock
  states, output axes first

p may carry leading batch axes (..., npara), one gate per row (a batch of
data rows); the matrices then are (..., k, k) and the Fock tensors (...,
cutoff, ..., cutoff). The Fock tensors follow the recurrences of
arXiv:2004.11002 (Eq. 74-75 for a beam splitter, 51-52 for squeezing, 57-58
for displacement, 64-67 for two-mode squeezing), one Python step per rank
over the cutoff, each step one vectorised update of the whole slice. The
cubic phase, Kerr and cross-Kerr gates exist only as Fock matrices; an
arbitrary fixed unitary's Fock tensor (``uany_fock_np``) is host numpy,
made once when the gate is added.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .. import config
from ..config import cdtype, rdtype

__all__ = ['PHOTONIC_REGISTRY', 'ps_unitary', 'ps_xp', 'bs_unitary', 'mzi_unitary',
           'bs_single_unitary', 'passive_xp_from_unitary', 'squeeze_xp', 'squeeze2_xp', 'disp_xp',
           'disp_position_xp', 'disp_momentum_xp', 'quad_phase_xp', 'cx_xp', 'cz_xp',
           'ps_fock', 'bs_fock_from_unitary', 'bs_fock', 'mzi_fock', 'bs_single_fock',
           'squeeze_fock', 'squeeze2_fock', 'disp_fock', 'disp_position_fock',
           'disp_momentum_fock', 'quad_phase_fock', 'cx_fock', 'cz_fock', 'cubic_phase_fock',
           'kerr_fock', 'cross_kerr_fock', 'passive_fock', 'uany_fock_np']


def _r(x):
    return x.to(rdtype())


def _c(x):
    return x.to(cdtype())


def _mat(entries, rows: int) -> torch.Tensor:
    """Row-major entries of (..., rows, cols) matrices, one per batch row."""
    m = torch.stack(entries, -1)
    return m.reshape(m.shape[:-1] + (rows, -1))


def _zero_vec(p, k: int) -> torch.Tensor:
    """The (..., 2k, 1) zero displacement of a k-mode gate."""
    return torch.zeros(p.shape[:-1] + (2 * k, 1), dtype=rdtype(), device=p.device)


def _eye(p, size: int) -> torch.Tensor:
    return torch.eye(size, dtype=rdtype(), device=p.device).expand(p.shape[:-1] + (size, size))


def _const(p, value: float) -> torch.Tensor:
    return torch.full(p.shape[:-1], value, dtype=rdtype(), device=p.device)


# --------------------------------------------------------------- PhaseShift
def ps_unitary(p):
    return _mat([torch.exp(1j * _c(p[..., 0]))], 1)


def ps_xp(p):
    theta = _r(p[..., 0])
    cos, sin = torch.cos(theta), torch.sin(theta)
    return _mat([cos, -sin, sin, cos], 2), _zero_vec(p, 1)


def ps_inv_unitary(p):
    """PhaseShift(-theta): ``r(..., inv_mode=True)``."""
    return ps_unitary(-p)


def ps_inv_xp(p):
    return ps_xp(-p)


# ------------------------------------------------------ BeamSplitter family
def bs_unitary(p):
    """BS(theta, phi) on creation operators."""
    theta, phi = _r(p[..., 0]), _r(p[..., 1])
    cos = _c(torch.cos(theta))
    sin = _c(torch.sin(theta))
    return _mat([cos, -torch.exp(-1j * _c(phi)) * sin, torch.exp(1j * _c(phi)) * sin, cos], 2)


def mzi_unitary(p, phi_first: bool = True):
    """MZI(theta, phi): the phase shifter before (phi_first) or after the
    first coupler."""
    theta, phi = _r(p[..., 0]), _r(p[..., 1])
    cos = _c(torch.cos(theta / 2))
    sin = _c(torch.sin(theta / 2))
    e_it = 1j * torch.exp(1j * _c(theta) / 2)
    e_ip = torch.exp(1j * _c(phi))
    if phi_first:
        mat = _mat([e_ip * sin, cos, e_ip * cos, -sin], 2)
    else:
        mat = _mat([e_ip * sin, e_ip * cos, cos, -sin], 2)
    return e_it[..., None, None] * mat


def bs_single_unitary(p, convention: str = 'rx'):
    """One-parameter beam splitter in the rx / ry / h convention (half
    angle)."""
    theta = _r(p[..., 0])
    cos = _c(torch.cos(theta / 2))
    sin = _c(torch.sin(theta / 2))
    if convention == 'rx':
        return _mat([cos, 1j * sin, 1j * sin, cos], 2)
    if convention == 'ry':
        return _mat([cos, -sin, sin, cos], 2)
    if convention == 'h':
        return _mat([cos, sin, sin, -cos], 2)
    raise ValueError(f'Unknown convention {convention}')


def bs_theta_unitary(p, phi: float):
    """BS(theta, phi) with phi fixed."""
    return bs_unitary(torch.stack([_r(p[..., 0]), _const(p, phi)], -1))


def bs_phi_unitary(p, theta: float):
    """BS(theta, phi) with theta fixed."""
    return bs_unitary(torch.stack([_const(p, theta), _r(p[..., 0])], -1))


def passive_xp_from_unitary(u):
    """Symplectic of a passive unitary: [[Re, -Im], [Im, Re]]."""
    k = u.shape[-1]
    m = torch.cat([torch.cat([u.real, -u.imag], -1), torch.cat([u.imag, u.real], -1)], -2)
    return m, torch.zeros(u.shape[:-2] + (2 * k, 1), dtype=rdtype(), device=u.device)


# ------------------------------------------------ Squeezing and displacement
def squeeze_xp(p):
    """S(r, theta) symplectic."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    ch, sh = torch.cosh(r), torch.sinh(r)
    cos, sin = torch.cos(theta), torch.sin(theta)
    m = _mat([ch - sh * cos, -sh * sin, -sh * sin, ch + sh * cos], 2)
    return m, _zero_vec(p, 1)


def squeeze2_xp(p):
    """Two-mode squeezing S2(r, theta) symplectic."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    ch, sh = torch.cosh(r), torch.sinh(r)
    cs, ss = torch.cos(theta) * sh, torch.sin(theta) * sh
    z = torch.zeros_like(r)
    m = _mat([ch, cs, z, ss,
              cs, ch, ss, z,
              z, ss, ch, -cs,
              ss, z, -cs, ch], 4)
    return m, _zero_vec(p, 2)


def disp_xp(p):
    """D(r, theta): identity plus a displacement."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    vec = _mat([r * torch.cos(theta), r * torch.sin(theta)], 2)
    return _eye(p, 2), vec * config.HBAR ** 0.5 / config.KAPPA


def disp_position_xp(p):
    """X(x): displacement along x."""
    x = _r(p[..., 0])
    return _eye(p, 2), _mat([x, torch.zeros_like(x)], 2)


def disp_momentum_xp(p):
    """Z(z): displacement along p."""
    z = _r(p[..., 0])
    return _eye(p, 2), _mat([torch.zeros_like(z), z], 2)


# ------------------------------------------- quadratic phase, CX and CZ
def quad_phase_xp(p):
    """P(s): [[1, 0], [s, 1]]."""
    s = _r(p[..., 0])
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return _mat([one, zero, s, one], 2), _zero_vec(p, 1)


def cx_xp(p):
    """CV controlled-X(s): x2 += s x1, p1 -= s p2."""
    s = _r(p[..., 0])
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    m = _mat([one, zero, zero, zero,
              s, one, zero, zero,
              zero, zero, one, -s,
              zero, zero, zero, one], 4)
    return m, _zero_vec(p, 2)


def cz_xp(p):
    """CV controlled-Z(s): p1 += s x2, p2 += s x1."""
    s = _r(p[..., 0])
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    m = _mat([one, zero, zero, zero,
              zero, one, zero, zero,
              zero, s, one, zero,
              s, zero, zero, one], 4)
    return m, _zero_vec(p, 2)




# ------------------------------------------------------------- Fock matrices
def _sqrtn(cutoff: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """sqrt(n) for n < cutoff, and 1 / sqrt(n) with 0 at n = 0."""
    sqrt = torch.arange(cutoff, dtype=rdtype(), device=device).sqrt()
    inv = torch.where(sqrt > 0, 1 / torch.where(sqrt > 0, sqrt, torch.ones_like(sqrt)),
                      torch.zeros_like(sqrt))
    return sqrt, inv


def _shift(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x[..., m - 1, ...] along ``dim`` (a negative axis), 0 at m = 0."""
    pad = torch.zeros_like(x.narrow(dim, 0, 1))
    return torch.cat([pad, x.narrow(dim, 0, x.shape[dim] - 1)], dim)


def _scalar(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(...,) -> (..., 1, ..., 1) against ndim trailing axes."""
    return x.reshape(x.shape + (1,) * ndim)


def ps_fock(p, cutoff: int):
    """PS(theta) = diag(e^(i theta n))."""
    n = torch.arange(cutoff, dtype=rdtype(), device=p.device)
    return torch.diag_embed(torch.exp(1j * _c(p[..., 0:1] * n)))


def passive_fock(u, cutoff: int):
    """The Fock tensor of a one- or two-mode passive unitary on creation
    operators: diag(u^n), or the beam-splitter recurrence."""
    if u.shape[-1] == 1:
        n = torch.arange(cutoff, dtype=rdtype(), device=u.device)
        return torch.diag_embed(u[..., 0, :] ** n.to(u.dtype))
    return bs_fock_from_unitary(u, cutoff)


def bs_fock_from_unitary(u, cutoff: int):
    """The (m, n, p, q) Fock tensor of a two-mode passive unitary u (..., 2,
    2) on creation operators (Eq. 74-75): the rank-3 slice (q = 0) over p,
    then rank 4 over q."""
    sqrt, inv = _sqrtn(cutoff, u.device)
    u = _c(u)
    lead = u.shape[:-2]
    r = torch.zeros(lead + (cutoff, cutoff), dtype=cdtype(), device=u.device)
    r[..., 0, 0] = 1
    u00, u10 = _scalar(u[..., 0, 0], 2), _scalar(u[..., 1, 0], 2)
    rank3 = [r]
    for p_idx in range(1, cutoff):
        r = inv[p_idx] * (sqrt[:, None] * u00 * _shift(r, -2) + sqrt * u10 * _shift(r, -1))
        rank3.append(r)
    s = torch.stack(rank3, -1)                                        # (..., m, n, p)
    u01, u11 = _scalar(u[..., 0, 1], 3), _scalar(u[..., 1, 1], 3)
    full = [s]
    for q_idx in range(1, cutoff):
        s = inv[q_idx] * (sqrt[:, None, None] * u01 * _shift(s, -3)
                          + sqrt[:, None] * u11 * _shift(s, -2))
        full.append(s)
    return torch.stack(full, -1)                                      # (..., m, n, p, q)


def bs_fock(p, cutoff: int):
    return bs_fock_from_unitary(bs_unitary(p), cutoff)


def mzi_fock(p, cutoff: int, phi_first: bool = True):
    return bs_fock_from_unitary(mzi_unitary(p, phi_first), cutoff)


def bs_single_fock(p, cutoff: int, convention: str = 'rx'):
    return bs_fock_from_unitary(bs_single_unitary(p, convention), cutoff)


def squeeze_fock(p, cutoff: int):
    """S(r, theta) Fock matrix (Eq. 51-52): column 0 from its even
    entries, then column by column."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    sqrt, inv = _sqrtn(cutoff, p.device)
    sech = 1 / torch.cosh(r)
    tanh = _c(torch.tanh(r))
    e_it_tanh = torch.exp(1j * _c(theta)) * tanh
    e_m_it_tanh = torch.exp(-1j * _c(theta)) * tanh
    zero = torch.zeros_like(e_it_tanh)
    col0 = [_c(torch.sqrt(sech))]
    for m in range(1, cutoff):
        col0.append(-sqrt[m - 1] * inv[m] * e_it_tanh * col0[m - 2] if m % 2 == 0 else zero)
    col = torch.stack(col0, -1)                                       # (..., m)
    sech_sqrt = sqrt * _scalar(_c(sech), 1)
    e_m = _scalar(e_m_it_tanh, 1)
    cols, prev = [col], torch.zeros_like(col)
    for n in range(cutoff - 1):
        new = inv[n + 1] * (sech_sqrt * _shift(col, -1) + sqrt[n] * e_m * prev)
        cols.append(new)
        col, prev = new, col
    return torch.stack(cols, -1)


def squeeze2_fock(p, cutoff: int):
    """S2(r, theta) Fock tensor (Eq. 64-67)."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    sqrt, inv = _sqrtn(cutoff, p.device)
    sech = _c(1 / torch.cosh(r))
    tanh = _c(torch.tanh(r))
    e_it_tanh = torch.exp(1j * _c(theta)) * tanh
    e_m_it_tanh = torch.exp(-1j * _c(theta)) * tanh
    n = torch.arange(cutoff, dtype=rdtype(), device=p.device)
    x = torch.diag_embed(_scalar(sech, 1) * _scalar(e_it_tanh, 1) ** n.to(cdtype()))
    sech2, sech3 = _scalar(sech, 2), _scalar(sech, 3)
    rank3 = [x]
    for p_idx in range(1, cutoff):
        x = sech2 * sqrt[:, None] * inv[p_idx] * _shift(x, -2)
        rank3.append(x)
    s = torch.stack(rank3, -1)                                        # (..., m, n, p)
    e_m = _scalar(e_m_it_tanh, 3)
    full = [s]
    for q_idx in range(1, cutoff):
        s = inv[q_idx] * (sech3 * sqrt[:, None] * _shift(s, -2) - e_m * sqrt * _shift(s, -1))
        full.append(s)
    return torch.stack(full, -1)                                      # (..., m, n, p, q)


def disp_fock(p, cutoff: int):
    """D(r, theta) Fock matrix (Eq. 57-58): column 0 is the coherent state,
    then column by column."""
    r, theta = _r(p[..., 0]), _r(p[..., 1])
    sqrt, inv = _sqrtn(cutoff, p.device)
    alpha = _scalar(_c(r) * torch.exp(1j * _c(theta)), 1)
    alpha_c = _scalar(_c(r) * torch.exp(-1j * _c(theta)), 1)
    ratios = (alpha * inv)[..., 1:]
    ones = torch.ones(ratios.shape[:-1] + (1,), dtype=cdtype(), device=p.device)
    col = torch.exp(-_scalar(_c(r), 1) ** 2 / 2) * torch.cat([ones, torch.cumprod(ratios, -1)], -1)
    cols = [col]
    for n in range(cutoff - 1):
        col = inv[n + 1] * (-alpha_c * col + sqrt * _shift(col, -1))
        cols.append(col)
    return torch.stack(cols, -1)


def _disp_along(x, cutoff: int, positive: float, negative: float):
    r = x.abs() * config.KAPPA / config.HBAR ** 0.5
    theta = torch.where(x >= 0, _const(x[..., None], positive), _const(x[..., None], negative))
    return disp_fock(torch.stack([r, theta], -1), cutoff)


def disp_position_fock(p, cutoff: int):
    """X(x) = D(|x| kappa / sqrt(hbar), 0 or pi)."""
    return _disp_along(_r(p[..., 0]), cutoff, 0.0, np.pi)


def disp_momentum_fock(p, cutoff: int):
    """Z(z) = D(|z| kappa / sqrt(hbar), +-pi / 2)."""
    return _disp_along(_r(p[..., 0]), cutoff, np.pi / 2, -np.pi / 2)


def quad_phase_fock(p, cutoff: int):
    """P(s) = PS(theta) S(r, phi)."""
    s = _r(p[..., 0])
    r = torch.arccosh(torch.sqrt(1 + s ** 2 / 4))
    theta = torch.arctan(s / 2)
    phi = -torch.sign(s) * np.pi / 2 - theta
    return ps_fock(theta[..., None], cutoff) @ squeeze_fock(torch.stack([r, phi], -1), cutoff)


def cx_fock(p, cutoff: int):
    """CX(s) = BS S S BS."""
    s = _r(p[..., 0])
    zero = torch.zeros_like(s)
    r = torch.arcsinh(-s / 2)
    theta = torch.atan2(-1 / torch.cosh(r), -torch.tanh(r)) / 2
    bs1 = bs_fock(torch.stack([theta, zero], -1), cutoff)
    s1 = squeeze_fock(torch.stack([r, zero], -1), cutoff)
    s2 = squeeze_fock(torch.stack([-r, zero], -1), cutoff)
    bs2 = bs_fock(torch.stack([theta + np.pi / 2, zero], -1), cutoff)
    return torch.einsum('...abcd,...ce,...df,...efgh->...abgh', bs2, s1, s2, bs1)


def cz_fock(p, cutoff: int):
    """CZ(s) = (I x PS(pi / 2)) CX(s) (I x PS(-pi / 2))."""
    half = torch.full((1,), np.pi / 2, dtype=rdtype(), device=p.device)
    return torch.einsum('an,...mnkl,lb->...makb', ps_fock(half, cutoff), cx_fock(p, cutoff),
                        ps_fock(-half, cutoff))


def cubic_phase_fock(p, cutoff: int):
    """V(gamma) = exp(i gamma x^3 / (3 hbar))."""
    from .qmath import ladder_ops
    a, ad = ladder_ops(cutoff, device=p.device)
    x = (a + ad) * config.HBAR ** 0.5 / (2 * config.KAPPA)
    x3 = x @ x @ x
    gamma = _scalar(_c(_r(p[..., 0])), 2)
    return torch.linalg.matrix_exp(1j * gamma * x3 / (3 * config.HBAR))


def kerr_fock(p, cutoff: int):
    """K(kappa) = diag(e^(i kappa n^2))."""
    n = torch.arange(cutoff, dtype=rdtype(), device=p.device)
    return torch.diag_embed(torch.exp(1j * _c(p[..., 0:1] * n ** 2)))


def cross_kerr_fock(p, cutoff: int):
    """CK(kappa) = diag(e^(i kappa n1 n2)) on two modes."""
    n = torch.arange(cutoff, dtype=rdtype(), device=p.device)
    n1n2 = (n[:, None] * n).reshape(-1)
    mat = torch.diag_embed(torch.exp(1j * _c(p[..., 0:1] * n1n2)))
    return mat.reshape(mat.shape[:-2] + (cutoff,) * 4)


def uany_fock_np(matrix: np.ndarray, nt: int, cutoff: int) -> np.ndarray:
    """The (cutoff,)*2nt Fock tensor of an arbitrary nt-mode unitary on
    creation operators (Eq. 71), complex128 host numpy (the gate has no
    parameter: ``QumodeCircuit.any`` makes it once and keeps it)."""
    matrix = np.asarray(matrix, dtype=np.complex128)
    sqrt = np.sqrt(np.arange(cutoff))
    tran = np.zeros([cutoff] * (2 * nt), dtype=np.complex128)
    tran[tuple([0] * 2 * nt)] = 1.0
    for rank in range(nt + 1, 2 * nt + 1):
        mj = matrix[:, rank - nt - 1]
        for modes in itertools.product(range(cutoff), repeat=rank - 1):
            in_rest = sum(modes[:nt]) - sum(modes[nt:])
            if 0 < in_rest < cutoff:
                state = list(modes) + [in_rest] + [0] * (2 * nt - rank)
                tot = 0
                for i in range(nt):
                    pre = list(state)
                    pre[i] -= 1
                    pre[len(modes)] -= 1
                    if pre[i] >= 0:
                        tot += mj[i] * sqrt[modes[i]] * tran[tuple(pre)]
                tran[tuple(state)] = tot / sqrt[in_rest]
    return tran


def _passive(unitary_fn):
    return lambda p: passive_xp_from_unitary(unitary_fn(p))


# registry: name -> dict(nwires, npara, unitary, xp, fock)
PHOTONIC_REGISTRY = {
    'PhaseShift': dict(nwires=1, npara=1, unitary=ps_unitary, xp=ps_xp, fock=ps_fock),
    'BeamSplitter': dict(nwires=2, npara=2, unitary=bs_unitary, xp=_passive(bs_unitary),
                         fock=bs_fock),
    'MZI': dict(nwires=2, npara=2, unitary=mzi_unitary, xp=_passive(mzi_unitary), fock=mzi_fock),
    'Squeezing': dict(nwires=1, npara=2, unitary=None, xp=squeeze_xp, fock=squeeze_fock),
    'Squeezing2': dict(nwires=2, npara=2, unitary=None, xp=squeeze2_xp, fock=squeeze2_fock),
    'Displacement': dict(nwires=1, npara=2, unitary=None, xp=disp_xp, fock=disp_fock),
    'DisplacementPosition': dict(nwires=1, npara=1, unitary=None, xp=disp_position_xp,
                                 fock=disp_position_fock),
    'DisplacementMomentum': dict(nwires=1, npara=1, unitary=None, xp=disp_momentum_xp,
                                 fock=disp_momentum_fock),
    'QuadraticPhase': dict(nwires=1, npara=1, unitary=None, xp=quad_phase_xp, fock=quad_phase_fock),
    'ControlledX': dict(nwires=2, npara=1, unitary=None, xp=cx_xp, fock=cx_fock),
    'ControlledZ': dict(nwires=2, npara=1, unitary=None, xp=cz_xp, fock=cz_fock),
    'CubicPhase': dict(nwires=1, npara=1, unitary=None, xp=None, fock=cubic_phase_fock),
    'Kerr': dict(nwires=1, npara=1, unitary=None, xp=None, fock=kerr_fock),
    'CrossKerr': dict(nwires=2, npara=1, unitary=None, xp=None, fock=cross_kerr_fock),
}
