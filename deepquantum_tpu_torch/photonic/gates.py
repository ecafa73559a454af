"""Photonic gate library: creation-operator unitaries and symplectic transforms.

PyTorch counterpart of ``deepquantum_tpu/photonic/gates.py``. A gate is up
to two pure functions of its parameter vector p (a 1-D real tensor; the
results live on p's device):

- ``*_unitary(p)``: k x k matrix on creation operators (passive gates only)
- ``*_xp(p)``: affine symplectic (matrix, vector) in xxpp ordering

p may carry leading batch axes (..., npara), one gate per row (a batch of
data rows); the matrices then are (..., k, k). The Fock-space recurrences
(``*_fock``) and the gates that have only those (cubic phase, Kerr,
cross-Kerr) are not ported yet: ``PHOTONIC_REGISTRY`` carries
``fock=None``, and a Fock-backend circuit refuses the CV-only gates.
"""

from __future__ import annotations

import torch

from .. import config
from ..config import cdtype, rdtype

__all__ = ['PHOTONIC_REGISTRY', 'ps_unitary', 'ps_xp', 'bs_unitary', 'mzi_unitary',
           'bs_single_unitary', 'passive_xp_from_unitary', 'squeeze_xp', 'squeeze2_xp', 'disp_xp',
           'disp_position_xp', 'disp_momentum_xp', 'quad_phase_xp', 'cx_xp', 'cz_xp']


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


def _passive(unitary_fn):
    return lambda p: passive_xp_from_unitary(unitary_fn(p))


# registry: name -> dict(nwires, npara, unitary, xp, fock)
PHOTONIC_REGISTRY = {
    'PhaseShift': dict(nwires=1, npara=1, unitary=ps_unitary, xp=ps_xp, fock=None),
    'BeamSplitter': dict(nwires=2, npara=2, unitary=bs_unitary, xp=_passive(bs_unitary),
                         fock=None),
    'MZI': dict(nwires=2, npara=2, unitary=mzi_unitary, xp=_passive(mzi_unitary), fock=None),
    'Squeezing': dict(nwires=1, npara=2, unitary=None, xp=squeeze_xp, fock=None),
    'Squeezing2': dict(nwires=2, npara=2, unitary=None, xp=squeeze2_xp, fock=None),
    'Displacement': dict(nwires=1, npara=2, unitary=None, xp=disp_xp, fock=None),
    'DisplacementPosition': dict(nwires=1, npara=1, unitary=None, xp=disp_position_xp, fock=None),
    'DisplacementMomentum': dict(nwires=1, npara=1, unitary=None, xp=disp_momentum_xp, fock=None),
    'QuadraticPhase': dict(nwires=1, npara=1, unitary=None, xp=quad_phase_xp, fock=None),
    'ControlledX': dict(nwires=2, npara=1, unitary=None, xp=cx_xp, fock=None),
    'ControlledZ': dict(nwires=2, npara=1, unitary=None, xp=cz_xp, fock=None),
}
