"""Qubit gate matrix library: differentiable torch functions.

PyTorch counterpart of ``deepquantum_tpu/ops/gates.py`` with identical
matrix conventions (half-angle Rx/Ry/Rz, U3(theta, phi, lambda), the
two-qubit rotations, the full-angle reconfigurable beam splitter). A
parametrised gate takes real scalars (tensors or floats) and returns a
(2^k, 2^k) complex tensor on the parameters' device; angles of shape (B,)
give a (B, 2^k, 2^k) stack, one matrix per sample (the port's counterpart
of the JAX package's ``jax.vmap`` over a gate's matrix). A fixed gate takes
an optional ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import cdtype, rdtype

__all__ = [
    'u3_matrix', 'phaseshift_matrix', 'identity_matrix', 'paulix_matrix', 'pauliy_matrix',
    'pauliz_matrix', 'hadamard_matrix', 's_matrix', 'sdg_matrix', 't_matrix', 'tdg_matrix',
    'rx_matrix', 'ry_matrix', 'rz_matrix', 'projection_j_matrix', 'cnot_matrix', 'swap_matrix',
    'iswap_matrix', 'rxx_matrix', 'ryy_matrix', 'rzz_matrix', 'rxy_matrix', 'rbs_matrix',
    'toffoli_matrix', 'fredkin_matrix', 'hamiltonian_matrix', 'latent_matrix', 'cz_matrix',
]


def _r(x):
    """Real parameter in the policy real dtype (keeps a tensor's device)."""
    return torch.as_tensor(x, dtype=rdtype())


def _c(x):
    return x.to(cdtype())


def _mat(entries, k: int = 2):
    """(k, k) matrices from their row-major entries, each entry a tensor of
    the angles' shape: the matrices stack behind the angles' axes."""
    m = torch.stack(torch.broadcast_tensors(*entries), dim=-1)
    return m.reshape(*m.shape[:-1], k, k)


def _const(a, device=None):
    return torch.tensor(np.asarray(a), dtype=cdtype(), device=device)


def u3_matrix(theta, phi, lambd):
    theta, phi, lambd = _r(theta), _r(phi), _r(lambd)
    cos = _c(torch.cos(theta / 2))
    sin = _c(torch.sin(theta / 2))
    e_ip = torch.exp(1j * _c(phi))
    e_il = torch.exp(1j * _c(lambd))
    return _mat([cos, -e_il * sin, e_ip * sin, e_ip * e_il * cos])


def phaseshift_matrix(theta):
    e_i = torch.exp(1j * _c(_r(theta)))
    one = torch.ones_like(e_i)
    zero = torch.zeros_like(e_i)
    return _mat([one, zero, zero, e_i])


def identity_matrix(device=None):
    return _const(np.eye(2), device)


def paulix_matrix(device=None):
    return _const([[0, 1], [1, 0]], device)


def pauliy_matrix(device=None):
    return _const([[0, -1j], [1j, 0]], device)


def pauliz_matrix(device=None):
    return _const([[1, 0], [0, -1]], device)


def hadamard_matrix(device=None):
    return _const(np.array([[1, 1], [1, -1]]) / np.sqrt(2.0), device)


def s_matrix(device=None):
    return _const([[1, 0], [0, 1j]], device)


def sdg_matrix(device=None):
    return _const([[1, 0], [0, -1j]], device)


def t_matrix(device=None):
    return _const([[1, 0], [0, (1 + 1j) / 2 ** 0.5]], device)


def tdg_matrix(device=None):
    return _const([[1, 0], [0, (1 - 1j) / 2 ** 0.5]], device)


def rx_matrix(theta):
    theta = _r(theta)
    cos = _c(torch.cos(theta / 2))
    isin = 1j * _c(torch.sin(theta / 2))
    return _mat([cos, -isin, -isin, cos])


def ry_matrix(theta):
    theta = _r(theta)
    cos = _c(torch.cos(theta / 2))
    sin = _c(torch.sin(theta / 2))
    return _mat([cos, -sin, sin, cos])


def rz_matrix(theta):
    theta = _r(theta)
    e_m = torch.exp(-1j * _c(theta) / 2)
    e_p = torch.exp(1j * _c(theta) / 2)
    zero = torch.zeros_like(e_m)
    return _mat([e_m, zero, zero, e_p])


def projection_j_matrix(theta, plane: str = 'xy'):
    """J-measurement gate for MBQC."""
    theta = _r(theta)
    plane = plane.lower()
    if plane in ('xy', 'yx'):
        e_m = torch.exp(-1j * _c(theta))
        one = torch.ones_like(e_m)
        return _mat([one, e_m, one, -e_m]) / 2 ** 0.5
    if plane in ('yz', 'zy'):
        c_p_s = _c(torch.cos(theta / 2) + torch.sin(theta / 2))
        c_m_s = _c(torch.cos(theta / 2) - torch.sin(theta / 2))
        return _mat([c_p_s, -1j * c_m_s, c_m_s, 1j * c_p_s]) / 2 ** 0.5
    if plane in ('zx', 'xz'):
        cos = _c(torch.cos(theta / 2))
        sin = _c(torch.sin(theta / 2))
        return _mat([cos, sin, sin, -cos])
    raise ValueError(f'Unsupported measurement plane: {plane}')


def cnot_matrix(device=None):
    return _const([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], device)


def cz_matrix(device=None):
    return _const(np.diag([1, 1, 1, -1]), device)


def swap_matrix(device=None):
    return _const([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], device)


def iswap_matrix(device=None):
    return _const([[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]], device)


def _two_qubit(entries):
    return _mat(entries, 4)


def rxx_matrix(theta):
    theta = _r(theta)
    cos = _c(torch.cos(theta / 2))
    isin = 1j * _c(torch.sin(theta / 2))
    z = torch.zeros_like(cos)
    return _two_qubit([cos, z, z, -isin,
                       z, cos, -isin, z,
                       z, -isin, cos, z,
                       -isin, z, z, cos])


def ryy_matrix(theta):
    theta = _r(theta)
    cos = _c(torch.cos(theta / 2))
    isin = 1j * _c(torch.sin(theta / 2))
    z = torch.zeros_like(cos)
    return _two_qubit([cos, z, z, isin,
                       z, cos, -isin, z,
                       z, -isin, cos, z,
                       isin, z, z, cos])


def rzz_matrix(theta):
    theta = _r(theta)
    e_m = torch.exp(-1j * _c(theta) / 2)
    e_p = torch.exp(1j * _c(theta) / 2)
    return torch.diag_embed(torch.stack([e_m, e_p, e_p, e_m], dim=-1))


def rxy_matrix(theta):
    theta = _r(theta)
    cos = _c(torch.cos(theta / 2))
    isin = 1j * _c(torch.sin(theta / 2))
    one = torch.ones_like(cos)
    z = torch.zeros_like(cos)
    return _two_qubit([one, z, z, z,
                       z, cos, -isin, z,
                       z, -isin, cos, z,
                       z, z, z, one])


def rbs_matrix(theta):
    """Reconfigurable beam splitter (full-angle Givens in the {01, 10} block)."""
    theta = _r(theta)
    cos = _c(torch.cos(theta))
    sin = _c(torch.sin(theta))
    one = torch.ones_like(cos)
    z = torch.zeros_like(cos)
    return _two_qubit([one, z, z, z,
                       z, cos, sin, z,
                       z, -sin, cos, z,
                       z, z, z, one])


def toffoli_matrix(device=None):
    m = np.eye(8, dtype=np.complex128)
    m[6:8, 6:8] = [[0, 1], [1, 0]]
    return _const(m, device)


def fredkin_matrix(device=None):
    m = np.eye(8, dtype=np.complex128)
    m[5:7, 5:7] = [[0, 1], [1, 0]]
    return _const(m, device)


def hamiltonian_matrix(ham, t):
    """exp(-i H t)."""
    t = _r(t)
    ham = torch.as_tensor(ham, dtype=cdtype(), device=t.device)
    return torch.linalg.matrix_exp(-1j * ham * _c(t)[..., None, None])


def latent_matrix(latent):
    """Closest unitary to an arbitrary latent matrix via polar projection U Vh."""
    latent = torch.as_tensor(latent).to(cdtype())
    u, _, vh = torch.linalg.svd(latent)
    return u @ vh
