"""Clements/Reck decomposition of an optical unitary into an MZI mesh.

The port's own copy of ``deepquantum_tpu/photonic/decompose.py`` (host-side
numpy, build-time only; the port imports nothing of the JAX package).
Implements the 'cssr' scheme of the
reference (reference src/deepquantum/photonic/decompose.py:9-390): Clements
elimination along antidiagonals using T U and U T^-1 Givens steps with the
single-arm MZI convention U_MZI = i e^{i theta/2} [[e^{i phi} sin(theta/2),
cos(theta/2)], [e^{i phi} cos(theta/2), -sin(theta/2)]], then commuting the
left factors through the diagonal. The Reck variants ('rssr', 'rssl') are
not carried over: nothing in the port uses them.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

__all__ = ['UnitaryDecomposer']

TWO_PI = 2 * np.pi


def _period_cut(x, period=TWO_PI):
    return x - np.floor(x / period) * period


def _factor_inv_ss(theta):
    return -1j * np.exp(-1j * theta / 2)


def _mzi_embed(n, jj, ii, phi, theta, kind):
    """Embedded MZI factor ('ss' convention): kind in {constr_r, inv_r}."""
    m = np.eye(n, dtype=complex)
    s, c = np.sin(theta / 2), np.cos(theta / 2)
    if kind == 'constr_r':
        f = np.conjugate(_factor_inv_ss(theta))
        e = np.exp(1j * phi)
        m[jj, jj], m[jj, ii], m[ii, jj], m[ii, ii] = f * e * s, f * c, f * e * c, -f * s
    else:
        f = _factor_inv_ss(theta)
        e = np.exp(-1j * phi)
        m[jj, jj], m[jj, ii], m[ii, jj], m[ii, ii] = f * e * s, f * e * c, f * c, -f * s
    return m


def _diag_transform_ss(phi, theta, a1, a2):
    """Commute a left MZI factor through the diagonal ('ss', reference decompose.py:306)."""
    theta_ = theta
    phi_ = a1 - a2
    b1 = a2 - phi + np.pi - theta
    b2 = a2 + np.pi - theta
    return phi_, theta_, b1, b2


class UnitaryDecomposer:
    """Decompose a unitary into MZI angles (API parity with reference decompose.py:9)."""

    def __init__(self, unitary, method: str = 'cssr') -> None:
        self.unitary = np.array(unitary, dtype=complex)
        assert self.unitary.ndim == 2 and self.unitary.shape[0] == self.unitary.shape[1], \
            'The matrix to be decomposed must be a square matrix.'
        if np.abs(self.unitary @ self.unitary.conj().T - np.eye(len(self.unitary))).sum() \
                / len(self.unitary) ** 2 > 1e-6:
            print('Make sure the input matrix is unitary.')
        self.unitary[np.abs(self.unitary) < 1e-32] = 1e-32
        if method != 'cssr':
            raise NotImplementedError(f"UnitaryDecomposer: method {method!r} is not ported "
                                      "(only 'cssr')")
        self.method = method

    def decomp(self):
        info = self._decomp_cssr()
        dic_mzi = self.sort_mzi(info)
        dic_pos = self.ps_pos(dic_mzi, info['phase_angle'])
        return info, dic_mzi, dic_pos

    def _decomp_cssr(self) -> dict:
        u = self.unitary.copy()
        n = len(u)
        info = {'N': n, 'method': 'cssr', 'MZI_list': [], 'right': [], 'left': []}
        for i in range(n - 1):
            if i % 2:  # left-multiply elimination T U
                for j in range(i + 1):
                    jj = j
                    ii = n - 1 - i + j
                    ratio = u[ii - 1, jj] / (u[ii, jj] + 1e-32)
                    theta = 2 * np.arctan(np.abs(ratio))
                    phi = -np.angle(ratio)
                    u = _mzi_embed(n, ii - 1, ii, phi, theta, 'constr_r') @ u
                    info['left'].append([ii - 1, ii, phi, theta])
            else:  # right-multiply elimination U T^-1
                for j in range(i + 1)[::-1]:
                    jj = j
                    ii = n - 1 - i + j
                    ratio = u[ii, jj + 1] / (u[ii, jj] + 1e-32)
                    theta = 2 * np.arctan(np.abs(ratio))
                    phi = -np.angle(-ratio)
                    u = u @ _mzi_embed(n, jj, jj + 1, phi, theta, 'inv_r')
                    info['right'].append([jj, jj + 1, phi, theta])
        phase_angle = np.angle(np.diag(u))
        info['phase_angle_ori'] = phase_angle.copy()
        for jj, ii, phi, theta in info['right']:
            info['MZI_list'].append([jj, ii, _period_cut(phi), _period_cut(theta)])
        for jj, ii, phi, theta in info['left'][::-1]:
            phi_, theta_, phase_angle[jj], phase_angle[ii] = _diag_transform_ss(
                phi, theta, phase_angle[jj], phase_angle[ii])
            info['MZI_list'].append([jj, ii, _period_cut(phi_), _period_cut(theta_)])
        info['phase_angle'] = _period_cut(phase_angle.copy())
        return info

    def sort_mzi(self, mzi_info) -> dict:
        """Group MZI angles by mode pair (reference decompose.py:364)."""
        dic_mzi = defaultdict(list)
        for item in mzi_info['MZI_list']:
            dic_mzi[tuple(item[0:2])].append(item[2:])
        return dic_mzi

    def ps_pos(self, dic_mzi, phase_angle):
        """Positions of phase shifters for 'cssr' (reference decompose.py:372)."""
        dic_pos = {}
        nmode = self.unitary.shape[0]
        for mode in range(nmode):
            value = np.array(dic_mzi[(mode, mode + 1)]).flatten()
            k = -1
            for k in range(len(value)):
                dic_pos[(mode, k)] = np.round(value[k], 4)
            if mode == nmode - 1:
                dic_pos[(mode, 0)] = np.round(phase_angle[mode], 4)
            else:
                dic_pos[(mode, k + 1)] = np.round(phase_angle[mode], 4)
        return dic_pos
