"""Photonic ansatz circuits.

PyTorch counterpart of ``deepquantum_tpu/photonic/ansatz.py``. The Clements
``dict2data`` angle ordering mirrors the JAX package exactly: the
(column, mode) -> parameter-slot mapping is a fixed hardware convention.
``GraphGBS`` is not ported yet (it needs ``takagi``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .circuit import QumodeCircuit

__all__ = ['Clements', 'GaussianBosonSampling']


class Clements(QumodeCircuit):
    """Rectangular MZI mesh whose angles are the circuit's input data."""

    def __init__(self, nmode: int, init_state: Any, cutoff: int | None = None,
                 basis: bool = True, phi_first: bool = True, noise: bool = False,
                 mu: float = 0, sigma: float = 0.1, device=None) -> None:
        super().__init__(nmode=nmode, init_state=init_state, cutoff=cutoff, basis=basis,
                         name='Clements', noise=noise, mu=mu, sigma=sigma, device=device)
        self.phi_first = phi_first
        wires = list(range(nmode))
        self.wires = wires
        if not phi_first:
            for wire in wires:
                self.ps(wire, encode=True)
        for i in range(nmode):
            for w in (wires[1::2] if i % 2 == 0 else wires[2::2]):
                self.mzi([w - 1, w], phi_first=phi_first, encode=True)
        if phi_first:
            for wire in wires:
                self.ps(wire, encode=True)

    def dict2data(self, angle_dict: dict) -> np.ndarray:
        """Angle dict {(mode, column): angle} -> circuit input data."""
        angle_dict = {k: np.asarray(v).reshape(-1) for k, v in angle_dict.items()}
        data = []
        columns = np.zeros(self.nmode, dtype=np.int64)
        wires1 = self.wires[1::2]
        wires2 = self.wires[2::2]
        if not self.phi_first:
            for i in range(self.nmode):
                data.append(angle_dict[(i, columns[i])])
                columns[i] += 1
        for i in range(self.nmode):
            wires_col = wires1 if i % 2 == 0 else wires2
            for w in wires_col:
                wire = w - 1
                if self.phi_first:
                    phi = angle_dict[(wire, columns[wire])]
                    theta = angle_dict[(wire, columns[wire] + 1)]
                else:
                    theta = angle_dict[(wire, columns[wire])]
                    phi = angle_dict[(wire, columns[wire] + 1)]
                data.append(theta)
                data.append(phi)
                columns[wire] += 2
        if self.phi_first:
            for i in range(self.nmode):
                data.append(angle_dict[(i, columns[i])])
                columns[i] += 1
        return np.concatenate(data)


class GaussianBosonSampling(QumodeCircuit):
    """Gaussian boson sampling: one squeezer per mode, then a Clements mesh
    of the given unitary."""

    def __init__(self, nmode: int, squeezing: Any, unitary: Any, cutoff: int | None = None,
                 backend: str = 'gaussian', basis: bool = True, detector: str = 'pnrd',
                 noise: bool = False, mu: float = 0, sigma: float = 0.1, device=None) -> None:
        squeezing = np.asarray(squeezing).reshape(-1)
        unitary = np.asarray(unitary, dtype=np.complex128).reshape(-1, nmode)
        if unitary.shape != (nmode, nmode) \
                or not np.allclose(unitary @ unitary.conj().T, np.eye(nmode), atol=1e-4):
            raise ValueError('GaussianBosonSampling: the matrix is not an nmode x nmode unitary')
        if cutoff is None:
            cutoff = 3
        super().__init__(nmode=nmode, init_state='vac', cutoff=cutoff, backend=backend,
                         basis=basis, detector=detector, name='GBS', noise=noise, mu=mu,
                         sigma=sigma, device=device)
        for i in range(self.nmode):
            self.s(i, float(squeezing[i]))
        self.clements(unitary)
