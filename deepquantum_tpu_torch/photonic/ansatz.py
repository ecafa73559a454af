"""Photonic ansatz circuits.

PyTorch counterpart of ``deepquantum_tpu/photonic/ansatz.py``. The Clements
``dict2data`` angle ordering mirrors the JAX package exactly: the
(column, mode) -> parameter-slot mapping is a fixed hardware convention.
``GraphGBS`` encodes a graph's adjacency matrix through its Takagi
decomposition; ``graph_density`` imports networkx only when it is called.
"""

from __future__ import annotations

import importlib
from typing import Any

import numpy as np

from .circuit import QumodeCircuit
from .qmath import takagi
from .state import FockState

__all__ = ['Clements', 'GaussianBosonSampling', 'GraphGBS']


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


class GraphGBS(GaussianBosonSampling):
    """Gaussian boson sampling that encodes a graph: the adjacency matrix A
    = U diag(lambda) U^T (Takagi), squeezing arctanh(c lambda) with c set for
    ``mean_photon_num`` photons on average, then a Clements mesh of U.
    ``rng`` (a numpy Generator) draws the root finder's starting points."""

    def __init__(self, adj_mat: Any, cutoff: int | None = None,
                 mean_photon_num: int | None = None, detector: str = 'pnrd',
                 noise: bool = False, mu: float = 0, sigma: float = 0.1, device=None,
                 rng: np.random.Generator | None = None) -> None:
        adj_mat = np.asarray(adj_mat)
        if not np.allclose(adj_mat, adj_mat.T):
            raise ValueError('GraphGBS: the adjacency matrix is not symmetric')
        self.adj_mat = adj_mat
        nmode = adj_mat.shape[-1]
        if mean_photon_num is None:
            mean_photon_num = nmode
        unitary, lambd = takagi(adj_mat, device='cpu')
        lambd = lambd.numpy()
        sol = self.norm_factor_c(mean_photon_num, lambd, rng=rng)
        if not sol:
            raise ValueError('GraphGBS: no normalisation c found for '
                             f'{mean_photon_num} photons on average')
        self.c = sol[0]
        super().__init__(nmode=nmode, squeezing=np.arctanh(lambd * self.c),
                         unitary=unitary.numpy(), cutoff=cutoff, backend='gaussian',
                         basis=False, detector=detector, noise=noise, mu=mu, sigma=sigma,
                         device=device)
        self.name = 'GraphGBS'

    @staticmethod
    def norm_factor_c(n_num, lambd, trials: int = 20, rng: np.random.Generator | None = None):
        """The normalisations c in (0, 1 / max lambda) with sum_j
        (c lambda_j)^2 / (1 - (c lambda_j)^2) = n_num, one per converged
        root search from ``trials`` random starts."""
        from scipy.optimize import root
        lambd = np.array(lambd)
        rng = np.random.default_rng() if rng is None else rng

        def f(c, lambd, n_num):
            ave_n = (lambd * c) ** 2 / (1 - (lambd * c) ** 2)
            return sum(ave_n) - n_num

        sol = []
        for _ in range(trials):
            re = root(f, rng.uniform(0, 1 / max(lambd)), (lambd, n_num))
            if 0 < re.x[0] < 1 / max(lambd):
                sol.append(re.x[0])
        return sol

    @staticmethod
    def postselect(samples: dict, nodes_list: list) -> list:
        """The samples of each total photon number in ``nodes_list``, one
        dict per entry."""
        dic_list = [{} for _ in range(len(nodes_list))]
        for key in samples:
            tot = int(sum(key.state.tolist())) if isinstance(key, FockState) else sum(key)
            if tot in nodes_list:
                dic_list[nodes_list.index(tot)][key] = samples[key]
        return dic_list

    @staticmethod
    def graph_density(graph, samples: dict) -> dict:
        """{pattern: [count, density of the subgraph it selects]}, densest
        first; ``graph`` a networkx Graph (networkx loads here, on the call:
        the package itself never needs it)."""
        nx = importlib.import_module('networkx')
        out = {}
        for key, count in samples.items():
            bits = key.state.tolist() if isinstance(key, FockState) else list(key)
            out[key] = [count, nx.density(graph.subgraph([i for i, b in enumerate(bits) if b]))]
        return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))
