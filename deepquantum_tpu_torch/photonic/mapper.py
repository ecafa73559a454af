"""UnitaryMapper: solve for an optical unitary realizing a qubit gate under
dual-rail encoding with post-selection.

The port's own copy of ``deepquantum_tpu/photonic/mapper.py`` (functional
counterpart of reference src/deepquantum/photonic/mapper.py:18-463). The
reference builds symbolic permanent equations (sympy) and roots them with
random restarts; here the same defining equations

    <out_i| U_optical |in_j>  =  success * U_gate[i, j]

are solved directly with scipy.optimize.least_squares over the (real or
complex) entries of the nmode x nmode matrix, with unitarity residuals.
It stays host numpy: a residual is a handful of small contractions, and a
launch on the card per residual would only add latency.

The Ryser evaluation of all dim^2 transfer permanents is precomputed at
construction into batched gather indices and subset masks, so a residual
is a few vectorized numpy contractions. Solved unitaries are cached on
disk, keyed by gate, modes, ancillas and success, under
``~/.cache/deepquantum_tpu_torch/mapper`` (``DQ_MAPPER_CACHE`` overrides
the folder), so repeat solves return at once.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import zipfile
from math import factorial

import numpy as np
from scipy.optimize import least_squares

__all__ = ['UnitaryMapper']


def _permanent_np(mat: np.ndarray) -> complex:
    n = mat.shape[0]
    if n == 0:
        return 1.0
    total = 0.0
    for idx in range(1, 1 << n):
        subset = [i for i in range(n) if (idx >> i) & 1]
        prod = np.prod(mat[subset].sum(axis=0))
        total += (-1) ** len(subset) * prod
    return (-1) ** n * total


def _cache_dir() -> str:
    base = os.environ.get('DQ_MAPPER_CACHE',
                          os.path.join(os.path.expanduser('~'), '.cache',
                                       'deepquantum_tpu_torch', 'mapper'))
    os.makedirs(base, exist_ok=True)
    return base


class UnitaryMapper:
    """Map a qubit gate to an optical unitary (API parity with reference mapper.py:18)."""

    def __init__(self, nqubit: int, nmode: int, ugate, success: float,
                 aux: list | None = None, aux_pos: list | None = None) -> None:
        assert 2 * nqubit <= nmode, 'need more modes'
        self.nqubit = nqubit
        self.nmode = nmode
        self.ugate = np.asarray(ugate, dtype=complex)
        self.success = success
        self.aux = aux
        if aux_pos is None:
            aux_pos = [nmode - 2, nmode - 1]
        self.aux_position = aux_pos
        self.basis = self.create_basis(aux_pos if aux else [])
        self._build_transfer_structure()

    def create_basis(self, aux_position) -> list[np.ndarray]:
        """Dual-rail computational basis states (reference mapper.py:90)."""
        main = [i for i in range(self.nmode) if i not in aux_position]
        out = []
        temp = [[1, 0], [0, 1]]
        for state in itertools.product([0, 1], repeat=self.nqubit):
            dual = []
            for s in state:
                dual.extend(temp[s])
            b = np.zeros(self.nmode, dtype=np.int64)
            if self.aux:
                b[np.asarray(aux_position)] = np.asarray(self.aux)
            b[np.asarray(main[:2 * self.nqubit])] = np.asarray(dual)
            out.append(b)
        return out

    @staticmethod
    def _sub_matrix(u, in_state, out_state):
        cols = np.repeat(np.arange(len(in_state)), in_state)
        rows = np.repeat(np.arange(len(out_state)), out_state)
        return u[np.ix_(rows, cols)]

    def _build_transfer_structure(self) -> None:
        """Precompute, once per instance, the batched Ryser structure for
        ALL dim^2 transfer permanents (the analog of the reference's
        shipped index tensors, mapper.py:75-86)."""
        dim = len(self.basis)
        k = int(np.sum(self.basis[0]))          # photons, equal for all states
        rows = [np.repeat(np.arange(self.nmode), b) for b in self.basis]
        cols = rows                              # same basis both sides
        # (dim*dim, k) row/col gather indices, i-major like get_transfer_mat
        self._tr_rows = np.stack([rows[i] for i in range(dim)
                                  for _ in range(dim)])
        self._tr_cols = np.stack([cols[j] for _ in range(dim)
                                  for j in range(dim)])
        # Ryser subset masks (S, k) and signs, shared by every pair
        s = np.arange(1, 1 << k)
        self._tr_masks = ((s[:, None] >> np.arange(k)[None, :]) & 1).astype(np.float64)
        card = self._tr_masks.sum(axis=1)
        self._tr_signs = ((-1.0) ** card) * ((-1.0) ** k)
        norms = np.array([np.sqrt(np.prod([factorial(int(x)) for x in b]))
                          for b in self.basis])
        self._tr_norm = np.outer(norms, norms)
        self._tr_dim, self._tr_k = dim, k

    def get_transfer_mat(self, u: np.ndarray) -> np.ndarray:
        """Post-selected transfer amplitudes between dual-rail basis states
        (reference mapper.py:178) — one vectorized Ryser evaluation over all
        dim^2 submatrices."""
        u = np.asarray(u, dtype=complex)
        dim, k = self._tr_dim, self._tr_k
        subs = u[self._tr_rows[:, :, None], self._tr_cols[:, None, :]]  # (B, k, k)
        rowsums = np.einsum('sk,bkj->bsj', self._tr_masks, subs)         # (B, S, k)
        perms = self._tr_signs @ np.prod(rowsums, axis=2).T              # (B,)
        return perms.reshape(dim, dim) / self._tr_norm

    def _residuals(self, y: np.ndarray, complex_u: bool) -> np.ndarray:
        m = self.nmode
        if complex_u:
            u = (y[:m * m] + 1j * y[m * m:]).reshape(m, m)
        else:
            u = y.reshape(m, m).astype(complex)
        t = self.get_transfer_mat(u)
        target = self.success * self.ugate
        res = (t - target)
        unit = u @ u.conj().T - np.eye(m)
        parts = [res.real.ravel(), res.imag.ravel(), unit.real.ravel(), unit.imag.ravel()]
        return np.concatenate(parts)

    def solve_eqs_real(self, total_trials: int = 10, trials: int = 1000,
                       precision: float = 1e-6):
        """Random-restart least squares over real orthogonal candidates
        (reference mapper.py:281)."""
        return self._solve(total_trials, precision, complex_u=False)

    def solve_eqs_complex(self, total_trials: int = 10, trials: int = 1000,
                          precision: float = 1e-5):
        """Random-restart least squares over complex unitary candidates
        (reference mapper.py:304)."""
        return self._solve(total_trials, precision, complex_u=True)

    def _cache_key(self, complex_u: bool, total_trials: int) -> str:
        # total_trials is part of the key: a run cached with fewer random
        # restarts must not short-circuit a later request for more
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(self.ugate).tobytes())
        h.update(repr((self.nqubit, self.nmode, self.success, self.aux,
                       self.aux_position, complex_u, total_trials)).encode())
        return h.hexdigest()[:24]

    def _solve(self, total_trials, precision, complex_u):
        m = self.nmode
        # disk result cache (the role the reference's shipped index tensors
        # play): repeat solves of the same gate/mode/aux instance are free
        path = os.path.join(_cache_dir(),
                            f'{self._cache_key(complex_u, total_trials)}.npz')
        if os.path.exists(path):
            try:
                sols = np.load(path)['solutions']
                if all(np.max(np.abs(self._residuals(
                        np.concatenate([u.real.ravel(), u.imag.ravel()])
                        if complex_u else u.real.ravel(), complex_u))) < precision
                       for u in sols):
                    return list(sols)
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):  # a corrupt cache file
                pass
        solutions = []
        rng = np.random.default_rng(0)
        for _ in range(total_trials):
            y0 = rng.standard_normal(2 * m * m if complex_u else m * m) * 0.5
            sol = least_squares(self._residuals, y0, args=(complex_u,),
                                xtol=1e-14, ftol=1e-14, gtol=1e-14)
            if np.max(np.abs(sol.fun)) < precision:
                if complex_u:
                    u = (sol.x[:m * m] + 1j * sol.x[m * m:]).reshape(m, m)
                else:
                    u = sol.x.reshape(m, m).astype(complex)
                solutions.append(u)
        if solutions:
            try:
                np.savez(path, solutions=np.stack(solutions))
            except OSError:
                pass
        return solutions

    @staticmethod
    def is_unitary(u, atol: float = 1e-5) -> bool:
        u = np.asarray(u)
        return np.allclose(u @ u.conj().T, np.eye(u.shape[-1]), atol=atol)

    @staticmethod
    def plot_u(unitary, vmax=1, vmin=0, fs=20, len_ticks=5, cl='RdBu'):
        """Heatmap of |U| (reference mapper.py:417)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        im = ax.imshow(np.abs(np.asarray(unitary)), vmax=vmax, vmin=vmin, cmap=cl)
        fig.colorbar(im)
        return fig
