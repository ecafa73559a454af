"""Gradient-free optimizers for hardware-in-the-loop training.

PyTorch counterpart of ``deepquantum_tpu/optimizer.py``: OptimizerSPSA,
OptimizerFourier and OptimizerBayesian with the suggest / register split.
They are host bookkeeping around a target function, which MINIMISES and
typically runs a circuit on the card and returns a number: the parameters
are one flat float64 numpy vector plus a name tuple (``param_dict`` is a
view), SPSA draws from its own ``numpy.random.default_rng(random_state)``
(so one seed gives the JAX package's trajectory), and the Fourier update
solves every parameter's linear system in one batched
``numpy.linalg.solve``. The Bayesian variant follows the optional
``bayes_opt`` package's suggest / probe API.
"""

from __future__ import annotations

import numpy as np

__all__ = ['Optimizer', 'OptimizerBayesian', 'OptimizerSPSA', 'OptimizerFourier']


class Optimizer:
    """Shared parameter bookkeeping: a flat vector + stable names."""

    def __init__(self, target_func, param_init, random_state: int = 0):
        self.target_func = target_func
        if isinstance(param_init, dict):
            self._names = tuple(param_init.keys())
            self.params = np.asarray(list(param_init.values()), dtype=float)
        else:
            self.params = np.asarray(param_init, dtype=float).reshape(-1)
            self._names = tuple(f'x_{i}' for i in range(self.params.size))
        self.random_state = random_state
        self.best_params = self.params.copy()
        self.best_target = np.inf
        self.iter = 0

    @property
    def nparam(self) -> int:
        return self.params.size

    def _as_dict(self, vec) -> dict:
        return dict(zip(self._names, np.asarray(vec, dtype=float), strict=True))

    @property
    def param_dict(self) -> dict:
        """Name -> value view of the current iterate (reference-compatible)."""
        return self._as_dict(self.params)

    @property
    def best_param_dict(self) -> dict:
        return self._as_dict(self.best_params)

    def _track_best(self, vec, value) -> None:
        if value < self.best_target:
            self.best_target = float(value)
            self.best_params = np.asarray(vec, dtype=float).copy()

    def __str__(self) -> str:
        return 'Optimizer'


class OptimizerBayesian(Optimizer):
    """Bayesian optimization over [0, 2pi]^nparam via the optional
    ``bayes_opt`` package (reference optimizer.py:41 — the suggest /
    register split below is the bayes_opt library API surface)."""

    def __init__(self, target_func, param_init, random_state: int = 0):
        super().__init__(target_func, param_init, random_state)
        try:
            from bayes_opt import BayesianOptimization, UtilityFunction
        except ImportError as exc:  # pragma: no cover
            raise ImportError('OptimizerBayesian requires the bayes_opt package') from exc
        bounds = dict.fromkeys(self._names, (0.0, 2 * np.pi))
        # bayes_opt maximizes; negate so self.target_func is minimized
        self.optimizer = BayesianOptimization(
            f=lambda **kw: -self.target_func(**kw), pbounds=bounds,
            random_state=self.random_state)
        self.util = UtilityFunction(kind='ucb', kappa=2.576, xi=0.0,
                                    kappa_decay=1, kappa_decay_delay=0)

    def param_suggest(self) -> np.ndarray:
        self.util.update_params()
        probe = self.optimizer.suggest(self.util)
        return np.asarray(self.optimizer._space._as_array(probe)).reshape(-1)

    def param_register(self, param_array, target) -> None:
        # `target` holds maximization values (-loss), like the reference
        for vec, val in zip(param_array, target, strict=True):
            self.optimizer._space.register(vec, val)
            self._track_best(vec, -val)
        self.iter += 1

    def run(self, nstep: int, if_print: bool = False) -> list:
        for step in range(nstep):
            probe = self.param_suggest()
            loss = float(self.target_func(probe))
            if if_print:
                print(step, '|', loss)
            self.param_register([probe], [-loss])
        return list(self.best_params)


class OptimizerSPSA(Optimizer):
    """Simultaneous-perturbation stochastic approximation: two probes per
    step along a random +-1 direction estimate the gradient (reference
    optimizer.py:113; standard Spall schedule)."""

    def __init__(self, target_func, param_init, random_state: int = 0):
        super().__init__(target_func, param_init, random_state)
        self._rng = np.random.default_rng(random_state)
        self.hyperparam = {'a': 1e-1, 'c': 1e-2, 'A': 200, 'nepoch': 2000,
                           'alpha': 0.602, 'gamma': 0.101}

    def set_hyperparam(self, hyperparam: dict) -> None:
        self.hyperparam = hyperparam

    def _schedules(self):
        hp = self.hyperparam
        ck = hp['c'] / (1 + self.iter) ** hp['gamma']
        ak = hp['a'] / (1 + self.iter + hp['A']) ** hp['alpha']
        return ak, ck

    def param_suggest(self) -> np.ndarray:
        """Two probe points (2, nparam): params -+ ck * delta."""
        _, ck = self._schedules()
        delta = self._rng.choice((-1.0, 1.0), size=self.nparam) * ck
        return np.stack([self.params - delta, self.params + delta])

    def param_register(self, param_array, target) -> None:
        lo, hi = (np.asarray(v, dtype=float) for v in param_array)
        f_lo, f_hi = target
        ak, _ = self._schedules()
        grad_est = (f_hi - f_lo) / (hi - lo)
        self.params = 0.5 * (lo + hi) - ak * grad_est
        self.iter += 1
        self._track_best(lo, f_lo)
        self._track_best(hi, f_hi)

    def run(self, nstep: int, if_print: bool = False) -> list:
        for step in range(nstep):
            probes = self.param_suggest()
            values = [float(self.target_func(p)) for p in probes]
            self.param_register(probes, values)
            if if_print:
                print(step, '|', *values)
        return list(self.best_params)


class OptimizerFourier(Optimizer):
    """Per-parameter Fourier-series surrogate gradient descent (reference
    optimizer.py:191): each step probes every parameter on a (2r+1)-point
    grid, fits a degree-r Fourier series by one batched linear solve, and
    descends along the analytic series derivative."""

    def __init__(self, target_func, param_init, order: int = 5, lr: float = 0.1,
                 random_state: int = 0):
        super().__init__(target_func, param_init, random_state)
        self.r = order
        self.lr = lr
        self.grid = 2 * np.pi * (np.arange(2 * order + 1) - order) / (2 * order + 1)
        # Vandermonde-like design matrix [1 | cos(k x) | sin(k x)], k=1..r
        ks = np.arange(1, order + 1)
        kx = np.outer(self.grid, ks)
        self.design = np.concatenate(
            [np.ones((self.grid.size, 1)), np.cos(kx), np.sin(kx)], axis=1)
        self.u = np.zeros(self.grid.size * self.nparam)

    def param_suggest(self) -> np.ndarray:
        """(nparam * (2r+1), nparam) probe block: row block p sweeps
        parameter p over the grid, others held at the current iterate."""
        npts = self.grid.size
        arr = np.tile(self.params, (self.nparam * npts, 1))
        for pid in range(self.nparam):
            arr[pid * npts:(pid + 1) * npts, pid] = self.grid
        return arr

    def param_register(self, param_array, target) -> None:
        npts = self.grid.size
        values = np.asarray(target, dtype=float).reshape(self.nparam, npts)
        # one batched solve: coeffs[p] fits parameter p's sweep
        coeffs = np.linalg.solve(
            np.broadcast_to(self.design, (self.nparam,) + self.design.shape),
            values[..., None])[..., 0]
        self.u = coeffs.reshape(-1)
        ks = np.arange(1, self.r + 1)
        kth = np.outer(self.params, ks)                      # (nparam, r)
        a_cos = coeffs[:, 1:self.r + 1]
        b_sin = coeffs[:, self.r + 1:]
        grad = np.sum(-a_cos * ks * np.sin(kth) + b_sin * ks * np.cos(kth), axis=1)
        self.params = self.params - self.lr * grad
        flat = np.asarray(target, dtype=float)
        self._track_best(np.asarray(param_array)[flat.argmin()], flat.min())
        self.iter += 1

    def run(self, nstep: int, if_print: bool = False) -> list:
        for step in range(nstep):
            probes = self.param_suggest()
            values = np.array([float(self.target_func(p)) for p in probes])
            self.param_register(probes, values)
            if if_print:
                print(step, '|', values.min())
        return list(self.best_params)
