"""QumodeCircuit: the photonic circuit API (Fock basis mode and Gaussian).

PyTorch counterpart of ``deepquantum_tpu/photonic/circuit.py``: a circuit is
a list of gate descriptors plus a flat parameter vector, and each backend is
a plain function of them (there is no jit cache: the functions are called).

- Fock backend, basis mode: the amplitudes of every output basis state as
  one dense vector, one Ryser permanent per state, all in ONE launch of the
  permanent kernel on the card (``qmath.permanent_batch``).
- Gaussian backend: affine symplectic folds on (cov, mean), then per
  outcome a hafnian (``detector='pnrd'``), or for ``detector='threshold'``
  the torontonians of all click patterns of one click count in one call
  of the CUDA LU kernel on the card (one pattern alone: one torontonian).

Not ported yet, and raising ``NotImplementedError`` by name: Fock tensor
mode (``basis=False``), ``den_mat``, ``mps``, ``backend='bosonic'``,
``delay`` (TDM), ``loss``, ``noise``, ``measure`` and homodyne, ``draw``,
``wigner``, and the gates that exist only as Fock matrices.
"""

from __future__ import annotations

import copy as _copy
from functools import partial
from math import factorial
from typing import Any

import numpy as np
import torch

from ..config import cdtype, rdtype, resolve_device
from . import gates as PG
from .gates import PHOTONIC_REGISTRY, passive_xp_from_unitary
from .qmath import fock_combinations, permanent, permanent_batch, photon_number_mean_var, sub_matrix
from .state import FockState, GaussianState

__all__ = ['QumodeCircuit', 'PhotonicOp']


def _missing(what: str):
    raise NotImplementedError(f'QumodeCircuit: {what} is not ported to deepquantum_tpu_torch yet')


class PhotonicOp:
    """One photonic operation of the circuit's list."""

    def __init__(self, name, wires, pidx=(), npara=0, unitary_fn=None, xp_fn=None,
                 static_unitary=None):
        self.name = name
        self.wires = tuple(wires)
        self.pidx = tuple(pidx)
        self.npara = npara
        self.unitary_fn = unitary_fn
        self.xp_fn = xp_fn
        self.static_unitary = static_unitary

    def params(self, full):
        if not self.npara:
            return None
        return full[list(self.pidx)]

    def unitary(self, full):
        """k x k creation-operator unitary (passive gates)."""
        if self.static_unitary is not None:
            return torch.as_tensor(self.static_unitary, device=full.device).to(cdtype())
        if self.unitary_fn is None:
            raise ValueError(f'{self.name} is not a passive linear-optical gate')
        return self.unitary_fn(self.params(full))

    def xp(self, full):
        """(matrix, vector) of the affine symplectic map in xxpp."""
        if self.xp_fn is None:
            if self.unitary_fn is None and self.static_unitary is None:
                raise ValueError(f'{self.name} has no symplectic representation')
            return passive_xp_from_unitary(self.unitary(full))
        return self.xp_fn(self.params(full))


class QumodeCircuit:
    """Photonic quantum circuit.

    Args:
        nmode: number of modes.
        init_state: Fock basis photon numbers / 'vac' / [cov, mean] / a state object.
        cutoff: Fock truncation.
        backend: 'fock' (basis mode) or 'gaussian'.
        basis: Fock basis mode (permanent-based); tensor mode is not ported.
        detector: 'pnrd' or 'threshold' (Gaussian probabilities).
        den_mat, mps, chi, noise, mu, sigma: the JAX package's options, kept in
            the signature; what is not ported raises when switched on.
        device: where the circuit computes; the default device (the CUDA
            card) when None.
    """

    def __init__(self, nmode: int, init_state: Any = None, cutoff: int | None = None,
                 backend: str = 'fock', basis: bool = True, detector: str = 'pnrd',
                 name: str | None = None, den_mat: bool = False, mps: bool = False,
                 chi: int | None = None, noise: bool = False, mu: float = 0,
                 sigma: float = 0.1, device=None) -> None:
        if backend == 'bosonic':
            _missing("backend='bosonic'")
        if backend not in ('fock', 'gaussian'):
            raise ValueError(f'Unknown backend {backend}')
        if den_mat:
            _missing('den_mat=True')
        if mps:
            _missing('mps=True')
        if noise:
            _missing('noise=True')
        if backend == 'fock' and not basis:
            _missing('Fock tensor mode (basis=False)')
        self.nmode = nmode
        self.backend = backend
        self.basis = basis if backend == 'fock' else False
        self.detector = detector.lower()
        self.name = name
        self.device = resolve_device(device)
        self.operators: list[PhotonicOp] = []
        self.encoders: list[PhotonicOp] = []
        self._pvals: list[float] = []
        self._train_mask: list[bool] = []
        self._enc_pidx: list[int] = []
        self.npara = 0
        self.ndata = 0
        self.state = None
        self._cv_state = None
        self._basis_table = None       # output basis of the last Fock forward
        self._custom_out_basis = None  # user override via set_fock_basis
        if cutoff is None:
            cutoff = 2 if backend == 'fock' else 5
        self.cutoff = cutoff
        self.set_init_state(init_state)

    # ---------------------------------------------------------------- state
    def set_init_state(self, init_state: Any) -> None:
        if self.backend == 'fock':
            if init_state is None:
                init_state = [0] * self.nmode
            if isinstance(init_state, FockState):
                self.init_state = init_state
            else:
                self.init_state = FockState(init_state, self.nmode, self.cutoff, self.basis)
            self.cutoff = self.init_state.cutoff
        else:
            if init_state is None:
                init_state = 'vac'
            if isinstance(init_state, GaussianState):
                self.init_state = init_state
            else:
                self.init_state = GaussianState(init_state, self.nmode, self.cutoff)

    # ---------------------------------------------------------- parameters
    def _trainable(self) -> list[int]:
        return [i for i, t in enumerate(self._train_mask) if t]

    @property
    def params(self) -> torch.Tensor:
        """The trainable parameters as a 1-D real tensor on the device."""
        vals = np.asarray(self._pvals, np.float64)[self._trainable()]
        return torch.as_tensor(vals, device=self.device).to(rdtype())

    @params.setter
    def params(self, values) -> None:
        if torch.is_tensor(values):
            values = values.detach().cpu().numpy()
        values = np.asarray(values, np.float64).reshape(-1)
        for i, v in zip(self._trainable(), values):
            self._pvals[i] = float(v)

    def _real(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=rdtype())
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(rdtype())

    def _full_params(self, params=None, data=None, data_idx=None) -> torch.Tensor:
        """All parameter slots as one vector: the stored values, with the
        trainable slots from ``params`` and the encoder slots from ``data``."""
        full = torch.as_tensor(np.asarray(self._pvals, np.float64), device=self.device).to(rdtype())
        if params is not None:
            ti = torch.as_tensor(self._trainable(), dtype=torch.long, device=self.device)
            full = full.index_put((ti,), self._real(params).reshape(-1))
        if data is not None and self._enc_pidx:
            ei = torch.as_tensor(self._enc_pidx, dtype=torch.long, device=self.device)
            full = full.index_put((ei,), self._real(data).reshape(-1)[list(data_idx)])
        return full

    def _data_indices(self, data_len: int) -> list[int]:
        if data_len < self.ndata:
            raise ValueError('The circuit needs more data')
        return list(range(self.ndata))

    def _new_params(self, values, encode, requires_grad):
        start = len(self._pvals)
        idx = tuple(range(start, start + len(values)))
        self._pvals.extend(float(v) for v in values)
        self._train_mask.extend([requires_grad and not encode] * len(values))
        return idx

    # ------------------------------------------------------------------ add
    def add_op(self, name: str, wires, inputs=None, encode=False, requires_grad=None,
               unitary_fn=None, xp_fn=None, npara=None, static_unitary=None) -> PhotonicOp:
        wires = [wires] if isinstance(wires, int) else list(wires)
        if unitary_fn is None and xp_fn is None and static_unitary is None:
            reg = PHOTONIC_REGISTRY.get(name)
            if reg is None:
                raise ValueError(f'Unknown photonic gate {name}')
            unitary_fn, xp_fn, npara = reg['unitary'], reg['xp'], reg['npara']
        npara = npara or 0
        if requires_grad is None:
            requires_grad = inputs is None and npara > 0 and not encode
        if npara:
            if inputs is None:
                values = [float(np.random.rand() * 2 * np.pi) for _ in range(npara)]
            else:
                values = list(np.asarray(inputs, np.float64).reshape(-1))
                if len(values) != npara:
                    raise ValueError(f'{name} takes {npara} parameters, got {len(values)}')
            pidx = self._new_params(values, encode, requires_grad)
        else:
            pidx = ()
        op = PhotonicOp(name, wires, pidx, npara, unitary_fn, xp_fn, static_unitary)
        self.operators.append(op)
        if encode:
            self.encoders.append(op)
            self._enc_pidx.extend(pidx)
            self.ndata += npara
        else:
            self.npara += npara
        self._basis_table = None
        return op

    def add(self, op: 'QumodeCircuit', encode: bool = False) -> None:
        """Append another circuit's operations and parameters."""
        if not isinstance(op, QumodeCircuit):
            _missing('add() of a standalone gate descriptor (add a circuit, or use the gate sugar)')
        if self.nmode != op.nmode:
            raise ValueError(f'add: {op.nmode} modes into a circuit of {self.nmode}')
        offset = len(self._pvals)
        self._pvals.extend(op._pvals)
        self._train_mask.extend(op._train_mask)
        for g in op.operators:
            g2 = _copy.copy(g)
            g2.pidx = tuple(i + offset for i in g.pidx)
            self.operators.append(g2)
            if g in op.encoders:
                self.encoders.append(g2)
                self._enc_pidx.extend(g2.pidx)
        self.npara += op.npara
        self.ndata += op.ndata
        self._basis_table = None

    # ----------------------------------------------------------- global ops
    def get_unitary(self, params=None, data=None) -> torch.Tensor:
        """Global nmode x nmode creation-operator unitary."""
        didx = None if data is None else self._data_indices(np.shape(data)[-1])
        return self._unitary_of(self._full_params(params, data, didx))

    def _unitary_of(self, full) -> torch.Tensor:
        eye = torch.eye(self.nmode, dtype=cdtype(), device=self.device)
        u = eye
        for op in self.operators:
            w = list(op.wires)
            u_op = eye.index_put((torch.as_tensor(w, device=self.device)[:, None],
                                  torch.as_tensor(w, device=self.device)[None, :]),
                                 op.unitary(full).to(cdtype()))
            u = u_op @ u
        return u

    def get_symplectic(self, params=None) -> torch.Tensor:
        """Global symplectic matrix in xxpp."""
        full = self._full_params(params)
        s = torch.eye(2 * self.nmode, dtype=rdtype(), device=self.device)
        for op in self.operators:
            s = self._global_xp(op, full)[0] @ s
        return s

    def _global_xp(self, op: PhotonicOp, full):
        n = self.nmode
        m, v = op.xp(full)
        wires = torch.as_tensor(list(op.wires) + [w + n for w in op.wires], device=self.device)
        s = torch.eye(2 * n, dtype=rdtype(), device=self.device).index_put(
            (wires[:, None], wires[None, :]), m.to(rdtype()))
        d = torch.zeros((2 * n, 1), dtype=rdtype(), device=self.device).index_put(
            (wires,), v.to(rdtype()))
        return s, d

    def get_displacement(self, init_mean, params=None) -> torch.Tensor:
        """Final mean vector after all operations."""
        full = self._full_params(params)
        mean = self._real(init_mean)
        for op in self.operators:
            s, d = self._global_xp(op, full)
            mean = s @ mean + d
        return mean

    # --------------------------------------------------------------- forward
    def __call__(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                 stepwise=False, params=None):
        return self.forward(data, state, is_prob, detector, sort, stepwise, params)

    def forward(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                stepwise=False, params=None):
        """Run the circuit. Fock backend: the unitary (``is_prob=None``) or a
        dict FockState -> amplitude / probability. Gaussian backend:
        [cov, mean], or with ``is_prob`` a dict FockState -> probability."""
        if self.backend == 'fock':
            return self._forward_fock(data, state, is_prob, sort, params)
        return self._forward_cv(data, state, is_prob, detector, params)

    # Fock-basis helpers ----------------------------------------------------
    def _basis_input(self, state) -> np.ndarray:
        if state is None:
            state = self.init_state
        if isinstance(state, FockState):
            state = state.state
        return np.asarray(state, dtype=np.int64)

    def _output_basis(self, in_state: np.ndarray) -> list:
        if self._custom_out_basis is not None:
            return list(self._custom_out_basis)
        nphoton = int(np.sum(in_state))
        return [tuple(s) for s in fock_combinations(self.nmode, nphoton, self.cutoff)]

    def set_fock_basis(self, state=None) -> None:
        """Override the output Fock basis states; ``None`` restores the
        default (all states with the input photon number)."""
        if state is None:
            self._custom_out_basis = None
        else:
            rows = np.asarray([s.state if isinstance(s, FockState) else s for s in state],
                              dtype=np.int64).reshape(-1, self.nmode)
            self._custom_out_basis = [tuple(int(v) for v in r) for r in rows]
        self._basis_table = None

    def get_fock_basis(self) -> np.ndarray:
        """Current output Fock basis states."""
        if self._custom_out_basis is not None:
            return np.asarray(self._custom_out_basis, dtype=np.int64)
        return np.asarray(self._output_basis(self._basis_input(None)), dtype=np.int64)

    def encode(self, data) -> None:
        """Write data into the stored encoder parameter values (the
        functional path passes data to forward() instead)."""
        if data is None:
            return
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, dtype=np.float64).reshape(-1)
        if len(data) < self.ndata:
            raise ValueError('The circuit needs more data')
        for k, pidx in enumerate(self._enc_pidx):
            self._pvals[pidx] = float(data[k])

    def _state_dict(self, basis, vals, sort: bool) -> dict:
        """{FockState: vals[..., i]} over the basis table, largest first
        (one transfer for the sort keys, not one per entry)."""
        cols = vals.unbind(-1)
        order = range(len(basis))
        if sort:
            keys = vals.detach().abs().reshape(-1, len(basis)).sum(0).cpu().numpy()
            order = np.argsort(-keys, kind='stable')
        return {FockState(list(basis[i]), self.nmode, self.cutoff): cols[i] for i in order}

    def _forward_fock(self, data, state, is_prob, sort, params=None):
        in_state = self._basis_input(state)
        if in_state.ndim == 2:
            outs = [self._forward_fock(data, row, is_prob, sort, params) for row in in_state]
            self.state = outs
            return outs
        if is_prob is None:
            self.state = self.get_unitary(params, data)
            return self.state
        out_basis = self._output_basis(in_state)
        self._basis_table = out_basis
        amps = self._fock_basis_amps(data, in_state, out_basis, params)
        vals = amps.abs() ** 2 if is_prob else amps
        self.state = self._state_dict(out_basis, vals, sort)
        return self.state

    def _fock_basis_amps(self, data, in_state, out_basis, params=None) -> torch.Tensor:
        """Dense amplitude vector over the output-basis table: every
        sub-matrix of the unitary in one stack, one permanent launch."""
        basis = np.asarray(out_basis, dtype=np.int64).reshape(len(out_basis), self.nmode)
        nphoton = int(np.sum(in_state))
        if (basis.sum(1) != nphoton).any():
            raise ValueError('an output basis state does not hold the input photon number')
        modes = np.arange(self.nmode)
        col_idx = np.repeat(modes, in_state)
        row_idx = np.repeat(np.tile(modes, len(basis)), basis.reshape(-1)).reshape(len(basis), -1)
        fact = np.array([factorial(i) for i in range(nphoton + 1)], dtype=np.float64)
        norms = np.sqrt(fact[in_state].prod() * fact[basis].prod(1))
        rows = torch.as_tensor(row_idx, device=self.device)[:, :, None]
        cols = torch.as_tensor(col_idx, device=self.device)[None, None, :]
        norms_t = torch.as_tensor(norms, device=self.device).to(cdtype())
        if data is None:
            batch = [None]
        else:
            data = self._real(data)
            batch = [data] if data.ndim == 1 else list(data)
        didx = None if data is None else self._data_indices(data.shape[-1])
        us = torch.stack([self._unitary_of(self._full_params(params, d, didx)) for d in batch])
        sub = us[:, rows, cols]                                     # (batch, nout, k, k)
        k = sub.shape[-1]
        perms = permanent_batch(sub.reshape(-1, k, k)).reshape(len(batch), -1)
        amps = perms / norms_t
        return amps[0] if data is None or data.ndim == 1 else amps

    # CV helpers ------------------------------------------------------------
    def _forward_cv(self, data, state, is_prob, detector, params=None):
        if state is None:
            state = self.init_state
        elif isinstance(state, str):
            state = GaussianState(state, self.nmode, self.cutoff)
        if isinstance(state, GaussianState):
            state = [state.cov, state.mean]
        cov, mean = self._real(state[0]), self._real(state[1])
        if data is None:
            cov, mean = self._run_cv(self._full_params(params), cov, mean)
        else:
            data = self._real(data)
            didx = self._data_indices(data.shape[-1])
            if data.ndim == 1:
                cov, mean = self._run_cv(self._full_params(params, data, didx), cov, mean)
            else:
                # batched data: one state for every row, or row i with state i
                zipped = cov.ndim > 2 and cov.shape[0] == data.shape[0] and cov.shape[0] > 1
                outs = []
                for i, d in enumerate(data):
                    c = cov[i] if zipped else (cov[0] if cov.ndim > 2 else cov)
                    m = mean[i] if zipped else (mean[0] if mean.ndim > 2 else mean)
                    outs.append(self._run_cv(self._full_params(params, d, didx), c, m))
                cov = torch.stack([o[0] for o in outs])
                mean = torch.stack([o[1] for o in outs])
        self._cv_state = [cov, mean]
        if is_prob:
            self.state = self._forward_cv_prob(cov, mean, detector)
        else:
            self.state = [cov, mean]
        return self.state

    def _run_cv(self, full, cov, mean):
        """Fold the affine symplectic operations over (cov, mean)."""
        for op in self.operators:
            s, d = self._global_xp(op, full)
            cov = s @ cov @ s.T
            mean = s @ mean + d
        return cov, mean

    def _forward_cv_prob(self, cov, mean, detector=None) -> dict:
        from .gaussian_prob import fock_probs_gaussian
        detector = (detector or self.detector).lower()
        probs, basis = fock_probs_gaussian(cov, mean, self.cutoff, detector)
        return self._state_dict(basis, probs, sort=True)

    # ------------------------------------------------------------- outcomes
    def photon_number_mean_var(self, wires=None):
        """Photon-number mean and variance per wire (Gaussian backend)."""
        if self.backend == 'fock':
            _missing('photon statistics of the Fock backend (tensor mode)')
        if wires is None:
            wires = list(range(self.nmode))
        wires = [wires] if isinstance(wires, int) else list(wires)
        state = self._cv_state if isinstance(self.state, dict) else self.state
        exp, var = photon_number_mean_var(state[0], state[1])
        return exp[..., wires], var[..., wires]

    def get_amplitude(self, final_state, init_state=None, unitary=None) -> torch.Tensor:
        """Transfer amplitude <final|U|init> of the Fock backend: one
        permanent."""
        if self.backend != 'fock':
            raise ValueError('get_amplitude needs the Fock backend')
        final_state = np.asarray(final_state.state if isinstance(final_state, FockState)
                                 else final_state, np.int64)
        in_state = self._basis_input(init_state)
        if unitary is None:
            unitary = self.get_unitary()
        if int(final_state.sum()) != int(in_state.sum()):
            return torch.zeros((), dtype=cdtype(), device=self.device)
        sub = sub_matrix(unitary, in_state, final_state, device=self.device)
        norm = np.sqrt(np.prod([factorial(int(x)) for x in in_state])
                       * np.prod([factorial(int(x)) for x in final_state]))
        return permanent(sub) / norm

    def get_prob(self, final_state, refer_state=None, unitary=None) -> torch.Tensor:
        """Probability of one Fock outcome. Gaussian backend: the hafnian or
        torontonian of the last forward's state."""
        if self.backend == 'fock':
            return self.get_amplitude(final_state, refer_state, unitary).abs() ** 2
        from .gaussian_prob import probs_gaussian_helper
        state = self._cv_state if isinstance(self.state, dict) else self.state
        if state is None:
            raise RuntimeError('Run the circuit forward first')
        cov = state[0].reshape(-1, 2 * self.nmode, 2 * self.nmode)
        mean = state[1].reshape(-1, 2 * self.nmode, 1)
        if isinstance(final_state, FockState):
            final_state = final_state.state
        fs = tuple(int(x) for x in np.asarray(final_state).reshape(-1))
        out = torch.stack([probs_gaussian_helper([fs], cov[i], mean[i], self.detector)[0]
                           for i in range(cov.shape[0])])
        return out[0] if out.shape[0] == 1 else out

    # ------------------------------------------------------------ gate sugar
    def ps(self, wires, inputs=None, encode=False):
        self.add_op('PhaseShift', wires, inputs, encode)

    def bs(self, wires, inputs=None, encode=False):
        self.add_op('BeamSplitter', wires, inputs, encode)

    def mzi(self, wires, inputs=None, phi_first=True, encode=False):
        self.add_op('MZI', wires, inputs, encode, npara=2,
                    unitary_fn=partial(PG.mzi_unitary, phi_first=phi_first))

    def bs_theta(self, wires, inputs=None, encode=False):
        # BeamSplitterTheta fixes phi at pi / 2
        self.add_op('BeamSplitterTheta', wires, inputs, encode, npara=1,
                    unitary_fn=partial(PG.bs_theta_unitary, phi=np.pi / 2))

    def bs_phi(self, wires, inputs=None, encode=False):
        self.add_op('BeamSplitterPhi', wires, inputs, encode, npara=1,
                    unitary_fn=partial(PG.bs_phi_unitary, theta=np.pi / 4))

    def _bs_single(self, wires, inputs, encode, conv):
        self.add_op(f'BeamSplitterSingle_{conv}', wires, inputs, encode, npara=1,
                    unitary_fn=partial(PG.bs_single_unitary, convention=conv))

    def bs_rx(self, wires, inputs=None, encode=False):
        self._bs_single(wires, inputs, encode, 'rx')

    def bs_ry(self, wires, inputs=None, encode=False):
        self._bs_single(wires, inputs, encode, 'ry')

    def bs_h(self, wires, inputs=None, encode=False):
        self._bs_single(wires, inputs, encode, 'h')

    def dc(self, wires):
        self._bs_single(wires, [np.pi / 2], False, 'rx')

    def h(self, wires):
        self._bs_single(wires, [np.pi / 2], False, 'h')

    def any(self, unitary, wires=None, minmax=None, name='uany'):
        """A fixed unitary on the given wires."""
        if wires is None:
            if minmax is None:
                minmax = [0, self.nmode - 1]
            wires = list(range(minmax[0], minmax[1] + 1))
        wires = [wires] if isinstance(wires, int) else list(wires)
        if torch.is_tensor(unitary):
            unitary = unitary.detach().cpu().numpy()
        u = np.asarray(unitary, dtype=np.complex128)
        self.add_op(name, wires, None, False, static_unitary=u, npara=0)

    def clements(self, unitary, wires=None, minmax=None):
        """Decompose a unitary into an MZI mesh ('cssr' Clements scheme) and
        add it, MZIs in the physical interleaved-column order."""
        from .decompose import UnitaryDecomposer
        if wires is None:
            if minmax is None:
                minmax = [0, self.nmode - 1]
            wires = list(range(minmax[0], minmax[1] + 1))
        wires = sorted([wires] if isinstance(wires, int) else list(wires))
        if torch.is_tensor(unitary):
            unitary = unitary.detach().cpu().numpy()
        mzi_info = UnitaryDecomposer(np.asarray(unitary, dtype=np.complex128), 'cssr').decomp()
        dic_mzi = mzi_info[1]
        phase_angle = mzi_info[0]['phase_angle']
        if len(phase_angle) != len(wires):
            raise ValueError('clements: the unitary does not match the wires')
        shift = wires[0]
        for i in range(len(wires)):
            idx = i // 2
            for w in (wires[1::2] if i % 2 == 0 else wires[2::2]):
                pair = dic_mzi[(w - 1 - shift, w - shift)]
                if idx < len(pair):
                    phi, theta = pair[idx]
                    self.mzi(wires=[w - 1, w], inputs=[theta, phi])
        for wire in wires:
            self.ps(wires=wire, inputs=phase_angle[wire - shift])

    def s(self, wires, r=None, theta=None, encode=False):
        self.add_op('Squeezing', wires, self._rt_inputs(r, theta), encode)

    def s2(self, wires, r=None, theta=None, encode=False):
        self.add_op('Squeezing2', wires, self._rt_inputs(r, theta), encode)

    def d(self, wires, r=None, theta=None, encode=False):
        self.add_op('Displacement', wires, self._rt_inputs(r, theta), encode)

    def _rt_inputs(self, r, theta):
        if r is None and theta is None:
            return None
        if r is None:
            return [float(np.random.rand()), theta]
        if theta is None:
            return [r, 0]
        return [r, theta]

    def x(self, wires, inputs=None, encode=False):
        self.add_op('DisplacementPosition', wires, inputs, encode)

    def z(self, wires, inputs=None, encode=False):
        self.add_op('DisplacementMomentum', wires, inputs, encode)


def _stub(what: str):
    def method(self, *args, **kwargs):
        _missing(what)
    method.__doc__ = f'Not ported yet: {what}.'
    return method


# the rest of the JAX package's QumodeCircuit surface raises by name
for _name, _what in {
        'r': 'r (phase shift with inv_mode)', 'f': 'f (Fourier gate)',
        'qp': 'qp (quadratic phase)', 'cx': 'cx (controlled-X)', 'cz': 'cz (controlled-Z)',
        'cp': 'cp (cubic phase, a Fock-only gate)', 'k': 'k (Kerr, a Fock-only gate)',
        'ck': 'ck (cross-Kerr, a Fock-only gate)', 'delay': 'delay (time-domain multiplexing)',
        'global_circuit': 'global_circuit (time-domain multiplexing)', 'loss': 'loss',
        'loss_t': 'loss_t', 'loss_db': 'loss_db', 'measure': 'measure (sampling)',
        'homodyne': 'homodyne', 'homodyne_x': 'homodyne_x', 'homodyne_p': 'homodyne_p',
        'measure_homodyne': 'measure_homodyne', 'quadrature_mean': 'quadrature_mean',
        'draw': 'draw', 'wigner': 'wigner', 'cat': "cat states (backend='bosonic')",
        'gkp': "GKP states (backend='bosonic')", 'barrier': 'barrier'}.items():
    setattr(QumodeCircuit, _name, _stub(_what))
