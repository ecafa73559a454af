"""QumodeCircuit: the photonic circuit API (Fock basis mode, Gaussian, Bosonic).

PyTorch counterpart of ``deepquantum_tpu/photonic/circuit.py``: a circuit is
a list of operation descriptors plus a flat parameter vector, and each
backend is a plain function of them (there is no jit cache: the functions
are called).

- Fock backend, basis mode: the amplitudes of every output basis state as
  one dense vector, one Ryser permanent per state, all in ONE launch of the
  permanent kernel on the card (``qmath.permanent_batch``); ``measure``
  draws from them.
- Gaussian backend: affine symplectic maps and photon loss on (cov, mean),
  each applied to the rows and columns of its modes, a batch of data rows
  at once; then per outcome group one batched hafnian (``detector='pnrd'``)
  or, for ``detector='threshold'``, the torontonians of all click patterns
  of one click count in one call of the CUDA LU kernel on the card; or
  homodyne samples and conditioning (``measurement.py``), Wigner functions.
- Bosonic backend: the same maps on every component of (cov, complex mean,
  weight); cat and GKP states on chosen modes.
- Time-domain multiplexing: ``delay`` loops unrolled onto concurrent modes,
  shifted after each time step (``tdm.QumodeCircuitTDM`` runs the steps
  with homodyne feedback); ``global_circuit`` unrolls them in space.

Not ported yet, and raising ``NotImplementedError`` by name (the Fock
slice): Fock tensor mode (``basis=False``), ``den_mat``, ``mps``, the gates
that exist only as Fock matrices (``cp``, ``k``, ``ck``) and the CV gates'
Fock matrices (``qp``, ``cx``, ``cz`` on the Fock backend), loss, delay and
homodyne on the Fock backend, per-forward ``noise``, ``draw``. Fock-basis
probabilities of a Bosonic state (``is_prob`` / ``measure`` /
``get_prob``) raise too: they need loop hafnians with complex
displacement, which the JAX package does not have either (it drops the
weights there, ROADMAP queue 3).
"""

from __future__ import annotations

import copy as _copy
from collections import defaultdict
from functools import partial
from math import factorial
from typing import Any

import numpy as np
import torch

from .. import config
from ..config import cdtype, rdtype, resolve_device
from . import gates as PG
from .channel import loss_xy, transmittance_to_theta
from .gates import PHOTONIC_REGISTRY
from .qmath import (fock_combinations, permanent, permanent_batch, photon_number_mean_var,
                    shift_func, sub_matrix)
from .state import BosonicState, CatState, FockState, GaussianState, GKPState, combine_bosonic_states

__all__ = ['QumodeCircuit', 'PhotonicOp']

_FOCK_SLICE = 'the Fock slice'
_BOSONIC_PROBS = ("Fock-basis probabilities of a Bosonic state need loop hafnians with "
                  "complex displacement; the JAX package computes one Gaussian table per "
                  "component and drops the weights (ROADMAP queue 3)")


def _missing(what: str, where: str = _FOCK_SLICE):
    raise NotImplementedError(f'QumodeCircuit: {what} is not ported to deepquantum_tpu_torch '
                              f'yet ({where})')


def _delay_subgates(op, wire1: int, wire2: int) -> list:
    """A delay loop's gates on its concurrent modes: wire1 the loop's mode,
    wire2 the spatial mode. 'bs': a BeamSplitterTheta (phi = pi / 2) on
    both, then a PhaseShift on the loop; 'mzi': one MZI with
    ``phi_first=False``."""
    if op.extra['convention'] == 'bs':
        return [PhotonicOp(op.name, [wire1, wire2], op.pidx[:1], 1,
                           unitary_fn=partial(PG.bs_theta_unitary, phi=np.pi / 2)),
                PhotonicOp(op.name + '_ps', [wire1], op.pidx[1:2], 1, unitary_fn=PG.ps_unitary,
                           xp_fn=PG.ps_xp)]
    return [PhotonicOp(op.name, [wire1, wire2], op.pidx, 2,
                       unitary_fn=partial(PG.mzi_unitary, phi_first=False))]


def _apply_map(cov, mean, m, v, idx):
    """cov -> S cov S^T and mean -> S mean + d for S the identity but the
    block m on the rows / columns ``idx`` (a tensor) and d the vector v
    there; m and v may carry batch axes in front of the state's."""
    batch = np.broadcast_shapes(cov.shape[:-2], m.shape[:-2])
    cov = cov.expand(batch + cov.shape[-2:])
    cov = cov.index_copy(-2, idx, m @ cov[..., idx, :])
    cov = cov.index_copy(-1, idx, cov[..., :, idx] @ m.mT)
    mb = np.broadcast_shapes(mean.shape[:-2], m.shape[:-2])
    mean = mean.expand(mb + mean.shape[-2:])
    mean = mean.index_copy(-2, idx, m.to(mean.dtype) @ mean[..., idx, :] + v.to(mean.dtype))
    return cov, mean


class PhotonicOp:
    """One photonic operation of the circuit's list; ``kind`` is 'gate',
    'loss', 'delay' or 'barrier'."""

    def __init__(self, name, wires, pidx=(), npara=0, kind='gate', unitary_fn=None,
                 xp_fn=None, static_unitary=None, extra=None):
        self.name = name
        self.wires = tuple(wires)
        self.pidx = tuple(pidx)
        self.npara = npara
        self.kind = kind
        self.unitary_fn = unitary_fn
        self.xp_fn = xp_fn
        self.static_unitary = static_unitary
        self.extra = extra or {}

    def params(self, full):
        if not self.npara:
            return None
        return full[..., list(self.pidx)]

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
            return PG.passive_xp_from_unitary(self.unitary(full))
        return self.xp_fn(self.params(full))


class QumodeCircuit:
    """Photonic quantum circuit.

    Args:
        nmode: number of modes.
        init_state: Fock basis photon numbers / 'vac' / [cov, mean(, weight)]
            / a state object.
        cutoff: Fock truncation.
        backend: 'fock' (basis mode), 'gaussian' or 'bosonic'.
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
        if backend not in ('fock', 'gaussian', 'bosonic'):
            raise ValueError(f'Unknown backend {backend}')
        if den_mat:
            _missing('den_mat=True')
        if mps:
            _missing('mps=True')
        if noise:
            _missing('noise=True', 'per-forward parameter noise')
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
        self.measurements: list = []
        self.wires_homodyne: list = []
        self._pvals: list[float] = []
        self._train_mask: list[bool] = []
        self._enc_pidx: list[int] = []
        self.npara = 0
        self.ndata = 0
        self.state = None
        self.state_measured = None
        self._cv_state = None
        self._basis_table = None       # output basis of the last Fock forward
        self._custom_out_basis = None  # user override via set_fock_basis
        self._bosonic_states = None    # per-mode Bosonic states (cat / gkp)
        # time-domain multiplexing: the delay loops of each spatial mode
        self._with_delay = False
        self._nmode_tdm = nmode
        self._ntau_dict = defaultdict(list)
        self._unroll_dict = None
        self._operators_tdm = None
        self._measurements_tdm = None
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
            return
        cls = GaussianState if self.backend == 'gaussian' else BosonicState
        if init_state is None:
            init_state = 'vac'
        self.init_state = init_state if isinstance(init_state, cls) else \
            cls(init_state, self.nmode, self.cutoff)

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

    def _complex(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(device=self.device, dtype=cdtype())
        return torch.as_tensor(np.asarray(x, np.complex128), device=self.device).to(cdtype())

    def _full_params(self, params=None, data=None, data_idx=None) -> torch.Tensor:
        """All parameter slots as one vector: the stored values, with the
        trainable slots from ``params`` and the encoder slots from ``data``;
        (B, P) for a (B, ndata) batch of data rows."""
        full = torch.as_tensor(np.asarray(self._pvals, np.float64), device=self.device).to(rdtype())
        if params is not None:
            ti = torch.as_tensor(self._trainable(), dtype=torch.long, device=self.device)
            full = full.index_put((ti,), self._real(params).reshape(-1))
        if data is not None and self._enc_pidx:
            vals = self._real(data)[..., list(data_idx)]
            full = full.expand(vals.shape[:-1] + full.shape).clone()
            full[..., self._enc_pidx] = vals
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

    def init_para(self) -> None:
        """Re-randomize all trainable parameters in [0, 2 pi)."""
        for i, trainable in enumerate(self._train_mask):
            if trainable:
                self._pvals[i] = float(np.random.rand() * 2 * np.pi)

    # ------------------------------------------------------------------ add
    def _touch(self) -> None:
        """Forget what was derived from the operation list."""
        self._basis_table = None
        self._unroll_dict = None
        self._operators_tdm = None
        self._measurements_tdm = None

    def _append(self, op: PhotonicOp, encode: bool) -> None:
        self.operators.append(op)
        if encode:
            self.encoders.append(op)
            self._enc_pidx.extend(op.pidx)
        if op.kind == 'delay':
            self._with_delay = True
            self._ntau_dict[op.wires[0]].append(op.extra['ntau'])
            self._nmode_tdm += op.extra['ntau']
        self._touch()

    def _register(self, op: PhotonicOp, encode: bool) -> PhotonicOp:
        """Append an op whose parameters are new slots, and count them."""
        self._append(op, encode)
        if encode:
            self.ndata += op.npara
        else:
            self.npara += op.npara
        return op

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
        return self._register(PhotonicOp(name, wires, pidx, npara, 'gate', unitary_fn, xp_fn,
                                         static_unitary), encode)

    def add(self, op, encode: bool = False, wires=None) -> None:
        """Append another circuit's operations and parameters, or a
        ``PhotonicOp`` descriptor. A descriptor's parameters are registered
        on this circuit the first time it is added (from ``extra['inputs']``,
        or random; trainable if ``extra['requires_grad']``) and shared when
        the same descriptor is added again; ``wires`` places the copy."""
        if isinstance(op, QumodeCircuit):
            if self.nmode != op.nmode:
                raise ValueError(f'add: {op.nmode} modes into a circuit of {self.nmode}')
            offset = len(self._pvals)
            self._pvals.extend(op._pvals)
            self._train_mask.extend(op._train_mask)
            enc = {id(g) for g in op.encoders}
            for g in op.operators:
                g2 = _copy.copy(g)
                g2.pidx = tuple(i + offset for i in g.pidx)
                self._append(g2, id(g) in enc)
            self.npara += op.npara
            self.ndata += op.ndata
            self.measurements.extend(op.measurements)
            self.wires_homodyne.extend(op.wires_homodyne)
            return
        if not isinstance(op, PhotonicOp):
            raise TypeError(f'cannot add {type(op).__name__} to a QumodeCircuit')
        shared = op.npara > 0 and op.extra.get('_owner') is self and bool(op.pidx)
        if op.npara > 0 and not shared:
            values = op.extra.get('inputs')
            if values is None:
                values = [float(np.random.rand() * 2 * np.pi) for _ in range(op.npara)]
            op.pidx = self._new_params(list(values), encode, op.extra.get('requires_grad', False))
            op.extra['_owner'] = self
        if wires is not None:
            op = _copy.copy(op)
            op.wires = tuple([wires] if isinstance(wires, int) else wires)
        if shared:                    # its slots are counted already
            self._append(op, False)
        else:
            self._register(op, encode)

    # ----------------------------------------------------------- global ops
    def get_unitary(self, params=None, data=None) -> torch.Tensor:
        """Global nmode x nmode creation-operator unitary (of one row of data)."""
        if data is not None:
            data = self._real(data).reshape(-1)
        didx = None if data is None else self._data_indices(data.shape[-1])
        return self._unitary_of(self._full_params(params, data, didx))

    def _unitary_of(self, full) -> torch.Tensor:
        eye = torch.eye(self.nmode, dtype=cdtype(), device=self.device)
        u = eye
        for op in self.operators:
            if op.kind != 'gate':
                continue
            w = torch.as_tensor(list(op.wires), device=self.device)
            u = eye.index_put((w[:, None], w[None, :]), op.unitary(full).to(cdtype())) @ u
        return u

    def _cv_operators(self):
        """(operators, modes) of one time step: the unrolled concurrent
        modes when the circuit has delay loops."""
        if self._with_delay:
            self._prepare_unroll_dict()
            self._unroll_circuit()
            return self._operators_tdm, self._nmode_tdm
        return self.operators, self.nmode

    def _idx(self, wires, n: int) -> torch.Tensor:
        return torch.as_tensor(list(wires) + [w + n for w in wires], device=self.device)

    def get_symplectic(self, params=None) -> torch.Tensor:
        """Global symplectic matrix in xxpp (of one unrolled time step when
        the circuit has delay loops)."""
        full = self._full_params(params)
        operators, n = self._cv_operators()
        s = torch.eye(2 * n, dtype=rdtype(), device=self.device)
        for op in operators:
            if op.kind == 'gate':
                idx = self._idx(op.wires, n)
                s = s.index_copy(-2, idx, op.xp(full)[0].to(rdtype()) @ s[idx])
        return s

    def get_displacement(self, init_mean, params=None) -> torch.Tensor:
        """Final mean vector after all gates."""
        full = self._full_params(params)
        mean = self._real(init_mean)
        operators, n = self._cv_operators()
        for op in operators:
            if op.kind == 'gate':
                m, v = op.xp(full)
                idx = self._idx(op.wires, n)
                mean = mean.index_copy(-2, idx, m.to(rdtype()) @ mean[idx] + v.to(rdtype()))
        return mean

    # --------------------------------------------------------------- forward
    def __call__(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                 stepwise=False, params=None):
        return self.forward(data, state, is_prob, detector, sort, stepwise, params)

    def forward(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                stepwise=False, params=None):
        """Run the circuit. Fock backend: the unitary (``is_prob=None``) or a
        dict FockState -> amplitude / probability. Gaussian backend:
        [cov, mean], or with ``is_prob`` a dict FockState -> probability.
        Bosonic backend: [cov, mean, weight]."""
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
    def _cv_parts(self, state):
        """The forward's input state as tensors: [cov, mean] (Gaussian) or
        [cov, complex mean, complex weight] (Bosonic)."""
        bosonic = self.backend == 'bosonic'
        if state is None:
            if bosonic and self._bosonic_states is not None:
                state = combine_bosonic_states(self._bosonic_states, self.cutoff)
            else:
                state = self.init_state
        elif isinstance(state, str):
            state = (BosonicState if bosonic else GaussianState)(state, self.nmode, self.cutoff)
        if isinstance(state, GaussianState):
            state = [state.cov, state.mean]
        elif isinstance(state, BosonicState):
            state = [state.cov, state.mean, state.weight]
        cov = self._real(state[0])
        if not bosonic:
            return [cov, self._real(state[1])]
        mean = self._complex(state[1])
        weight = self._complex(state[2]) if len(state) > 2 else \
            torch.ones((1, cov.shape[-3]), dtype=cdtype(), device=self.device)
        return [cov, mean, weight]

    def _forward_cv(self, data, state, is_prob, detector, params=None):
        parts = self._cv_parts(state)
        cov, mean = parts[0], parts[1]
        if self._with_delay:
            self._prepare_unroll_dict()
            self._unroll_circuit()
            cov, mean = self._unroll_init_state(cov, mean)
        if data is None:
            full = self._full_params(params)
        else:
            data = self._real(data)
            full = self._full_params(params, data, self._data_indices(data.shape[-1]))
            if data.ndim > 1:
                # a batch of data rows: one state for every row, or row i with state i
                zipped = cov.ndim > 2 and cov.shape[0] == data.shape[0] and cov.shape[0] > 1
                if not zipped:
                    cov = cov[0] if cov.ndim > 2 else cov
                    mean = mean[0] if mean.ndim > 2 else mean
        cov, mean = self._run_cv(full, cov, mean)
        self._cv_state = [cov, mean] + parts[2:]
        if is_prob:
            if self.backend == 'bosonic':
                _missing('is_prob=True on the Bosonic backend', _BOSONIC_PROBS)
            self.state = self._forward_cv_prob(cov, mean, detector)
            return self.state
        if self._with_delay:
            # the returned state is already advanced one time step
            cov, mean = self._shift_state(cov, mean)
        self.state = [cov, mean] + parts[2:]
        return self.state

    def _run_cv(self, full, cov, mean):
        """Apply the symplectic maps and the loss channels in order to
        (cov, mean); parameters (B, P) act on a batch of states, each map on
        every Bosonic component."""
        operators, n = self._cv_operators()
        lift = (1,) if self.backend == 'bosonic' and full.ndim > 1 else ()

        def lifted(t):
            return t if t.ndim == 2 else t.reshape(t.shape[:-2] + lift + t.shape[-2:])

        for op in operators:
            if op.kind == 'loss':
                x, y = (lifted(t) for t in loss_xy(op.params(full)))
                idx = self._idx(op.wires, n)
                cov, mean = _apply_map(cov, mean, x, torch.zeros_like(x[..., :1]), idx)
                y_full = torch.zeros(y.shape[:-2] + (2 * n, 2 * n), dtype=cov.dtype,
                                     device=cov.device)
                y_full[..., idx[:, None], idx] = y
                cov = cov + y_full
            elif op.kind == 'gate':
                m, v = op.xp(full)
                cov, mean = _apply_map(cov, mean, lifted(m.to(cov.dtype)),
                                       lifted(v.to(cov.dtype)), self._idx(op.wires, n))
        return cov, mean

    def _forward_cv_prob(self, cov, mean, detector=None) -> dict:
        from .gaussian_prob import fock_probs_gaussian
        detector = (detector or self.detector).lower()
        probs, basis = fock_probs_gaussian(cov, mean, self.cutoff, detector)
        return self._state_dict(basis, probs, sort=True)

    # ------------------------------------------------------------- outcomes
    def _last_cv_state(self) -> list:
        state = self._cv_state if isinstance(self.state, dict) else self.state
        if state is None:
            raise RuntimeError('Run the circuit forward first')
        return state

    def measure(self, shots: int = 1024, with_prob: bool = False, wires=None, detector=None,
                generator: torch.Generator | None = None, mcmc: bool = False):
        """Sample Fock-basis outcomes of the last forward: {FockState:
        count}, or {FockState: (count, probability)} with ``with_prob``; a
        list of such dicts for a batch. ``wires`` keeps those modes' photon
        numbers (the others summed out). Fock basis mode draws from the
        forward's dict (amplitudes or probabilities); the Gaussian backend
        from its probability table (computed here, with ``detector``, when
        the forward returned the state). ``torch.multinomial`` on
        ``generator``."""
        if mcmc:
            _missing('measure(mcmc=True)', 'Markov-chain sampling')
        if self.state is None:
            raise RuntimeError('Run the circuit forward before measurement')
        if self.backend == 'bosonic':
            _missing('measure on the Bosonic backend', _BOSONIC_PROBS)
        if self.backend == 'fock':
            if not isinstance(self.state, dict):
                raise ValueError('measure: run the Fock circuit forward with is_prob=True or '
                                 'False first (is_prob=None returns the unitary)')
            probs_dict = self.state
        else:
            probs_dict = self.state if isinstance(self.state, dict) else \
                self._forward_cv_prob(self.state[0], self.state[1], detector)
        basis = list(probs_dict.keys())
        vals = torch.stack([probs_dict[b] for b in basis], -1)
        probs = vals.abs() ** 2 if vals.is_complex() else vals.clamp(min=0)
        single = probs.ndim == 1 or (self.backend == 'gaussian' and probs.shape[0] == 1)
        probs = probs.detach().reshape(-1, len(basis)).to(torch.float64)
        if wires is not None:
            wires = [wires] if isinstance(wires, int) else sorted(wires)
            sub = np.asarray([b.state for b in basis])[:, wires]
            keys, inverse = np.unique(sub, axis=0, return_inverse=True)
            probs = torch.zeros((probs.shape[0], len(keys)), dtype=probs.dtype,
                                device=probs.device).index_add_(
                1, torch.as_tensor(inverse.reshape(-1), device=probs.device), probs)
            basis = [FockState(list(k), len(wires), self.cutoff) for k in keys]
        draws = torch.multinomial(probs, shots, replacement=True, generator=generator)
        counts = torch.zeros(probs.shape, dtype=torch.long, device=probs.device).scatter_add_(
            1, draws, torch.ones_like(draws))
        counts, probs = counts.cpu().numpy(), probs.cpu().numpy()
        results = []
        for c_row, p_row in zip(counts, probs):
            hit = np.flatnonzero(c_row)
            results.append({basis[i]: (int(c_row[i]), float(p_row[i])) if with_prob
                            else int(c_row[i]) for i in hit})
        return results[0] if single else results

    def photon_number_mean_var(self, wires=None):
        """Photon-number mean and variance per wire of the last CV forward;
        a Bosonic state's are the mixture's (sum_k w_k <n>_k, and
        sum_k w_k <n^2>_k - <n>^2, real parts)."""
        if self.backend == 'fock':
            _missing('photon statistics of the Fock backend (tensor mode)')
        if wires is None:
            wires = list(range(self.nmode))
        wires = [wires] if isinstance(wires, int) else list(wires)
        state = self._last_cv_state()
        if self.backend == 'gaussian':
            exp, var = photon_number_mean_var(state[0], state[1])
            return exp[..., wires], var[..., wires]
        weight = state[2][..., None]
        exp_k, var_k = photon_number_mean_var(state[0].to(cdtype()), state[1])
        exp = (weight * exp_k).sum(-2)
        var = (weight * (var_k + exp_k ** 2)).sum(-2) - exp ** 2
        return exp.real[..., wires], var.real[..., wires]

    def quadrature_mean(self, wires=None):
        """<x> per wire of the last CV forward; a Bosonic state's is
        Re sum_k w_k <x>_k."""
        if self.backend == 'fock':
            _missing('quadrature_mean of the Fock backend (tensor mode)')
        if wires is None:
            wires = list(range(self.nmode))
        wires = [wires] if isinstance(wires, int) else list(wires)
        state = self._last_cv_state()
        mean = state[1][..., wires, 0]
        if self.backend == 'bosonic':
            mean = (state[2][..., None] * mean).sum(-2)
        return mean.real

    def wigner(self, wire: int, **kwargs):
        """Wigner function of one mode of the last CV forward (see
        ``wigner.cv_to_wigner``)."""
        if self.backend == 'fock':
            _missing('wigner of the Fock backend (fock_to_wigner)')
        from .wigner import cv_to_wigner
        return cv_to_wigner(self._last_cv_state(), wire, **kwargs)

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
        if self.backend == 'bosonic':
            _missing('get_prob on the Bosonic backend', _BOSONIC_PROBS)
        from .gaussian_prob import probs_gaussian_helper
        state = self._last_cv_state()
        cov = state[0].reshape(-1, 2 * self.nmode, 2 * self.nmode)
        mean = state[1].reshape(-1, 2 * self.nmode, 1)
        if isinstance(final_state, FockState):
            final_state = final_state.state
        fs = tuple(int(x) for x in np.asarray(final_state).reshape(-1))
        out = torch.stack([probs_gaussian_helper([fs], cov[i], mean[i], self.detector)[0]
                           for i in range(cov.shape[0])])
        return out[0] if out.shape[0] == 1 else out

    @property
    def max_depth(self) -> int:
        """The most operations on one mode."""
        depth = np.zeros(self.nmode, np.int64)
        for op in self.operators:
            for w in op.wires:
                depth[w] += 1
        return int(depth.max())

    # ------------------------------------------------------------ gate sugar
    def ps(self, wires, inputs=None, encode=False):
        self.add_op('PhaseShift', wires, inputs, encode)

    def r(self, wires, inputs=None, encode=False, inv_mode=False):
        """A phase shift; with ``inv_mode`` by minus the angle."""
        if inv_mode:
            self.add_op('PhaseShiftInv', wires, inputs, encode, npara=1,
                        unitary_fn=PG.ps_inv_unitary, xp_fn=PG.ps_inv_xp)
        else:
            self.ps(wires, inputs, encode)

    def f(self, wires):
        """The Fourier gate: a phase shift by pi / 2."""
        self.add_op('PhaseShift', wires, [np.pi / 2], False)

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

    def _cv_gate(self, name: str, sugar: str, wires, inputs, encode):
        if self.backend == 'fock':
            _missing(f'{sugar} on the Fock backend (its Fock matrix)')
        self.add_op(name, wires, inputs, encode)

    def qp(self, wires, inputs=None, encode=False):
        """Quadratic phase P(s)."""
        self._cv_gate('QuadraticPhase', 'qp', wires, inputs, encode)

    def cx(self, wires, inputs=None, encode=False):
        """CV controlled-X(s) on [control, target]."""
        self._cv_gate('ControlledX', 'cx', wires, inputs, encode)

    def cz(self, wires, inputs=None, encode=False):
        """CV controlled-Z(s)."""
        self._cv_gate('ControlledZ', 'cz', wires, inputs, encode)

    def barrier(self, wires=None):
        """A barrier (drawing only; no operation)."""
        wires = list(range(self.nmode)) if wires is None else wires
        self._append(PhotonicOp('Barrier', [wires] if isinstance(wires, int) else wires,
                                kind='barrier'), False)

    # ---------------------------------------------------------- loss, delay
    def loss(self, wires, inputs=None, encode=False):
        """Photon loss of angle theta, transmittance T = cos^2(theta / 2)."""
        if self.backend == 'fock':
            _missing('loss on the Fock backend (Kraus operators on density matrices)')
        if inputs is None:
            inputs = [float(np.random.rand() * np.pi)]
        pidx = self._new_params(list(np.asarray(inputs, np.float64).reshape(-1)), encode, False)
        self._register(PhotonicOp('PhotonLoss', [wires] if isinstance(wires, int) else wires,
                                  pidx, 1, kind='loss'), encode)

    def loss_t(self, wires, inputs=None, encode=False):
        """Photon loss of transmittance T."""
        theta = None if inputs is None else \
            [transmittance_to_theta(float(np.asarray(inputs).reshape(-1)[0]))]
        self.loss(wires, theta, encode)

    def loss_db(self, wires, inputs=None, encode=False):
        """Photon loss in dB: T = 10^(-dB / 10)."""
        theta = None if inputs is None else \
            [transmittance_to_theta(10 ** (-float(np.asarray(inputs).reshape(-1)[0]) / 10))]
        self.loss(wires, theta, encode)

    def delay(self, wires, ntau: int = 1, inputs=None, convention: str = 'bs',
              encode: bool = False, loop_gates=None):
        """A delay loop of ntau time bins on one spatial mode, coupled in by
        a BeamSplitterTheta and a PhaseShift on the loop ('bs') or by an
        MZI ('mzi'): two parameters (theta, phi)."""
        if convention not in ('bs', 'mzi'):
            raise ValueError(f'Unknown delay convention {convention}')
        if self.backend == 'fock':
            _missing('delay on the Fock backend')
        if loop_gates is not None:
            _missing('delay(loop_gates=...)', 'gates inside the loop; the JAX package ignores them')
        if inputs is None:
            values = [float(np.random.rand() * 2 * np.pi) for _ in range(2)]
        else:
            values = list(np.asarray(inputs, np.float64).reshape(-1))
            if len(values) != 2:
                raise ValueError(f'delay takes 2 parameters (theta, phi), got {len(values)}')
        pidx = self._new_params(values, encode, inputs is None and not encode)
        wire = wires if isinstance(wires, int) else wires[0]
        self._register(PhotonicOp(f'Delay_{convention}', [wire], pidx, 2, kind='delay',
                                  extra={'ntau': ntau, 'convention': convention}), encode)

    def _prepare_unroll_dict(self):
        """Spatial mode -> its delay loops' concurrent modes (the last loop
        added first), then the spatial mode itself."""
        if self._unroll_dict is None:
            self._unroll_dict = defaultdict(list)
            start = 0
            for i in range(self.nmode):
                for ntau in reversed(self._ntau_dict[i]):
                    self._unroll_dict[i].append(list(range(start, start + ntau)))
                    start += ntau
                self._unroll_dict[i].append(start)
                start += 1
        return self._unroll_dict

    def _unroll_init_state(self, cov, mean):
        """Embed a state of the spatial modes into the concurrent modes,
        the loops in vacuum; a state already on them is kept."""
        nt = 2 * self._nmode_tdm
        if cov.shape[-1] == nt:
            return cov, mean
        idx = np.array([v[-1] for v in self._unroll_dict.values()])
        idx = np.concatenate([idx, idx + self._nmode_tdm])
        vac = config.HBAR / (4 * config.KAPPA ** 2)
        cov_tdm = (torch.eye(nt, dtype=cov.dtype, device=cov.device) * vac).repeat(
            cov.shape[:-2] + (1, 1))
        cov_tdm[..., idx[:, None], idx] = cov
        mean_tdm = torch.zeros(mean.shape[:-2] + (nt, 1), dtype=mean.dtype, device=mean.device)
        mean_tdm[..., idx, :] = mean
        return cov_tdm, mean_tdm

    def _unroll_circuit(self):
        """The operations and measurements of one time step on the
        concurrent modes; a delay becomes its coupling gates on the
        loop's first mode and the spatial mode."""
        if self._operators_tdm is None:
            ops = []
            ndelay = np.zeros(self.nmode, np.int64)
            for op in self.operators:
                if op.kind == 'delay':
                    wire = op.wires[0]
                    ndelay[wire] += 1
                    loop = self._unroll_dict[wire][-int(ndelay[wire]) - 1]
                    ops.extend(_delay_subgates(op, loop[0], self._unroll_dict[wire][-1]))
                else:
                    g = _copy.copy(op)
                    g.wires = tuple(self._unroll_dict[w][-1] for w in op.wires)
                    ops.append(g)
            self._operators_tdm = ops
        if self._measurements_tdm is None:
            ms = []
            for op_m in self.measurements:
                m2 = _copy.copy(op_m)
                m2.nmode = self._nmode_tdm
                m2.wires = [self._unroll_dict[w][-1] for w in op_m.wires]
                ms.append(m2)
            self._measurements_tdm = ms

    def _shift_state(self, cov, mean, nstep: int = 1, reverse: bool = False):
        """Cycle every delay loop's modes by nstep time bins."""
        idx_shift = []
        for wire in self._unroll_dict:
            for idx in self._unroll_dict[wire]:
                if isinstance(idx, int):
                    idx_shift.append(idx)
                else:
                    idx_shift.extend(shift_func(list(idx), -nstep if reverse else nstep))
        idx_shift = np.asarray(idx_shift)
        idx_shift = np.concatenate([idx_shift, idx_shift + self._nmode_tdm])
        return cov[..., idx_shift[:, None], idx_shift], mean[..., idx_shift, :]

    def global_circuit(self, nstep: int) -> 'QumodeCircuit':
        """The delay circuit unrolled in space over nstep time steps, from
        the vacuum: step i's gates act on fresh spatial modes; the fixed
        parameters are shared across steps (not trainable), the encoders'
        are fresh each step."""
        self._prepare_unroll_dict()
        nmode = self._nmode_tdm + (nstep - 1) * self.nmode
        cir = QumodeCircuit(nmode, init_state='vac', cutoff=self.cutoff, backend=self.backend,
                            detector=self.detector, name=self.name, device=self.device)

        def proto_of(op):
            """The op's gates (a delay: its coupling gates) as descriptors
            holding their parameter values."""
            subs = _delay_subgates(op, 0, 1) if op.kind == 'delay' else [_copy.copy(op)]
            for sub in subs:
                sub.extra = {k: v for k, v in op.extra.items() if k != '_owner'}
                sub.extra['inputs'] = [self._pvals[j] for j in sub.pidx]
                sub.pidx = ()
            return subs

        enc = {id(op) for op in self.encoders}
        protos = {id(op): proto_of(op) for op in self.operators if id(op) not in enc}
        for i in range(nstep):
            ndelay = np.zeros(self.nmode, np.int64)

            def spatial(w, i=i):
                return self._unroll_dict[w][-1] if i == 0 else \
                    self._nmode_tdm + self.nmode * (i - 1) + w

            for op in self.operators:
                encode = id(op) in enc
                gs = proto_of(op) if encode else protos[id(op)]
                if op.kind == 'delay':
                    wire = op.wires[0]
                    ndelay[wire] += 1
                    wire1 = self._unroll_dict[wire][-int(ndelay[wire]) - 1][i % op.extra['ntau']]
                    wire_lists = [[wire1, spatial(wire)]] + [[wire1]] * (len(gs) - 1)
                else:
                    wire_lists = [[spatial(w) for w in op.wires]]
                for g, ws in zip(gs, wire_lists):
                    cir.add(g, encode=encode, wires=ws)
            for op_m in self.measurements:
                m2 = _copy.copy(op_m)
                m2.nmode = nmode
                m2.wires = [spatial(w) for w in op_m.wires]
                cir.measurements.append(m2)
        return cir

    # ------------------------------------------------------------- homodyne
    def homodyne(self, wires, phi: float = 0.0, eps: float = 2e-4):
        """A conditional homodyne measurement of the quadrature at angle phi
        (``measure_homodyne`` draws it)."""
        from .measurement import Homodyne
        if self.backend == 'fock':
            _missing('homodyne on the Fock backend (Homodyne.op_fock)')
        m = Homodyne(phi=phi, nmode=self.nmode, wires=wires, cutoff=self.cutoff, eps=eps)
        self.measurements.append(m)
        self.wires_homodyne.append(m.wires[0])
        self._measurements_tdm = None

    def homodyne_x(self, wires, eps: float = 2e-4):
        self.homodyne(wires, phi=0.0, eps=eps)

    def homodyne_p(self, wires, eps: float = 2e-4):
        self.homodyne(wires, phi=np.pi / 2, eps=eps)

    def measure_homodyne(self, shots: int = 10, wires=None,
                         generator: torch.Generator | None = None):
        """Homodyne samples of the last CV forward, (batch, shots, nwire)
        squeezed. With conditional measurements (``homodyne``) each is drawn
        in turn and conditions the state, which ends in
        ``self.state_measured`` (shots x batch states). Without them: a
        Gaussian state's x and p of ``wires`` (its Wigner function is a
        distribution), a Bosonic state's x quadratures of ``wires`` (its
        Wigner function goes negative; x alone is a homodyne outcome)."""
        if self.backend == 'fock':
            _missing('measure_homodyne on the Fock backend')
        if self.state is None or isinstance(self.state, dict):
            raise RuntimeError('Run forward first (without is_prob)')
        measurements = self._measurements_tdm if self._with_delay else self.measurements
        cov, mean = self.state[0], self.state[1]
        if measurements:
            batch = mean.shape[0]

            def tile(t):
                return t if shots == 1 else t.repeat((shots,) + (1,) * (t.ndim - 1))

            # one covariance serves every shot: conditioning does not depend on the outcome
            parts = [cov if cov.shape[0] == 1 else tile(cov), tile(mean)] + \
                [tile(w) for w in self.state[2:]]
            samples = []
            for op_m in measurements:
                parts = op_m(parts, generator=generator)
                s = op_m.samples.reshape(shots, batch, -1)[..., :len(op_m.wires)]
                samples.append(s.transpose(0, 1))
            parts[0] = parts[0].expand((parts[1].shape[0],) + parts[0].shape[1:])
            self.state_measured = parts
            return torch.cat(samples, -1).squeeze()
        from .measurement import _mvn_sample, sample_bosonic
        if wires is None:
            wires = list(range(self.nmode))
        wires = np.asarray(sorted([wires] if isinstance(wires, int) else list(wires)))
        if self.backend == 'gaussian':
            idx = np.concatenate([wires, wires + self.nmode])
            loc = mean[..., idx, 0].expand((shots,) + mean.shape[:-2] + (len(idx),))
            return _mvn_sample(loc, cov[..., idx[:, None], idx], generator).squeeze()
        cov_sub, mean_sub = cov[..., wires[:, None], wires], mean[..., wires, :]
        rows = mean_sub.shape[0]
        draws = sample_bosonic(cov_sub if cov_sub.shape[0] == 1 else cov_sub.repeat(shots, 1, 1, 1),
                               mean_sub.repeat(shots, 1, 1, 1),
                               self.state[2].repeat(shots, 1) if self.state[2].shape[0] > 1
                               else self.state[2], generator)
        return draws.reshape(shots, rows, -1).squeeze()

    # -------------------------------------------------------- Bosonic states
    def _bosonic_mode(self, wires: int, state: BosonicState) -> None:
        if self.backend != 'bosonic':
            raise ValueError("cat and GKP states need backend='bosonic'")
        if self._bosonic_states is None:
            self._bosonic_states = [BosonicState('vac', 1, self.cutoff) for _ in range(self.nmode)]
        self._bosonic_states[wires] = state

    def cat(self, wires: int, r=None, theta=None, p: int = 1) -> None:
        """Prepare a cat state on one mode (the others stay in vacuum)."""
        self._bosonic_mode(wires, CatState(r=r, theta=theta, p=p, cutoff=self.cutoff))

    def gkp(self, wires: int, theta=None, phi=None, amp_cutoff: float = 0.1,
            epsilon: float = 0.05) -> None:
        """Prepare a GKP state on one mode (the others stay in vacuum)."""
        self._bosonic_mode(wires, GKPState(theta=theta, phi=phi, amp_cutoff=amp_cutoff,
                                           epsilon=epsilon, cutoff=self.cutoff))


def _stub(what: str):
    def method(self, *args, **kwargs):
        _missing(what)
    method.__doc__ = f'Not ported yet: {what}.'
    return method


# the rest of the JAX package's QumodeCircuit surface raises by name
for _name, _what in {'cp': 'cp (cubic phase, a Fock-only gate)', 'k': 'k (Kerr, a Fock-only gate)',
                     'ck': 'ck (cross-Kerr, a Fock-only gate)', 'draw': 'draw'}.items():
    setattr(QumodeCircuit, _name, _stub(_what))
