"""QumodeCircuit: the photonic circuit API (Fock, Gaussian and Bosonic backends).

PyTorch counterpart of ``deepquantum_tpu/photonic/circuit.py``: a circuit is
a list of operation descriptors plus a flat parameter vector, and each
backend is a plain function of them (there is no jit cache: the functions
are called).

- Fock backend, basis mode: the amplitudes of every output basis state as
  one dense vector, one Ryser permanent per state, all in ONE launch of the
  permanent kernel on the card (``qmath.permanent_batch``); ``measure``
  draws from them.
- Fock backend, tensor mode (``basis=False``): the (cutoff,)*n state, or
  with ``den_mat`` the (cutoff,)*2n density matrix, evolved gate by gate
  through ``ops/apply.py`` with ``qudit=cutoff`` (each gate's Fock matrix
  from ``gates.py``, a (B, ndata) data batch as (B, ...) matrices); photon
  loss as one c^2 x c^2 superoperator on a mode's row and column wires;
  photon statistics, quadrature means and Wigner functions from a mode's
  reduced density matrix; ``measure`` draws from the probabilities on the
  device; homodyne from a mode's grid pdf (``measurement.py``). With
  ``mps`` the state is a matrix product state of qudits (``mps.py``).
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
  with homodyne feedback); ``global_circuit`` unrolls them in space (on
  the Fock backend the only way a delay runs).
- ``noise``: Gaussian jitter on every parameter, drawn once when the gate
  is added, or with ``noise_per_forward`` at every forward (from
  ``noise_generator`` when one is given).

``draw`` renders SVG text (``photonic/draw.py``). Not ported, and raising
``NotImplementedError`` by name: ``measure(mcmc=True)`` and
``delay(loop_gates=...)``. Fock-basis
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
from ..ops.apply import evolve_den_mat, evolve_state, permute_matrix_wires
from . import gates as PG
from .channel import loss_superop, loss_xy, transmittance_to_theta
from .gates import PHOTONIC_REGISTRY
from .qmath import (fock_combinations, permanent, permanent_batch, photon_number_mean_var,
                    shift_func, sub_matrix)
from .state import BosonicState, CatState, FockState, GaussianState, GKPState, combine_bosonic_states

__all__ = ['QumodeCircuit', 'PhotonicOp']

_BOSONIC_PROBS = ("Fock-basis probabilities of a Bosonic state need loop hafnians with "
                  "complex displacement; the JAX package computes one Gaussian table per "
                  "component and drops the weights (ROADMAP queue 3)")


def _missing(what: str, where: str):
    raise NotImplementedError(f'QumodeCircuit: {what} is not ported to deepquantum_tpu_torch '
                              f'yet ({where})')


def _delay_subgates(op, wire1: int, wire2: int) -> list:
    """A delay loop's gates on its concurrent modes: wire1 the loop's mode,
    wire2 the spatial mode. 'bs': a BeamSplitterTheta (phi = pi / 2) on
    both, then a PhaseShift on the loop; 'mzi': one MZI with
    ``phi_first=False``. Their Fock matrices come from their unitaries."""
    if op.extra['convention'] == 'bs':
        return [PhotonicOp(op.name, [wire1, wire2], op.pidx[:1], 1,
                           unitary_fn=partial(PG.bs_theta_unitary, phi=np.pi / 2)),
                PhotonicOp(op.name + '_ps', [wire1], op.pidx[1:2], 1, unitary_fn=PG.ps_unitary,
                           xp_fn=PG.ps_xp, fock_fn=PG.ps_fock)]
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


# torch.multinomial takes at most 2^24 categories
MULTINOMIAL_MAX = 1 << 24


def draw_outcomes(probs, shots: int, generator=None) -> torch.Tensor:
    """``shots`` outcome indices per row of (B, K) probabilities (need not
    sum to 1), on their device: ``torch.multinomial`` up to
    MULTINOMIAL_MAX categories, above that uniform draws located in the
    cumulative sums (``searchsorted``)."""
    if probs.shape[-1] <= MULTINOMIAL_MAX:
        return torch.multinomial(probs, shots, replacement=True, generator=generator)
    cdf = probs.cumsum(-1)
    u = torch.rand((probs.shape[0], shots), generator=generator, dtype=cdf.dtype,
                   device=cdf.device) * cdf[:, -1:]
    return torch.searchsorted(cdf, u, right=True).clamp_(max=probs.shape[-1] - 1)


class PhotonicOp:
    """One photonic operation of the circuit's list; ``kind`` is 'gate',
    'loss', 'delay' or 'barrier'."""

    def __init__(self, name, wires, pidx=(), npara=0, kind='gate', unitary_fn=None,
                 xp_fn=None, static_unitary=None, extra=None, fock_fn=None):
        self.name = name
        self.wires = tuple(wires)
        self.pidx = tuple(pidx)
        self.npara = npara
        self.kind = kind
        self.unitary_fn = unitary_fn
        self.xp_fn = xp_fn
        self.fock_fn = fock_fn
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

    def fock(self, full, cutoff: int):
        """The (..., cutoff, ..., cutoff) Fock tensor, output modes first: a
        fixed unitary's from ``extra['static_fock']``, a passive gate's
        without a Fock function from its unitary."""
        if 'static_fock' in self.extra:
            return torch.as_tensor(self.extra['static_fock'], device=full.device).to(cdtype())
        if self.fock_fn is not None:
            return self.fock_fn(self.params(full), cutoff)
        if self.unitary_fn is None and self.static_unitary is None:
            raise ValueError(f'{self.name} has no Fock representation')
        return PG.passive_fock(self.unitary(full), cutoff)


class QumodeCircuit:
    """Photonic quantum circuit.

    Args:
        nmode: number of modes.
        init_state: Fock photon numbers / a dense Fock tensor / 'vac' /
            [cov, mean(, weight)] / a state object (an MPS's site tensors
            with ``mps``).
        cutoff: Fock truncation.
        backend: 'fock', 'gaussian' or 'bosonic'.
        basis: Fock basis mode (permanent-based) or, when False, tensor mode.
        detector: 'pnrd' or 'threshold' (Gaussian probabilities).
        den_mat: tensor mode on density matrices (photon loss needs it).
        mps, chi: tensor mode as a matrix product state of bond ``chi``.
        noise, mu, sigma: Gaussian jitter N(mu, sigma) on every parameter
            added, drawn once when it is added (numpy's global generator);
            with ``noise_per_forward`` drawn anew at every forward.
        device: where the circuit computes; the default device (the CUDA
            card) when None.
    """

    def __init__(self, nmode: int, init_state: Any = None, cutoff: int | None = None,
                 backend: str = 'fock', basis: bool = True, detector: str = 'pnrd',
                 name: str | None = None, den_mat: bool = False, mps: bool = False,
                 chi: int | None = None, noise: bool = False, mu: float = 0,
                 sigma: float = 0.1, noise_per_forward: bool = False, device=None) -> None:
        if backend not in ('fock', 'gaussian', 'bosonic'):
            raise ValueError(f'Unknown backend {backend}')
        self.nmode = nmode
        self.backend = backend
        self.basis = basis if backend == 'fock' else False
        if (den_mat or mps) and self.basis:
            raise ValueError('den_mat and mps need the Fock backend in tensor mode (basis=False)')
        self.detector = detector.lower()
        self.name = name
        self.device = resolve_device(device)
        self.den_mat = den_mat
        self.mps = mps
        self.chi = chi
        self.noise = noise
        self.mu = mu
        self.sigma = sigma
        self.noise_per_forward = noise_per_forward
        self._noise_pidx: list[int] = []
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
        self._state_is_prob = False    # the last Fock tensor forward returned probabilities
        self._cache: dict = {}         # MPO split bases of the Fock MPS, per gate family
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
            if self.mps:
                from ..mps import MatrixProductState
                if isinstance(init_state, MatrixProductState):
                    self.init_state = init_state
                else:
                    if isinstance(init_state, str):
                        init_state = [0] * self.nmode
                    sites = [int(v) if np.ndim(v) == 0 else v for v in init_state]
                    self.init_state = MatrixProductState(self.nmode, sites, self.chi,
                                                         qudit=self.cutoff, device=self.device)
                self.chi = self.init_state.chi
                return
            if isinstance(init_state, FockState):
                self.init_state = init_state
            else:
                self.init_state = FockState(init_state, self.nmode, self.cutoff, self.basis,
                                            self.den_mat)
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

    def _full_params(self, params=None, data=None, data_idx=None, jitter=None) -> torch.Tensor:
        """All parameter slots as one vector: the stored values, with the
        trainable slots from ``params``, the encoder slots from ``data``
        and the per-forward ``jitter`` added; (B, P) for a (B, ndata) batch
        of data rows."""
        full = torch.as_tensor(np.asarray(self._pvals, np.float64), device=self.device).to(rdtype())
        if params is not None:
            ti = torch.as_tensor(self._trainable(), dtype=torch.long, device=self.device)
            full = full.index_put((ti,), self._real(params).reshape(-1))
        if data is not None and self._enc_pidx:
            vals = self._real(data)[..., list(data_idx)]
            full = full.expand(vals.shape[:-1] + full.shape).clone()
            full[..., self._enc_pidx] = vals
        if jitter is not None:
            full = full + jitter
        return full

    def _data_indices(self, data_len: int) -> list[int]:
        if data_len < self.ndata:
            raise ValueError('The circuit needs more data')
        return list(range(self.ndata))

    def _new_params(self, values, encode, requires_grad):
        start = len(self._pvals)
        if self.noise:
            if self.noise_per_forward:
                self._noise_pidx.extend(range(start, start + len(values)))
            else:
                values = [v + np.random.normal(self.mu, self.sigma) for v in values]
        idx = tuple(range(start, start + len(values)))
        self._pvals.extend(float(v) for v in values)
        self._train_mask.extend([requires_grad and not encode] * len(values))
        return idx

    def _noise_jitter(self, generator: torch.Generator | None = None):
        """Fresh jitter N(mu, sigma) on the per-forward noisy slots (None
        when per-forward noise is off): from ``generator`` (normals drawn in
        float64 on its device, then cast) or, without one, from numpy's
        global generator, as the JAX package draws without a key."""
        if not (self.noise and self.noise_per_forward and self._noise_pidx):
            return None
        pidx = torch.as_tensor(self._noise_pidx, device=self.device)
        if generator is None:
            eps = torch.as_tensor(np.random.normal(self.mu, self.sigma, len(self._noise_pidx)))
        else:
            eps = self.mu + self.sigma * torch.randn(len(self._noise_pidx), generator=generator,
                                                     dtype=torch.float64, device=generator.device)
        eps = eps.to(device=self.device, dtype=rdtype())
        return torch.zeros(len(self._pvals), dtype=rdtype(), device=self.device).index_add(
            0, pidx, eps)

    def init_para(self) -> None:
        """Re-randomize all trainable parameters in [0, 2 pi)."""
        for i, trainable in enumerate(self._train_mask):
            if trainable:
                self._pvals[i] = float(np.random.rand() * 2 * np.pi)

    # ------------------------------------------------------------------ add
    def _touch(self) -> None:
        """Forget what was derived from the operation list."""
        self._basis_table = None
        self._cache.clear()
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
               unitary_fn=None, xp_fn=None, npara=None, static_unitary=None,
               fock_fn=None, extra=None) -> PhotonicOp:
        wires = [wires] if isinstance(wires, int) else list(wires)
        if unitary_fn is None and xp_fn is None and static_unitary is None and fock_fn is None:
            reg = PHOTONIC_REGISTRY.get(name)
            if reg is None:
                raise ValueError(f'Unknown photonic gate {name}')
            unitary_fn, xp_fn, fock_fn, npara = reg['unitary'], reg['xp'], reg['fock'], reg['npara']
        if self.backend != 'fock' and xp_fn is None and unitary_fn is None \
                and static_unitary is None:
            raise ValueError(f"{name} exists only as a Fock matrix: it needs backend='fock'")
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
                                         static_unitary, extra, fock_fn), encode)

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
            # the sub-circuit's per-forward noisy slots keep their jitter
            self._noise_pidx.extend(i + offset for i in op._noise_pidx)
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
    def get_unitary(self, params=None, data=None, jitter=None) -> torch.Tensor:
        """Global nmode x nmode creation-operator unitary (of one row of data)."""
        if data is not None:
            data = self._real(data).reshape(-1)
        didx = None if data is None else self._data_indices(data.shape[-1])
        return self._unitary_of(self._full_params(params, data, didx, jitter))

    def _unitary_of(self, full) -> torch.Tensor:
        eye = torch.eye(self.nmode, dtype=cdtype(), device=self.device)
        u = eye
        for op in self.operators:
            if op.kind == 'delay' and self.backend == 'fock':
                raise ValueError('a delay loop on the Fock backend runs through '
                                 'global_circuit(nstep)')
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
                 stepwise=False, params=None, noise_generator=None):
        return self.forward(data, state, is_prob, detector, sort, stepwise, params,
                            noise_generator)

    def forward(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                stepwise=False, params=None, noise_generator: torch.Generator | None = None):
        """Run the circuit. Fock basis mode: the unitary (``is_prob=None``)
        or a dict FockState -> amplitude / probability. Fock tensor mode:
        the state tensor ((B,) (cutoff,)*n, or *2n with ``den_mat``), its
        probabilities (cutoff,)*n with ``is_prob``, or with ``mps`` the
        site tensors. Gaussian backend: [cov, mean], or with ``is_prob`` a
        dict FockState -> probability. Bosonic backend: [cov, mean,
        weight]. ``noise_generator`` draws the per-forward noise."""
        jitter = self._noise_jitter(noise_generator)
        if self.backend == 'fock':
            return self._forward_fock(data, state, is_prob, sort, params, jitter)
        return self._forward_cv(data, state, is_prob, detector, params, jitter)

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

    def _forward_fock(self, data, state, is_prob, sort, params=None, jitter=None):
        if not self.basis:
            if self.mps:
                return self._forward_fock_mps(data, state, params, jitter)
            return self._forward_fock_tensor(data, state, is_prob, params, jitter)
        in_state = self._basis_input(state)
        if in_state.ndim == 2:
            outs = [self._forward_fock(data, row, is_prob, sort, params, jitter)
                    for row in in_state]
            self.state = outs
            return outs
        if is_prob is None:
            self.state = self.get_unitary(params, data, jitter)
            return self.state
        out_basis = self._output_basis(in_state)
        self._basis_table = out_basis
        amps = self._fock_basis_amps(data, in_state, out_basis, params, jitter)
        vals = amps.abs() ** 2 if is_prob else amps
        self.state = self._state_dict(out_basis, vals, sort)
        return self.state

    def _fock_basis_amps(self, data, in_state, out_basis, params=None,
                         jitter=None) -> torch.Tensor:
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
        us = torch.stack([self._unitary_of(self._full_params(params, d, didx, jitter))
                          for d in batch])
        sub = us[:, rows, cols]                                     # (batch, nout, k, k)
        k = sub.shape[-1]
        perms = permanent_batch(sub.reshape(-1, k, k)).reshape(len(batch), -1)
        amps = perms / norms_t
        return amps[0] if data is None or data.ndim == 1 else amps

    # Fock-tensor helpers ---------------------------------------------------
    def _fock_input(self, state) -> torch.Tensor:
        """The forward's input as a Fock tensor on the device: the init
        state, a FockState, photon numbers, or a (batch,) tensor."""
        if state is None:
            state = self.init_state
        if isinstance(state, (list, tuple)) and np.asarray(state).ndim == 1:
            state = FockState(list(state), self.nmode, self.cutoff, False, self.den_mat)
        if isinstance(state, FockState):
            return state.tensor(self.device, cdtype())
        return self._complex(state)

    def _fock_full(self, data, params, jitter) -> torch.Tensor:
        if data is None:
            return self._full_params(params, jitter=jitter)
        data = self._real(data)
        return self._full_params(params, data, self._data_indices(data.shape[-1]), jitter)

    def _forward_fock_tensor(self, data, state, is_prob, params=None, jitter=None):
        out = self._run_fock_tensor(self._fock_full(data, params, jitter),
                                    self._fock_input(state), is_prob)
        self.state = out
        self._state_is_prob = bool(is_prob)
        return out

    def _run_fock_tensor(self, full, x, is_prob=None):
        """Evolve a Fock tensor (leading batch axes allowed; (B, P)
        parameters make a batch of states) through the operations: each
        gate's Fock matrix on its modes, on a density matrix U on the row
        wires and conj(U) on the column wires, loss as its superoperator on
        a mode's (row, column) pair."""
        c, n = self.cutoff, self.nmode
        dims = 2 * n if self.den_mat else n
        if tuple(x.shape[x.dim() - dims:]) != (c,) * dims:
            if x.numel() % c ** dims:
                raise ValueError(f'a Fock tensor of shape {tuple(x.shape)} for {n} modes at '
                                 f'cutoff {c}' + (' (a density matrix)' if self.den_mat else ''))
            x = x.reshape(((-1,) if x.numel() > c ** dims else ()) + (c,) * dims)
        mats = self._fock_matrices(full)
        for op, mat in zip(self.operators, mats):
            if op.kind == 'loss':
                if not self.den_mat:
                    raise ValueError('photon loss on Fock tensors needs den_mat=True')
                sup = loss_superop(op.params(full), c)
                for w in op.wires:
                    x = evolve_state(x, sup, 2 * n, [w, w + n], c)
            elif op.kind == 'delay':
                raise ValueError('a delay loop on the Fock backend runs through '
                                 'global_circuit(nstep)')
            elif op.kind == 'gate':
                evolve = evolve_den_mat if self.den_mat else evolve_state
                x = evolve(x, mat, n, list(op.wires), c)
        if not is_prob:
            return x
        if self.den_mat:
            lead = x.shape[:x.dim() - 2 * n]
            diag = x.reshape(lead + (c ** n, c ** n)).diagonal(dim1=-2, dim2=-1)
            return diag.abs().reshape(lead + (c,) * n)
        return x.abs() ** 2

    def _fock_matrices(self, full) -> list:
        """Every gate's (..., c^k, c^k) Fock matrix (None for the other
        operations), each gate family's built in one call: the parameters
        of all its gates stacked on a leading axis (all the beam splitters
        of a circuit are one recurrence, not one each)."""
        c = self.cutoff
        groups = defaultdict(list)
        mats = [None] * len(self.operators)
        for i, op in enumerate(self.operators):
            if op.kind != 'gate':
                continue
            if op.npara and 'static_fock' not in op.extra and (op.fock_fn or op.unitary_fn):
                groups[op.fock_fn or ('passive', op.unitary_fn)].append(i)
            else:
                mats[i] = op.fock(full, c)
        for fn, idx in groups.items():
            p = torch.stack([self.operators[i].params(full) for i in idx])
            built = PG.passive_fock(fn[1](p), c) if isinstance(fn, tuple) else fn(p, c)
            for i, mat in zip(idx, built.unbind(0)):
                mats[i] = mat
        for i, mat in enumerate(mats):
            if mat is not None:
                k = len(self.operators[i].wires)
                mats[i] = mat.reshape(mat.shape[:mat.dim() - 2 * k] + (c ** k, c ** k))
        return mats

    def _forward_fock_mps(self, data, state, params=None, jitter=None):
        """The Fock MPS forward: the final site tensors (one row of data)."""
        from ..mps import MatrixProductState
        if state is None:
            state = self.init_state
        tensors = state.tensors if isinstance(state, MatrixProductState) else list(state)
        if data is not None and np.ndim(data) > 1:
            raise ValueError('a Fock MPS takes one row of data at a time')
        full = self._fock_full(data, params, jitter)
        self.state = self._run_fock_mps(full, [self._complex(t) for t in tensors])
        self._state_is_prob = False
        return self.state

    def _run_fock_mps(self, full, tensors: list) -> list:
        """TEBD of the gates on qudits of dimension cutoff, bond ``chi``,
        normalised after every gate as in the JAX package."""
        from ..mps import apply_gate_mps, gate_to_mpo
        state = (list(tensors), -1)
        for op, mat in zip(self.operators, self._fock_matrices(full)):
            if op.kind == 'barrier':
                continue
            if op.kind != 'gate':
                raise ValueError(f'a Fock MPS takes gates only, not {op.name}')
            wires = sorted(op.wires)
            order = sorted(range(len(op.wires)), key=lambda i: op.wires[i])
            mat = permute_matrix_wires(mat.to(cdtype()), order, self.cutoff)
            mpo = None
            if len(wires) > 1:
                mpo = gate_to_mpo(mat, wires, self.cutoff, bases=self._mpo_bases(op, full, order))
            state = apply_gate_mps(state, mat, wires, self.chi, True, self.cutoff, mpo=mpo)
        return state[0]

    def _mps_matrix(self, op: PhotonicOp, full, order: list) -> torch.Tensor:
        """The op's (c^k, c^k) Fock matrix, its modes in sorted wire order
        (a probe of its family)."""
        k = len(order)
        mat = op.fock(full, self.cutoff).to(cdtype()).reshape(self.cutoff ** k, self.cutoff ** k)
        return permute_matrix_wires(mat, order, self.cutoff)

    def _mpo_bases(self, op: PhotonicOp, full, order: list) -> list:
        """The MPO split bases of the op's gate family (``mps.mpo_bases``),
        made once per family and cutoff from its Fock matrix at generic
        parameters (a generic member carries the family's operator Schmidt
        rank: c^2 for a beam splitter, c for a cross-Kerr gate)."""
        from ..mps import mpo_bases
        key = (op.name, id(op.fock_fn), id(op.unitary_fn), id(op.static_unitary),
               id(op.extra.get('static_fock')), tuple(order), self.cutoff, cdtype(), full.device)
        bases = self._cache.get(key)
        if bases is None:
            k = len(order)
            with torch.no_grad():
                if op.npara == 0:
                    probes = [self._mps_matrix(op, full, order)]
                else:
                    gen = torch.Generator(device='cpu').manual_seed(0)
                    draws = torch.rand(4 ** (k // 2), full.shape[-1], generator=gen,
                                       dtype=torch.float64) * 2 * np.pi
                    draws = draws.to(device=full.device, dtype=full.dtype)
                    probes = [self._mps_matrix(op, p, order) for p in draws]
                bases = self._cache[key] = mpo_bases(probes, k, self.cutoff)
        return bases

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

    def _forward_cv(self, data, state, is_prob, detector, params=None, jitter=None):
        parts = self._cv_parts(state)
        cov, mean = parts[0], parts[1]
        if self._with_delay:
            self._prepare_unroll_dict()
            self._unroll_circuit()
            cov, mean = self._unroll_init_state(cov, mean)
        if data is None:
            full = self._full_params(params, jitter=jitter)
        else:
            data = self._real(data)
            full = self._full_params(params, data, self._data_indices(data.shape[-1]), jitter)
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
        the forward returned the state); Fock tensor mode from the state's
        probabilities on the device (a dict of the outcomes drawn only), a
        Fock MPS by ancestral sampling. ``torch.multinomial`` on
        ``generator``."""
        if mcmc:
            _missing('measure(mcmc=True)', 'Markov-chain sampling')
        if self.state is None:
            raise RuntimeError('Run the circuit forward before measurement')
        if self.backend == 'fock' and not self.basis:
            return self._measure_fock_tensor(shots, with_prob, wires, generator)
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

    def _fock_state(self, what: str) -> torch.Tensor:
        """The last forward's Fock tensor (its amplitudes or density matrix)."""
        if self.basis or self.mps:
            raise ValueError(f'{what} of the Fock backend needs tensor mode (basis=False), '
                             'not an MPS')
        if self.state is None or self._state_is_prob:
            raise RuntimeError(f'{what}: run the circuit forward first (without is_prob)')
        return self.state

    def _measure_fock_tensor(self, shots: int, with_prob: bool, wires, generator):
        """measure() of Fock tensor mode: the outcomes of ``wires`` (the
        others summed out) drawn on the device; the dict holds only the
        outcomes drawn."""
        c, n = self.cutoff, self.nmode
        keep = list(range(n)) if wires is None else \
            ([wires] if isinstance(wires, int) else sorted(wires))
        if self.mps:
            from ..mps import bitstring_prob, sample_mps
            sites = sample_mps(self.state, shots, generator)[:, keep]        # (shots, k)
            weights = c ** torch.arange(len(keep) - 1, -1, -1, device=sites.device)
            draws, flat, single = (sites * weights).sum(-1)[None], None, True
        else:
            x = self.state.detach()
            if self._state_is_prob:
                probs = x
            elif self.den_mat:
                lead = x.shape[:x.dim() - 2 * n]
                probs = x.reshape(lead + (c ** n, c ** n)).diagonal(dim1=-2, dim2=-1).abs()
            else:
                probs = x.abs() ** 2
            single = probs.numel() == c ** n
            probs = probs.reshape((-1,) + (c,) * n).to(torch.float64)
            other = tuple(i + 1 for i in range(n) if i not in keep)
            if other:
                probs = probs.sum(other)
            flat = probs.reshape(probs.shape[0], -1)
            draws = draw_outcomes(flat, shots, generator)
        results = []
        for row, drawn in enumerate(draws):
            idx, counts = (t.cpu().numpy() for t in torch.unique(drawn, return_counts=True))
            keys = np.stack(np.unravel_index(idx, (c,) * len(keep)), -1)
            if not with_prob:
                vals = counts.tolist()
            elif flat is not None:
                vals = list(zip(counts.tolist(), flat[row, torch.as_tensor(idx)].tolist()))
            else:       # an MPS outcome's probability, of full outcomes only
                vals = [(int(m), float(bitstring_prob(self.state, k)) if len(keep) == n else None)
                        for m, k in zip(counts, keys)]
            results.append({FockState(list(k), len(keep), c): v for k, v in zip(keys, vals)})
        return results[0] if single else results

    def photon_number_mean_var(self, wires=None):
        """Photon-number mean and variance per wire of the last forward:
        (batch, nwire) of a CV state, where a Bosonic state's are the
        mixture's (sum_k w_k <n>_k, and sum_k w_k <n^2>_k - <n>^2, real
        parts); (nwire, batch) of a Fock tensor, as the JAX package
        returns them."""
        if wires is None:
            wires = list(range(self.nmode))
        wires = [wires] if isinstance(wires, int) else list(wires)
        if self.backend == 'fock':
            from .wigner import photon_number_mean_var_fock
            return photon_number_mean_var_fock(self._fock_state('photon statistics'), self.nmode,
                                               self.cutoff, wires, self.den_mat)
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
        """<x> per wire of the last forward: (batch, nwire) of a CV state
        (a Bosonic state's is Re sum_k w_k <x>_k); (nwire, batch) of a Fock
        tensor."""
        if wires is None:
            wires = list(range(self.nmode))
        wires = [wires] if isinstance(wires, int) else list(wires)
        if self.backend == 'fock':
            from .wigner import quadrature_mean_fock
            return quadrature_mean_fock(self._fock_state('quadrature_mean'), self.nmode,
                                        self.cutoff, wires, self.den_mat)
        state = self._last_cv_state()
        mean = state[1][..., wires, 0]
        if self.backend == 'bosonic':
            mean = (state[2][..., None] * mean).sum(-2)
        return mean.real

    def wigner(self, wire: int, **kwargs):
        """Wigner function of one mode of the last forward (see
        ``wigner.cv_to_wigner`` and ``wigner.fock_to_wigner``)."""
        if self.backend == 'fock':
            from .wigner import fock_to_wigner
            return fock_to_wigner(self._fock_state('wigner'), wire, self.nmode, self.cutoff,
                                  self.den_mat, **kwargs)
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
        """A fixed unitary on the given wires (in Fock tensor mode its Fock
        tensor, made once on the host)."""
        if wires is None:
            if minmax is None:
                minmax = [0, self.nmode - 1]
            wires = list(range(minmax[0], minmax[1] + 1))
        wires = [wires] if isinstance(wires, int) else list(wires)
        if torch.is_tensor(unitary):
            unitary = unitary.detach().cpu().numpy()
        u = np.asarray(unitary, dtype=np.complex128)
        extra = None
        if self.backend == 'fock' and not self.basis:
            extra = {'static_fock': PG.uany_fock_np(u, len(wires), self.cutoff)}
        self.add_op(name, wires, None, False, static_unitary=u, npara=0, extra=extra)

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

    def qp(self, wires, inputs=None, encode=False):
        """Quadratic phase P(s)."""
        self.add_op('QuadraticPhase', wires, inputs, encode)

    def cx(self, wires, inputs=None, encode=False):
        """CV controlled-X(s) on [control, target]."""
        self.add_op('ControlledX', wires, inputs, encode)

    def cz(self, wires, inputs=None, encode=False):
        """CV controlled-Z(s)."""
        self.add_op('ControlledZ', wires, inputs, encode)

    def cp(self, wires, inputs=None, encode=False):
        """Cubic phase V(gamma) = exp(i gamma x^3 / (3 hbar)) (Fock backend)."""
        self.add_op('CubicPhase', wires, inputs, encode)

    def k(self, wires, inputs=None, encode=False):
        """Kerr K(kappa) = exp(i kappa n^2) (Fock backend)."""
        self.add_op('Kerr', wires, inputs, encode)

    def ck(self, wires, inputs=None, encode=False):
        """Cross-Kerr CK(kappa) = exp(i kappa n1 n2) (Fock backend)."""
        self.add_op('CrossKerr', wires, inputs, encode)

    def barrier(self, wires=None):
        """A barrier (drawing only; no operation)."""
        wires = list(range(self.nmode)) if wires is None else wires
        self._append(PhotonicOp('Barrier', [wires] if isinstance(wires, int) else wires,
                                kind='barrier'), False)

    # ---------------------------------------------------------- loss, delay
    def loss(self, wires, inputs=None, encode=False):
        """Photon loss of angle theta, transmittance T = cos^2(theta / 2);
        on the Fock backend a density matrix's channel (den_mat=True)."""
        if self.backend == 'fock' and not self.den_mat:
            raise ValueError('photon loss on the Fock backend needs den_mat=True')
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
        MZI ('mzi'): two parameters (theta, phi). On the Fock backend it
        runs through ``global_circuit``."""
        if convention not in ('bs', 'mzi'):
            raise ValueError(f'Unknown delay convention {convention}')
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
                            basis=self.basis, detector=self.detector, name=self.name,
                            den_mat=self.den_mat, mps=self.mps, chi=self.chi, device=self.device)

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
        if self.backend == 'fock' and (self.basis or self.mps):
            raise ValueError('homodyne on the Fock backend needs tensor mode (basis=False), '
                             'not an MPS')
        m = Homodyne(phi=phi, nmode=self.nmode, wires=wires, cutoff=self.cutoff,
                     den_mat=self.den_mat, eps=eps)
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
        Wigner function goes negative; x alone is a homodyne outcome). A
        Fock tensor: without conditional measurements the x quadrature of
        one wire, every shot from one grid pdf (``measurement.py``)."""
        if self.backend == 'fock':
            return self._measure_homodyne_fock(shots, wires, generator)
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

    def _measure_homodyne_fock(self, shots: int, wires, generator):
        """measure_homodyne on a Fock tensor: with conditional measurements
        each draws in turn on shots x batch copies of the state (ending in
        ``state_measured``); without, the x quadrature of one wire."""
        from .measurement import sample_homodyne_fock
        x = self._fock_state('measure_homodyne')
        c, n = self.cutoff, self.nmode
        dims = 2 * n if self.den_mat else n
        measurements = self._measurements_tdm if self._with_delay else self.measurements
        if measurements:
            core = x.reshape((-1,) + (c,) * dims)
            batch = core.shape[0]
            state = core.repeat((shots,) + (1,) * dims)
            samples = []
            for op_m in measurements:
                state = op_m(state, generator=generator)
                s = op_m.samples.reshape(shots, batch, -1)[..., :len(op_m.wires)]
                samples.append(s.transpose(0, 1))
            self.state_measured = state
            return torch.cat(samples, -1).squeeze()
        wires = list(range(n)) if wires is None else ([wires] if isinstance(wires, int) else wires)
        if len(wires) != 1:
            raise ValueError('measure_homodyne on a Fock tensor measures one wire')
        return sample_homodyne_fock(x, wires[0], n, c, shots, self.den_mat, generator).squeeze()

    # -------------------------------------------------------- Bosonic states
    def _bosonic_mode(self, wires: int, state: BosonicState) -> None:
        if self.backend != 'bosonic':
            raise ValueError("cat and GKP states need backend='bosonic'")
        if self._bosonic_states is None:
            self._bosonic_states = [BosonicState('vac', 1, self.cutoff) for _ in range(self.nmode)]
        self._bosonic_states[wires] = state

    def draw(self, filename: str | None = None, unroll: bool = False) -> str:
        """The circuit as SVG text (``photonic/draw.py``), also written to
        ``filename`` when given; ``unroll`` draws a TDM circuit's
        concurrent modes."""
        from .draw import DrawCircuit
        tdm = unroll and self._with_delay
        if tdm:
            self._prepare_unroll_dict()
            self._unroll_circuit()
        drawer = DrawCircuit(self.name, self._nmode_tdm if tdm else self.nmode,
                             self._operators_tdm if tdm else self.operators, self.measurements,
                             params=np.asarray(self._pvals, np.float64))
        svg = drawer.draw()
        if filename:
            drawer.save(filename)
        return svg

    def cat(self, wires: int, r=None, theta=None, p: int = 1) -> None:
        """Prepare a cat state on one mode (the others stay in vacuum)."""
        self._bosonic_mode(wires, CatState(r=r, theta=theta, p=p, cutoff=self.cutoff))

    def gkp(self, wires: int, theta=None, phi=None, amp_cutoff: float = 0.1,
            epsilon: float = 0.05) -> None:
        """Prepare a GKP state on one mode (the others stay in vacuum)."""
        self._bosonic_mode(wires, GKPState(theta=theta, phi=phi, amp_cutoff=amp_cutoff,
                                           epsilon=epsilon, cutoff=self.cutoff))

