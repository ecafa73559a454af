"""QubitCircuit: the qubit-circuit API of the PyTorch port.

PyTorch counterpart of the ``deepquantum_tpu/circuit.py`` subset that the
serving and training paths use: build a circuit, run ``forward`` on one
state, take Pauli-string ``expectation`` values, and differentiate them in
the parameters (``expectation(params=p)[0].backward()`` with ``p`` a leaf
that requires grad). The circuit records an op list (the IR) plus one flat
parameter vector; simulation runs eagerly on the circuit's device.

Data-encoded circuits (QML): gates added with ``encode=True`` take their
angles from ``data`` instead of the parameters. ``forward(data=d)`` with d
of shape (ndata,) runs one state; with d of shape (B, ndata) it runs a batch
of B states, each with its own encoder angles, and returns (B, 2^n, 1);
``expectation`` then gives (B, n_observables). Gradients reach both the
parameters and the data (so a classical layer in front of the circuit
trains too). With ``reupload`` the data wraps around the encoders.

Routing is a pure function of the dtype, n, the plan and the device: at
complex64 with n >= 10 and every fused group a unitary on <= 3 wires, the
state runs as float32 planes through the planar engine (ops/planar_gate.py,
its window scheduler and its CUDA kernels on a CUDA device); everything
else runs the complex einsum engine (ops/apply.py). A batch takes the same
routes with the batch as a leading axis: the planar engine's per-gate
kernels run it as a grid axis (windows and the one-launch chain refuse
batched planes, as in the JAX package), the einsum engine as an einsum
axis. Gradients follow the route: the planar engine's chain has an adjoint
backward over its own kernels, the einsum engine is plain autograd. Both
differentiate again (``hessian``: reverse over reverse).

Noisy circuits (``den_mat=True``): the state is a density matrix rho
(2^n, 2^n), and the seven Kraus channels (``bit_flip`` ... ``gen_amp_damp``)
act on it. On the planar engine (complex64, 2n >= 10) rho is a 2n-wire
planar state: a gate U runs as U on its wires and conj(U) on the wires + n
in one chain, and each channel ends the chain and runs as its 4^k
superoperator on (w, w + n) (``planar_superop``, one K1 launch, an
input-residual backward); a batch of data gives a batch of rho, each with
its own matrices. ``measure`` and ``expectation(shots=)`` sample a state,
a batch or rho's diagonal from an explicit ``torch.Generator``.

Mid-circuit measurement follows the deferred-measurement principle: a gate
added with ``condition=True`` is a controlled gate whose controls are the
measured wires (``wires_condition``); it keeps the circuit on the einsum
route, as in the JAX package. ``defer_measure`` then draws the condition
wires' outcome once and slices the state; ``post_select`` slices it on
given bits. ``reset`` and ``move`` are non-unitary ops of the einsum route.
Circuits compose (``add`` of a circuit, a gate descriptor or an
observable; ``inverse``, ``+``), and ``get_unitary``, ``get_amplitude`` and
``get_prob`` inspect them.

MPS circuits (``mps=True, chi=...``): the state is a matrix product state
(mps.py), each gate an MPO contracted in and truncated back to ``chi`` by
QR / SVD sweeps (``svd_safe`` / ``qr_stable``, differentiable); forward
returns the list of site tensors, and expectation, measure and
get_amplitude read it without the dense state.

The toolchain works on the op list: ``cut`` marks wire cuts for
``get_subexperiments`` / ``transform_cut2move`` (cutting.py), ``pattern``
transpiles to an MBQC pattern (mbqc/), ``qasm`` / ``qasm3`` export OpenQASM
(qasm.py) and ``draw`` gives the text drawing (draw.py).
"""

from __future__ import annotations

import copy as _copy
from typing import Any

import numpy as np
import torch

from .config import cdtype, rdtype, resolve_device
from .gate import GATE_REGISTRY, GateOp, hamiltonian_fn, latent_fn, projection_j_fn
from .ops import gates as G
from .ops.apply import (controlled_matrix, evolve_den_mat, evolve_den_mat_controlled, evolve_state,
                        evolve_state_controlled, permute_matrix_wires)
from .ops.qmath import (amplitude_encoding, expectation_pauli, measure as qmeasure, sample2expval,
                        slice_state_vector)
from .state import QubitState

__all__ = ['QubitCircuit', 'Observable']

_PAULI_FNS = {'x': G.paulix_matrix, 'y': G.pauliy_matrix, 'z': G.pauliz_matrix}


class Observable:
    """A Pauli-string observable."""

    def __init__(self, nqubit: int, wires=None, basis: str = 'z') -> None:
        self.nqubit = nqubit
        if wires is None:
            wires = list(range(nqubit))
        if isinstance(wires, int):
            wires = [wires]
        self.wires = [[w] if isinstance(w, int) else list(w) for w in wires]
        basis = basis.lower()
        if len(basis) == 1:
            basis = basis * len(self.wires)
        if len(self.wires) != len(basis):
            raise ValueError('The number of wires is not equal to the number of bases')
        self.basis = basis

    def apply(self, x: torch.Tensor, den_mat: bool = False) -> torch.Tensor:
        """Apply the Pauli string to a state tensor (2,)*n, or to each state
        of a batch (B, 2, ..., 2); with ``den_mat`` left-multiply a
        density-matrix tensor (2,)*2n (for tr(O rho))."""
        n = 2 * self.nqubit if den_mat else self.nqubit
        for wire, b in zip(self.wires, self.basis):
            x = evolve_state(x, _PAULI_FNS[b](x.device), n, [wire[0]])
        return x


def _float64(values) -> np.ndarray:
    """Host float64 copy of a tensor, an array or a list of numbers."""
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    return np.array(values, dtype=np.float64).reshape(-1)


def _flat_wires(wires):
    if isinstance(wires, int):
        return [wires]
    return list(wires)


def _apply_reset(x: torch.Tensor, wires, postselect: int, n: int) -> torch.Tensor:
    """Project each wire of a state tensor (..., 2, ..., 2) (its last n axes
    the qubits) on |postselect>, renormalise, and set it to |0>. Where the
    post-selected branch has zero probability the other branch is kept
    instead: the mask keeps the division away from zero, as the JAX
    package's does."""
    lead = x.dim() - n
    if len(wires) == n:
        flat = torch.zeros(1 << n, dtype=x.dtype, device=x.device)
        flat[0] = 1
        return flat.reshape([2] * n).expand(x.shape).clone()
    for wire in wires:
        xt = x.movedim(lead + wire, 0)
        sel, alt = xt[postselect], xt[1 - postselect]
        axes = tuple(range(lead, sel.dim()))
        prob = (sel.abs() ** 2).sum(dim=axes, keepdim=True)
        mask = 1 - torch.sign(prob)
        state0 = ((1 - mask) * sel + mask * alt) / torch.sqrt(prob + mask)
        x = torch.stack([state0, torch.zeros_like(state0)]).movedim(0, lead + wire)
    return x


_PAULI_NP = {'x': np.array([[0, 1], [1, 0]], np.complex64),
             'y': np.array([[0, -1j], [1j, 0]], np.complex64),
             'z': np.array([[1, 0], [0, -1]], np.complex64)}


def _pauli_obs_blocks(obs):
    """Compile a Pauli-string observable into <= 3-wire constant blocks for
    the planar engine: [(np (2^k, 2^k) complex64, sorted wire tuple), ...]."""
    pairs = sorted((w[0], b) for w, b in zip(obs.wires, obs.basis))
    blocks = []
    for i in range(0, len(pairs), 3):
        chunk = pairs[i:i + 3]
        mat = np.array([[1]], np.complex64)
        for _, b in chunk:
            mat = np.kron(mat, _PAULI_NP[b])
        blocks.append((mat, tuple(w for w, _ in chunk)))
    return blocks


class QubitCircuit:
    """Quantum circuit for qubits (API surface mirrors deepquantum_tpu's).

    Args:
        nqubit: number of qubits.
        init_state: 'zeros' | 'equal' | 'ghz'/'GHZ'/'entangle' | array | QubitState.
        name: optional label.
        den_mat: density-matrix simulation (noisy circuits with channels).
        device: where states, parameters and matrices live (default: the
            config's default device, which is the CUDA card unless
            ``set_device`` chose another). 'cuda' without CUDA raises.
        reupload: data re-uploading for encoders (data shorter than ndata
            wraps around).
        shots: default measurement shots.
        mps: matrix-product-state simulation (mps.py).
        chi: the MPS bond dimension (default 10 * nqubit).
    """

    #: max combined wire support of one fused gate group (the JAX package's
    #: default, K = 2, kept so that plans are identical)
    fuse_max_support: int = 2
    #: run a gate step of the planar backward as the single fused kernel
    #: (planar_bwd_fused) instead of apply + grad + apply (default off, as
    #: the JAX package's switch)
    fused_bwd: bool = False

    def __init__(self, nqubit: int, init_state: Any = 'zeros', name: str | None = None,
                 den_mat: bool = False, device=None, reupload: bool = False,
                 shots: int = 1024, mps: bool = False, chi: int | None = None) -> None:
        self.nqubit = nqubit
        self.name = name
        self.den_mat = den_mat
        self.device = resolve_device(device)
        self.reupload = reupload
        self.shots = shots
        self.mps = mps
        self.chi = chi
        self.depth = np.zeros(nqubit, dtype=np.int64)
        self.wires_measure: list[int] = []
        self.wires_condition: list[int] = []
        self._cut_lst: list[tuple] = []     # (operator index, wire) of each wire cut
        self.operators: list[GateOp] = []
        self.observables: list[Observable] = []
        self.encoders: list[GateOp] = []
        self._pvals: list[float] = []       # all parameter values (host-side master copy)
        self._enc_pidx: list[int] = []      # parameter indices fed by data, in encoder order
        self._train_mask: list[bool] = []   # per-parameter trainability
        self.npara = 0
        self.ndata = 0
        self.state = None
        self._version = 0
        self._cache: dict = {}
        self.set_init_state(init_state)

    # ------------------------------------------------------------------ state
    def set_init_state(self, init_state: Any) -> None:
        if self.mps:
            from .mps import MatrixProductState
            if isinstance(init_state, MatrixProductState):
                if init_state.nsite != self.nqubit:
                    raise ValueError('init_state has another number of sites')
                self.init_state = init_state
            else:
                self.init_state = MatrixProductState(self.nqubit, init_state, chi=self.chi,
                                                     device=self.device)
            self.chi = self.init_state.chi
        elif isinstance(init_state, QubitState):
            if init_state.nqubit != self.nqubit:
                raise ValueError('init_state has another number of qubits')
            self.den_mat = init_state.den_mat
            self.init_state = init_state
        else:
            self.init_state = QubitState(self.nqubit, init_state, den_mat=self.den_mat,
                                         device=self.device)

    def reset_circuit(self, init_state: Any = 'zeros') -> None:
        """Clear the operators, parameters and observables and set the
        initial state anew."""
        self.set_init_state(init_state)
        self.operators = []
        self.observables = []
        self.encoders = []
        self._pvals = []
        self._enc_pidx = []
        self._train_mask = []
        self.state = None
        self.npara = 0
        self.ndata = 0
        self.depth = np.zeros(self.nqubit, dtype=np.int64)
        self.wires_measure = []
        self.wires_condition = []
        self._cut_lst = []
        self._touch()

    def set_nqubit(self, nqubit: int) -> None:
        """Resize the circuit; only before operators are added."""
        if self.operators:
            raise ValueError('set_nqubit before adding operators')
        self.nqubit = nqubit
        self.depth = np.zeros(nqubit, dtype=np.int64)
        self.set_init_state('zeros')
        self._touch()

    def set_wires(self, wires) -> None:
        """Record the ``wires`` attribute (a circuit acts on all its qubits)."""
        self.wires = _flat_wires(wires)

    # ------------------------------------------------------ state reshapers
    def tensor_rep(self, x) -> torch.Tensor:
        """A state as a (batch, 2, ..., 2) tensor (2n axes of 2 for a density
        matrix)."""
        return torch.as_tensor(x).reshape([-1] + [2] * (2 * self.nqubit if self.den_mat
                                                        else self.nqubit))

    def vector_rep(self, x) -> torch.Tensor:
        """A state as a (batch, 2^n, 1) column."""
        return torch.as_tensor(x).reshape(-1, 2 ** self.nqubit, 1)

    def matrix_rep(self, x) -> torch.Tensor:
        """A state as a (batch, 2^n, 2^n) density matrix."""
        return torch.as_tensor(x).reshape(-1, 2 ** self.nqubit, 2 ** self.nqubit)

    # ------------------------------------------------------------- parameters
    @property
    def _train_idx(self) -> list[int]:
        return [i for i, t in enumerate(self._train_mask) if t]

    @property
    def params(self) -> torch.Tensor:
        """Trainable parameter vector on the circuit's device."""
        vals = np.asarray(self._pvals, dtype=np.float64)[self._train_idx]
        return torch.as_tensor(vals, device=self.device).to(rdtype())

    @params.setter
    def params(self, values) -> None:
        idx = self._train_idx
        values = _float64(values)
        if len(values) != len(idx):
            raise ValueError(f'expected {len(idx)} parameters, got {len(values)}')
        for i, v in zip(idx, values):
            self._pvals[i] = float(v)

    def _index(self, name: str, idx) -> torch.Tensor:
        """A parameter-index list as a long tensor on the device, made once
        per circuit version (each upload would synchronise the stream)."""
        key = ('index', name, self._version, self.device)
        t = self._cache.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = torch.as_tensor(list(idx), dtype=torch.long, device=self.device)
            self._cache[key] = t
        return t

    def _full_params(self, params=None, data=None, data_idx=None) -> torch.Tensor:
        """Full parameter vector on the circuit's device, with the trainable
        entries replaced by ``params`` and the encoder entries by
        ``data[..., data_idx]`` when given, differentiable in both. Data of
        shape (B, ndata) gives one vector per sample, (B, P)."""
        full = torch.as_tensor(np.asarray(self._pvals, dtype=np.float64), device=self.device)
        full = full.to(rdtype())
        if params is not None:
            params = torch.as_tensor(params, device=self.device).to(rdtype()).reshape(-1)
            full = full.index_put((self._index('train', self._train_idx),), params)
        if data is not None and self._enc_pidx:
            data = torch.as_tensor(data, device=self.device).to(rdtype())
            vals = data[..., self._index(('data', tuple(data_idx)), data_idx)]
            if vals.dim() == 2:
                full = full.expand(vals.shape[0], full.shape[0])
            full = full.index_copy(-1, self._index('enc', self._enc_pidx), vals)
        return full

    def _data_indices(self, data_len: int) -> list[int]:
        """Encoder position -> index into the data vector (wrapping around
        with ``reupload``)."""
        if self.reupload:
            return [i % data_len for i in range(self.ndata)]
        if data_len < self.ndata:
            raise ValueError('The circuit needs more data, or consider data re-uploading')
        return list(range(self.ndata))

    def encode(self, data) -> None:
        """Write data into the stored encoder parameter values (the
        functional path passes data to forward() instead). Supports
        re-uploading."""
        if data is None:
            return
        data = _float64(data)
        if not self.reupload and len(data) < self.ndata:
            raise ValueError('The circuit needs more data, or consider data re-uploading')
        for k, pidx in enumerate(self._enc_pidx):
            self._pvals[pidx] = float(data[k % len(data)])
        self._touch()

    def init_para(self, seed: int | None = None) -> None:
        """Re-randomize all trainable parameters from ``seed`` (numpy's
        default_rng, as the JAX package draws them)."""
        rng = np.random.default_rng(seed)
        for i, t in enumerate(self._train_mask):
            if t:
                self._pvals[i] = float(rng.random() * 2 * np.pi)

    def init_encoder(self) -> None:
        """Re-randomize the encoder parameters."""
        for pidx in self._enc_pidx:
            self._pvals[pidx] = float(np.random.rand() * 2 * np.pi)
        self._touch()

    # ------------------------------------------------------------------- add
    def _new_params(self, values, encode: bool, requires_grad: bool) -> tuple:
        start = len(self._pvals)
        idx = tuple(range(start, start + len(values)))
        self._pvals.extend(float(v) for v in values)
        self._train_mask.extend([requires_grad and not encode] * len(values))
        return idx

    def add_gate(self, name: str, wires, controls=None, inputs=None, encode: bool = False,
                 condition: bool = False, requires_grad: bool | None = None, matrix_fn=None,
                 static_matrix=None, npara: int | None = None,
                 extra: dict | None = None) -> GateOp:
        """Append a gate to the IR, registering its parameters (trainable
        unless given as ``inputs`` or fed by data: ``encode``). A registry
        gate is named; any other gives its ``matrix_fn`` ((params, device)
        -> matrix) and ``npara``, or a ``static_matrix``. ``condition``
        makes it a gate conditioned on its controls' measured values."""
        wires = tuple(_flat_wires(wires))
        controls = tuple(_flat_wires(controls)) if controls is not None else ()
        if len(set(wires)) != len(wires) or len(set(controls)) != len(controls) \
                or set(wires) & set(controls):
            raise ValueError(f'{name}: repeated wires {wires} / controls {controls}')
        for w in wires + controls:
            if not 0 <= w < self.nqubit:
                raise ValueError(f'wire {w} out of range for {self.nqubit} qubits')
        if condition and not controls:
            raise ValueError(f'{name}: a conditional gate needs the measured wires as controls')
        if matrix_fn is None and static_matrix is None:
            reg = GATE_REGISTRY.get(name)
            if reg is None:
                raise ValueError(f'Unknown gate: {name}')
            matrix_fn, npara = reg['fn'], reg['npara']
            if len(wires) != reg['nwires']:
                raise ValueError(f'{name} acts on {reg["nwires"]} wire(s), got {wires}')
        npara = npara or 0
        if requires_grad is None:
            requires_grad = inputs is None and npara > 0 and not encode
        if npara > 0:
            if inputs is None:
                values = [float(np.random.rand() * 2 * np.pi) for _ in range(npara)]
            else:
                values = _float64(inputs)
                if len(values) != npara:
                    raise ValueError(f'{name} expects {npara} parameters')
            pidx = self._new_params(values, encode, requires_grad)
        else:
            pidx = ()
        op = GateOp(name=name, wires=wires, controls=controls, matrix_fn=matrix_fn,
                    static_matrix=static_matrix, pidx=pidx, npara=npara, condition=condition,
                    requires_grad=requires_grad, extra=extra or {})
        self.operators.append(op)
        self.depth[list(wires + controls)] += 1
        if condition:
            self.wires_condition = sorted(set(self.wires_condition) | set(controls))
        if encode:
            self.encoders.append(op)
            self._enc_pidx.extend(pidx)
            self.ndata += npara
        else:
            self.npara += npara
        self._touch()
        return op

    def add(self, op, encode: bool = False, wires=None, controls=None) -> None:
        """Append a QubitCircuit (its ops, parameters copied; its
        observables replace this circuit's), an Observable, or a GateOp
        descriptor. A descriptor's parameters are registered on this
        circuit the first time it is added (from ``extra['inputs']``, or
        random) and shared when the same descriptor is added again;
        ``wires`` / ``controls`` place the copy."""
        if isinstance(op, QubitCircuit):
            if op.nqubit != self.nqubit:
                raise ValueError('the circuits have different numbers of qubits')
            offset = len(self._pvals)
            self._cut_lst.extend((i + len(self.operators), w) for i, w in op._cut_lst)
            self._pvals.extend(op._pvals)
            self._train_mask.extend(op._train_mask)
            enc = {id(g) for g in op.encoders}
            for g in op.operators:
                g2 = _copy.copy(g)
                g2.pidx = tuple(i + offset for i in g.pidx)
                self.operators.append(g2)
                if id(g) in enc:
                    self.encoders.append(g2)
                    self._enc_pidx.extend(g2.pidx)
            self.observables = list(op.observables)
            self.npara += op.npara
            self.ndata += op.ndata
            self.depth += op.depth
            self.wires_measure = op.wires_measure
            self.wires_condition = sorted(set(self.wires_condition) | set(op.wires_condition))
            self._touch()
            return
        if isinstance(op, Observable):
            self.observables.append(op)
            return
        if not isinstance(op, GateOp):
            raise TypeError(f'cannot add {type(op).__name__} to a QubitCircuit')
        if op.kind == 'channel' and not self.den_mat:
            raise ValueError('Channels act on density matrices; build the circuit with '
                             'den_mat=True')
        shared = op.npara > 0 and op.extra.get('_owner') is self and bool(op.pidx)
        if op.npara > 0 and not shared:
            # the slice goes on the descriptor itself, so adding it again shares it
            values = op.extra.get('inputs')
            if values is None:
                values = [float(np.random.rand() * 2 * np.pi) for _ in range(op.npara)]
            op.pidx = self._new_params(_float64(values), encode, op.requires_grad)
            op.extra['_owner'] = self
        g = _copy.copy(op)
        if wires is not None:
            g.wires = tuple(_flat_wires(wires))
            g.controls = tuple(_flat_wires(controls)) if controls is not None else ()
        self.operators.append(g)
        self.depth[list(g.wires + g.controls)] += 1
        if not shared:
            if encode:
                self.encoders.append(g)
                self._enc_pidx.extend(g.pidx)
                self.ndata += g.npara
            else:
                self.npara += g.npara
        self._touch()

    def _touch(self) -> None:
        self._version += 1
        self._cache.clear()

    # ---------------------------------------------------------------- fusion
    def _fused_plan(self):
        """Greedy wire-support grouping, identical to the JAX package's.

        Consecutive gates merge into a group while their combined wire
        support stays within ``fuse_max_support``; groups on disjoint wires
        commute, so a group closes only when a later op needs more support.
        Entries: ('op', op) | ('group', [ops], sorted wires tuple)."""
        key = ('fuseplan', self._version, self.fuse_max_support)
        plan = self._cache.get(key)
        if plan is not None:
            return plan
        K = max(1, int(self.fuse_max_support))
        plan = []
        groups: list[dict] = []            # open groups, creation order
        owner: dict[int, dict] = {}        # wire -> open group

        def close(group):
            if group.get('closed'):
                return
            group['closed'] = True
            for w in group['wires']:
                if owner.get(w) is group:
                    del owner[w]
            if len(group['ops']) == 1:
                op = group['ops'][0]
                if not op.controls and len(op.wires) == len(group['wires']):
                    plan.append(('op', op))
                    return
            plan.append(('group', group['ops'], tuple(sorted(group['wires']))))

        for op in self.operators:
            if op.kind in ('barrier', 'cut'):
                continue
            fusable = op.kind == 'gate' and not op.condition
            wires = set(op.wires) | set(op.controls)
            touching = []
            for w in wires:
                g = owner.get(w)
                if g is not None and g not in touching:
                    touching.append(g)
            if fusable:
                union = set(wires)
                for g in touching:
                    union |= g['wires']
                if len(union) <= K:
                    if touching:
                        tgt = touching[0]
                        for g in touching[1:]:
                            tgt['ops'].extend(g['ops'])
                            tgt['wires'] |= g['wires']
                            g['closed'] = True
                            groups.remove(g)
                    else:
                        tgt = {'ops': [], 'wires': set(), 'closed': False}
                        groups.append(tgt)
                    tgt['ops'].append(op)
                    tgt['wires'] = set(union)
                    for w in tgt['wires']:
                        owner[w] = tgt
                    continue
            for g in [g for g in groups if g in touching]:
                close(g)
            groups = [g for g in groups if not g.get('closed')]
            if fusable:
                g = {'ops': [op], 'wires': set(wires), 'closed': False}
                groups.append(g)
                for w in g['wires']:
                    owner[w] = g
            else:
                plan.append(('op', op))
        for g in groups:
            close(g)
        self._cache[key] = plan
        return plan

    def _fused_matrix(self, entry, full_params: torch.Tensor):
        """Compose one group's 2^k unitary (k = |group wires|), axes in the
        group's sorted wire order; (B, 2^k, 2^k) for (B, P) parameters."""
        _, ops, wires = entry
        k = len(wires)
        mat = None
        for op in ops:
            m = controlled_matrix(op.matrix(full_params).to(cdtype()), len(op.controls))
            aw = list(op.controls) + list(op.wires)
            pad = k - len(aw)
            if pad:
                # kron with a 2-D identity keeps a leading batch axis: torch
                # pads the identity to (1, 2^pad, 2^pad)
                m = torch.kron(m, torch.eye(1 << pad, dtype=cdtype(), device=m.device))
            order = aw + [w for w in wires if w not in aw]
            perm = [order.index(w) for w in wires]
            m = permute_matrix_wires(m, perm)
            mat = m if mat is None else m @ mat
        return mat, wires

    # -------------------------------------------------------------- simulate
    def _op_matrix(self, entry, full_params):
        """(matrix, wires list) of one fused-plan entry."""
        if entry[0] == 'op':
            op = entry[1]
            mat = controlled_matrix(op.matrix(full_params).to(cdtype()), len(op.controls))
            return mat, list(op.controls) + list(op.wires)
        mat, wires = self._fused_matrix(entry, full_params)
        return mat, list(wires)

    def _planar_ok(self) -> bool:
        """Route through the planar engine? complex64, n >= 10 (a density
        matrix: 2n >= 10), and every fused-plan entry a plain unitary on
        <= 3 wires or, for a density matrix, a channel."""
        key = ('planar_ok', self._version, self.fuse_max_support, cdtype(), self.den_mat)
        ok = self._cache.get(key)
        if ok is None:
            eff_n = 2 * self.nqubit if self.den_mat else self.nqubit
            ok = not self.mps and eff_n >= 10 and cdtype() == torch.complex64
            if ok:
                for entry in self._fused_plan():
                    if entry[0] == 'group':
                        ok = len(entry[2]) <= 3
                    else:
                        op = entry[1]
                        ok = ((self.den_mat and op.kind == 'channel')
                              or (op.kind == 'gate' and not op.condition
                                  and len(set(op.wires) | set(op.controls)) <= 3))
                    if not ok:
                        break
            self._cache[key] = ok
        return ok

    def _planar_seq(self, full_params: torch.Tensor):
        """The scheduled planar sequence (mres, mims, wseq) of the circuit:
        fused matrices as sorted-wire planes, then windows / relabels."""
        from .ops.planar_gate import _sorted_mat_planes, schedule_planar_seq
        mres, mims, wseq = [], [], []
        for entry in self._fused_plan():
            mat, wires = self._op_matrix(entry, full_params)
            mre, mim = _sorted_mat_planes(mat, wires)
            mres.append(mre)
            mims.append(mim)
            wseq.append(tuple(sorted(wires)))
        return schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), self.nqubit)

    def _sim_planar(self, full_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        from .ops.planar_gate import from_planar, planar_chain, to_planar
        n = self.nqubit
        mres, mims, wseq = self._planar_seq(full_params)
        p = planar_chain(to_planar(x.reshape(-1)), mres, mims, n, wseq,
                         fused_bwd=self.fused_bwd)
        return from_planar(p).reshape([2] * n)

    def _planar_seq_batched(self, fulls: torch.Tensor):
        """The scheduled planar sequence of a batch: fulls (B, P) per-sample
        full parameters give every group's matrix as a (B, K, K) stack (a
        fixed group's one matrix is expanded, not copied), so the window
        scheduler stands aside (it refuses batched planes, as the JAX
        package's does) and each step is one per-gate kernel."""
        from .ops.planar_gate import _sorted_mat_planes, schedule_planar_seq
        bsz = fulls.shape[0]
        mres, mims, wseq = [], [], []
        for entry in self._fused_plan():
            mat, wires = self._op_matrix(entry, fulls)
            if mat.dim() == 2:
                mat = mat.expand(bsz, *mat.shape)
            mre, mim = _sorted_mat_planes(mat, wires)
            mres.append(mre)
            mims.append(mim)
            wseq.append(tuple(sorted(wires)))
        return schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), self.nqubit)

    def _sim_planar_batched(self, fulls: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
        """The batched planar engine: states (B, 2^n) complex, fulls (B, P);
        the batch is the grid axis of the per-gate kernels. Returns
        (B, 2^n)."""
        from .ops.planar_gate import from_planar, planar_chain, to_planar_batched
        mres, mims, wseq = self._planar_seq_batched(fulls)
        p = planar_chain(to_planar_batched(states), mres, mims, self.nqubit, wseq,
                         fused_bwd=self.fused_bwd)
        return from_planar(p)

    def _sim_planar_dm(self, full_params: torch.Tensor, states: torch.Tensor) -> torch.Tensor:
        """Density matrices on the planar engine: rho, flat (4^n,) or a batch
        (B, 4^n) complex with (B, P) parameters, runs as a 2n-wire planar
        state. Each gate U on wires w is U on w and conj(U) on w + n in ONE
        chain (row and column steps commute); a channel ends the chain and
        runs as its 4^k superoperator sum_k K (x) conj(K) on (w, w + n)
        (``planar_superop``: K1 on a non-unitary map, its input kept for the
        backward), per sample for a batch. A channel on more than one wire
        (4^k > 8 rows) runs its Kraus sum on the einsum route. Returns the
        same shape as ``states``."""
        from .ops.planar_gate import (_sorted_mat_planes, from_planar, planar_chain,
                                      planar_superop, schedule_planar_seq, to_planar,
                                      to_planar_batched)
        n, nn = self.nqubit, 2 * self.nqubit
        bsz = states.shape[0] if states.dim() == 2 else None
        p = to_planar(states) if bsz is None else to_planar_batched(states)
        mres, mims, wseq = [], [], []

        def flush(p):
            if mres:
                seq = schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), nn)
                p = planar_chain(p, *seq[:2], nn, seq[2], fused_bwd=self.fused_bwd)
                mres.clear()
                mims.clear()
                wseq.clear()
            return p

        def add(mat, wires):
            if bsz is not None and mat.dim() == 2:
                mat = mat.expand(bsz, *mat.shape)
            mre, mim = _sorted_mat_planes(mat, wires)
            mres.append(mre)
            mims.append(mim)
            wseq.append(tuple(sorted(wires)))

        for entry in self._fused_plan():
            if entry[0] == 'op' and entry[1].kind == 'channel':
                op = entry[1]
                p = flush(p)
                kraus = op.matrix(full_params).to(cdtype())
                k = len(op.wires)
                if 2 * k <= 3:
                    sop = torch.einsum('...zab,...zcd->...acbd', kraus, kraus.conj())
                    swires = list(op.wires) + [w + n for w in op.wires]
                    sre, sim = _sorted_mat_planes(sop.reshape(*sop.shape[:-4], 4 ** k, 4 ** k),
                                                  swires)
                    p = planar_superop(p, sre, sim, nn, swires)
                else:
                    lead = [] if bsz is None else [bsz]
                    rho = self._apply_op(op, full_params, from_planar(p).reshape(lead + [2] * nn))
                    p = to_planar(rho) if bsz is None else to_planar_batched(rho.reshape(bsz, -1))
                continue
            mat, wires = self._op_matrix(entry, full_params)
            add(mat, wires)
            add(mat.conj(), [w + n for w in wires])
        return from_planar(flush(p))

    def _apply_op(self, op: GateOp, full_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One op on the einsum route: a gate on a state or a density matrix
        (a conditional gate is its controlled form), a channel's Kraus sum
        on a density matrix, a reset or a move on a state."""
        n = self.nqubit
        if op.kind in ('barrier', 'cut'):
            return x
        if op.kind in ('reset', 'move'):
            if self.den_mat:
                raise ValueError(f'{op.name} acts on state vectors')
            ps = op.extra.get('postselect', 0)
            if op.kind == 'reset':
                return _apply_reset(x, op.wires, ps, n)
            x = _apply_reset(x, (op.wires[1],), ps, n)
            return evolve_state(x, G.swap_matrix(x.device), n, list(op.wires))
        if op.kind == 'channel':
            kraus = op.matrix(full_params).to(cdtype())
            return sum(evolve_den_mat(x, kraus[..., z, :, :], n, list(op.wires))
                       for z in range(kraus.shape[-3]))
        evolve = evolve_den_mat_controlled if self.den_mat else evolve_state_controlled
        return evolve(x, op.matrix(full_params), n, list(op.wires), list(op.controls))

    def _sim_tensor(self, full_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Simulation over a state tensor (2,)*n (a density matrix (2,)*2n),
        or a batch (B, 2, ..., 2) with (B, P) parameters on the einsum
        route."""
        n = self.nqubit
        if self._planar_ok() and full_params.dim() == 1:
            if self.den_mat:
                return self._sim_planar_dm(full_params, x.reshape(-1)).reshape(x.shape)
            return self._sim_planar(full_params, x)
        evolve = evolve_den_mat if self.den_mat else evolve_state
        for entry in self._fused_plan():
            if entry[0] == 'op':
                x = self._apply_op(entry[1], full_params, x)
            else:
                mat, wires = self._fused_matrix(entry, full_params)
                x = evolve(x, mat, n, list(wires))
        return x

    # --------------------------------------------------------------- forward
    def __call__(self, data=None, state=None, params=None):
        return self.forward(data, state, params)

    def forward(self, data=None, state=None, params=None) -> torch.Tensor:
        """Run the circuit; returns and stores the final state.

        data: optional (ndata,) or (B, ndata) encoder data (ignored when the
        circuit has no encoders). One state gives shape (2^n, 1), a batch
        (B, 2^n, 1); a density matrix (2^n, 2^n), a batch (B, 2^n, 2^n).
        state: optional initial state (tensor, array or QubitState), one
        state shared by the batch or one per sample; defaults to
        init_state.
        params: optional trainable-parameter vector.
        """
        if self.mps:
            return self._forward_mps(data, state, params)
        if state is None:
            state = self.init_state
        if isinstance(state, QubitState):
            state = state.state
        state = torch.as_tensor(state).to(device=self.device, dtype=cdtype())
        n = self.nqubit
        nw = 2 * n if self.den_mat else n         # the state tensor's wires
        size = 1 << nw
        shape = (2 ** n, 2 ** n) if self.den_mat else (2 ** n, 1)
        if self.ndata == 0:
            data = None
        if data is not None:
            data = torch.as_tensor(data, device=self.device).to(rdtype())
        if data is None or data.dim() == 1:
            didx = None if data is None else self._data_indices(data.shape[-1])
            full = self._full_params(params, data, didx)
            x = self._sim_tensor(full, state.reshape([2] * nw))
            self.state = x.reshape(shape)
            return self.state
        bsz = data.shape[0]
        fulls = self._full_params(params, data, self._data_indices(data.shape[-1]))
        if state.numel() == size:
            states = state.reshape(1, size).expand(bsz, size)
        else:
            states = state.reshape(bsz, size)
        if self._planar_ok():
            sim = self._sim_planar_dm if self.den_mat else self._sim_planar_batched
            out = sim(fulls, states)
        else:
            out = self._sim_tensor(fulls, states.reshape([bsz] + [2] * nw))
        self.state = out.reshape(bsz, *shape)
        return self.state

    def _run_mps(self, full_params: torch.Tensor, tensors: list) -> list:
        """The gates, one after another, on an MPS (tensors, no center).
        Under autograd the sweeps' rank tests are read once at the end; if
        a factor was rank-deficient, the gates run again with each test
        read where it is made (``ops.linalg.deferred_rank_checks``)."""
        from .ops.linalg import deferred_rank_checks
        with deferred_rank_checks() as flags:
            state = self._run_mps_gates(full_params, tensors)
        if flags and bool(torch.stack(flags).any()):
            state = self._run_mps_gates(full_params, tensors)
        return state

    def _run_mps_gates(self, full_params: torch.Tensor, tensors: list) -> list:
        from .mps import apply_gate_mps, gate_to_mpo
        normalize = getattr(self.init_state, 'normalize', True)
        state = (list(tensors), -1)
        for op in self.operators:
            if op.kind in ('barrier', 'cut'):
                continue
            if op.kind != 'gate':
                raise ValueError(f'MPS circuits take unitary gates only, not {op.name}')
            all_wires = list(op.controls) + list(op.wires)
            wires = sorted(all_wires)
            order = sorted(range(len(all_wires)), key=lambda i: all_wires[i])
            mat = self._mps_matrix(op, full_params, order)
            mpo = None
            if len(wires) > 1:
                mpo = gate_to_mpo(mat, wires, bases=self._mpo_bases(op, full_params, order))
            state = apply_gate_mps(state, mat, wires, self.chi, normalize, mpo=mpo)
        return state[0]

    @staticmethod
    def _mps_matrix(op: GateOp, full_params: torch.Tensor, order: list) -> torch.Tensor:
        """The op's matrix with its controls, its qudits in sorted wire order."""
        mat = controlled_matrix(op.matrix(full_params).to(cdtype()), len(op.controls))
        return permute_matrix_wires(mat, order)

    def _mpo_bases(self, op: GateOp, full_params: torch.Tensor, order: list) -> list:
        """The MPO split bases of the op's gate family (``mps.mpo_bases``),
        made once per circuit version for every op of the same family: from
        its one matrix if it is fixed, else from its matrix at generic
        parameter values (as many as the largest bond can be), so that a
        bond does not shrink where the gate is a product at some angle."""
        from .mps import mpo_bases
        key = ('mpo_bases', id(op.matrix_fn), id(op.static_matrix), op.inv, len(op.controls),
               tuple(order), self._version, cdtype(), full_params.device)
        bases = self._cache.get(key)
        if bases is None:
            k = len(order)
            with torch.no_grad(), torch.inference_mode(False):
                if op.npara == 0:
                    probes = [self._mps_matrix(op, full_params, order)]
                else:
                    gen = torch.Generator(device='cpu').manual_seed(0)
                    nprobe = 4 ** (k // 2)
                    draws = torch.rand(nprobe, full_params.shape[-1], generator=gen,
                                       dtype=torch.float64) * 2 * np.pi
                    draws = draws.to(device=full_params.device, dtype=full_params.dtype)
                    probes = [self._mps_matrix(op, p, order) for p in draws]
                bases = self._cache[key] = mpo_bases(probes, k)
        return bases

    def _forward_mps(self, data=None, state=None, params=None) -> list:
        """MPS forward: the final site tensors; with data (B, ndata) one run
        a sample, each site's tensors stacked (B, chi_l, d, chi_r)."""
        from .mps import MatrixProductState
        if state is None:
            state = self.init_state
        tensors = state.tensors if isinstance(state, MatrixProductState) else list(state)
        tensors = [torch.as_tensor(t).to(device=self.device, dtype=cdtype()) for t in tensors]
        if self.ndata == 0:
            data = None
        if data is not None:
            data = torch.as_tensor(data, device=self.device).to(rdtype())
        if data is None or data.dim() == 1:
            didx = None if data is None else self._data_indices(data.shape[-1])
            self.state = self._run_mps(self._full_params(params, data, didx), tensors)
            return self.state
        fulls = self._full_params(params, data, self._data_indices(data.shape[-1]))
        runs = [self._run_mps(full, tensors) for full in fulls]
        self.state = [torch.stack(ts) for ts in zip(*runs)]
        return self.state

    def _expectation_mps(self, tensors: list) -> torch.Tensor:
        """<O> of each observable on an MPS, from the site tensors alone."""
        from .ops.qmath import inner_product_mps
        if tensors[0].dim() == 4:
            return torch.stack([self._expectation_mps([t[b] for t in tensors])
                                for b in range(tensors[0].shape[0])])
        out = []
        for obs in self.observables:
            t2 = list(tensors)
            for wire, b in zip(obs.wires, obs.basis):
                mat = _PAULI_FNS[b](tensors[0].device).to(tensors[0].dtype)
                t2[wire[0]] = torch.einsum('ab,ibj->iaj', mat, t2[wire[0]])
            out.append(inner_product_mps(tensors, t2).real)
        return torch.stack(out, dim=-1)

    # ------------------------------------------------------------ observables
    def observable(self, wires=None, basis: str = 'z') -> None:
        self.observables.append(Observable(nqubit=self.nqubit, wires=wires, basis=basis))

    def reset_observable(self) -> None:
        self.observables = []

    def _obs_seq(self, obs: Observable, bsz: int | None = None):
        """Scheduled planar sequence of one observable's Pauli blocks (a
        constant: cached per wires, basis, device and batch, and built
        outside inference mode so that a later autograd-tracked call may
        use it). For a batch of ``bsz`` states the planes are expanded to
        (bsz, K, K) views, as the JAX package broadcasts them: windows stand
        aside and the kernels read one set of planes for every sample. For a
        density matrix the blocks act on the row wires of the 2n-wire
        planar rho and the sequence is scheduled on 2n wires."""
        key = ('obs', tuple(map(tuple, obs.wires)), obs.basis, self.device, bsz, self.den_mat)
        seq = self._cache.get(key)
        if seq is None:
            with torch.inference_mode(False), torch.no_grad():
                seq = self._build_obs_seq(obs, bsz)
            self._cache[key] = seq
        return seq

    def _build_obs_seq(self, obs: Observable, bsz: int | None):
        from .ops.planar_gate import schedule_planar_seq
        mres, mims, wseq = [], [], []
        for mat, wires in _pauli_obs_blocks(obs):
            mre = torch.as_tensor(mat.real, dtype=torch.float32, device=self.device)
            mim = torch.as_tensor(mat.imag, dtype=torch.float32, device=self.device)
            if bsz is not None:
                mre, mim = mre.expand(bsz, *mre.shape), mim.expand(bsz, *mim.shape)
            mres.append(mre)
            mims.append(mim)
            wseq.append(wires)
        nn = 2 * self.nqubit if self.den_mat else self.nqubit
        return schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), nn)

    def expectation(self, data=None, state=None, params=None, shots: int | None = None,
                    generator: torch.Generator | None = None):
        """Expectation values of all observables, shape (n_observables,), or
        (B, n_observables) for a batch of states.

        With no arguments, uses the stored final state; with
        data/state/params, runs forward first. With ``shots``, each value is
        estimated from that many samples in the observable's basis (drawn
        from ``generator`` when given)."""
        if not self.observables:
            raise ValueError('There is no observable')
        if data is not None or params is not None or state is not None or self.state is None:
            s = self.forward(data, state, params)
        else:
            s = self.state
        if shots is not None:
            return self._expectation_shots(s, shots, generator)
        if self.mps:
            return self._expectation_mps(s)
        n = self.nqubit
        bsz = s.shape[0] if s.dim() == 3 else None
        vals = []
        if self.den_mat:
            dim = 2 ** n
            lead = () if bsz is None else (bsz,)
            if self._planar_ok():
                from .ops.planar_gate import planar_chain, to_planar, to_planar_batched
                # tr(O rho): the Pauli blocks on the row wires of the planar
                # rho (one chain), then the real plane's diagonal
                xp = to_planar(s) if bsz is None else to_planar_batched(s.reshape(bsz, -1))
                for obs in self.observables:
                    mres, mims, wseq = self._obs_seq(obs, bsz)
                    y = planar_chain(xp, mres, mims, 2 * n, wseq)
                    vals.append(y[..., 0, :].reshape(*lead, dim, dim)
                                .diagonal(dim1=-2, dim2=-1).sum(-1))
            else:
                x = s.reshape(list(lead) + [2] * (2 * n))
                for obs in self.observables:
                    ox = obs.apply(x, den_mat=True).reshape(*lead, dim, dim)
                    vals.append(ox.diagonal(dim1=-2, dim2=-1).sum(-1).real)
        elif self._planar_ok():
            from .ops.planar_gate import planar_pauli_expectation, to_planar, to_planar_batched
            xp = to_planar(s) if bsz is None else to_planar_batched(s.reshape(bsz, -1))
            for obs in self.observables:
                mres, mims, wseq = self._obs_seq(obs, bsz)
                vals.append(planar_pauli_expectation(xp, mres, mims, n, wseq))
        else:
            x = s.reshape(([] if bsz is None else [bsz]) + [2] * n)
            for obs in self.observables:
                vals.append(expectation_pauli(x, obs.apply(x), n))
        return torch.stack(vals, dim=-1)

    def hessian(self, params=None, data=None, obs_index: int = 0) -> torch.Tensor:
        """Full Hessian (P, P) of ``expectation()[obs_index]`` in the
        trainable parameters (at ``params``, default the stored ones), in
        the rdtype: reverse over reverse, one gradient with
        ``create_graph=True``, then one reverse pass per basis column. On
        the planar engine the first backward walks every step through the
        differentiable kernel Functions (K1, K5, K2), so every pass of the
        second runs on the kernels; the one-launch chains serve only
        first-order passes."""
        p = self.params if params is None else torch.as_tensor(params, device=self.device)
        p = p.detach().to(rdtype()).reshape(-1).requires_grad_()
        with torch.enable_grad():
            f = self.expectation(data=data, params=p)[obs_index]
            grad, = torch.autograd.grad(f, p, create_graph=True)
            eye = torch.eye(p.numel(), dtype=grad.dtype, device=grad.device)
            rows = [torch.autograd.grad(grad, p, grad_outputs=eye[i], retain_graph=True,
                                        allow_unused=True)[0] for i in range(p.numel())]
        return torch.stack([torch.zeros_like(p) if r is None else r for r in rows]).detach()

    def _expectation_shots(self, state: torch.Tensor, shots: int, generator=None):
        """Each observable estimated from ``shots`` samples: rotate into its
        basis (h for x; sdg, h for y), measure its wires, take the parity."""
        batched = state.dim() == 3
        out = []
        for obs in self.observables:
            cir_basis = QubitCircuit(self.nqubit, den_mat=self.den_mat, device=self.device)
            for wire, basis in zip(obs.wires, obs.basis):
                if basis == 'x':
                    cir_basis.h(wire[0])
                elif basis == 'y':
                    cir_basis.sdg(wire[0])
                    cir_basis.h(wire[0])
            wires = sum(obs.wires, [])
            vals = []
            for s in (state if batched else [state]):
                cir_basis.forward(state=s)
                vals.append(sample2expval(cir_basis.measure(shots=shots, wires=wires,
                                                            generator=generator)))
            out.append(vals)
        vals = torch.tensor(out, dtype=rdtype(), device=self.device)      # (n_obs, B)
        return vals.T if batched else vals[:, 0]

    # ------------------------------------------------------------ measurement
    def measure(self, shots: int | None = None, with_prob: bool = False, wires=None,
                generator: torch.Generator | None = None):
        """Sample the stored final state (a batch, or rho's diagonal) in the
        computational basis: {bitstring: count}, a list of dicts for a
        batch, or with ``with_prob`` {bitstring: (count, probability)}.
        ``wires`` (default all) are measured; ``generator`` (on the
        circuit's device) fixes the draw. None before the first forward."""
        if shots is None:
            shots = self.shots
        else:
            self.shots = shots
        self.wires_measure = _flat_wires(list(range(self.nqubit)) if wires is None else wires)
        if self.state is None:
            return None
        if self.mps:
            from .mps import measure_mps
            return measure_mps(self.state, shots=shots, wires=self.wires_measure,
                               with_prob=with_prob, generator=generator)
        return qmeasure(self.state, shots=shots, with_prob=with_prob, wires=self.wires_measure,
                        den_mat=self.den_mat, generator=generator)

    def expval_fn(self):
        """A function (params, data=None) -> the expectation values."""
        def fn(params, data=None):
            return self.expectation(data=data, params=params)
        return fn

    def _sliced(self, state: torch.Tensor, bits: str) -> torch.Tensor:
        out = slice_state_vector(state.reshape(1, -1), self.nqubit, self.wires_condition, bits)
        return out[0][:, None]

    def defer_measure(self, with_prob: bool = False,
                      generator: torch.Generator | None = None):
        """Measure the condition wires once (drawn from ``generator``) and
        slice the stored state on the outcome: the state of the other wires
        (2^(n - k), 1), and with ``with_prob`` also the bits and their
        probability; for a batch, a (B, 2^(n - k), 1) stack and lists."""
        if self.den_mat or self.mps:
            raise ValueError('defer_measure acts on state vectors')
        rst = self.measure(shots=1, with_prob=with_prob, wires=self.wires_condition,
                           generator=generator)
        if isinstance(rst, dict):
            bit = next(iter(rst))
            state = self._sliced(self.state, bit)
            return (state, bit, rst[bit][1]) if with_prob else state
        states, bits, probs = [], [], []
        for i, d in enumerate(rst):
            bit = next(iter(d))
            states.append(self._sliced(self.state[i], bit))
            bits.append(bit)
            if with_prob:
                probs.append(d[bit][1])
        out = torch.stack(states)
        return (out, bits, probs) if with_prob else out

    def post_select(self, bits: str) -> torch.Tensor:
        """The stored state sliced on the condition wires' values ``bits``,
        renormalised: (2^(n - k), 1), or (B, 2^(n - k), 1) for a batch."""
        if self.den_mat or self.mps:
            raise ValueError('post_select acts on state vectors')
        state = self.state
        single = state.dim() == 2
        out = slice_state_vector(state.reshape(1 if single else state.shape[0], -1),
                                 self.nqubit, self.wires_condition, bits)
        return out[0][:, None] if single else out[..., None]

    # ------------------------------------------------------------- inspection
    def get_unitary(self, params=None) -> torch.Tensor:
        """The circuit's 2^n x 2^n unitary: the identity's columns run as one
        batch through the einsum route, op by op (gates only)."""
        n = self.nqubit
        full = self._full_params(params)
        dim = 1 << n
        x = torch.eye(dim, dtype=cdtype(), device=self.device).reshape([dim] + [2] * n)
        for op in self.operators:
            if op.kind in ('barrier', 'cut'):
                continue
            if op.kind != 'gate':
                raise ValueError(f'{op.name} has no unitary')
            x = evolve_state_controlled(x, op.matrix(full), n, list(op.wires), list(op.controls))
        return x.reshape(dim, dim).T

    def get_amplitude(self, bits: str) -> torch.Tensor:
        """<bits|state> of the stored state (one value a sample for a
        batch); from the site tensors for an MPS."""
        if self.den_mat:
            raise ValueError('get_amplitude acts on state vectors')
        if len(bits) != self.nqubit:
            raise ValueError(f'{len(bits)} bits for {self.nqubit} qubits')
        if self.mps:
            from .mps import bitstring_amplitude
            return bitstring_amplitude(self.state, bits)
        return self.state.reshape(-1, 1 << self.nqubit)[:, int(bits, 2)].squeeze()

    def get_prob(self, bits: str, wires=None) -> torch.Tensor:
        """The probability of ``bits`` on ``wires`` (default all) in the
        stored state, the other wires summed out."""
        if wires is not None:
            wires = _flat_wires(wires)
            if len(wires) != self.nqubit:
                state = self.state.reshape(-1, 1 << self.nqubit)
                sliced = slice_state_vector(state, self.nqubit, wires, bits, normalize=False)
                return (sliced.abs() ** 2).sum(-1).squeeze()
        return self.get_amplitude(bits).abs() ** 2

    def amplitude_encoding(self, data) -> torch.Tensor:
        return amplitude_encoding(torch.as_tensor(data, device=self.device), self.nqubit)

    @property
    def max_depth(self) -> int:
        return int(max(self.depth))

    def inverse(self, encode: bool = False) -> 'QubitCircuit':
        """The inverse circuit: the ops in reverse order, each gate's adjoint
        (its ``inv`` flag), the parameter values copied. Without ``encode``
        the encoders' values become fixed parameters."""
        cir = QubitCircuit(self.nqubit, name=(self.name or '') + '_inverse', den_mat=self.den_mat,
                           device=self.device, reupload=self.reupload, mps=self.mps, chi=self.chi)
        cir._pvals = list(self._pvals)
        cir._train_mask = list(self._train_mask)
        enc = {id(op) for op in self.encoders}
        for op in reversed(self.operators):
            g = _copy.copy(op)
            if g.kind == 'gate':
                g.inv = not g.inv
            cir.operators.append(g)
            if encode and id(op) in enc:
                cir.encoders.append(g)
                cir._enc_pidx.extend(g.pidx)
        cir.wires_condition = list(self.wires_condition)
        if encode:
            cir.npara, cir.ndata = self.npara, self.ndata
        else:
            cir.npara, cir.ndata = self.npara + self.ndata, 0
        cir._touch()
        return cir

    def __add__(self, rhs: 'QubitCircuit') -> 'QubitCircuit':
        if self.nqubit != rhs.nqubit:
            raise ValueError('the circuits have different numbers of qubits')
        cir = QubitCircuit(self.nqubit, init_state=self.init_state, name=self.name,
                           den_mat=self.den_mat, device=self.device, reupload=self.reupload,
                           mps=self.mps, chi=self.chi)
        cir.add(self)
        cir.add(rhs)
        cir.observables = list(rhs.observables)
        return cir

    # ------------------------------------------------------------- gate sugar
    def u3(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('U3Gate', wires, controls, inputs, encode, condition)

    def cu(self, control, target, inputs=None, encode=False):
        self.add_gate('U3Gate', target, control, inputs, encode)

    def p(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('PhaseShift', wires, controls, inputs, encode, condition)

    def cp(self, control, target, inputs=None, encode=False):
        self.add_gate('PhaseShift', target, control, inputs, encode)

    def x(self, wires, controls=None, condition=False):
        self.add_gate('PauliX', wires, controls, condition=condition)

    def y(self, wires, controls=None, condition=False):
        self.add_gate('PauliY', wires, controls, condition=condition)

    def z(self, wires, controls=None, condition=False):
        self.add_gate('PauliZ', wires, controls, condition=condition)

    def h(self, wires, controls=None, condition=False):
        self.add_gate('Hadamard', wires, controls, condition=condition)

    def s(self, wires, controls=None, condition=False):
        self.add_gate('SGate', wires, controls, condition=condition)

    def sdg(self, wires, controls=None, condition=False):
        self.add_gate('SDaggerGate', wires, controls, condition=condition)

    def t(self, wires, controls=None, condition=False):
        self.add_gate('TGate', wires, controls, condition=condition)

    def tdg(self, wires, controls=None, condition=False):
        self.add_gate('TDaggerGate', wires, controls, condition=condition)

    def ch(self, control, target):
        self.add_gate('Hadamard', target, control)

    def cs(self, control, target):
        self.add_gate('SGate', target, control)

    def csdg(self, control, target):
        self.add_gate('SDaggerGate', target, control)

    def ct(self, control, target):
        self.add_gate('TGate', target, control)

    def ctdg(self, control, target):
        self.add_gate('TDaggerGate', target, control)

    def rx(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Rx', wires, controls, inputs, encode, condition)

    def ry(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Ry', wires, controls, inputs, encode, condition)

    def rz(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Rz', wires, controls, inputs, encode, condition)

    def crx(self, control, target, inputs=None, encode=False):
        self.add_gate('Rx', target, control, inputs, encode)

    def cry(self, control, target, inputs=None, encode=False):
        self.add_gate('Ry', target, control, inputs, encode)

    def crz(self, control, target, inputs=None, encode=False):
        self.add_gate('Rz', target, control, inputs, encode)

    def j(self, wires, inputs=None, plane='xy', controls=None, condition=False, encode=False):
        self.add_gate('ProjectionJ', wires, controls, inputs, encode, condition,
                      matrix_fn=projection_j_fn(plane), npara=1, extra={'plane': plane})

    def cnot(self, control, target):
        self.add_gate('CNOT', [control, target])

    def cx(self, control, target):
        self.add_gate('PauliX', target, control)

    def cy(self, control, target):
        self.add_gate('PauliY', target, control)

    def cz(self, control, target):
        self.add_gate('PauliZ', target, control)

    def swap(self, wires, controls=None, condition=False):
        self.add_gate('Swap', wires, controls, condition=condition)

    def iswap(self, wires, controls=None, condition=False):
        self.add_gate('ImaginarySwap', wires, controls, condition=condition)

    def rxx(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Rxx', wires, controls, inputs, encode, condition)

    def ryy(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Ryy', wires, controls, inputs, encode, condition)

    def rzz(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Rzz', wires, controls, inputs, encode, condition)

    def rxy(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('Rxy', wires, controls, inputs, encode, condition)

    def rbs(self, wires, inputs=None, controls=None, condition=False, encode=False):
        self.add_gate('ReconfigurableBeamSplitter', wires, controls, inputs, encode, condition)

    def crxx(self, control, target1, target2, inputs=None, encode=False):
        self.add_gate('Rxx', [target1, target2], control, inputs, encode)

    def cryy(self, control, target1, target2, inputs=None, encode=False):
        self.add_gate('Ryy', [target1, target2], control, inputs, encode)

    def crzz(self, control, target1, target2, inputs=None, encode=False):
        self.add_gate('Rzz', [target1, target2], control, inputs, encode)

    def crxy(self, control, target1, target2, inputs=None, encode=False):
        self.add_gate('Rxy', [target1, target2], control, inputs, encode)

    def toffoli(self, control1, control2, target):
        self.add_gate('Toffoli', [control1, control2, target])

    def ccx(self, control1, control2, target):
        self.add_gate('PauliX', target, [control1, control2])

    def fredkin(self, control, target1, target2):
        self.add_gate('Fredkin', [control, target1, target2])

    def cswap(self, control, target1, target2):
        self.add_gate('Swap', [target1, target2], control)

    def any(self, unitary, wires=None, minmax=None, controls=None, name='uany'):
        """A fixed arbitrary unitary on ``wires`` (default the ``minmax`` span)."""
        unitary = unitary.detach().cpu().numpy() if torch.is_tensor(unitary) else unitary
        self.add_gate(name, self._layer_wires(wires, minmax), controls,
                      static_matrix=np.asarray(unitary, dtype=np.complex128), npara=0)

    def latent(self, wires=None, inputs=None, minmax=None, controls=None, encode=False):
        """A latent gate: the polar projection U V^H of a trainable 2^k x 2^k
        latent matrix (random normal when not given)."""
        wires = self._layer_wires(wires, minmax)
        dim = 2 ** len(wires)
        if inputs is None:
            inputs = np.random.randn(dim, dim)
        self.add_gate('LatentGate', wires, controls, _float64(inputs), encode,
                      matrix_fn=latent_fn(dim), npara=dim * dim)

    def hamiltonian(self, hamiltonian, t=None, wires=None, minmax=None, controls=None,
                    encode=False):
        """exp(-i H t) on ``wires``, the time t a parameter."""
        ham = hamiltonian.detach().cpu().numpy() if torch.is_tensor(hamiltonian) else hamiltonian
        ham = np.asarray(ham, dtype=np.complex128)
        self.add_gate('HamiltonianGate', self._layer_wires(wires, minmax), controls, t, encode,
                      matrix_fn=hamiltonian_fn(ham), npara=1, extra={'ham': ham})

    def _layer_wires(self, wires, minmax=None):
        """``wires`` as a list; None: the ``minmax`` span, default all."""
        if wires is not None:
            return _flat_wires(wires)
        lo, hi = (0, self.nqubit - 1) if minmax is None else minmax
        return list(range(lo, hi + 1))

    def xlayer(self, wires=None):
        for w in self._layer_wires(wires):
            self.x(w)

    def ylayer(self, wires=None):
        for w in self._layer_wires(wires):
            self.y(w)

    def zlayer(self, wires=None):
        for w in self._layer_wires(wires):
            self.z(w)

    def hlayer(self, wires=None):
        for w in self._layer_wires(wires):
            self.h(w)

    def _rot_layer(self, kind, wires, inputs, encode, npara: int = 1):
        flat = None if inputs is None else _float64(inputs)
        for i, w in enumerate(self._layer_wires(wires)):
            ins = None if flat is None else flat[npara * i:npara * (i + 1)]
            getattr(self, kind)(w, ins, encode=encode)

    def rxlayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('rx', wires, inputs, encode)

    def rylayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('ry', wires, inputs, encode)

    def rzlayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('rz', wires, inputs, encode)

    def u3layer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('u3', wires, inputs, encode, npara=3)

    def cxlayer(self, wires=None):
        if wires is None:
            wires = [[i, i + 1] for i in range(0, self.nqubit - 1, 2)]
        for c, t in wires:
            self.cx(c, t)

    def cnot_ring(self, minmax=None, step: int = 1, reverse: bool = False):
        """Ring of CNOTs."""
        if minmax is None:
            minmax = [0, self.nqubit - 1]
        wires = list(range(minmax[0], minmax[1] + 1))
        nw = len(wires)
        if reverse:
            pairs = [(wires[(i + step) % nw], wires[i]) for i in reversed(range(nw))]
        else:
            pairs = [(wires[i], wires[(i + step) % nw]) for i in range(nw)]
        for c, t in pairs:
            self.cnot(c, t)

    # channels (density matrices only)
    def bit_flip(self, wires, inputs=None, encode=False):
        self._add_channel('BitFlip', wires, inputs, encode)

    def phase_flip(self, wires, inputs=None, encode=False):
        self._add_channel('PhaseFlip', wires, inputs, encode)

    def depolarizing(self, wires, inputs=None, encode=False):
        self._add_channel('Depolarizing', wires, inputs, encode)

    def pauli(self, wires, inputs=None, encode=False):
        self._add_channel('Pauli', wires, inputs, encode)

    def amp_damp(self, wires, inputs=None, encode=False):
        self._add_channel('AmplitudeDamping', wires, inputs, encode)

    def phase_damp(self, wires, inputs=None, encode=False):
        self._add_channel('PhaseDamping', wires, inputs, encode)

    def gen_amp_damp(self, wires, inputs=None, encode=False):
        self._add_channel('GeneralizedAmplitudeDamping', wires, inputs, encode)

    def _add_channel(self, name: str, wires, inputs, encode: bool) -> GateOp:
        """Append a Kraus channel; its thetas (prob = sin^2 theta) are fixed
        values (random in [0, pi) when not given), or data with ``encode``."""
        if not self.den_mat:
            raise ValueError('Channels act on density matrices; build the circuit with '
                             'den_mat=True')
        from .channel import CHANNEL_REGISTRY
        reg = CHANNEL_REGISTRY[name]
        npara = reg['npara']
        wires = tuple(_flat_wires(wires))
        if inputs is None:
            values = [float(np.random.rand() * np.pi) for _ in range(npara)]
        else:
            values = _float64(inputs)
            if len(values) != npara:
                raise ValueError(f'{name} expects {npara} parameters')
        pidx = self._new_params(values, encode, requires_grad=False)
        op = GateOp(name=name, wires=wires, matrix_fn=reg['fn'], pidx=pidx, npara=npara,
                    kind='channel', requires_grad=False)
        self.operators.append(op)
        if encode:
            self.encoders.append(op)
            self._enc_pidx.extend(pidx)
            self.ndata += npara
        else:
            self.npara += npara
        self._touch()
        return op

    def barrier(self, wires=None):
        self.operators.append(GateOp(name='Barrier', wires=tuple(self._layer_wires(wires)),
                                     kind='barrier'))
        self._touch()

    def reset(self, wires=None, postselect: int | None = 0):
        """Reset ``wires`` (default all) to |0>, post-selecting
        ``postselect`` (0 or 1) on each."""
        if postselect not in (0, 1):
            raise ValueError('reset post-selects 0 or 1')
        self.operators.append(GateOp(name='Reset', wires=tuple(self._layer_wires(wires)),
                                     kind='reset', extra={'postselect': postselect}))
        self._touch()

    def move(self, wire1: int, wire2: int, postselect: int | None = 0):
        """Reset ``wire2`` (post-selecting ``postselect``), then swap it with
        ``wire1``."""
        self.operators.append(GateOp(name='Move', wires=(wire1, wire2), kind='move',
                                     extra={'postselect': postselect}))
        self._touch()

    def cut(self, wires):
        """Mark a wire cut on each of ``wires`` at this point of the circuit."""
        for w in _flat_wires(wires):
            self._cut_lst.append((len(self.operators), w))
            self.operators.append(GateOp(name='WireCut', wires=(w,), kind='cut'))
        self._touch()

    def transform_cut2move(self) -> 'QubitCircuit':
        """The circuit with each wire cut rewritten as a move onto a new
        wire: it simulates the cut circuit directly, no sampling of terms."""
        from .cutting import _ir_ops, transform_cut2move
        observables = [(sum(o.wires, []), o.basis) for o in self.observables] or None
        new_ops, new_obs, new_nq = transform_cut2move(_ir_ops(self), self._cut_lst, self.nqubit,
                                                      observables, qpd_form=False)
        cir = QubitCircuit(new_nq, den_mat=self.den_mat, device=self.device,
                           reupload=self.reupload, shots=self.shots)
        for op in new_ops:
            op.add_to(cir)
        for w, b in (new_obs or []):
            cir.observable([[x] for x in w], basis=b)
        return cir

    def get_subexperiments(self, qubit_labels=None):
        """The cut circuit's subexperiments and their coefficients
        (``cutting.get_subexperiments``)."""
        from .cutting import get_subexperiments
        return get_subexperiments(self, qubit_labels)

    def pattern(self, generator: torch.Generator | None = None):
        """The circuit as an MBQC pattern on the circuit's device: each gate
        expands to its command template (``mbqc.templates``), a wire-to-node
        map following each wire as measurements consume nodes. Its runs draw
        from ``generator`` (on the circuit's device) when given."""
        if self.den_mat or self.mps:
            raise ValueError('the MBQC transpiler takes state-vector circuits')
        from .mbqc import Pattern
        from .mbqc.templates import MBQC_TEMPLATES

        wire2node = {i: i for i in range(self.nqubit)}
        init = self.init_state.state.reshape(-1)
        zeros = torch.zeros_like(init)
        zeros[0] = 1
        if torch.allclose(init, zeros):
            pattern = Pattern(device=self.device, generator=generator)
            for i in range(self.nqubit):
                pattern.add_graph(nodes_state=[i], state='zero')
        else:
            pattern = Pattern(nodes_state=self.nqubit, state=init, device=self.device,
                              generator=generator)
        pattern.reupload = self.reupload
        node_next = self.nqubit
        encoders = {id(op) for op in self.encoders}
        for op in self.operators:
            if op.kind == 'barrier':
                continue
            if op.kind != 'gate' or op.controls or op.condition:
                raise ValueError(f'{op.name}: the MBQC transpiler takes gates without controls '
                                 'or conditions')
            entry = MBQC_TEMPLATES.get(op.name)
            if entry is None:
                raise ValueError(f'{op.name} is not supported by the MBQC transpiler')
            template, nanc = entry
            nodes = [wire2node[w] for w in op.wires]
            ancilla = [node_next + i for i in range(nanc)]
            angle = self._pvals[op.pidx[0]] if op.npara else None
            if op.inv and angle is not None:
                angle = -angle
            cmds, out_nodes, enc_idx = template(nodes if len(nodes) > 1 else nodes[0], ancilla,
                                                angle, op.requires_grad)
            base = len(pattern.commands)
            pattern.commands.extend(cmds)
            if id(op) in encoders:
                for i in enc_idx:
                    pattern.encoders.append(pattern.commands[base + i])
                pattern.npara += nanc - len(enc_idx)
                pattern.ndata += len(enc_idx)
            else:
                pattern.npara += nanc
            node_next += nanc
            for wire, node in zip(op.wires, out_nodes):
                wire2node[wire] = node
        pattern.set_nodes_out_seq([wire2node[i] for i in range(self.nqubit)])
        return pattern

    def draw(self, output: str = 'text', **kwargs):
        """The circuit as text (printed for ``output`` 'text' or 'mpl'), the
        JAX package's drawing character for character."""
        from .draw import draw_circuit_text
        text = draw_circuit_text(self)
        if output in ('text', 'mpl'):
            print(text)
        return text

    def qasm(self) -> str:
        from .qasm import cir_to_qasm2
        return cir_to_qasm2(self)

    def qasm3(self) -> str:
        from .qasm import cir_to_qasm3
        return cir_to_qasm3(self)
