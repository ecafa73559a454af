"""QubitCircuit: the qubit-circuit API of the PyTorch port.

PyTorch counterpart of the ``deepquantum_tpu/circuit.py`` subset that the
serving and training paths use: build a circuit, run ``forward`` on one
state, take Pauli-string ``expectation`` values, and differentiate them in
the parameters (``expectation(params=p)[0].backward()`` with ``p`` a leaf
that requires grad). The circuit records an op list (the IR) plus one flat
parameter vector; simulation runs eagerly on the circuit's device.

Routing is a pure function of the dtype, n, the plan and the device: at
complex64 with n >= 10 and every fused group a unitary on <= 3 wires, the
state runs as float32 planes through the planar engine (ops/planar_gate.py,
its window scheduler and its CUDA kernels on a CUDA device); everything
else runs the complex einsum engine (ops/apply.py). Gradients follow the
route: the planar engine's chain has an adjoint backward over its own
kernels, the einsum engine is plain autograd.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import cdtype, rdtype, resolve_device
from .gate import GATE_REGISTRY, GateOp
from .ops import gates as G
from .ops.apply import controlled_matrix, evolve_state, evolve_state_controlled, permute_matrix_wires
from .ops.qmath import expectation_pauli
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

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Apply the Pauli string to a state tensor (2,)*n."""
        for wire, b in zip(self.wires, self.basis):
            x = evolve_state(x, _PAULI_FNS[b](x.device), self.nqubit, [wire[0]])
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
        device: where states, parameters and matrices live (default: the
            config's default device, which is the CUDA card unless
            ``set_device`` chose another). 'cuda' without CUDA raises.
    """

    #: max combined wire support of one fused gate group (the JAX package's
    #: default, K = 2, kept so that plans are identical)
    fuse_max_support: int = 2
    #: run a gate step of the planar backward as the single fused kernel
    #: (planar_bwd_fused) instead of apply + grad + apply (default off, as
    #: the JAX package's switch)
    fused_bwd: bool = False

    def __init__(self, nqubit: int, init_state: Any = 'zeros', name: str | None = None,
                 device=None) -> None:
        self.nqubit = nqubit
        self.name = name
        self.device = resolve_device(device)
        self.operators: list[GateOp] = []
        self.observables: list[Observable] = []
        self._pvals: list[float] = []       # all parameter values (host-side master copy)
        self._train_mask: list[bool] = []   # per-parameter trainability
        self.state = None
        self._version = 0
        self._cache: dict = {}
        self.set_init_state(init_state)

    # ------------------------------------------------------------------ state
    def set_init_state(self, init_state: Any) -> None:
        if isinstance(init_state, QubitState):
            if init_state.nqubit != self.nqubit:
                raise ValueError('init_state has another number of qubits')
            self.init_state = init_state
        else:
            self.init_state = QubitState(self.nqubit, init_state, device=self.device)

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

    def _full_params(self, params=None) -> torch.Tensor:
        """Full parameter vector on the circuit's device, with the trainable
        entries replaced by ``params`` when given (differentiable in them)."""
        full = torch.as_tensor(np.asarray(self._pvals, dtype=np.float64), device=self.device)
        full = full.to(rdtype())
        if params is not None:
            params = torch.as_tensor(params, device=self.device).to(rdtype()).reshape(-1)
            idx = torch.as_tensor(self._train_idx, dtype=torch.long, device=self.device)
            full = full.index_put((idx,), params)
        return full

    def init_para(self, seed: int | None = None) -> None:
        """Re-randomize all trainable parameters from ``seed`` (numpy's
        default_rng, as the JAX package draws them)."""
        rng = np.random.default_rng(seed)
        for i, t in enumerate(self._train_mask):
            if t:
                self._pvals[i] = float(rng.random() * 2 * np.pi)

    # ------------------------------------------------------------------- add
    def _new_params(self, values, requires_grad: bool) -> tuple:
        start = len(self._pvals)
        idx = tuple(range(start, start + len(values)))
        self._pvals.extend(float(v) for v in values)
        self._train_mask.extend([requires_grad] * len(values))
        return idx

    def add_gate(self, name: str, wires, controls=None, inputs=None) -> GateOp:
        """Append a GATE_REGISTRY gate to the IR, registering its parameters
        (trainable unless given as ``inputs``)."""
        wires = tuple(_flat_wires(wires))
        controls = tuple(_flat_wires(controls)) if controls is not None else ()
        if len(set(wires)) != len(wires) or len(set(controls)) != len(controls) \
                or set(wires) & set(controls):
            raise ValueError(f'{name}: repeated wires {wires} / controls {controls}')
        for w in wires + controls:
            if not 0 <= w < self.nqubit:
                raise ValueError(f'wire {w} out of range for {self.nqubit} qubits')
        reg = GATE_REGISTRY.get(name)
        if reg is None:
            raise ValueError(f'Unknown gate: {name}')
        npara = reg['npara']
        if len(wires) != reg['nwires']:
            raise ValueError(f'{name} acts on {reg["nwires"]} wire(s), got {wires}')
        requires_grad = inputs is None and npara > 0
        if npara > 0:
            if inputs is None:
                values = [float(np.random.rand() * 2 * np.pi) for _ in range(npara)]
            else:
                values = _float64(inputs)
                if len(values) != npara:
                    raise ValueError(f'{name} expects {npara} parameters')
            pidx = self._new_params(values, requires_grad)
        else:
            pidx = ()
        op = GateOp(name=name, wires=wires, controls=controls, matrix_fn=reg['fn'], pidx=pidx,
                    npara=npara, requires_grad=requires_grad)
        self.operators.append(op)
        self._touch()
        return op

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
        group's sorted wire order."""
        _, ops, wires = entry
        k = len(wires)
        mat = None
        for op in ops:
            m = controlled_matrix(op.matrix(full_params).to(cdtype()), len(op.controls))
            aw = list(op.controls) + list(op.wires)
            pad = k - len(aw)
            if pad:
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
        """Route through the planar engine? complex64, n >= 10, and every
        fused-plan entry a plain unitary on <= 3 wires."""
        key = ('planar_ok', self._version, self.fuse_max_support, cdtype())
        ok = self._cache.get(key)
        if ok is None:
            ok = self.nqubit >= 10 and cdtype() == torch.complex64
            if ok:
                for entry in self._fused_plan():
                    if entry[0] == 'group':
                        ok = len(entry[2]) <= 3
                    else:
                        op = entry[1]
                        ok = (op.kind == 'gate' and not op.condition
                              and len(set(op.wires) | set(op.controls)) <= 3)
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

    def _sim_tensor(self, full_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Simulation over a state tensor (2,)*n."""
        n = self.nqubit
        if self._planar_ok():
            return self._sim_planar(full_params, x)
        for entry in self._fused_plan():
            if entry[0] == 'op':
                op = entry[1]
                x = evolve_state_controlled(x, op.matrix(full_params), n,
                                            list(op.wires), list(op.controls))
            else:
                mat, wires = self._fused_matrix(entry, full_params)
                x = evolve_state(x, mat, n, list(wires))
        return x

    # --------------------------------------------------------------- forward
    def __call__(self, data=None, state=None, params=None):
        return self.forward(data, state, params)

    def forward(self, data=None, state=None, params=None) -> torch.Tensor:
        """Run the circuit on one state; returns and stores the final state,
        shape (2^n, 1).

        state: optional initial state (tensor, array or QubitState);
        defaults to init_state. params: optional trainable-parameter vector.
        """
        if data is not None:
            raise NotImplementedError('data encoding is not ported yet (ROADMAP queue 1)')
        if state is None:
            state = self.init_state
        if isinstance(state, QubitState):
            state = state.state
        state = torch.as_tensor(state).to(device=self.device, dtype=cdtype())
        n = self.nqubit
        full = self._full_params(params)
        x = self._sim_tensor(full, state.reshape([2] * n))
        self.state = x.reshape(2 ** n, 1)
        return self.state

    # ------------------------------------------------------------ observables
    def observable(self, wires=None, basis: str = 'z') -> None:
        self.observables.append(Observable(nqubit=self.nqubit, wires=wires, basis=basis))

    def _obs_seq(self, obs: Observable):
        """Scheduled planar sequence of one observable's Pauli blocks (a
        constant: cached per wires, basis and device, and built outside
        inference mode so that a later autograd-tracked call may use it)."""
        key = ('obs', tuple(map(tuple, obs.wires)), obs.basis, self.device)
        seq = self._cache.get(key)
        if seq is None:
            with torch.inference_mode(False), torch.no_grad():
                seq = self._build_obs_seq(obs)
            self._cache[key] = seq
        return seq

    def _build_obs_seq(self, obs: Observable):
        from .ops.planar_gate import schedule_planar_seq
        mres, mims, wseq = [], [], []
        for mat, wires in _pauli_obs_blocks(obs):
            mres.append(torch.as_tensor(mat.real, dtype=torch.float32, device=self.device))
            mims.append(torch.as_tensor(mat.imag, dtype=torch.float32, device=self.device))
            wseq.append(wires)
        return schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), self.nqubit)

    def expectation(self, data=None, state=None, params=None, shots: int | None = None):
        """Expectation values of all observables, shape (n_observables,).

        With no arguments, uses the stored final state; with state/params,
        runs forward first."""
        if not self.observables:
            raise ValueError('There is no observable')
        if shots is not None:
            raise NotImplementedError('shot sampling is not ported yet (ROADMAP queue 1)')
        if data is not None or params is not None or state is not None or self.state is None:
            s = self.forward(data, state, params)
        else:
            s = self.state
        n = self.nqubit
        vals = []
        if self._planar_ok():
            from .ops.planar_gate import planar_pauli_expectation, to_planar
            xp = to_planar(s)
            for obs in self.observables:
                mres, mims, wseq = self._obs_seq(obs)
                vals.append(planar_pauli_expectation(xp, mres, mims, n, wseq))
        else:
            x = s.reshape([2] * n)
            for obs in self.observables:
                vals.append(expectation_pauli(x, obs.apply(x)))
        return torch.stack(vals, dim=-1)

    # ------------------------------------------------------------- gate sugar
    def u3(self, wires, inputs=None, controls=None):
        self.add_gate('U3Gate', wires, controls, inputs)

    def p(self, wires, inputs=None, controls=None):
        self.add_gate('PhaseShift', wires, controls, inputs)

    def x(self, wires, controls=None):
        self.add_gate('PauliX', wires, controls)

    def y(self, wires, controls=None):
        self.add_gate('PauliY', wires, controls)

    def z(self, wires, controls=None):
        self.add_gate('PauliZ', wires, controls)

    def h(self, wires, controls=None):
        self.add_gate('Hadamard', wires, controls)

    def s(self, wires, controls=None):
        self.add_gate('SGate', wires, controls)

    def sdg(self, wires, controls=None):
        self.add_gate('SDaggerGate', wires, controls)

    def t(self, wires, controls=None):
        self.add_gate('TGate', wires, controls)

    def tdg(self, wires, controls=None):
        self.add_gate('TDaggerGate', wires, controls)

    def rx(self, wires, inputs=None, controls=None):
        self.add_gate('Rx', wires, controls, inputs)

    def ry(self, wires, inputs=None, controls=None):
        self.add_gate('Ry', wires, controls, inputs)

    def rz(self, wires, inputs=None, controls=None):
        self.add_gate('Rz', wires, controls, inputs)

    def cnot(self, control, target):
        self.add_gate('CNOT', [control, target])

    def cx(self, control, target):
        self.add_gate('PauliX', target, control)

    def cz(self, control, target):
        self.add_gate('PauliZ', target, control)

    def swap(self, wires, controls=None):
        self.add_gate('Swap', wires, controls)

    def iswap(self, wires, controls=None):
        self.add_gate('ImaginarySwap', wires, controls)

    def rxx(self, wires, inputs=None, controls=None):
        self.add_gate('Rxx', wires, controls, inputs)

    def ryy(self, wires, inputs=None, controls=None):
        self.add_gate('Ryy', wires, controls, inputs)

    def rzz(self, wires, inputs=None, controls=None):
        self.add_gate('Rzz', wires, controls, inputs)

    def rxy(self, wires, inputs=None, controls=None):
        self.add_gate('Rxy', wires, controls, inputs)

    def rbs(self, wires, inputs=None, controls=None):
        self.add_gate('ReconfigurableBeamSplitter', wires, controls, inputs)

    def toffoli(self, control1, control2, target):
        self.add_gate('Toffoli', [control1, control2, target])

    def fredkin(self, control, target1, target2):
        self.add_gate('Fredkin', [control, target1, target2])

    def _layer_wires(self, wires):
        if wires is None:
            return list(range(self.nqubit))
        return _flat_wires(wires)

    def _rot_layer(self, kind, wires, inputs):
        for i, w in enumerate(self._layer_wires(wires)):
            ins = None if inputs is None else np.asarray(inputs).reshape(-1)[i:i + 1]
            getattr(self, kind)(w, ins)

    def rxlayer(self, wires=None, inputs=None):
        self._rot_layer('rx', wires, inputs)

    def rylayer(self, wires=None, inputs=None):
        self._rot_layer('ry', wires, inputs)

    def rzlayer(self, wires=None, inputs=None):
        self._rot_layer('rz', wires, inputs)

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

    def barrier(self, wires=None):
        self.operators.append(GateOp(name='Barrier', wires=tuple(self._layer_wires(wires)),
                                     kind='barrier'))
        self._touch()
