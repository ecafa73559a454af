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
backward over its own kernels, the einsum engine is plain autograd.
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
        """Apply the Pauli string to a state tensor (2,)*n, or to each state
        of a batch (B, 2, ..., 2)."""
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
        reupload: data re-uploading for encoders (data shorter than ndata
            wraps around).
    """

    #: max combined wire support of one fused gate group (the JAX package's
    #: default, K = 2, kept so that plans are identical)
    fuse_max_support: int = 2
    #: run a gate step of the planar backward as the single fused kernel
    #: (planar_bwd_fused) instead of apply + grad + apply (default off, as
    #: the JAX package's switch)
    fused_bwd: bool = False

    def __init__(self, nqubit: int, init_state: Any = 'zeros', name: str | None = None,
                 device=None, reupload: bool = False) -> None:
        self.nqubit = nqubit
        self.name = name
        self.device = resolve_device(device)
        self.reupload = reupload
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

    def add_gate(self, name: str, wires, controls=None, inputs=None,
                 encode: bool = False) -> GateOp:
        """Append a GATE_REGISTRY gate to the IR, registering its parameters
        (trainable unless given as ``inputs`` or fed by data: ``encode``)."""
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
        op = GateOp(name=name, wires=wires, controls=controls, matrix_fn=reg['fn'], pidx=pidx,
                    npara=npara, requires_grad=requires_grad)
        self.operators.append(op)
        if encode:
            self.encoders.append(op)
            self._enc_pidx.extend(pidx)
            self.ndata += npara
        else:
            self.npara += npara
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

    def _sim_tensor(self, full_params: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Simulation over a state tensor (2,)*n, or a batch (B, 2, ..., 2)
        with (B, P) parameters on the einsum route."""
        n = self.nqubit
        if self._planar_ok() and full_params.dim() == 1:
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
        """Run the circuit; returns and stores the final state.

        data: optional (ndata,) or (B, ndata) encoder data (ignored when the
        circuit has no encoders). One state gives shape (2^n, 1), a batch
        (B, 2^n, 1).
        state: optional initial state (tensor, array or QubitState), one
        state shared by the batch or (B, 2^n) states; defaults to
        init_state.
        params: optional trainable-parameter vector.
        """
        if state is None:
            state = self.init_state
        if isinstance(state, QubitState):
            state = state.state
        state = torch.as_tensor(state).to(device=self.device, dtype=cdtype())
        n = self.nqubit
        dim = 2 ** n
        if self.ndata == 0:
            data = None
        if data is not None:
            data = torch.as_tensor(data, device=self.device).to(rdtype())
        if data is None or data.dim() == 1:
            didx = None if data is None else self._data_indices(data.shape[-1])
            full = self._full_params(params, data, didx)
            x = self._sim_tensor(full, state.reshape([2] * n))
            self.state = x.reshape(dim, 1)
            return self.state
        bsz = data.shape[0]
        fulls = self._full_params(params, data, self._data_indices(data.shape[-1]))
        if state.numel() == dim:
            states = state.reshape(1, dim).expand(bsz, dim)
        else:
            states = state.reshape(bsz, dim)
        if self._planar_ok():
            out = self._sim_planar_batched(fulls, states)
        else:
            out = self._sim_tensor(fulls, states.reshape([bsz] + [2] * n))
        self.state = out.reshape(bsz, dim, 1)
        return self.state

    # ------------------------------------------------------------ observables
    def observable(self, wires=None, basis: str = 'z') -> None:
        self.observables.append(Observable(nqubit=self.nqubit, wires=wires, basis=basis))

    def _obs_seq(self, obs: Observable, bsz: int | None = None):
        """Scheduled planar sequence of one observable's Pauli blocks (a
        constant: cached per wires, basis, device and batch, and built
        outside inference mode so that a later autograd-tracked call may
        use it). For a batch of ``bsz`` states the planes are expanded to
        (bsz, K, K) views, as the JAX package broadcasts them: windows stand
        aside and the kernels read one set of planes for every sample."""
        key = ('obs', tuple(map(tuple, obs.wires)), obs.basis, self.device, bsz)
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
        return schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), self.nqubit)

    def expectation(self, data=None, state=None, params=None, shots: int | None = None):
        """Expectation values of all observables, shape (n_observables,), or
        (B, n_observables) for a batch of states.

        With no arguments, uses the stored final state; with
        data/state/params, runs forward first."""
        if not self.observables:
            raise ValueError('There is no observable')
        if shots is not None:
            raise NotImplementedError('shot sampling is not ported yet (ROADMAP queue 1)')
        if data is not None or params is not None or state is not None or self.state is None:
            s = self.forward(data, state, params)
        else:
            s = self.state
        n = self.nqubit
        bsz = s.shape[0] if s.dim() == 3 else None
        vals = []
        if self._planar_ok():
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

    # ------------------------------------------------------------- gate sugar
    def u3(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('U3Gate', wires, controls, inputs, encode)

    def p(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('PhaseShift', wires, controls, inputs, encode)

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

    def rx(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Rx', wires, controls, inputs, encode)

    def ry(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Ry', wires, controls, inputs, encode)

    def rz(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Rz', wires, controls, inputs, encode)

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

    def rxx(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Rxx', wires, controls, inputs, encode)

    def ryy(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Ryy', wires, controls, inputs, encode)

    def rzz(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Rzz', wires, controls, inputs, encode)

    def rxy(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('Rxy', wires, controls, inputs, encode)

    def rbs(self, wires, inputs=None, controls=None, encode=False):
        self.add_gate('ReconfigurableBeamSplitter', wires, controls, inputs, encode)

    def toffoli(self, control1, control2, target):
        self.add_gate('Toffoli', [control1, control2, target])

    def fredkin(self, control, target1, target2):
        self.add_gate('Fredkin', [control, target1, target2])

    def _layer_wires(self, wires):
        if wires is None:
            return list(range(self.nqubit))
        return _flat_wires(wires)

    def _rot_layer(self, kind, wires, inputs, encode):
        for i, w in enumerate(self._layer_wires(wires)):
            ins = None if inputs is None else np.asarray(inputs).reshape(-1)[i:i + 1]
            getattr(self, kind)(w, ins, encode=encode)

    def rxlayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('rx', wires, inputs, encode)

    def rylayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('ry', wires, inputs, encode)

    def rzlayer(self, wires=None, inputs=None, encode=False):
        self._rot_layer('rz', wires, inputs, encode)

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
