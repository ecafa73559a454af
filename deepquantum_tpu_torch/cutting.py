"""Circuit cutting: wire cuts -> quasiprobability decomposition -> subexperiments.

PyTorch counterpart of ``deepquantum_tpu/cutting.py``. Host-side graph
logic on the GateOp IR: each wire cut becomes a move between two wires,
the move is decomposed into the eight measure / prepare terms of
``MoveQPD``, and the circuit splits into fragments (the connected
components of the gate graph). ``get_subexperiments`` gives, per fragment,
one ordinary ``QubitCircuit`` per combination of terms, on the parent's
device and with its ``den_mat`` and ``shots``, and the combinations'
coefficients; the expectation of the uncut circuit is
sum_k coefficient_k prod_fragments <O>_{fragment, k}. The components are
found by a union-find here, so cutting needs no graph package.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from itertools import product

__all__ = ['MoveQPD', 'transform_cut2move', 'partition_labels', 'partition_problem',
           'separate_operators', 'decompose_observables', 'get_subexperiments']


class _QPDOp:
    """A two-qubit (or decomposed single-qubit) QPD op in the IR.

    bases[i][j] = the primitive actions on the j-th wire for term i, each
    'h' | 'sdg' | 's' | 'x' | 'measure'."""

    def __init__(self, bases, coeffs, wires, label=None, name='MoveQPD'):
        self.bases = bases
        self.coeffs = coeffs
        self.wires = list(wires)
        self.controls = []
        self.label = label
        self.name = name
        self.kind = 'qpd'
        self.npara = 0

    def decompose(self):
        g1 = _QPDOp([[b[0]] for b in self.bases], self.coeffs, [self.wires[0]], self.label,
                    self.name + f'_label{self.label}_1')
        g2 = _QPDOp([[b[1]] for b in self.bases], self.coeffs, [self.wires[1]], self.label,
                    self.name + f'_label{self.label}_2')
        return g1, g2


def MoveQPD(wires, label=None) -> _QPDOp:
    """The eight-term measure / prepare decomposition of a move."""
    measure_i = []
    measure_x = ['h', 'measure']
    measure_y = ['sdg', 'h', 'measure']
    measure_z = ['measure']
    prep_0 = []
    prep_1 = ['x']
    prep_plus = ['h']
    prep_minus = ['x', 'h']
    prep_iplus = ['h', 's']
    prep_iminus = ['x', 'h', 's']
    bases = [
        [measure_i, prep_0],
        [measure_i, prep_1],
        [measure_x, prep_plus],
        [measure_x, prep_minus],
        [measure_y, prep_iplus],
        [measure_y, prep_iminus],
        [measure_z, prep_0],
        [measure_z, prep_1],
    ]
    coeffs = [0.5, 0.5, 0.5, -0.5, 0.5, -0.5, 0.5, -0.5]
    return _QPDOp(bases, coeffs, wires, label)


class _IROp:
    """A portable copy of a GateOp with its parameter values inlined."""

    def __init__(self, op, pvals):
        self.name = op.name
        self.kind = op.kind
        self.wires = list(op.wires)
        self.controls = list(op.controls)
        self.values = [pvals[i] for i in op.pidx] if op.pidx else []
        self.inv = op.inv
        self.condition = op.condition
        self.matrix_fn = op.matrix_fn
        self.static_matrix = op.static_matrix
        self.npara = op.npara
        self.extra = {k: v for k, v in op.extra.items() if k in ('plane', 'ham', 'postselect')}

    @classmethod
    def marker(cls, name: str, kind: str, wires, extra=None) -> '_IROp':
        """A parameterless op (a cut, a move, a barrier)."""
        m = cls.__new__(cls)
        m.name, m.kind, m.wires, m.controls = name, kind, list(wires), []
        m.values, m.inv, m.condition, m.matrix_fn, m.static_matrix, m.npara = (
            [], False, False, None, None, 0)
        m.extra = dict(extra or {})
        return m

    def add_to(self, cir, wire_map=None):
        wires = [wire_map[w] if wire_map else w for w in self.wires]
        controls = [wire_map[w] if wire_map else w for w in self.controls]
        if self.kind == 'barrier':
            cir.barrier(wires)
            return
        if self.kind == 'move':
            cir.move(wires[0], wires[1], self.extra.get('postselect', 0))
            return
        if self.kind == 'reset':
            cir.reset(wires, self.extra.get('postselect', 0))
            return
        if self.kind == 'channel':
            cir._add_channel(self.name, wires, self.values, False)
            return
        op = cir.add_gate(self.name, wires, controls or None, self.values or None,
                          condition=self.condition, matrix_fn=self.matrix_fn,
                          static_matrix=self.static_matrix, npara=self.npara,
                          extra=dict(self.extra))
        op.inv = self.inv


def _ir_ops(cir) -> list:
    """The circuit's op list as _IROp items (a wire cut as its marker)."""
    return [_IROp(op, cir._pvals) if op.kind != 'cut' else
            _IROp.marker('WireCut', 'cut', op.wires) for op in cir.operators]


def transform_cut2move(ops, cut_lst, nqubit, observables=None, qpd_form: bool = False):
    """Each wire cut becomes a move onto a new wire (or its ``MoveQPD``),
    the later ops re-indexed. Returns (new_ops, new_observable_wires,
    new_nqubit); ops are _IROp or _QPDOp items, observables (wires, basis)
    pairs."""
    cuts_per_qubit = defaultdict(list)
    for idx, wire in cut_lst:
        cuts_per_qubit[wire].append(idx)
    ncut_cum = []
    ncut = 0
    for i in range(nqubit + 1):
        ncut_cum.append(ncut)
        ncut += len(cuts_per_qubit[i])
    new_nqubit = nqubit + ncut
    new_ops = []
    for i, op in enumerate(ops):
        def remap(wire):
            nb = bisect.bisect_left(cuts_per_qubit[wire], i)
            return wire + ncut_cum[wire] + nb
        op.wires = [remap(w) for w in op.wires]
        op.controls = [remap(w) for w in op.controls]
        if op.kind == 'cut':
            w = op.wires[0]
            new_ops.append(MoveQPD([w, w + 1]) if qpd_form else
                           _IROp.marker('Move', 'move', [w, w + 1]))
        else:
            new_ops.append(op)
    new_obs = None
    if observables is not None:
        new_obs = []
        for wires, basis in observables:
            new_wires = [w + ncut_cum[w + 1] for w in wires]
            new_obs.append((new_wires, basis))
    return new_ops, new_obs, new_nqubit


def _components(nqubit: int, edges) -> list:
    """Connected components of the graph on range(nqubit), each a set,
    sorted by their least member."""
    parent = list(range(nqubit))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in edges:
        parent[find(a)] = find(b)
    groups = defaultdict(set)
    for q in range(nqubit):
        groups[find(q)].add(q)
    return sorted(groups.values(), key=min)


def partition_labels(ops, nqubit, ignore=lambda op: False, keep_idle_wires: bool = False):
    """The fragment label of each wire: the connected components of the
    gate graph (ops for which ``ignore`` holds, and barriers, add no
    edges); idle wires get None unless ``keep_idle_wires``."""
    edges = []
    for op in ops:
        if ignore(op) or op.kind == 'barrier':
            continue
        wires = list(op.wires) + list(op.controls)
        edges.extend((w1, w2) for i, w1 in enumerate(wires) for w2 in wires[i + 1:])
    subsets = _components(nqubit, edges)
    if not keep_idle_wires:
        idle = set(range(nqubit))
        for op in ops:
            for w in list(op.wires) + list(op.controls):
                idle.discard(w)
        subsets = [s for s in subsets if not (len(s) == 1 and next(iter(s)) in idle)]
    labels = [None] * nqubit
    for i, subset in enumerate(subsets):
        for q in subset:
            labels[q] = i
    return labels


def map_qubit(labels):
    """Each wire's (label, index within its fragment), and label -> wires."""
    qubit_map = []
    label2qubits = defaultdict(list)
    for i, label in enumerate(labels):
        if label is None:
            qubit_map.append((None, None))
        else:
            qubits = label2qubits[label]
            qubit_map.append((label, len(qubits)))
            qubits.append(i)
    return qubit_map, dict(label2qubits)


def get_qpd_operators(ops, labels):
    """The ops, checked: only wire cuts (moves) may cross fragments."""
    out = []
    for op in ops:
        if isinstance(op, _QPDOp) or op.kind == 'barrier':
            out.append(op)
            continue
        wires = list(op.wires) + list(op.controls)
        if len(wires) < 2 or len({labels[w] for w in wires}) == 1:
            out.append(op)
            continue
        raise ValueError('Only wire cuts (Move) are supported for gate decomposition here')
    return out


def separate_operators(ops, labels):
    """Split the ops into per-fragment lists with the wires re-indexed."""
    qubit_map, label2qubits = map_qubit(labels)
    label2sub = defaultdict(list)
    for op in ops:
        wires = list(op.wires) + list(op.controls)
        if op.kind == 'barrier':
            # a barrier splits across the fragments it touches
            for label, qubits in label2qubits.items():
                ws = [qubit_map[w][1] for w in wires if w in qubits]
                if ws:
                    label2sub[label].append(_IROp.marker('Barrier', 'barrier', ws))
            continue
        op_labels = {qubit_map[w][0] for w in wires}
        if len(op_labels) != 1:
            raise ValueError(f'{op.name} spans several fragments')
        label = op_labels.pop()
        op.wires = [qubit_map[w][1] for w in op.wires]
        op.controls = [qubit_map[w][1] for w in op.controls]
        label2sub[label].append(op)
    return dict(label2sub), label2qubits


def decompose_observables(observables, labels):
    """Each observable's restriction to each fragment, wires re-indexed."""
    if observables is None:
        return None
    qubit_map, label2qubits = map_qubit(labels)
    label2obs = {}
    for label, qubits in label2qubits.items():
        sub = []
        for wires, basis in observables:
            new_wires = []
            new_basis = ''
            for w, b in zip(wires, basis):
                if w in qubits:
                    new_wires.append(qubit_map[w][1])
                    new_basis += b
            sub.append((new_wires, new_basis))
        label2obs[label] = sub
    return label2obs


def partition_problem(ops, nqubit, labels=None, observables=None):
    """The fragments' op lists (each MoveQPD split into its two one-wire
    halves, labelled by the gate's index) and their observables."""
    if labels is None:
        labels = partition_labels(ops, nqubit, lambda op: isinstance(op, _QPDOp))
    ops = get_qpd_operators(ops, labels)
    expanded = []
    gate_label = 0
    for op in ops:
        if isinstance(op, _QPDOp) and len(op.wires) == 2:
            op.label = gate_label
            g1, g2 = op.decompose()
            expanded.extend([g1, g2])
            gate_label += 1
        else:
            expanded.append(op)
    label2sub, _ = separate_operators(expanded, labels)
    label2obs = decompose_observables(observables, labels)
    return label2sub, label2obs


_QPD_PRIMS = {'h': 'h', 'sdg': 'sdg', 's': 's', 'x': 'x'}


def get_subexperiments(cir, qubit_labels=None):
    """The subexperiments of a cut circuit, {label: [QubitCircuit, ...]}
    with one circuit per combination of QPD terms, and the combinations'
    coefficients."""
    from .circuit import QubitCircuit

    observables = [(sum(o.wires, []), o.basis) for o in cir.observables] or None
    ops, observables, new_nqubit = transform_cut2move(_ir_ops(cir), cir._cut_lst, cir.nqubit,
                                                      observables, qpd_form=True)
    label2sub, label2obs = partition_problem(ops, new_nqubit, qubit_labels, observables)
    gate_labels, gate_coeffs, nbases = [], [], []
    for label, sub_ops in label2sub.items():
        for op in sub_ops:
            if isinstance(op, _QPDOp) and op.label is not None and op.label not in gate_labels:
                gate_labels.append(op.label)
                gate_coeffs.append(op.coeffs)
                nbases.append(len(op.bases))
    order = sorted(range(len(gate_labels)), key=lambda i: gate_labels[i])
    gate_labels = [gate_labels[i] for i in order]
    gate_coeffs = [gate_coeffs[i] for i in order]
    nbases = [nbases[i] for i in order]

    subexperiments = defaultdict(list)
    coefficients = []
    for combination in product(*[range(nb) for nb in nbases]):
        for label, sub_ops in label2sub.items():
            nq = max((max(list(o.wires) + list(o.controls), default=0) for o in sub_ops),
                     default=0) + 1
            cir_sub = QubitCircuit(nq, den_mat=cir.den_mat, shots=cir.shots, device=cir.device)
            obs_ext = [(list(w), b) for w, b in (label2obs[label] if label2obs else [])]
            for op in sub_ops:
                if not isinstance(op, _QPDOp):
                    op.add_to(cir_sub)
                    continue
                idx = combination[gate_labels.index(op.label)]
                measured = False
                for act in op.bases[idx][0]:
                    if act == 'measure':
                        measured = True
                        continue
                    getattr(cir_sub, _QPD_PRIMS[act])(op.wires[0])
                if measured and obs_ext:
                    # a QPD measurement contributes a Z factor to every observable
                    obs_ext = [(w + [op.wires[0]], b + 'z') for w, b in obs_ext]
            for w, b in obs_ext:
                if w:
                    cir_sub.observable([[x] for x in w], basis=b)
            subexperiments[label].append(cir_sub)
        coeff = 1.0
        for i, idx in enumerate(combination):
            coeff *= gate_coeffs[i][idx]
        coefficients.append(coeff)
    return dict(subexperiments), coefficients
