"""MBQC graph states: a node dict plus an {edge: cz} dict, the state a tensor.

PyTorch counterpart of ``deepquantum_tpu/mbqc/state.py``, keeping its
design:

- a pattern run touches its subgraphs once per command, so the graph is a
  plain insertion-ordered node dict plus an {edge: cz-flag} dict (a
  networkx view is built only on demand, for drawing);
- ``full_state`` materialises the 2^k state in ONE Kronecker product of
  the input state with the |+> background nodes, and ONE sign pass for the
  cz-flagged edges (their parity accumulated in a boolean tensor first);
- the state is a torch tensor on the graph's device (the card unless the
  caller asks for the CPU).

Semantics pinned to the JAX package for pattern-vs-circuit parity: the
nodes_state ring (cz=False), later edge flags overwriting earlier ones,
node-to-wire = rank in sorted node order (or the output sequence), and
the compose / shift_labels relabelling rules.
"""

from __future__ import annotations

import importlib
from collections import defaultdict
from functools import reduce
from typing import Any

import torch

from ..config import cdtype, resolve_device
from ..ops.qmath import amplitude_encoding, inverse_permutation

__all__ = ['SubGraphState', 'GraphState']


def _ekey(a, b):
    return (a, b) if a <= b else (b, a)


_BASE = {'plus': (1, 1), 'minus': (1, -1), 'zero': (1, 0), 'one': (0, 1)}


class SubGraphState:
    """A subgraph state: adjacency dicts and the input state on
    ``nodes_state``; the other nodes are |+> until ``full_state`` joins
    them. ``_nodes`` is an insertion-ordered node set, ``_edges`` maps a
    normalised (a, b) pair to its cz flag."""

    def __init__(self, nodes_state=None, state: Any = 'plus', edges=None, nodes=None,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.nodes_out_seq = None
        self.set_graph(nodes_state, edges, nodes)
        self.set_state(state)
        self.measure_dict = defaultdict(list)

    @property
    def nodes(self):
        return self._nodes.keys()

    @property
    def edges(self):
        """The edge list with data dicts (networkx-shaped)."""
        return [(a, b, {'cz': cz}) for (a, b), cz in self._edges.items()]

    @property
    def graph(self):
        """A networkx view, built on demand (drawing and interop only;
        networkx is loaded on the call, as the card's machine may lack it)."""
        g = importlib.import_module('networkx').Graph()
        g.add_nodes_from(self._nodes)
        g.add_edges_from(self.edges)
        return g

    @property
    def full_state(self) -> torch.Tensor:
        """The subgraph's state (2^k, 1): one kron of the input state with
        the background nodes' |+>, the axes put in wire order, then the
        cz-flagged edges as one sign pass."""
        nqubit = len(self._nodes)
        state = self.state.reshape(-1)
        if nqubit == 0:
            return state.reshape(1, 1)
        n2w = self.node2wire_dict
        nodes_bg = [v for v in self._nodes if v not in self.nodes_state]
        if nodes_bg:
            plus = torch.full((1 << len(nodes_bg),), 2 ** (-len(nodes_bg) / 2), dtype=state.dtype,
                              device=state.device)
            state = torch.kron(state, plus)
        order = [n2w[v] for v in self.nodes_state + nodes_bg]
        x = state.reshape([2] * nqubit).permute(inverse_permutation(order))
        cz = [(n2w[a], n2w[b]) for (a, b), flag in self._edges.items() if flag]
        if cz:
            both = torch.zeros((2, 2), dtype=torch.bool, device=x.device)
            both[1, 1] = True
            odd = torch.zeros([2] * nqubit, dtype=torch.bool, device=x.device)
            for wa, wb in cz:
                shape = [1] * nqubit
                shape[wa] = shape[wb] = 2
                odd ^= both.reshape(shape)
            x = torch.where(odd, -x, x)
        return x.reshape(-1, 1)

    def set_graph(self, nodes_state=None, edges=None, nodes=None) -> None:
        if nodes_state is None:
            nodes_state = []
        elif isinstance(nodes_state, int):
            nodes_state = list(range(nodes_state))
        if nodes is None:
            nodes = []
        elif isinstance(nodes, int):
            nodes = [nodes]
        self.nodes_state = list(nodes_state)
        self._nodes: dict = {}
        self._edges: dict = {}
        for v in nodes_state:
            self._nodes.setdefault(v, None)
        if len(nodes_state) > 1:
            # the input state's ring (cz=False), as the reference keeps it
            ring = list(nodes_state)
            for a, b in zip(ring, ring[1:] + ring[:1]):
                self._edges[_ekey(a, b)] = False
        for e in edges or []:
            # (a, b) pairs default to cz=True, (a, b, data) triples carry
            # their flag; a later insertion overwrites an earlier one
            a, b = e[0], e[1]
            cz = e[2].get('cz', True) if len(e) > 2 else True
            self._nodes.setdefault(a, None)
            self._nodes.setdefault(b, None)
            self._edges[_ekey(a, b)] = cz
        for v in nodes:
            self._nodes.setdefault(v, None)
        self.update_node2wire_dict()

    def set_state(self, state: Any = 'plus') -> None:
        """The input state of ``nodes_state``: a name ('plus', 'minus',
        'zero', 'one') for each node, or amplitudes (normalised)."""
        nqubit = len(self.nodes_state)
        if nqubit == 0:
            self.state = torch.ones((), dtype=cdtype(), device=self.device)
        elif isinstance(state, str):
            base = torch.tensor(_BASE[state], dtype=cdtype(), device=self.device)
            base = base / torch.linalg.vector_norm(base)
            self.state = reduce(torch.kron, [base] * nqubit)
        else:
            data = torch.as_tensor(state).to(device=self.device, dtype=cdtype()).reshape(-1)
            self.state = amplitude_encoding(data, nqubit).reshape(-1)

    def set_nodes_out_seq(self, nodes=None) -> None:
        if nodes is not None and (len(nodes) != len(self._nodes) or set(nodes) != set(self._nodes)):
            raise ValueError('the output sequence must hold every node once')
        self.nodes_out_seq = nodes
        self.update_node2wire_dict()

    def add_nodes(self, nodes) -> None:
        if isinstance(nodes, int):
            nodes = [nodes]
        for v in nodes:
            self._nodes.setdefault(v, None)
        self.update_node2wire_dict()

    def add_edges(self, edges) -> None:
        for a, b in edges:
            self._nodes.setdefault(a, None)
            self._nodes.setdefault(b, None)
            self._edges[_ekey(a, b)] = True
        self.update_node2wire_dict()

    def shift_labels(self, n: int) -> None:
        self._nodes = {v + n: None for v in self._nodes}
        self._edges = {(a + n, b + n): cz for (a, b), cz in self._edges.items()}
        self.nodes_state = [s + n for s in self.nodes_state]
        self.measure_dict = defaultdict(list, {k + n: v for k, v in self.measure_dict.items()})
        self.update_node2wire_dict()

    def compose(self, other: 'SubGraphState', relabel: bool = True) -> 'SubGraphState':
        """Merge two subgraphs: the kron of their input states; the other's
        flag wins on a shared edge."""
        if relabel and (set(self._nodes) & set(other._nodes)):
            other.shift_labels(max(self._nodes) - min(other._nodes) + 1)
        if set(other.nodes_state) & set(self.nodes_state):
            raise ValueError('the subgraphs share input-state nodes')
        merged = {**self._edges, **other._edges}
        edges = [(a, b, {'cz': cz}) for (a, b), cz in merged.items()]
        nodes = list(self._nodes) + [v for v in other._nodes if v not in self._nodes]
        state = torch.kron(self.state.reshape(-1), other.state.reshape(-1).to(self.device))
        sgs = SubGraphState(self.nodes_state + other.nodes_state, state, edges, nodes,
                            device=self.device)
        sgs.measure_dict = defaultdict(list)
        sgs.measure_dict.update(self.measure_dict)
        sgs.measure_dict.update(other.measure_dict)
        return sgs

    def update_node2wire_dict(self) -> dict:
        if self.nodes_out_seq is None:
            self.node2wire_dict = {v: i for i, v in enumerate(sorted(self._nodes))}
        else:
            self.node2wire_dict = {node: i for i, node in enumerate(self.nodes_out_seq)}
        return self.node2wire_dict

    def draw(self, **kwargs):
        importlib.import_module('networkx').draw(self.graph, with_labels=True, **kwargs)

    def __repr__(self):
        return f'SubGraphState(nodes_state={self.nodes_state}, nodes={list(self._nodes)})'


class GraphState:
    """A graph state: a list of SubGraphStates, joined only where an
    entanglement needs it."""

    def __init__(self, nodes_state=None, state: Any = 'plus', edges=None, nodes=None,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.subgraphs = [SubGraphState(nodes_state, state, edges, nodes, self.device)]
        self.nodes_out_seq = None

    def add_subgraph(self, nodes_state=None, state='plus', edges=None, nodes=None,
                     measure_dict=None, index=None) -> None:
        sgs = SubGraphState(nodes_state, state, edges, nodes, self.device)
        if measure_dict is not None:
            sgs.measure_dict = measure_dict
        if index is None:
            self.subgraphs.append(sgs)
        else:
            self.subgraphs.insert(index, sgs)

    def node_set(self) -> set:
        """The union of the subgraphs' node sets, without composing them."""
        out: set = set()
        for sg in self.subgraphs:
            out.update(sg.nodes)
        return out

    def find_subgraph(self, node) -> int:
        """The index of the subgraph holding ``node`` (-1 when none does)."""
        for i, sg in enumerate(self.subgraphs):
            if node in sg.nodes:
                return i
        return -1

    @property
    def graph(self) -> SubGraphState:
        graph = None
        for sg in self.subgraphs:
            graph = sg if graph is None else graph.compose(sg, relabel=True)
        graph.set_nodes_out_seq(self.nodes_out_seq)
        return graph

    @property
    def full_state(self) -> torch.Tensor:
        return self.graph.full_state

    @property
    def measure_dict(self) -> dict:
        return self.graph.measure_dict

    def set_nodes_out_seq(self, nodes=None) -> None:
        self.nodes_out_seq = nodes
