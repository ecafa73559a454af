"""MBQC measurement patterns.

PyTorch counterpart of ``deepquantum_tpu/mbqc/pattern.py``: a sequence of
N / E / M / C commands run over a GraphState on the pattern's device (the
card unless the caller asks for the CPU), the measurement outcomes drawn
from the pattern's ``torch.Generator``; ``standardize`` and
``shift_signals`` rewrite the command list as the JAX package does.
Ref: V. Danos, E. Kashefi and P. Panangaden, J. ACM 54.2 8 (2007).
"""

from __future__ import annotations

import importlib
from copy import copy, deepcopy
from typing import Any

import numpy as np
import torch

from ..config import resolve_device
from .command import Correction, Entanglement, Measurement, Node
from .state import GraphState, SubGraphState

__all__ = ['Pattern']


class Pattern:
    """An MBQC pattern: N / E / M / C commands over an initial graph state.

    Args:
        nodes_state, state, edges, nodes: the initial graph (GraphState).
        name: optional label.
        reupload: data re-uploading for the encoded measurement angles.
        device: where the graph states live (default: the default device,
            the card).
        generator: a ``torch.Generator`` (on any device) for the outcomes
            of a run and for angles left random; torch's default generator
            when None.
    """

    def __init__(self, nodes_state=None, state: Any = 'plus', edges=None, nodes=None,
                 name: str | None = None, reupload: bool = False, device=None,
                 generator: torch.Generator | None = None) -> None:
        self.name = name
        self.reupload = reupload
        self.device = resolve_device(device)
        self.generator = generator
        self.init_state = GraphState(nodes_state, state, edges, nodes, device=self.device)
        self.commands: list = []
        self.encoders: list = []
        self.state = None
        self.npara = 0
        self.ndata = 0
        self.nodes_out_seq = None

    def __call__(self, data=None, state=None):
        return self.forward(data, state)

    def forward(self, data=None, state: GraphState | None = None) -> GraphState:
        """Run the commands on a copy of the initial graph (or on ``state``)
        with ``data`` written into the encoded angles; returns the final
        GraphState, its output nodes in ``nodes_out_seq`` order."""
        self.state = deepcopy(self.init_state) if state is None else state
        self.encode(data)
        for cmd in self.commands:
            self.state = cmd(self.state, self.generator)
        self.state.set_nodes_out_seq(self.nodes_out_seq)
        return self.state

    def encode(self, data) -> None:
        """Write data into encoder measurement angles (reference mbqc/pattern.py:78)."""
        if data is None:
            return
        if torch.is_tensor(data):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, np.float64).reshape(-1)
        if not self.reupload:
            if len(data) < self.ndata:
                raise ValueError('The pattern needs more data, or consider data re-uploading')
        if self.reupload and self.ndata > len(data):
            n = int(np.ceil(self.ndata / len(data)))
            data = np.concatenate([data] * n)
        count = 0
        for op in self.encoders:
            op.init_para(data[count:count + op.npara])
            count += op.npara

    def add_graph(self, nodes_state=None, state='plus', edges=None, nodes=None, index=None) -> None:
        self.init_state.add_subgraph(nodes_state=nodes_state, state=state, edges=edges,
                                     nodes=nodes, index=index)

    @property
    def graph(self) -> SubGraphState:
        if self.state is None:
            return self.init_state.graph
        return self.state.graph

    def set_nodes_out_seq(self, nodes=None) -> None:
        self.nodes_out_seq = nodes

    def add(self, op, encode: bool = False) -> None:
        self.commands.append(op)
        if encode:
            if op.requires_grad:
                raise ValueError('an encoded command takes its angle from data')
            self.encoders.append(op)
            self.ndata += op.npara
        else:
            self.npara += op.npara

    # command sugar (reference mbqc/pattern.py:158-195)
    def n(self, nodes) -> None:
        self.add(Node(nodes=nodes))

    def e(self, node1: int, node2: int) -> None:
        self.add(Entanglement(node1=node1, node2=node2))

    def m(self, node, angle: float = 0.0, plane: str = 'xy', t_domain=None, s_domain=None,
          encode: bool = False) -> None:
        requires_grad = not encode and angle is None
        self.add(Measurement(nodes=node, angle=angle, plane=plane, t_domain=t_domain,
                             s_domain=s_domain, requires_grad=requires_grad,
                             generator=self.generator), encode=encode)

    def x(self, node: int, domain=None) -> None:
        self.add(Correction(nodes=node, basis='x', domain=domain))

    def z(self, node: int, domain=None) -> None:
        self.add(Correction(nodes=node, basis='z', domain=domain))

    def is_standard(self) -> bool:
        """NEMC order check (reference mbqc/pattern.py:243)."""
        it = iter(self.commands)
        try:
            op = next(it)
            while isinstance(op, Node):
                op = next(it)
            while isinstance(op, Entanglement):
                op = next(it)
            while isinstance(op, Measurement):
                op = next(it)
            while isinstance(op, Correction):
                op = next(it)
            return False
        except StopIteration:
            return True

    def standardize(self) -> None:
        """Reorder commands into NEMC normal form by domain rewriting
        (reference mbqc/pattern.py:275, algorithm from arXiv:0704.1263 Ch.5.4).

        Adapted from Graphix (Copyright (c) 2022 Team Graphix, Apache-2.0),
        https://github.com/TeamGraphix/graphix/blob/0ca40c19/graphix/pattern.py#L287
        — the same upstream the reference credits; the rewrite rules leave
        little room for a structurally different implementation."""
        n_list, e_list, m_list = [], [], []
        z_dict, x_dict = {}, {}

        def add_domain(domain_dict, node, domain):
            if node in domain_dict:
                domain_dict[node] ^= domain
            else:
                domain_dict[node] = set(domain)

        for op in self.commands:
            if isinstance(op, Node):
                n_list.append(op)
            elif isinstance(op, Entanglement):
                for side in (0, 1):
                    s_domain = x_dict.get(op.nodes[side])
                    if s_domain:
                        add_domain(z_dict, op.nodes[1 - side], s_domain)
                e_list.append(op)
            elif isinstance(op, Measurement):
                new_op = copy(op)
                t_domain = z_dict.pop(op.nodes[0], None)
                if t_domain:
                    new_op.t_domain = new_op.t_domain ^ t_domain
                s_domain = x_dict.pop(op.nodes[0], None)
                if s_domain:
                    new_op.s_domain = new_op.s_domain ^ s_domain
                m_list.append(new_op)
            elif isinstance(op, Correction):
                if op.basis == 'z':
                    add_domain(z_dict, op.nodes[0], op.domain)
                elif op.basis == 'x':
                    add_domain(x_dict, op.nodes[0], op.domain)
        corrections = []
        for node, domain in x_dict.items():
            if domain:
                corrections.append(Correction(node, basis='x', domain=domain))
        for node, domain in z_dict.items():
            if domain:
                corrections.append(Correction(node, basis='z', domain=domain))
        self.commands = n_list + e_list + m_list + corrections

    def shift_signals(self) -> None:
        """Signal shifting: remove t-domains of XY measurements by pushing them
        forward (reference mbqc/pattern.py:348).

        Adapted from Graphix (Copyright (c) 2022 Team Graphix, Apache-2.0),
        https://github.com/TeamGraphix/graphix/blob/0ca40c19/graphix/pattern.py#L426
        — same upstream attribution the reference carries."""
        signal_dict = {}
        for op in self.commands:
            if isinstance(op, Measurement):
                if op.plane in ('xy', 'yx'):
                    # expand dependencies from previously shifted signals
                    expanded_s = set()
                    for s in op.s_domain:
                        expanded_s ^= signal_dict.get(s, {s})
                    expanded_t = set()
                    for t in op.t_domain:
                        expanded_t ^= signal_dict.get(t, {t})
                    op.s_domain = expanded_s
                    signal_dict[op.nodes[0]] = {op.nodes[0]} ^ expanded_t
                    op.t_domain = set()
            elif isinstance(op, Correction):
                expanded = set()
                for s in op.domain:
                    expanded ^= signal_dict.get(s, {s})
                op.domain = expanded

    def draw(self):
        """Draw the MBQC pattern (reference mbqc/pattern.py:196)."""
        plt = importlib.import_module('matplotlib.pyplot')
        nx = importlib.import_module('networkx')
        g = nx.MultiDiGraph(self.init_state.graph.graph)
        for i in list(g.nodes()):
            g.nodes[i]['layer'] = 0
        nodes_init = list(g.nodes())
        nodes_measured = []
        for op in self.commands:
            if isinstance(op, Node):
                g.add_nodes_from(op.nodes, layer=2)
            elif isinstance(op, Entanglement):
                g.add_edge(*op.nodes)
            elif isinstance(op, Measurement):
                nodes_measured.append(op.nodes[0])
                if op.nodes[0] not in nodes_init:
                    g.nodes[op.nodes[0]]['layer'] = 1
        pos = nx.multipartite_layout(g, subset_key='layer')
        nx.draw(g, pos, with_labels=True)
        plt.show()
