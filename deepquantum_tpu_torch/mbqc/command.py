"""MBQC commands: Node, Entanglement, Measurement, Correction.

PyTorch counterpart of ``deepquantum_tpu/mbqc/command.py``. Node and
Entanglement are graph bookkeeping. A Measurement materialises the owning
subgraph on its device, applies the adaptive-angle J projector to the
measured wire as a reshape and one contraction, draws the outcome from the
pattern's ``torch.Generator`` and keeps the projected branch; a Correction
applies its conditional X / Z byproduct the same way. Outcomes stay on the
device as 0-dim tensors, and the adaptive angles and corrections are
computed from them there, so a pattern run never waits for the card. The
domain algebra (the s / t sign rules per plane) is the standard MBQC
calculus, term for term the JAX package's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import cdtype, rdtype
from ..ops import gates as G
from .state import GraphState

__all__ = ['Command', 'Node', 'Entanglement', 'Measurement', 'Correction']


def _apply_1q(state: torch.Tensor, mat: torch.Tensor, wire: int) -> torch.Tensor:
    """A 2 x 2 matrix on one wire of a flat state: (2^wire, 2, rest)."""
    x = state.reshape(1 << wire, 2, -1)
    return torch.einsum('ab,ibj->iaj', mat.to(x.dtype), x)


def _signal(measure_dict, domain, device) -> torch.Tensor:
    """The sum of the last outcomes of the nodes in ``domain`` (each 0 for
    a node not measured yet), as a real tensor on the device."""
    bits = [measure_dict[v][-1] for v in domain if measure_dict[v]]
    if not bits:
        return torch.zeros((), dtype=rdtype(), device=device)
    return torch.stack(bits).sum().to(rdtype())


def _uniform(generator: torch.Generator | None, device) -> torch.Tensor:
    """One uniform draw in [0, 1) on ``device``, from ``generator`` (drawn
    where the generator lives) or, without one, torch's default one."""
    where = device if generator is None else generator.device
    return torch.rand((), generator=generator, device=where, dtype=torch.float64).to(device)


class Command:
    """A pattern command acting on a GraphState."""

    def __init__(self, name: str, nodes) -> None:
        self.name = name
        if isinstance(nodes, int):
            nodes = [nodes]
        self.nodes = list(nodes)
        self.npara = 0
        self.requires_grad = False

    def __call__(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        return self.forward(x, generator)

    def forward(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        return x

    def __repr__(self):
        return f'{self.name}(nodes={self.nodes})'


class Node(Command):
    """Add |+> node(s), each as a subgraph of its own."""

    def __init__(self, nodes) -> None:
        super().__init__('Node', nodes)

    def forward(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        existing = x.node_set()
        for node in self.nodes:
            if node in existing:
                raise ValueError(f'Node {node} already exists')
            x.add_subgraph(nodes=node)
        return x


class Entanglement(Command):
    """A CZ edge between two nodes, merging their subgraphs when apart."""

    def __init__(self, node1: int, node2: int) -> None:
        super().__init__('Entanglement', [node1, node2])

    def forward(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        idx1 = x.find_subgraph(self.nodes[0])
        idx2 = x.find_subgraph(self.nodes[1])
        if idx1 < 0 or idx2 < 0:
            raise ValueError(f'Nodes {self.nodes} not found')
        if idx1 == idx2:
            x.subgraphs[idx1].add_edges([(self.nodes[0], self.nodes[1])])
        else:
            subgraph = x.subgraphs[idx1].compose(x.subgraphs[idx2])
            subgraph.add_edges([(self.nodes[0], self.nodes[1])])
            for i in sorted([idx1, idx2], reverse=True):
                x.subgraphs.pop(i)
            x.subgraphs.insert(0, subgraph)
        return x


class Measurement(Command):
    """An adaptive projective measurement in the XY, YZ or XZ plane, its
    angle flipped and shifted by the outcomes of its s and t domains."""

    def __init__(self, nodes, angle: Any = 0.0, plane: str = 'xy', s_domain=None,
                 t_domain=None, requires_grad: bool = False,
                 generator: torch.Generator | None = None) -> None:
        super().__init__('Measurement', nodes)
        self.plane = plane.lower()
        if self.plane not in ('xy', 'yx', 'zx', 'xz', 'yz', 'zy'):
            raise ValueError(f'Unsupported plane {plane}')
        if s_domain is None:
            s_domain = []
        elif isinstance(s_domain, int):
            s_domain = [s_domain]
        if t_domain is None:
            t_domain = []
        elif isinstance(t_domain, int):
            t_domain = [t_domain]
        self.s_domain = set(s_domain)
        self.t_domain = set(t_domain)
        self.requires_grad = requires_grad
        self.enc_sign = 1.0      # the sign of encoded data (-1 for the Rx / Ry / Rz templates)
        self.init_para(angle, generator)
        self.npara = 1

    def init_para(self, angle: Any = None, generator: torch.Generator | None = None) -> None:
        """Set the angle (times ``enc_sign``); None draws it uniformly in
        [0, 2 pi) from ``generator``."""
        while isinstance(angle, (list, tuple)):
            angle = angle[0]
        if angle is None:
            angle = float(_uniform(generator, 'cpu' if generator is None else generator.device)
                          .item()) * 2 * np.pi
        elif torch.is_tensor(angle):
            angle = float(angle.detach().reshape(-1)[0].item())
        else:
            angle = float(np.asarray(angle, np.float64).reshape(-1)[0])
        self.angle = getattr(self, 'enc_sign', 1.0) * angle

    def forward(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        node = self.nodes[0]
        idx = x.find_subgraph(node)
        if idx < 0:
            raise ValueError(f'Node {node} not found')
        sgs = x.subgraphs[idx]
        init_state = sgs.full_state.reshape(-1)
        device = init_state.device
        wire = sgs.node2wire_dict[node]
        qs = _signal(sgs.measure_dict, self.s_domain, device)
        qt = _signal(sgs.measure_dict, self.t_domain, device)
        if self.plane in ('xy', 'yx'):
            alpha = (1 - 2 * torch.remainder(qs, 2)) * self.angle + np.pi * qt
        elif self.plane in ('zx', 'xz'):
            alpha = (1 - 2 * torch.remainder(qs + qt, 2)) * self.angle + np.pi * qs
        else:
            alpha = (1 - 2 * torch.remainder(qt, 2)) * self.angle + np.pi * (qs + qt)
        final = _apply_1q(init_state, G.projection_j_matrix(alpha, self.plane), wire)
        prob = (final.real ** 2 + final.imag ** 2).sum(dim=(0, 2))
        p1 = prob[1] / prob.sum().clamp_min(1e-300)
        bit = (_uniform(generator, device) < p1).long()
        state = final.index_select(1, bit.reshape(1)).reshape(-1)
        sgs.measure_dict[node].append(bit)
        nodes_state = sorted(sgs.nodes)
        nodes_state.remove(node)
        x.subgraphs.pop(idx)
        # the subgraph's state normalises the kept branch
        x.add_subgraph(nodes_state=nodes_state, state=state, measure_dict=sgs.measure_dict,
                       index=0)
        return x

    def __repr__(self):
        return (f'Measurement(nodes={self.nodes}, plane={self.plane.upper()}, '
                f'angle={self.angle}, s_domain={self.s_domain}, t_domain={self.t_domain})')


class Correction(Command):
    """A conditional X or Z byproduct: applied where the outcomes of its
    domain sum to an odd number."""

    def __init__(self, nodes, basis: str = 'x', domain=None) -> None:
        super().__init__('Correction', nodes)
        self.basis = basis.lower()
        if self.basis not in ('x', 'z'):
            raise ValueError(f'Invalid basis {basis}')
        if domain is None:
            domain = []
        elif isinstance(domain, int):
            domain = [domain]
        self.domain = set(domain)

    def forward(self, x: GraphState, generator: torch.Generator | None = None) -> GraphState:
        node = self.nodes[0]
        idx = x.find_subgraph(node)
        if idx < 0:
            raise ValueError(f'Node {node} not found')
        sgs = x.subgraphs[idx]
        init_state = sgs.full_state.reshape(-1)
        wire = sgs.node2wire_dict[node]
        half = np.pi / 2 * _signal(sgs.measure_dict, self.domain, init_state.device)
        c, s = torch.cos(half).to(cdtype()), torch.sin(half).to(cdtype())
        if self.basis == 'x':
            mat = torch.stack([c, -1j * s, -1j * s, c]).reshape(2, 2)   # global phase irrelevant
        else:
            zero = torch.zeros_like(c)
            mat = torch.stack([c - 1j * s, zero, zero, c + 1j * s]).reshape(2, 2)
        state = _apply_1q(init_state, mat, wire)
        x.subgraphs.pop(idx)
        x.add_subgraph(nodes_state=sorted(sgs.nodes), state=state.reshape(-1),
                       measure_dict=sgs.measure_dict, index=0)
        return x

    def __repr__(self):
        return f'Correction(nodes={self.nodes}, basis={self.basis}, domain={self.domain})'
