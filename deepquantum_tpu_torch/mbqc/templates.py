"""Per-gate MBQC pattern templates.

PyTorch counterpart of ``deepquantum_tpu/mbqc/templates.py``, the same
commands, angles and domains. Each template maps (nodes, ancilla[, angle])
to a command list, the output nodes that replace the input wires, and the
indices of its data-encoded commands.
"""

from __future__ import annotations

import numpy as np

from .command import Correction, Entanglement, Measurement, Node

__all__ = ['MBQC_TEMPLATES', 'NANCILLA']

PI = np.pi


def _one(nodes):
    return nodes[0] if isinstance(nodes, (list, tuple)) else nodes


def pauli_x(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:855)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(n),
        Measurement(ancilla[0], angle=-PI),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=n),
    ]
    return cmds, [ancilla[1]], []


def pauli_y(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:930)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Entanglement(ancilla[1], ancilla[2]),
        Entanglement(ancilla[2], ancilla[3]),
        Measurement(n, angle=PI / 2),
        Measurement(ancilla[0], angle=PI, s_domain=n),
        Measurement(ancilla[1], angle=-PI / 2, s_domain=n),
        Measurement(ancilla[2]),
        Correction(ancilla[3], basis='x', domain=[ancilla[0], ancilla[2]]),
        Correction(ancilla[3], basis='z', domain=[ancilla[0], ancilla[1]]),
    ]
    return cmds, [ancilla[3]], []


def pauli_z(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1007)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(n, angle=-PI),
        Measurement(ancilla[0]),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=n),
    ]
    return cmds, [ancilla[1]], []


def hadamard(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1083)"""
    n = _one(nodes)
    a = ancilla[0] if isinstance(ancilla, (list, tuple)) else ancilla
    cmds = [
        Node([a]),
        Entanglement(n, a),
        Measurement(n),
        Correction(a, basis='x', domain=n),
    ]
    return cmds, [a], []


def s_gate(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1171)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(n, angle=-PI / 2),
        Measurement(ancilla[0]),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=n),
    ]
    return cmds, [ancilla[1]], []


def rx(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1461)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(n),
        Measurement(ancilla[0], angle=None if angle is None else -angle,
                    s_domain=n, requires_grad=requires_grad),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=n),
    ]
    cmds[4].enc_sign = -1.0
    return cmds, [ancilla[1]], [4]


def ry(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1556)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Entanglement(ancilla[1], ancilla[2]),
        Entanglement(ancilla[2], ancilla[3]),
        Measurement(n, angle=PI / 2),
        Measurement(ancilla[0], angle=None if angle is None else -angle,
                    s_domain=n, requires_grad=requires_grad),
        Measurement(ancilla[1], angle=-PI / 2, s_domain=n),
        Measurement(ancilla[2]),
        Correction(ancilla[3], basis='x', domain=[ancilla[0], ancilla[2]]),
        Correction(ancilla[3], basis='z', domain=[ancilla[0], ancilla[1]]),
    ]
    cmds[6].enc_sign = -1.0
    return cmds, [ancilla[3]], [6]


def rz(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1652)"""
    n = _one(nodes)
    cmds = [
        Node(ancilla),
        Entanglement(n, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(n, angle=None if angle is None else -angle, requires_grad=requires_grad),
        Measurement(ancilla[0]),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=n),
    ]
    cmds[3].enc_sign = -1.0
    return cmds, [ancilla[1]], [3]


def cnot(nodes, ancilla, angle=None, requires_grad=False):
    """(reference gate.py:1941)"""
    control, target = nodes
    cmds = [
        Node(ancilla),
        Entanglement(target, ancilla[0]),
        Entanglement(control, ancilla[0]),
        Entanglement(ancilla[0], ancilla[1]),
        Measurement(target),
        Measurement(ancilla[0]),
        Correction(ancilla[1], basis='x', domain=ancilla[0]),
        Correction(ancilla[1], basis='z', domain=target),
        Correction(control, basis='z', domain=target),
    ]
    return cmds, [control, ancilla[1]], []


def toffoli(nodes, ancilla, angle=None, requires_grad=False):
    """18-ancilla Toffoli pattern (reference gate.py:2560)."""
    c1, c2, t = nodes
    a = ancilla
    cmds = [
        Node(a),
        Entanglement(t, a[0]),
        Entanglement(a[0], a[1]),
        Entanglement(a[1], a[2]),
        Entanglement(a[1], c2),
        Entanglement(c1, a[14]),
        Entanglement(a[2], a[3]),
        Entanglement(a[14], a[4]),
        Entanglement(a[3], a[5]),
        Entanglement(a[3], a[4]),
        Entanglement(a[5], a[6]),
        Entanglement(c2, a[6]),
        Entanglement(c2, a[9]),
        Entanglement(a[6], a[7]),
        Entanglement(a[9], a[4]),
        Entanglement(a[9], a[10]),
        Entanglement(a[7], a[8]),
        Entanglement(a[10], a[11]),
        Entanglement(a[4], a[8]),
        Entanglement(a[4], a[11]),
        Entanglement(a[4], a[16]),
        Entanglement(a[8], a[12]),
        Entanglement(a[11], a[15]),
        Entanglement(a[12], a[13]),
        Entanglement(a[16], a[17]),
        Measurement(t),
        Measurement(a[0], s_domain=t),
        Measurement(a[1], s_domain=a[0]),
        Measurement(c1),
        Measurement(a[2], angle=-PI * 7 / 4, s_domain=[a[1], t]),
        Measurement(a[14], s_domain=c1),
        Measurement(a[3], s_domain=[a[2], a[0]]),
        Measurement(a[5], angle=-PI / 4, s_domain=[a[3], a[1], a[14], t]),
        Measurement(c2, angle=-PI / 4),
        Measurement(a[6], s_domain=[a[5], a[2], a[0]]),
        Measurement(a[9], s_domain=[c2, a[5], a[2]]),
        Measurement(a[7], angle=-PI * 7 / 4, s_domain=[a[6], a[3], a[1], a[14], t]),
        Measurement(a[10], angle=-PI * 7 / 4, s_domain=[a[9], a[14]]),
        Measurement(a[4], angle=-PI / 4, s_domain=a[14]),
        Measurement(a[8], s_domain=[a[7], a[5], a[2], a[0]]),
        Measurement(a[11], s_domain=[a[10], c2, a[5], a[2]]),
        Measurement(a[12], angle=-PI / 4, s_domain=[a[8], a[6], a[3], a[1], t]),
        Measurement(a[16], s_domain=[a[4], c1, a[2], c2, a[7], a[10], a[2], c2, a[5]]),
        Correction(a[17], basis='x', domain=[a[14], a[16]]),
        Correction(a[15], basis='x', domain=[a[9], a[11]]),
        Correction(a[13], basis='x', domain=[a[0], a[2], a[5], a[7], a[12]]),
        Correction(a[17], basis='z', domain=[a[4], a[5], a[7], a[10], c1]),
        Correction(a[15], basis='z', domain=[c2, a[2], a[5], a[10]]),
        Correction(a[13], basis='z', domain=[a[1], a[3], a[6], a[8], t]),
    ]
    return cmds, [a[17], a[15], a[13]], []


def barrier(nodes, ancilla, angle=None, requires_grad=False):
    return [], list(nodes), []


# gate name -> (template fn, nancilla)
MBQC_TEMPLATES = {
    'PauliX': (pauli_x, 2),
    'PauliY': (pauli_y, 4),
    'PauliZ': (pauli_z, 2),
    'Hadamard': (hadamard, 1),
    'SGate': (s_gate, 2),
    'Rx': (rx, 2),
    'Ry': (ry, 4),
    'Rz': (rz, 2),
    'CNOT': (cnot, 2),
    'Toffoli': (toffoli, 18),
    'Barrier': (barrier, 0),
}

NANCILLA = {k: v[1] for k, v in MBQC_TEMPLATES.items()}
