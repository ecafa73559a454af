"""Text drawing of qubit circuits.

PyTorch counterpart of ``deepquantum_tpu/draw.py``: a dependency-free ASCII
rendering of the op list, character for character the JAX package's for
the same circuit.
"""

from __future__ import annotations

import numpy as np

__all__ = ['draw_circuit_text']

_SHORT = {
    'Hadamard': 'H', 'PauliX': 'X', 'PauliY': 'Y', 'PauliZ': 'Z', 'SGate': 'S',
    'SDaggerGate': 'S+', 'TGate': 'T', 'TDaggerGate': 'T+', 'Rx': 'RX', 'Ry': 'RY',
    'Rz': 'RZ', 'PhaseShift': 'P', 'U3Gate': 'U3', 'CNOT': 'CX', 'Swap': 'SW',
    'ImaginarySwap': 'iSW', 'Toffoli': 'CCX', 'Fredkin': 'CSW', 'Rxx': 'RXX',
    'Ryy': 'RYY', 'Rzz': 'RZZ', 'Rxy': 'RXY', 'Barrier': '|',
}


def draw_circuit_text(cir) -> str:
    """ASCII rendering of a QubitCircuit."""
    n = cir.nqubit
    cols: list[list[str]] = []
    depth = np.zeros(n, np.int64)
    grid: dict[tuple[int, int], str] = {}
    for op in cir.operators:
        wires = list(op.controls) + list(op.wires)
        if not wires:
            continue
        col = int(max(depth[w] for w in wires))
        label = _SHORT.get(op.name, op.name[:3].upper())
        for w in op.controls:
            grid[(w, col)] = '*'
        for w in op.wires:
            grid[(w, col)] = label
        span = range(min(wires), max(wires) + 1)
        for w in span:
            if (w, col) not in grid:
                grid[(w, col)] = '|'
            depth[w] = col + 1
    ncol = int(depth.max()) if len(cir.operators) else 0
    lines = []
    for q in range(n):
        cells = []
        for c in range(ncol):
            cell = grid.get((q, c), '-')
            cells.append(f'{cell:-^5}')
        lines.append(f'q{q}: ' + '-'.join(cells))
    return '\n'.join(lines)
