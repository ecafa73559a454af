"""Basic gates in the measurement-based model.

Three views of one computation: a Hadamard as a hand-written two-node
N / E / M / X teleportation pattern, an RZ(theta) teleportation pattern
(measurement angle -theta), and a small circuit (H, CNOT, rotations)
transpiled to a pattern by ``QubitCircuit.pattern()`` and held to its
statevector. Measurement outcomes are drawn on the device from
``generator``; the corrections make the output the same for any draw.

    python -m deepquantum_tpu_torch.examples.mbqc_basic_gates
"""

from __future__ import annotations

import numpy as np
import torch

from .. import QubitCircuit
from ..config import resolve_device
from ..mbqc import Pattern

THETA = 0.7


def overlap(a, b) -> float:
    a = torch.as_tensor(a).reshape(-1).to(torch.complex128).cpu()
    b = torch.as_tensor(b).reshape(-1).to(torch.complex128).cpu()
    return float(torch.vdot(a, b).abs() / (a.norm() * b.norm()))


def teleport(state: str, angle: float, device, generator):
    """The output of N(1) E(0, 1) M(0, angle) X(1, domain 0) on node 0
    prepared in ``state``."""
    pattern = Pattern(nodes_state=[0], state=state, device=device, generator=generator)
    pattern.n(1)
    pattern.e(0, 1)
    pattern.m(0, angle=angle)
    pattern.x(1, domain=0)
    return pattern().full_state.reshape(-1)


def circuit(device=None) -> QubitCircuit:
    cir = QubitCircuit(2, device=device)
    cir.h(0)
    cir.rx(1, inputs=0.3)
    cir.cnot(0, 1)
    cir.rz(0, inputs=1.1)
    return cir


def main(generator: torch.Generator | None = None, device=None) -> dict:
    """The three checks, each output's overlap with its target > 1 - 1e-6;
    outcomes from ``generator`` (default: one on the device seeded with
    0). Returns the three output states and overlaps."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    h_state = teleport('zero', 0.0, dev, generator)
    h_overlap = overlap(h_state, np.array([1, 1]) / np.sqrt(2))
    assert h_overlap > 1 - 1e-6, h_overlap
    print('H |0> -> |+> via 2-node teleportation: OK')
    j_state = teleport('plus', -THETA, dev, generator)
    # J(theta) = H RZ(theta); on |+>: H (|0> + e^{i theta} |1>) / sqrt(2)
    expected = np.array([1 + np.exp(1j * THETA), 1 - np.exp(1j * THETA)]) / 2
    j_overlap = overlap(j_state, expected)
    assert j_overlap > 1 - 1e-6, j_overlap
    print(f'J({THETA}) teleportation pattern: OK')
    cir = circuit(dev)
    with torch.no_grad():
        target = cir().reshape(-1)
    pat = cir.pattern(generator=generator)
    pat.standardize()
    pat.shift_signals()
    state = pat().full_state.reshape(-1)
    fid = overlap(state, target)
    print(f'transpiled pattern vs statevector overlap = {fid:.8f}')
    assert fid > 1 - 1e-6, fid
    print('PASS')
    return dict(h_state=h_state, h_overlap=h_overlap, j_state=j_state, j_overlap=j_overlap,
                pattern_state=state, target=target, overlap=fid)


if __name__ == '__main__':
    main()
