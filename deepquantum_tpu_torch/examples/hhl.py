"""HHL linear-system solver.

Solves A x = b for a Hermitian 2 x 2 system with the HHL ansatz (QPE,
controlled eigenvalue-inversion rotations, inverse QPE) and compares the
post-selected solution's distribution with numpy.linalg.solve's.

    python -m deepquantum_tpu_torch.examples.hhl
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import cdtype, resolve_device
from ..models.ansatz import HHL

# t0 makes the counting register resolve the eigenvalues (4/3, 2/3) exactly
A = np.array([[1.0, -1 / 3], [-1 / 3, 1.0]])
B = np.array([0.0, 1.0])
NCOUNT = 3                       # QPE counting register width
T0 = 3 / 4


def main(device=None) -> dict:
    """|b> in the target register (the last qubit), ancilla and counting
    register in |0>; post-select ancilla |1> and counting |0...0>. Returns
    the state, the two distributions and their (Bhattacharyya) fidelity,
    asserted > 0.995."""
    dev = resolve_device(device)
    cir = HHL(ncount=NCOUNT, mat=A, t0=T0, device=dev)
    init = torch.zeros(2 ** cir.nqubit, dtype=cdtype(), device=dev)
    init[0], init[1] = float(B[0]), float(B[1])
    with torch.no_grad():
        state = cir(state=init).reshape(-1)
    base = 1 << (NCOUNT + 1)          # |1, 0...0, x>
    p_q = (state[base:base + 2].abs() ** 2).double().cpu().numpy()
    p_q = p_q / p_q.sum()
    x_ref = np.linalg.solve(A, B)
    p_ref = x_ref ** 2 / np.sum(x_ref ** 2)
    # the eigenvalue inversion leaves phases on the counting register, so
    # the distributions are compared (classical fidelity)
    fidelity = float(np.sum(np.sqrt(p_q * p_ref)) ** 2)
    print(f'HHL |solution|^2 (normalized): {p_q}')
    print(f'Classical solution probs     : {p_ref}')
    print(f'distribution fidelity = {fidelity:.6f}')
    assert fidelity > 0.995, fidelity
    print('PASS')
    return dict(state=state, p_q=p_q, p_ref=p_ref, fidelity=fidelity)


if __name__ == '__main__':
    main()
