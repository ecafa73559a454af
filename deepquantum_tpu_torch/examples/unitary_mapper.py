"""Map qubit gates onto linear-optical unitaries.

``UnitaryMapper`` solves <out_i| U_optical |in_j> = success * U_gate[i, j]
over dual-rail basis states: a Hadamard on 2 modes (success 1: a beam
splitter) and the post-selected CNOT on 6 modes with 2 vacuum ancillas at
success 1/3. Each solution is checked by rebuilding its transfer matrix
from permanents; solutions are cached on disk for repeat solves. The
mapper runs on the host (numpy and scipy).

    python -m deepquantum_tpu_torch.examples.unitary_mapper
"""

from __future__ import annotations

import numpy as np

from ..config import resolve_device
from ..photonic.mapper import UnitaryMapper

HADAMARD = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
CNOT = np.eye(4)[[0, 1, 3, 2]]


def main(device=None) -> dict:
    """Solve both gates; their transfer matrices must match the gates'
    moduli (Hadamard to 1e-5, CNOT / 3 to 1e-4). Returns the unitaries
    and transfer matrices."""
    resolve_device(device)
    mapper = UnitaryMapper(nqubit=1, nmode=2, ugate=HADAMARD, success=1.0)
    sols = mapper.solve_eqs_real(total_trials=5)
    assert sols, 'no Hadamard solution found'
    h_u = sols[0]
    assert mapper.is_unitary(h_u)
    h_transfer = mapper.get_transfer_mat(h_u)
    np.testing.assert_allclose(np.abs(h_transfer), np.abs(HADAMARD), atol=1e-5)
    print('Hadamard -> 2-mode optical unitary:')
    print(np.round(h_u, 4))
    mapper = UnitaryMapper(nqubit=2, nmode=6, ugate=CNOT, success=1 / 3, aux=[0, 0],
                           aux_pos=[4, 5])
    sols = mapper.solve_eqs_real(total_trials=5)
    assert sols, 'no CNOT solution found'
    cnot_u = sols[0]
    assert mapper.is_unitary(cnot_u)
    cnot_transfer = mapper.get_transfer_mat(cnot_u)
    np.testing.assert_allclose(np.abs(cnot_transfer), np.abs(CNOT) / 3, atol=1e-4)
    print('\npost-selected CNOT transfer matrix (success 1/3):')
    print(np.round(np.real_if_close(cnot_transfer), 4))
    print('PASS')
    return dict(h_unitary=h_u, h_transfer=h_transfer, cnot_unitary=cnot_u,
                cnot_transfer=cnot_transfer)


if __name__ == '__main__':
    main()
