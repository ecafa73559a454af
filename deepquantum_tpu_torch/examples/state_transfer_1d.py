"""Perfect quantum state transfer on a 1D spin chain.

An XY chain with the couplings J_i = sqrt(i (N - i)) carries the first
qubit's state to the last qubit at t = pi / 2. exp(-i H t), H = sum_i J_i
(XX + YY) / 2, is Trotterised into rxx / ryy gates; the transfer is held
to the input state. The excitation picks up the phase (-i)^(N - 1), and
the overlap below sees the relative phase of |0> and |1>, so its bar
holds for N = 1 (mod 4); the leak needs enough Trotter steps (17 qubits:
1400). At 14 <= N <= 19 the forward runs on the card's window-chain
kernel.

    python -m deepquantum_tpu_torch.examples.state_transfer_1d
"""

from __future__ import annotations

import numpy as np
import torch

from .. import QubitCircuit
from ..config import cdtype, resolve_device

N = 5
STEPS = 200                       # Trotter steps
T = np.pi / 2
ALPHA, BETA = 0.6, 0.8j           # the input state on qubit 0


def couplings(nqubit: int) -> list[float]:
    return [float(np.sqrt((i + 1) * (nqubit - 1 - i))) for i in range(nqubit - 1)]


def build(nqubit: int = N, steps: int = STEPS, device=None) -> QubitCircuit:
    j = couplings(nqubit)
    dt = T / steps
    cir = QubitCircuit(nqubit, device=device)
    for _ in range(steps):
        for i in range(nqubit - 1):
            # exp(-i J dt (XX + YY) / 2): rxx / ryy are exp(-i theta XX / 2)
            cir.rxx([i, i + 1], inputs=j[i] * dt)
            cir.ryy([i, i + 1], inputs=j[i] * dt)
    return cir


def initial_state(nqubit: int, alpha: complex, beta: complex) -> np.ndarray:
    """alpha |0...0> + beta |1 0...0> (qubit 0 leftmost)."""
    init = np.zeros(2 ** nqubit, dtype=np.complex128)
    init[0] = alpha
    init[1 << (nqubit - 1)] = beta
    return init


def main(nqubit: int = N, steps: int = STEPS, device=None) -> dict:
    """Transfer ALPHA |0> + BETA |1> from qubit 0 to qubit N - 1. Returns
    the final state, the population outside the target qubit (``leak``)
    and the transfer fidelity up to a global phase; asserts leak < 1e-3
    and fidelity > 0.999."""
    dev = resolve_device(device)
    cir = build(nqubit, steps, dev)
    init = torch.as_tensor(initial_state(nqubit, ALPHA, BETA)).to(device=dev, dtype=cdtype())
    with torch.no_grad():
        state = cir(state=init).reshape(-1)
    out = state[:2].cpu().numpy().astype(np.complex128)   # |0...0 0>, |0...0 1>
    leak = float(1.0 - np.sum(np.abs(out) ** 2))
    psi_in = np.array([ALPHA, BETA], dtype=np.complex128)
    fid = float(abs(np.vdot(psi_in / np.linalg.norm(psi_in), out / np.linalg.norm(out))))
    print(f'couplings J = {np.round(couplings(nqubit), 3)}')
    print(f'population outside the target qubit: {leak:.2e}')
    print(f'transfer fidelity (up to phase)    : {fid:.6f}')
    assert leak < 1e-3 and fid > 0.999, (leak, fid)
    print('PASS')
    return dict(state=state, leak=leak, fidelity=fid)


if __name__ == '__main__':
    main()
