"""VQE on a transverse-field Ising chain.

H = -sum_i Z_i Z_{i+1} - g sum_i X_i (2n - 1 observables), minimised with
a hardware-efficient ansatz (ry, rz on every wire, a CNOT chain) by Adam.
At 14 <= n <= 19 a step runs on the card's window-chain kernels.

    python -m deepquantum_tpu_torch.examples.vqe
"""

from __future__ import annotations

import torch

from .. import QubitCircuit
from ..config import resolve_device
from . import adam_steps

N = 8
LAYERS = 3
G_FIELD = 1.0
LR = 0.05


def build(nqubit: int = N, layers: int = LAYERS, device=None) -> QubitCircuit:
    cir = QubitCircuit(nqubit, device=device)
    for _ in range(layers):
        for i in range(nqubit):
            cir.ry(i)
            cir.rz(i)
        for i in range(nqubit - 1):
            cir.cnot(i, i + 1)
    for i in range(nqubit - 1):
        cir.observable([[i], [i + 1]], basis='zz')
    for i in range(nqubit):
        cir.observable(i, basis='x')
    return cir


def energy(cir: QubitCircuit, params: torch.Tensor) -> torch.Tensor:
    ev = cir.expectation(params=params)
    n = cir.nqubit
    return -(ev[:n - 1].sum() + G_FIELD * ev[n - 1:].sum())


def main(nqubit: int = N, layers: int = LAYERS, steps: int = 200, device=None,
         seed: int | None = None) -> dict:
    """Adam from parameters drawn from ``seed``; the energies of every step
    and the last one (``final``)."""
    cir = build(nqubit, layers, resolve_device(device))
    cir.init_para(seed)
    params = cir.params.requires_grad_()
    energies = adam_steps(lambda: energy(cir, params), torch.optim.Adam([params], lr=LR), steps)
    for it in range(0, steps, 20):
        print(f'iter {it:4d}  E = {energies[it]:.6f}')
    print(f'final E = {energies[-1]:.6f}')
    return dict(energies=energies, final=energies[-1], params=params.detach())


if __name__ == '__main__':
    main()
