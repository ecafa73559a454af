"""Gradient-free on-chip optimisation of a photonic interferometer.

A physical photonic chip gives no gradients, only measured probabilities.
SPSA and Fourier-series optimizers tune the phase shifters of a triangular
MZI mesh to send the input photons into a target output pattern, from
forward evaluations of the circuit alone: each evaluation builds the mesh,
runs it in the Fock basis (every outcome's permanent in one kernel launch
on the card) and takes the target's amplitude (one more permanent).

    python -m deepquantum_tpu_torch.examples.onchip_optimizer
"""

from __future__ import annotations

import numpy as np

from ..config import resolve_device
from ..optimizer import OptimizerFourier, OptimizerSPSA
from ..photonic import QumodeCircuit

NMODE = 4
TARGET = 2            # the script's demo: |1,0,0,0> -> the photon in mode 2
X0 = 0.3              # every phase's start
FOURIER_ORDER, FOURIER_LR = 3, 0.3


def build(phases, nmode: int, init_state, cutoff: int, device=None) -> QumodeCircuit:
    """A triangular mesh of nmode (nmode - 1) / 2 MZIs, two phases each."""
    cir = QumodeCircuit(nmode=nmode, init_state=list(init_state), cutoff=cutoff,
                        backend='fock', basis=True, device=device)
    k = 0
    for i in range(nmode - 1):
        for j in range(nmode - 1 - i):
            cir.mzi([j, j + 1], inputs=[phases[k], phases[k + 1]])
            k += 2
    return cir


def objective(nmode: int, init_state, target_state, cutoff: int, device=None):
    """phases -> minus the probability of ``target_state``, as a float."""
    def neg_target_prob(phases) -> float:
        cir = build(np.asarray(phases, dtype=float).reshape(-1), nmode, init_state, cutoff,
                    device)
        cir()
        return -float(cir.get_amplitude(list(target_state)).abs() ** 2)
    return neg_target_prob


def main(nmode: int = NMODE, init_state=None, target_state=None, cutoff: int = 2,
         spsa_steps: int = 300, fourier_steps: int = 6, random_state: int = 0, device=None,
         bar: float | None = 0.9) -> dict:
    """Start every phase at X0; run SPSA (its draws from
    ``numpy.random.default_rng(random_state)``) and the Fourier optimizer
    (0 steps skips one). ``init_state`` defaults to one photon in mode 0,
    ``target_state`` to that photon in mode 2. Returns each optimizer's
    best target probability and parameters; asserts the better one is
    above ``bar`` (None: no assertion)."""
    dev = resolve_device(device)
    if init_state is None:
        init_state = [1] + [0] * (nmode - 1)
    if target_state is None:
        target_state = [0] * TARGET + [1] + [0] * (nmode - 1 - TARGET)
    neg_target_prob = objective(nmode, init_state, target_state, cutoff, dev)
    start = np.full(nmode * (nmode - 1), X0)
    initial = -neg_target_prob(start)
    print(f'initial target-mode probability: {initial:.4f}')
    spsa = OptimizerSPSA(neg_target_prob, start, random_state=random_state)
    # the default hyperparameters suit ~2000-step budgets; a shorter decay here
    spsa.set_hyperparam({'a': 0.5, 'c': 0.05, 'A': 20, 'nepoch': spsa_steps,
                         'alpha': 0.602, 'gamma': 0.101})
    fourier = OptimizerFourier(neg_target_prob, start, order=FOURIER_ORDER, lr=FOURIER_LR)
    results, best_params = {}, {}
    for name, opt, nstep in (('SPSA', spsa, spsa_steps), ('Fourier', fourier, fourier_steps)):
        if not nstep:
            continue
        best_params[name] = np.asarray(opt.run(nstep, if_print=False))
        results[name] = -neg_target_prob(best_params[name])
        print(f'{name}: target-mode probability after {nstep} steps = {results[name]:.4f}')
    if bar is not None:
        assert max(results.values()) > bar, results
        print('PASS')
    return dict(initial=initial, results=results, best_params=best_params)


if __name__ == '__main__':
    main()
