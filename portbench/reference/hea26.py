"""Plain reference of ``hea26``: DeepQuantum's gradient-benchmark ansatz
(rx, rz, rx on every wire, then a CNOT ring, per layer) and the
expectation of X on every wire, with Adam on its parameters."""

from __future__ import annotations

import torch

from portbench.reference.statevector import Sim, adam


def circuit(cfg: dict, params: torch.Tensor) -> list:
    """The ops of the ansatz with the angles ``params`` (P,), in the order
    the configuration adds its gates."""
    n, ops, i = cfg['nqubit'], [], 0
    for _ in range(cfg['layers']):
        for q in range(n):
            for gate in cfg['rotations']:
                ops.append((gate, (q,), params[i]))
                i += 1
        ops.extend(('cnot', (q, (q + 1) % n), None) for q in range(n))
    return ops


def evaluate(cfg: dict, inputs: dict, drawn: dict, precision: str = 'float64'):
    """<X...X> of the circuit at the evaluation's parameters, (1,)."""
    sim, params = Sim(precision), drawn['params']
    n = cfg['nqubit']
    psi = sim.forward(circuit(cfg, params), n, 1, params.device)
    return sim.expectation(psi, n, 'x_string')[0]


def train(cfg: dict, traffic: dict, inputs: dict, steps: int, precision: str = 'float64'):
    """``steps`` Adam updates of the parameters from ``inputs['params']``,
    the loss <X...X> itself. Returns each step's loss, the first step's
    gradient, each parameter's least |gradient| over the steps and the
    change of the parameters after all the steps."""
    sim = Sim(precision)
    n = cfg['nqubit']
    p = inputs['params'].to(sim.real).clone()
    p0, state, losses, first, least = p.clone(), {}, [], None, None
    for _ in range(steps):
        vals, grads = sim.value_and_grad(circuit(cfg, p), n, 1, 'x_string', torch.ones_like,
                                         p.device)
        g = torch.stack([x for x in grads if x is not None])
        losses.append(float(vals[0]))
        first = g.clone() if first is None else first
        least = g.abs() if least is None else torch.minimum(least, g.abs())
        adam([p], [g], state, traffic['lr'])
    return dict(losses=losses, grads={'params': first}, least={'params': least},
                deltas={'params': p - p0})
