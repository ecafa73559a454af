"""QAOA for MaxCut on a random 3-regular graph.

P layers of rzz on every edge and rx on every wire after a Hadamard layer,
one trainable angle per gate; Adam minimises sum <Z_a Z_b> over the edges,
then the trained state is sampled. At 14 <= n <= 19 a step runs on the
card's window-chain kernels.

    python -m deepquantum_tpu_torch.examples.qaoa
"""

from __future__ import annotations

import numpy as np
import torch

from .. import QubitCircuit
from ..config import resolve_device
from . import adam_steps

N = 6
P_LAYERS = 3
GRAPH_SEED = 7
LR = 0.1
# networkx.random_regular_graph(3, 6, seed=7).edges, the JAX script's graph
EDGES_6 = [(0, 1), (0, 2), (0, 5), (1, 5), (1, 4), (2, 4), (2, 3), (3, 4), (3, 5)]


def regular_graph(nqubit: int, seed: int = GRAPH_SEED, degree: int = 3) -> list[tuple]:
    """The edges of a random ``degree``-regular graph on ``nqubit`` nodes:
    the script's graph at (6, 7), else the pairing model (every node's
    stubs shuffled and paired) from ``numpy.random.default_rng(seed)``,
    drawn again until no pair is a loop or a repeated edge."""
    if (nqubit, seed, degree) == (N, GRAPH_SEED, 3):
        return list(EDGES_6)
    if nqubit * degree % 2 or degree >= nqubit:
        raise ValueError(f'no {degree}-regular graph on {nqubit} nodes')
    rng = np.random.default_rng(seed)
    while True:
        stubs = np.repeat(np.arange(nqubit), degree)
        rng.shuffle(stubs)
        pairs = [tuple(sorted(p)) for p in stubs.reshape(-1, 2).tolist()]
        if all(a != b for a, b in pairs) and len(set(pairs)) == len(pairs):
            return pairs


def build(nqubit: int, p_layers: int, edges, device=None) -> QubitCircuit:
    cir = QubitCircuit(nqubit, device=device)
    cir.hlayer()
    for _ in range(p_layers):
        for a, b in edges:
            cir.rzz([a, b], encode=False)
        for i in range(nqubit):
            cir.rx(i)
    for a, b in edges:
        cir.observable([[a], [b]], basis='zz')
    return cir


def cost(cir: QubitCircuit, params: torch.Tensor) -> torch.Tensor:
    """sum <Z_a Z_b>: minimising it maximises the cut sum (1 - <ZZ>) / 2."""
    return cir.expectation(params=params).sum()


def main(nqubit: int = N, p_layers: int = P_LAYERS, steps: int = 150, shots: int = 500,
         seed: int | None = None, generator: torch.Generator | None = None, device=None) -> dict:
    """Adam from parameters drawn from ``seed``, then ``shots`` bitstrings
    of the trained state from ``generator`` (default: one on the device
    seeded with the graph's seed). Returns the edges, the cost of every
    step, the approximate cut and the counts."""
    dev = resolve_device(device)
    edges = regular_graph(nqubit)
    cir = build(nqubit, p_layers, edges, dev)
    cir.init_para(seed)
    params = cir.params.requires_grad_()
    costs = adam_steps(lambda: cost(cir, params), torch.optim.Adam([params], lr=LR), steps)
    cut = (len(edges) - costs[-1]) / 2
    print(f'approx MaxCut value: {cut:.3f} / {len(edges)} edges')
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(GRAPH_SEED)
    with torch.no_grad():
        cir.forward(params=params)
    counts = cir.measure(shots=shots, generator=generator)
    print('top bitstrings:', dict(sorted(counts.items(), key=lambda kv: -kv[1])[:4]))
    return dict(edges=edges, costs=costs, cut=cut, counts=counts, params=params.detach())


if __name__ == '__main__':
    main()
