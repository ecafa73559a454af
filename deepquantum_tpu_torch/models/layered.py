"""The layered hardware-efficient ansatz as a pure function.

PyTorch counterpart of ``deepquantum_tpu/models/layered.py``: Rx-Rz-Rx on
every wire, then a CNOT ring, ``nlayer`` times; a Pauli string of ``basis``
on every wire. The JAX package scans one layer body under
``jax.checkpoint`` to keep the compiled program and the residual states
small; here the same layers are a QubitCircuit, whose planar chain keeps
O(1) state memory in the depth (its backward un-applies the steps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit import QubitCircuit
from ..config import rdtype

__all__ = ['make_layered_vqe']


def make_layered_vqe(nqubit: int, nlayer: int, basis: str = 'x', device=None):
    """(expectation_fn, init_params): ``expectation_fn(params)`` is the
    scalar <P...P> for params of shape (nlayer, nqubit, 3) (angles of
    rx, rz, rx on each wire of each layer), differentiable in them;
    ``init_params`` is drawn from numpy's global generator, as the JAX
    package's is."""
    init = np.random.rand(nlayer, nqubit, 3) * 2 * np.pi
    cir = QubitCircuit(nqubit, device=device)
    for layer in init:
        for i, (a, b, c) in enumerate(layer):
            for name, angle in (('Rx', a), ('Rz', b), ('Rx', c)):
                cir.add_gate(name, i, inputs=[angle], requires_grad=True)
        cir.cnot_ring()
    cir.observable(list(range(nqubit)), basis=basis * nqubit)

    def expectation(params):
        return cir.expectation(params=torch.as_tensor(params).reshape(-1))[0]

    return expectation, torch.as_tensor(init, device=cir.device).to(rdtype())
