"""Carry circuits, weights and states across from the JAX package.

``from_jax`` reads only Python and numpy attributes of a
``deepquantum_tpu.QubitCircuit`` (it never imports JAX), so the same
circuit, with the same parameter values, runs through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import rdtype, resolve_device
from .gate import GATE_REGISTRY, GateOp

__all__ = ['from_jax', 'params_from_numpy']


def params_from_numpy(a, device=None, dtype=None, requires_grad: bool = False) -> torch.Tensor:
    """A parameter vector (numpy or array-like) as a 1-D real tensor; with
    ``requires_grad`` a leaf whose ``.grad`` a backward pass fills."""
    dtype = rdtype() if dtype is None else dtype
    p = torch.as_tensor(np.array(a, dtype=np.float64).reshape(-1),
                        device=resolve_device(device)).to(dtype)
    return p.requires_grad_(requires_grad)


def from_jax(cir, device=None):
    """Build the port's QubitCircuit from a deepquantum_tpu QubitCircuit.

    Reads ``nqubit``, the init state, ``operators`` (name, wires, controls,
    pidx, npara, static_matrix, inv), ``_pvals``, ``_train_mask`` and
    ``observables``. Gates are mapped by name through the port's
    GATE_REGISTRY; a gate it cannot map (a latent, hamiltonian or projection
    gate, a channel, a measurement) raises NotImplementedError."""
    from .circuit import Observable, QubitCircuit

    init = cir.init_state
    if getattr(cir, 'den_mat', False) or getattr(cir, 'mps', False):
        raise NotImplementedError('from_jax: density-matrix and MPS circuits are not ported yet')
    kind = getattr(init, 'kind', None)
    state = kind if kind is not None else np.asarray(init.state)
    out = QubitCircuit(cir.nqubit, init_state=state, name=getattr(cir, 'name', None),
                       device=device)
    for op in cir.operators:
        if op.kind == 'barrier':
            out.barrier(list(op.wires))
            continue
        if op.kind != 'gate' or op.condition:
            raise NotImplementedError(f'from_jax: cannot map {op.kind} op {op.name}')
        if op.matrix_fn is None:
            fn, static = None, np.asarray(op.static_matrix)
        else:
            reg = GATE_REGISTRY.get(op.name)
            if reg is None or reg['npara'] != op.npara:
                raise NotImplementedError(f'from_jax: cannot map gate {op.name}')
            fn, static = reg['fn'], None
        out.operators.append(GateOp(
            name=op.name, wires=tuple(op.wires), controls=tuple(op.controls), matrix_fn=fn,
            static_matrix=static, pidx=tuple(op.pidx), npara=op.npara,
            requires_grad=op.requires_grad, inv=op.inv))
    out._pvals = [float(v) for v in cir._pvals]
    out._train_mask = [bool(t) for t in cir._train_mask]
    for obs in cir.observables:
        out.observables.append(Observable(cir.nqubit, [list(w) for w in obs.wires], obs.basis))
    out._touch()
    return out
