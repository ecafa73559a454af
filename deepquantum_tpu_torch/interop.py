"""Carry circuits, weights and states across from the JAX package.

``from_jax`` and ``qumode_from_jax`` read only Python and numpy attributes
of a ``deepquantum_tpu`` circuit (they never import JAX), so the same
circuit, with the same parameter values, runs through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import rdtype, resolve_device
from .gate import GATE_REGISTRY, GateOp

__all__ = ['from_jax', 'params_from_numpy', 'qumode_from_jax']


def params_from_numpy(a, device=None, dtype=None, requires_grad: bool = False) -> torch.Tensor:
    """A parameter vector (numpy or array-like) as a 1-D real tensor; with
    ``requires_grad`` a leaf whose ``.grad`` a backward pass fills."""
    dtype = rdtype() if dtype is None else dtype
    p = torch.as_tensor(np.array(a, dtype=np.float64).reshape(-1),
                        device=resolve_device(device)).to(dtype)
    return p.requires_grad_(requires_grad)


def from_jax(cir, device=None):
    """Build the port's QubitCircuit from a deepquantum_tpu QubitCircuit.

    Reads ``nqubit``, ``reupload``, the init state, ``operators`` (name,
    wires, controls, pidx, npara, static_matrix, inv), ``encoders``,
    ``_pvals``, ``_train_mask``, ``_enc_pidx``, ``npara``, ``ndata`` and
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
                       device=device, reupload=bool(getattr(cir, 'reupload', False)))
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
    enc = {id(op) for op in cir.encoders}
    out.encoders = [new for new, op in zip(out.operators, cir.operators) if id(op) in enc]
    out._enc_pidx = [int(i) for i in cir._enc_pidx]
    out.npara, out.ndata = int(cir.npara), int(cir.ndata)
    for obs in cir.observables:
        out.observables.append(Observable(cir.nqubit, [list(w) for w in obs.wires], obs.basis))
    out._touch()
    return out


_SINGLE_BS = {'BeamSplitterSingle_rx': 'bs_rx', 'BeamSplitterSingle_ry': 'bs_ry',
              'BeamSplitterSingle_h': 'bs_h'}
_BY_NAME = {'PhaseShift': 'ps', 'BeamSplitter': 'bs', 'BeamSplitterTheta': 'bs_theta',
            'BeamSplitterPhi': 'bs_phi', 'DisplacementPosition': 'x', 'DisplacementMomentum': 'z',
            **_SINGLE_BS}
_R_THETA = {'Squeezing': 's', 'Squeezing2': 's2', 'Displacement': 'd'}


def qumode_from_jax(cir, device=None):
    """Build the port's QumodeCircuit from a deepquantum_tpu QumodeCircuit.

    Reads ``nmode``, ``backend``, ``basis``, ``cutoff``, ``detector``, the
    init state (``state`` or ``cov`` / ``mean``), ``operators``, ``_pvals``,
    ``_train_mask``, ``_enc_pidx``, ``encoders`` and ``_custom_out_basis``.
    The JAX gates hold closures, so they are told apart by name (an MZI's
    ``phi_first`` sits in the defaults of its ``unitary_fn``; a fixed
    unitary carries ``static_unitary``). What the port cannot map (delay,
    loss, homodyne, Fock-only gates, tensor mode, the bosonic backend,
    per-forward noise) raises NotImplementedError."""
    from .photonic import QumodeCircuit

    if cir.measurements or getattr(cir, '_with_delay', False):
        raise NotImplementedError('qumode_from_jax: homodyne measurements and delay loops are '
                                  'not ported yet')
    if getattr(cir, '_noise_pidx', None) or getattr(cir, '_bosonic_states', None):
        raise NotImplementedError('qumode_from_jax: per-forward noise and cat / GKP states are '
                                  'not ported yet')
    init = cir.init_state
    if cir.backend == 'fock':
        state = np.asarray(init.state)
    elif cir.backend == 'gaussian':
        state = [np.asarray(init.cov, np.float64), np.asarray(init.mean, np.float64)]
    else:
        raise NotImplementedError(f"qumode_from_jax: backend={cir.backend!r} is not ported yet")
    out = QumodeCircuit(cir.nmode, init_state=state, cutoff=cir.cutoff, backend=cir.backend,
                        basis=cir.basis if cir.backend == 'fock' else True,
                        detector=cir.detector, name=cir.name, den_mat=cir.den_mat, mps=cir.mps,
                        device=device)
    for op in cir.operators:
        if op.kind != 'gate':
            raise NotImplementedError(f'qumode_from_jax: cannot map {op.kind} op {op.name}')
        wires = list(op.wires)
        # parameter values are placeholders here: the slots are overwritten below
        if op.static_unitary is not None:
            out.any(np.asarray(op.static_unitary), wires, name=op.name)
        elif op.name == 'MZI':
            out.mzi(wires, [0.0, 0.0], phi_first=bool(op.unitary_fn.__defaults__[0]))
        elif op.name in _BY_NAME:
            getattr(out, _BY_NAME[op.name])(wires, [0.0] * op.npara)
        elif op.name in _R_THETA:
            getattr(out, _R_THETA[op.name])(wires, 0.0, 0.0)
        else:
            raise NotImplementedError(f'qumode_from_jax: cannot map gate {op.name}')
        new = out.operators[-1]
        if new.npara != op.npara:
            raise NotImplementedError(f'qumode_from_jax: {op.name} has {op.npara} parameters '
                                      f'here, {new.npara} in the port')
        new.pidx = tuple(op.pidx)
    enc = {id(op) for op in cir.encoders}
    out.encoders = [new for new, op in zip(out.operators, cir.operators) if id(op) in enc]
    out._pvals = [float(v) for v in cir._pvals]
    out._train_mask = [bool(t) for t in cir._train_mask]
    out._enc_pidx = [int(i) for i in cir._enc_pidx]
    out.npara, out.ndata = cir.npara, cir.ndata
    if cir._custom_out_basis is not None:
        out._custom_out_basis = [tuple(int(v) for v in b) for b in cir._custom_out_basis]
    return out
