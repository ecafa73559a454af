"""Carry circuits, weights and states across from the JAX package.

``from_jax`` and ``qumode_from_jax`` read only Python and numpy attributes
of a ``deepquantum_tpu`` circuit (they never import JAX), so the same
circuit, with the same parameter values, runs through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import rdtype, resolve_device
from .gate import GATE_REGISTRY, GateOp, hamiltonian_fn, latent_fn, projection_j_fn

__all__ = ['from_jax', 'params_from_numpy', 'qumode_from_jax']


def params_from_numpy(a, device=None, dtype=None, requires_grad: bool = False) -> torch.Tensor:
    """A parameter vector (numpy or array-like) as a 1-D real tensor; with
    ``requires_grad`` a leaf whose ``.grad`` a backward pass fills."""
    dtype = rdtype() if dtype is None else dtype
    p = torch.as_tensor(np.array(a, dtype=np.float64).reshape(-1),
                        device=resolve_device(device)).to(dtype)
    return p.requires_grad_(requires_grad)


def _gate_fn(op):
    """The port's matrix function of a JAX gate op: by registry name, or for
    the gates built from their own arguments, from those (a projection J's
    plane, a latent gate's size, a Hamiltonian gate's ``extra['ham']``); a
    fixed matrix carries over as numpy."""
    if op.matrix_fn is None:
        return None, np.asarray(op.static_matrix)
    if op.name == 'ProjectionJ':
        return projection_j_fn(op.extra.get('plane', 'xy')), None
    if op.name == 'LatentGate':
        return latent_fn(2 ** len(op.wires)), None
    if op.name == 'HamiltonianGate':
        return hamiltonian_fn(np.asarray(op.extra['ham'])), None
    reg = GATE_REGISTRY.get(op.name)
    if reg is None or reg['npara'] != op.npara:
        raise NotImplementedError(f'from_jax: cannot map gate {op.name}')
    return reg['fn'], None


def from_jax(cir, device=None):
    """Build the port's QubitCircuit from a deepquantum_tpu QubitCircuit (an
    Ansatz too: it becomes a plain QubitCircuit of the same ops,
    parameters and observables).

    Reads ``nqubit``, ``den_mat``, ``reupload``, ``shots``, ``mps`` and
    ``chi``, the init state (an MPS's site tensors as numpy), ``operators``
    (name, wires, controls, pidx, npara, static_matrix, inv, condition,
    extra), ``encoders``, ``_pvals``, ``_train_mask``, ``_enc_pidx``,
    ``npara``, ``ndata``, ``depth``, ``wires_condition`` and
    ``observables``. Gates map by name through the port's GATE_REGISTRY
    (projection J, latent and Hamiltonian gates from their arguments, a
    fixed matrix as it is), Kraus channels through its CHANNEL_REGISTRY,
    resets and moves with their post-selection; an op it cannot map (a
    wire cut) raises NotImplementedError."""
    from .channel import CHANNEL_REGISTRY
    from .circuit import Observable, QubitCircuit

    init = cir.init_state
    mps = bool(getattr(cir, 'mps', False))
    if mps:
        state = [np.asarray(t) for t in init.tensors]
    else:
        kind = getattr(init, 'kind', None)
        state = kind if kind is not None else np.asarray(init.state)
    out = QubitCircuit(cir.nqubit, init_state=state, name=getattr(cir, 'name', None),
                       den_mat=bool(getattr(cir, 'den_mat', False)), device=device,
                       reupload=bool(getattr(cir, 'reupload', False)),
                       shots=int(getattr(cir, 'shots', 1024)), mps=mps,
                       chi=getattr(cir, 'chi', None))
    if mps:
        out.init_state.normalize = bool(getattr(init, 'normalize', True))
    for op in cir.operators:
        if op.kind == 'barrier':
            out.barrier(list(op.wires))
            continue
        if op.kind in ('reset', 'move'):
            out.operators.append(GateOp(name=op.name, wires=tuple(op.wires), kind=op.kind,
                                        extra={'postselect': op.extra.get('postselect', 0)}))
            continue
        if op.kind == 'channel' and op.name in CHANNEL_REGISTRY:
            out.operators.append(GateOp(
                name=op.name, wires=tuple(op.wires), matrix_fn=CHANNEL_REGISTRY[op.name]['fn'],
                pidx=tuple(op.pidx), npara=op.npara, kind='channel', requires_grad=False))
            continue
        if op.kind != 'gate':
            raise NotImplementedError(f'from_jax: cannot map {op.kind} op {op.name}')
        fn, static = _gate_fn(op)
        extra = {k: v for k, v in op.extra.items() if k in ('plane', 'ham')}
        out.operators.append(GateOp(
            name=op.name, wires=tuple(op.wires), controls=tuple(op.controls), matrix_fn=fn,
            static_matrix=static, pidx=tuple(op.pidx), npara=op.npara,
            condition=bool(op.condition), requires_grad=op.requires_grad, inv=op.inv,
            extra=extra))
    out._pvals = [float(v) for v in cir._pvals]
    out._train_mask = [bool(t) for t in cir._train_mask]
    enc = {id(op) for op in cir.encoders}
    out.encoders = [new for new, op in zip(out.operators, cir.operators) if id(op) in enc]
    out._enc_pidx = [int(i) for i in cir._enc_pidx]
    out.npara, out.ndata = int(cir.npara), int(cir.ndata)
    if getattr(cir, 'depth', None) is not None:
        out.depth = np.array(cir.depth, dtype=np.int64)
    out.wires_condition = [int(w) for w in getattr(cir, 'wires_condition', [])]
    for obs in cir.observables:
        out.observables.append(Observable(cir.nqubit, [list(w) for w in obs.wires], obs.basis))
    out._touch()
    return out


_SINGLE_BS = {'BeamSplitterSingle_rx': 'bs_rx', 'BeamSplitterSingle_ry': 'bs_ry',
              'BeamSplitterSingle_h': 'bs_h'}
_BY_NAME = {'PhaseShift': 'ps', 'BeamSplitter': 'bs', 'BeamSplitterTheta': 'bs_theta',
            'BeamSplitterPhi': 'bs_phi', 'DisplacementPosition': 'x', 'DisplacementMomentum': 'z',
            'QuadraticPhase': 'qp', 'ControlledX': 'cx', 'ControlledZ': 'cz', **_SINGLE_BS}
_R_THETA = {'Squeezing': 's', 'Squeezing2': 's2', 'Displacement': 'd'}


def _bosonic_from_jax(state):
    from .photonic import BosonicState
    return BosonicState([np.asarray(state.cov), np.asarray(state.mean), np.asarray(state.weight)],
                        state.nmode, state.cutoff)


def _qumode_op(out, op):
    """Append the port's counterpart of one JAX photonic op to ``out``."""
    wires = list(op.wires)
    # parameter values are placeholders here: the slots are overwritten
    if op.kind == 'barrier':
        out.barrier(wires)
    elif op.kind == 'loss':
        out.loss(wires, [0.0])
    elif op.kind == 'delay':
        out.delay(wires[0], ntau=op.extra['ntau'], inputs=[0.0, 0.0],
                  convention=op.extra['convention'])
    elif op.kind != 'gate':
        raise NotImplementedError(f'qumode_from_jax: cannot map {op.kind} op {op.name}')
    elif op.static_unitary is not None:
        out.any(np.asarray(op.static_unitary), wires, name=op.name)
    elif op.name == 'MZI':
        out.mzi(wires, [0.0, 0.0], phi_first=bool(op.unitary_fn.__defaults__[0]))
    elif op.name == 'PhaseShiftInv':
        out.r(wires, [0.0], inv_mode=True)
    elif op.name in _BY_NAME:
        getattr(out, _BY_NAME[op.name])(wires, [0.0] * op.npara)
    elif op.name in _R_THETA:
        getattr(out, _R_THETA[op.name])(wires, 0.0, 0.0)
    else:
        raise NotImplementedError(f'qumode_from_jax: cannot map gate {op.name}')


def qumode_from_jax(cir, device=None):
    """Build the port's QumodeCircuit (or QumodeCircuitTDM) from a
    deepquantum_tpu one.

    Reads ``nmode``, ``backend``, ``basis``, ``cutoff``, ``detector``, the
    init state (``state``, ``cov`` / ``mean`` / ``weight``), the cat / GKP
    states of the Bosonic backend (``_bosonic_states``), ``operators``
    (gates, loss, delay loops, barriers), the homodyne ``measurements``,
    ``_pvals``, ``_train_mask``, ``_enc_pidx``, ``encoders`` and
    ``_custom_out_basis``. The JAX gates hold closures, so they are told
    apart by name (an MZI's ``phi_first`` sits in the defaults of its
    ``unitary_fn``; a fixed unitary carries ``static_unitary``). What the
    port cannot map (the Fock-only gates, tensor mode, per-forward noise, a
    measurement other than Homodyne) raises NotImplementedError."""
    from .photonic import QumodeCircuit, QumodeCircuitTDM

    if getattr(cir, '_noise_pidx', None):
        raise NotImplementedError('qumode_from_jax: per-forward noise is not ported yet')
    init = cir.init_state
    if cir.backend == 'fock':
        state = np.asarray(init.state)
    elif cir.backend == 'gaussian':
        state = [np.asarray(init.cov, np.float64), np.asarray(init.mean, np.float64)]
    else:
        state = _bosonic_from_jax(init)
    if type(cir).__name__ == 'QumodeCircuitTDM':
        out = QumodeCircuitTDM(cir.nmode, init_state=state, cutoff=cir.cutoff,
                               backend=cir.backend, name=cir.name, device=device)
    else:
        out = QumodeCircuit(cir.nmode, init_state=state, cutoff=cir.cutoff, backend=cir.backend,
                            basis=cir.basis if cir.backend == 'fock' else True,
                            detector=cir.detector, name=cir.name, den_mat=cir.den_mat,
                            mps=cir.mps, device=device)
    for op in cir.operators:
        _qumode_op(out, op)
        new = out.operators[-1]
        if new.npara != op.npara:
            raise NotImplementedError(f'qumode_from_jax: {op.name} has {op.npara} parameters '
                                      f'here, {new.npara} in the port')
        new.pidx = tuple(op.pidx)
    for m in cir.measurements:
        if type(m).__name__ != 'Homodyne':
            raise NotImplementedError(f'qumode_from_jax: cannot map measurement {m.name}')
        out.homodyne(list(m.wires), phi=m.phi, eps=float(np.sqrt(m.cov_m[0, 0])))
    if getattr(cir, '_bosonic_states', None) is not None:
        out._bosonic_states = [_bosonic_from_jax(s) for s in cir._bosonic_states]
    enc = {id(op) for op in cir.encoders}
    out.encoders = [new for new, op in zip(out.operators, cir.operators) if id(op) in enc]
    out._pvals = [float(v) for v in cir._pvals]
    out._train_mask = [bool(t) for t in cir._train_mask]
    out._enc_pidx = [int(i) for i in cir._enc_pidx]
    out.npara, out.ndata = cir.npara, cir.ndata
    if cir._custom_out_basis is not None:
        out._custom_out_basis = [tuple(int(v) for v in b) for b in cir._custom_out_basis]
    return out
