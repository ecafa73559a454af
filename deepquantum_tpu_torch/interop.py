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

__all__ = ['from_jax', 'params_from_numpy', 'qumode_from_jax', 'pattern_from_jax']


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


def _mesh_for(cir, device, mesh):
    """The mesh of a carried-over distributed circuit: ``mesh`` when given,
    else as many shards as the JAX circuit's mesh has devices: on the
    cards for a CUDA ``device`` (raising if too few are visible), on the
    CPU for a CPU one."""
    if mesh is not None:
        return mesh
    from .parallel.sharded import make_mesh
    size = int(np.asarray(cir.mesh.devices).size)
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return make_mesh(devices=[dev] * size)
    return make_mesh(size)


def from_jax(cir, device=None, mesh=None):
    """Build the port's QubitCircuit from a deepquantum_tpu QubitCircuit (an
    Ansatz too: it becomes a plain QubitCircuit of the same ops,
    parameters and observables). A JAX ``DistributedQubitCircuit`` becomes
    the port's, with the same engine ('gspmd' or 'shardmap'), on ``mesh``
    or on a mesh of its mesh's size (``_mesh_for``).

    Reads ``nqubit``, ``den_mat``, ``reupload``, ``shots``, ``mps`` and
    ``chi``, the init state (an MPS's site tensors as numpy), ``operators``
    (name, wires, controls, pidx, npara, static_matrix, inv, condition,
    extra), ``encoders``, ``_pvals``, ``_train_mask``, ``_enc_pidx``,
    ``npara``, ``ndata``, ``depth``, ``wires_condition`` and
    ``observables``, and the wire cuts (``_cut_lst``). Gates map by name
    through the port's GATE_REGISTRY (projection J, latent and Hamiltonian
    gates from their arguments, a fixed matrix as it is), Kraus channels
    through its CHANNEL_REGISTRY, resets and moves with their
    post-selection, wire cuts as cut markers; an op it cannot map raises
    NotImplementedError."""
    from .channel import CHANNEL_REGISTRY
    from .circuit import Observable, QubitCircuit

    init = cir.init_state
    mps = bool(getattr(cir, 'mps', False))
    if type(cir).__name__ == 'DistributedQubitCircuit':
        from .parallel.circuit import DistributedQubitCircuit
        out = DistributedQubitCircuit(cir.nqubit, mesh=_mesh_for(cir, device, mesh), name=cir.name,
                                      reupload=bool(cir.reupload), shots=int(cir.shots),
                                      engine=cir.engine)
    else:
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
        if op.kind == 'cut':
            out.operators.append(GateOp(name=op.name, wires=tuple(op.wires), kind='cut'))
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
    out._cut_lst = [(int(i), int(w)) for i, w in getattr(cir, '_cut_lst', [])]
    for obs in cir.observables:
        out.observables.append(Observable(cir.nqubit, [list(w) for w in obs.wires], obs.basis))
    out._touch()
    return out


_SINGLE_BS = {'BeamSplitterSingle_rx': 'bs_rx', 'BeamSplitterSingle_ry': 'bs_ry',
              'BeamSplitterSingle_h': 'bs_h'}
_BY_NAME = {'PhaseShift': 'ps', 'BeamSplitter': 'bs', 'BeamSplitterTheta': 'bs_theta',
            'BeamSplitterPhi': 'bs_phi', 'DisplacementPosition': 'x', 'DisplacementMomentum': 'z',
            'QuadraticPhase': 'qp', 'ControlledX': 'cx', 'ControlledZ': 'cz', 'CubicPhase': 'cp',
            'Kerr': 'k', 'CrossKerr': 'ck', **_SINGLE_BS}
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


def qumode_from_jax(cir, device=None, mesh=None):
    """Build the port's QumodeCircuit (or QumodeCircuitTDM, or
    DistributedQumodeCircuit on ``mesh`` or on a mesh of its mesh's size)
    from a deepquantum_tpu one.

    Reads ``nmode``, ``backend``, ``basis``, ``cutoff``, ``detector``, the
    init state (``state``, ``cov`` / ``mean`` / ``weight``), the cat / GKP
    states of the Bosonic backend (``_bosonic_states``), ``operators``
    (gates, loss, delay loops, barriers), the homodyne ``measurements``,
    ``_pvals``, ``_train_mask``, ``_enc_pidx``, ``encoders`` and
    ``_custom_out_basis``; tensor mode (``basis``), ``den_mat``, ``mps``
    and ``chi`` (an MPS's site tensors as numpy), and the noise settings
    (``noise``, ``mu``, ``sigma``, ``noise_per_forward`` and the noisy
    slots ``_noise_pidx``; build-time jitter is in ``_pvals`` already).
    The JAX gates hold closures, so they are told apart by name (an MZI's
    ``phi_first`` sits in the defaults of its ``unitary_fn``; a fixed
    unitary carries ``static_unitary``). What the port cannot map (a
    measurement other than Homodyne) raises NotImplementedError."""
    from .photonic import QumodeCircuit, QumodeCircuitTDM

    init = cir.init_state
    mps = bool(getattr(cir, 'mps', False))
    noise = dict(noise=bool(getattr(cir, 'noise', False)), mu=getattr(cir, 'mu', 0),
                 sigma=getattr(cir, 'sigma', 0.1))
    if cir.backend == 'fock' and mps:
        state = [np.asarray(t) for t in init.tensors]
    elif cir.backend == 'fock':
        state = np.asarray(init.state)
    elif cir.backend == 'gaussian':
        state = [np.asarray(init.cov, np.float64), np.asarray(init.mean, np.float64)]
    else:
        state = _bosonic_from_jax(init)
    if type(cir).__name__ == 'DistributedQumodeCircuit':
        from .photonic.distributed import DistributedQumodeCircuit
        out = DistributedQumodeCircuit(cir.nmode, init_state=state, cutoff=cir.cutoff,
                                       name=cir.name, mesh=_mesh_for(cir, device, mesh),
                                       noise_per_forward=bool(getattr(cir, 'noise_per_forward',
                                                                      False)), **noise)
    elif type(cir).__name__ == 'QumodeCircuitTDM':
        out = QumodeCircuitTDM(cir.nmode, init_state=state, cutoff=cir.cutoff,
                               backend=cir.backend, name=cir.name, device=device, **noise)
    else:
        out = QumodeCircuit(cir.nmode, init_state=state, cutoff=cir.cutoff, backend=cir.backend,
                            basis=cir.basis if cir.backend == 'fock' else True,
                            detector=cir.detector, name=cir.name, den_mat=cir.den_mat,
                            mps=mps, chi=cir.chi, device=device,
                            noise_per_forward=bool(getattr(cir, 'noise_per_forward', False)),
                            **noise)
    if mps:
        out.init_state.normalize = bool(getattr(init, 'normalize', True))
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
    out._noise_pidx = [int(i) for i in getattr(cir, '_noise_pidx', [])]
    out.npara, out.ndata = cir.npara, cir.ndata
    if cir._custom_out_basis is not None:
        out._custom_out_basis = [tuple(int(v) for v in b) for b in cir._custom_out_basis]
    return out


def pattern_from_jax(pattern, device=None, generator=None):
    """Build the port's MBQC Pattern from a deepquantum_tpu one: its initial
    graph (each subgraph's nodes, input nodes, input state, edges with
    their cz flags and measurement record), the commands (nodes, angles,
    planes, s / t domains, encoding signs, correction bases and domains),
    the encoders, ``nodes_out_seq``, ``npara``, ``ndata``, ``reupload``
    and ``name``, on ``device`` (default: the default device)."""
    from .mbqc import Correction, Entanglement, Measurement, Node, Pattern
    from .mbqc.state import SubGraphState

    out = Pattern(name=pattern.name, reupload=bool(pattern.reupload), device=device,
                  generator=generator)
    subgraphs = []
    for sg in pattern.init_state.subgraphs:
        edges = [(a, b, {'cz': bool(cz)}) for (a, b), cz in sg._edges.items()]
        new = SubGraphState(list(sg.nodes_state), np.asarray(sg.state), edges, list(sg._nodes),
                            device=out.device)
        for node, bits in sg.measure_dict.items():
            new.measure_dict[node] = [torch.tensor(int(b), device=out.device) for b in bits]
        subgraphs.append(new)
    out.init_state.subgraphs = subgraphs
    out.init_state.nodes_out_seq = pattern.init_state.nodes_out_seq
    commands = {}
    for cmd in pattern.commands:
        kind = type(cmd).__name__
        if kind == 'Node':
            new = Node(list(cmd.nodes))
        elif kind == 'Entanglement':
            new = Entanglement(*cmd.nodes)
        elif kind == 'Measurement':
            new = Measurement(list(cmd.nodes), angle=0.0, plane=cmd.plane,
                              s_domain=sorted(cmd.s_domain), t_domain=sorted(cmd.t_domain),
                              requires_grad=bool(cmd.requires_grad))
            new.enc_sign = float(cmd.enc_sign)
            new.angle = float(cmd.angle)
        elif kind == 'Correction':
            new = Correction(list(cmd.nodes), basis=cmd.basis, domain=sorted(cmd.domain))
        else:
            raise NotImplementedError(f'pattern_from_jax: cannot map command {kind}')
        commands[id(cmd)] = new
        out.commands.append(new)
    out.encoders = [commands[id(cmd)] for cmd in pattern.encoders]
    out.nodes_out_seq = None if pattern.nodes_out_seq is None else list(pattern.nodes_out_seq)
    out.npara, out.ndata = int(pattern.npara), int(pattern.ndata)
    return out
