"""Class-style operation API: every gate, layer and channel by its class name.

PyTorch counterpart of ``deepquantum_tpu/api.py``. The names are factories:
a gate or a channel is a ``GateOp`` descriptor that carries its own
parameter values (``extra['inputs']``), a layer is a ``QubitCircuit``
fragment; ``QubitCircuit.add`` takes both, registering a descriptor's
parameters in the circuit's flat vector the first time it is added and
sharing them when it is added again. A descriptor also runs on its own:
``gate.matrix()`` and ``gate(state)`` give tensors on the device it was
made for (``device=``, default the default device, the card).

The simulation flags of the reference API (``den_mat``, ``tsr_mode``,
``noise`` / ``mu`` / ``sigma``) are accepted and ignored, with a warning:
the density-matrix form is a property of the circuit, and parameter noise
is drawn by the circuit's sugar.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .channel import CHANNEL_REGISTRY
from .circuit import Observable, QubitCircuit
from .config import cdtype  # noqa: F401 — api.cdtype, as in the JAX package
from .gate import GATE_REGISTRY, GateOp, hamiltonian_fn, latent_fn, projection_j_fn
from .ops import gates as G
from .ops.qmath import inner_product_mps

__all__ = [
    'U3Gate', 'PhaseShift', 'Identity', 'PauliX', 'PauliY', 'PauliZ', 'Hadamard',
    'SGate', 'SDaggerGate', 'TGate', 'TDaggerGate', 'Rx', 'Ry', 'Rz', 'CNOT',
    'Swap', 'ImaginarySwap', 'Rxx', 'Ryy', 'Rzz', 'Rxy',
    'ReconfigurableBeamSplitter', 'Toffoli', 'Fredkin', 'ProjectionJ',
    'UAnyGate', 'LatentGate', 'HamiltonianGate', 'CombinedSingleGate', 'Barrier',
    'BitFlip', 'PhaseFlip', 'Depolarizing', 'Pauli', 'AmplitudeDamping',
    'PhaseDamping', 'GeneralizedAmplitudeDamping',
    'XLayer', 'YLayer', 'ZLayer', 'HLayer', 'RxLayer', 'RyLayer', 'RzLayer',
    'U3Layer', 'CnotLayer', 'CnotRing', 'Observable', 'expectation',
]


def _warn_ignored(**flags):
    """Say, once per call site, that a reference simulation flag has no
    per-gate effect here."""
    for k, v in flags.items():
        if v:
            warnings.warn(
                f'{k}={v!r} is accepted for reference-API parity but has no per-gate effect in '
                'deepquantum_tpu_torch: the density-matrix form is a property of the circuit, '
                'and parameter noise is drawn when the gate is added to a circuit.',
                UserWarning, stacklevel=3)


def _tuple_wires(wires, default=None):
    if wires is None:
        wires = default
    return (wires,) if isinstance(wires, int) else tuple(wires)


def _resolve_wires(wires, minmax, nqubit):
    if wires is None:
        if minmax is None:
            minmax = [0, nqubit - 1]
        wires = list(range(minmax[0], minmax[1] + 1))
    return _tuple_wires(wires)


def _standalone(name, inputs, wires, controls, condition, requires_grad, matrix_fn, npara,
                nqubit, device=None, static_matrix=None, kind='gate', extra=None) -> GateOp:
    """A GateOp carrying its own parameter values in ``extra['inputs']``
    (random in [0, 2 pi) from numpy's global generator when not given, as
    the JAX package draws them)."""
    controls = () if controls is None else (
        (controls,) if isinstance(controls, int) else tuple(controls))
    extra = dict(extra or {})
    extra['nqubit'] = nqubit
    extra['device'] = device
    if requires_grad is None:
        requires_grad = inputs is None and npara > 0
    if npara:
        if inputs is None:
            values = [float(np.random.rand() * 2 * np.pi) for _ in range(npara)]
        else:
            if torch.is_tensor(inputs):
                inputs = inputs.detach().cpu().numpy()
            values = [float(v) for v in np.asarray(inputs, np.float64).reshape(-1)]
        if len(values) != npara:
            raise ValueError(f'{name} expects {npara} parameters, got {len(values)}')
        extra['inputs'] = values
    return GateOp(name=name, wires=wires, controls=controls, matrix_fn=matrix_fn,
                  static_matrix=static_matrix, npara=npara, kind=kind, condition=condition,
                  requires_grad=bool(requires_grad), extra=extra)


def _gate_factory(name: str, default_nwires: int = 1):
    reg = GATE_REGISTRY[name]

    def factory(inputs=None, nqubit=None, wires=None, controls=None, condition=False,
                den_mat=False, tsr_mode=False, requires_grad=None, noise=False, mu=0, sigma=0.1,
                device=None):
        _warn_ignored(den_mat=den_mat, tsr_mode=tsr_mode, noise=noise)
        wires = _tuple_wires(wires, default=list(range(default_nwires)))
        ctrl = [controls] if isinstance(controls, int) else list(controls or [])
        nq = nqubit if nqubit is not None else max(list(wires) + ctrl) + 1
        return _standalone(name, inputs, wires, controls, condition, requires_grad, reg['fn'],
                           reg['npara'], nq, device)

    factory.__name__ = name
    factory.__qualname__ = name
    factory.__doc__ = f'{name} gate descriptor (class-style API; see GATE_REGISTRY["{name}"]).'
    return factory


_NWIRES = {'CNOT': 2, 'Swap': 2, 'ImaginarySwap': 2, 'Rxx': 2, 'Ryy': 2, 'Rzz': 2, 'Rxy': 2,
           'ReconfigurableBeamSplitter': 2, 'Toffoli': 3, 'Fredkin': 3}
for _name in GATE_REGISTRY:
    globals()[_name] = _gate_factory(_name, _NWIRES.get(_name, 1))


def ProjectionJ(inputs=None, nqubit=None, wires=None, plane='xy', controls=None,
                condition=False, den_mat=False, tsr_mode=False, requires_grad=None, device=None,
                **kwargs) -> GateOp:
    """The J(theta) basis-projection gate of an MBQC measurement plane."""
    wires = _tuple_wires(wires, default=[0])
    nq = nqubit if nqubit is not None else max(wires) + 1
    plane = plane.lower()
    return _standalone('ProjectionJ', inputs, wires, controls, condition, requires_grad,
                       projection_j_fn(plane), 1, nq, device, extra={'plane': plane})


def UAnyGate(unitary, nqubit=None, wires=None, minmax=None, controls=None, name='UAnyGate',
             den_mat=False, tsr_mode=False, device=None, **kwargs) -> GateOp:
    """A fixed arbitrary unitary."""
    if torch.is_tensor(unitary):
        unitary = unitary.detach().cpu().numpy()
    unitary = np.asarray(unitary, dtype=np.complex128)
    k = int(round(np.log2(unitary.shape[-1])))
    if nqubit is None:
        nqubit = k if wires is None and minmax is None else None
    wires = _resolve_wires(wires, minmax if minmax is not None else [0, k - 1], nqubit or k)
    if nqubit is None:
        nqubit = max(wires) + 1
    return _standalone(name, None, wires, controls, False, False, None, 0, nqubit, device,
                       static_matrix=unitary)


def LatentGate(inputs=None, nqubit=None, wires=None, minmax=None, controls=None, den_mat=False,
               tsr_mode=False, requires_grad=None, device=None, **kwargs) -> GateOp:
    """The polar projection U V^H of a latent 2^k x 2^k matrix (random
    normal when not given)."""
    wires = _resolve_wires(wires, minmax, nqubit if nqubit is not None else 1)
    if nqubit is None:
        nqubit = max(wires) + 1
    dim = 2 ** len(wires)
    if inputs is None:
        inputs = np.random.randn(dim, dim)
    if torch.is_tensor(inputs):
        inputs = inputs.detach().cpu().numpy()
    inputs = np.asarray(inputs, np.float64).reshape(-1)
    return _standalone('LatentGate', inputs, wires, controls, False, requires_grad,
                       latent_fn(dim), dim * dim, nqubit, device)


def HamiltonianGate(hamiltonian, t=None, nqubit=None, wires=None, minmax=None, controls=None,
                    den_mat=False, tsr_mode=False, requires_grad=None, device=None,
                    **kwargs) -> GateOp:
    """exp(-i H t), the time t its parameter."""
    if torch.is_tensor(hamiltonian):
        hamiltonian = hamiltonian.detach().cpu().numpy()
    ham = np.asarray(hamiltonian, dtype=np.complex128)
    k = int(round(np.log2(ham.shape[-1])))
    wires = _resolve_wires(wires, minmax if minmax is not None else [0, k - 1],
                           nqubit if nqubit is not None else k)
    if nqubit is None:
        nqubit = max(wires) + 1
    return _standalone('HamiltonianGate', t, wires, controls, False, requires_grad,
                       hamiltonian_fn(ham), 1, nqubit, device, extra={'ham': ham})


def _member_matrix(g: GateOp, p, device) -> torch.Tensor:
    if g.matrix_fn is None:
        mat = torch.as_tensor(np.asarray(g.static_matrix), device=device)
    else:
        mat = g.matrix_fn(p if g.npara else None, device)
    if g.inv:
        mat = mat.conj().transpose(-1, -2)
    return mat


def CombinedSingleGate(gatelist, nqubit=None, wires=None, den_mat=False, tsr_mode=False,
                       device=None, **kwargs) -> GateOp:
    """The product of single-qubit gates as one descriptor: its parameters
    are the members' in list order, and the members apply in that order."""
    gatelist = list(gatelist)
    if not all(len(g.wires) == 1 and not g.controls for g in gatelist):
        raise ValueError('CombinedSingleGate takes single-qubit gates without controls')
    wires = _tuple_wires(wires, default=gatelist[0].wires)
    nq = nqubit if nqubit is not None else max(wires) + 1
    slices, off = [], 0
    for g in gatelist:
        slices.append(slice(off, off + g.npara))
        off += g.npara
    inputs = [v for g in gatelist for v in g.extra.get('inputs', [])]

    def fn(p, device):
        mat = None
        for g, sl in zip(gatelist, slices):
            mg = _member_matrix(g, None if p is None else p[..., sl], device)
            mat = mg if mat is None else mg @ mat
        return mat

    return _standalone('CombinedSingleGate', inputs if off else None, wires, None, False,
                       any(g.requires_grad for g in gatelist), fn, off, nq, device)


def Barrier(nqubit=None, wires=None, **kwargs) -> GateOp:
    """A barrier (no operation)."""
    wires = _tuple_wires(wires, default=list(range(nqubit if nqubit is not None else 1)))
    return GateOp(name='Barrier', wires=wires, kind='barrier', npara=0, requires_grad=False,
                  extra={'nqubit': nqubit or max(wires) + 1})


def _channel_factory(name: str):
    reg = CHANNEL_REGISTRY[name]

    def factory(inputs=None, nqubit=None, wires=0, tsr_mode=False, requires_grad=None,
                device=None, **kwargs):
        wires = _tuple_wires(wires)
        nq = nqubit if nqubit is not None else max(wires) + 1
        if inputs is None:
            inputs = [float(np.random.rand() * np.pi) for _ in range(reg['npara'])]
        return _standalone(name, inputs, wires, None, False, False, reg['fn'], reg['npara'], nq,
                           device, kind='channel')

    factory.__name__ = name
    factory.__qualname__ = name
    factory.__doc__ = f'{name} Kraus channel descriptor (density-matrix circuits only).'
    return factory


for _name in CHANNEL_REGISTRY:
    globals()[_name] = _channel_factory(_name)


# ------------------------------------------------------------------- layers
def _fixed_layer(method: str, doc: str):
    def factory(nqubit=1, wires=None, den_mat=False, tsr_mode=False, device=None, **kwargs):
        cir = QubitCircuit(nqubit, device=device)
        getattr(cir, method)(wires)
        return cir
    factory.__doc__ = doc
    return factory


XLayer = _fixed_layer('xlayer', 'A layer of PauliX gates.')
YLayer = _fixed_layer('ylayer', 'A layer of PauliY gates.')
ZLayer = _fixed_layer('zlayer', 'A layer of PauliZ gates.')
HLayer = _fixed_layer('hlayer', 'A layer of Hadamard gates.')


def _rot_layer(method: str, doc: str):
    def factory(nqubit=1, wires=None, inputs=None, den_mat=False, tsr_mode=False,
                requires_grad=True, device=None, **kwargs):
        cir = QubitCircuit(nqubit, device=device)
        getattr(cir, method)(wires, inputs)
        return cir
    factory.__doc__ = doc
    return factory


RxLayer = _rot_layer('rxlayer', 'A layer of Rx gates.')
RyLayer = _rot_layer('rylayer', 'A layer of Ry gates.')
RzLayer = _rot_layer('rzlayer', 'A layer of Rz gates.')
U3Layer = _rot_layer('u3layer', 'A layer of U3 gates.')


def CnotLayer(nqubit=2, wires=None, name='CnotLayer', den_mat=False, tsr_mode=False, device=None,
              **kwargs) -> QubitCircuit:
    """CNOTs on the given (control, target) pairs (default (0, 1), (2, 3), ...)."""
    cir = QubitCircuit(nqubit, device=device)
    cir.cxlayer(wires)
    return cir


def CnotRing(nqubit=2, minmax=None, step=1, reverse=False, den_mat=False, tsr_mode=False,
             device=None, **kwargs) -> QubitCircuit:
    """A ring of CNOTs."""
    cir = QubitCircuit(nqubit, device=device)
    cir.cnot_ring(minmax=minmax, step=step, reverse=reverse)
    return cir


# -------------------------------------------------------------- expectation
_PAULI = {'x': G.paulix_matrix, 'y': G.pauliy_matrix, 'z': G.pauliz_matrix,
          'i': G.identity_matrix}


def expectation(state, observable: Observable, den_mat: bool = False, chi: int | None = None):
    """The expectation value of a Pauli-string observable on a state vector
    (2^n, 1) or a batch (B, 2^n, 1), a density matrix (2^n, 2^n) or a batch
    of them, or an MPS given as its list of site tensors (chi_l, 2, chi_r)."""
    if isinstance(state, (list, tuple)):
        ket = list(state)
        for wire, b in zip(observable.wires, observable.basis):
            site = ket[wire[0]]
            mat = _PAULI[b](site.device).to(site.dtype)
            ket[wire[0]] = torch.einsum('ab,xby->xay', mat, site)
        return inner_product_mps(list(state), ket).real
    state = torch.as_tensor(state)
    n = observable.nqubit
    dim = 2 ** n
    if den_mat:
        rho = state.reshape([-1] + [2] * (2 * n))
        ox = observable.apply(rho, den_mat=True).reshape(-1, dim, dim)
        out = ox.diagonal(dim1=-2, dim2=-1).sum(-1).real
    else:
        psi = state.reshape(-1, dim)
        ox = observable.apply(psi.reshape([-1] + [2] * n)).reshape(-1, dim)
        out = (psi.conj() * ox).sum(-1).real
    batched = state.numel() > (dim * dim if den_mat else dim)
    return out if batched else out[0]
