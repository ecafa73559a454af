"""Class-style photonic operation API.

PyTorch counterpart of ``deepquantum_tpu/photonic/api.py``: the gate names
are factories of ``PhotonicOp`` descriptors that carry their parameter
values (``extra['inputs']``, trainable where ``extra['requires_grad']``);
``QumodeCircuit.add`` registers them in the circuit's flat vector the first
time a descriptor is added and shares them when it is added again.

The reference flags ``cutoff``, ``den_mat`` and ``noise`` / ``mu`` /
``sigma`` are accepted; the representation and the noise are properties of
the circuit.
"""

from __future__ import annotations

import warnings
from functools import partial

import numpy as np
import torch

from . import gates as PG
from .circuit import PhotonicOp
from .gates import PHOTONIC_REGISTRY

__all__ = [
    'PhaseShift', 'BeamSplitter', 'MZI', 'BeamSplitterTheta', 'BeamSplitterPhi',
    'BeamSplitterSingle', 'UAnyGate', 'Squeezing', 'Squeezing2', 'Displacement',
    'DisplacementPosition', 'DisplacementMomentum', 'QuadraticPhase',
    'ControlledX', 'ControlledZ', 'CubicPhase', 'Kerr', 'CrossKerr',
    'PhotonLoss', 'Delay', 'DelayBS', 'DelayMZI', 'Barrier',
]


def _wires(wires, default_n):
    if wires is None:
        wires = list(range(default_n))
    return [wires] if isinstance(wires, int) else list(wires)


def _standalone(name, wires, inputs, npara, unitary_fn=None, xp_fn=None, fock_fn=None,
                static_unitary=None, kind='gate', extra=None, requires_grad=None) -> PhotonicOp:
    extra = dict(extra or {})
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
        extra['requires_grad'] = bool(requires_grad)
    return PhotonicOp(name, wires, (), npara, kind, unitary_fn, xp_fn, static_unitary, extra,
                      fock_fn)


def _registry_factory(name: str, default_nwires: int):
    reg = PHOTONIC_REGISTRY[name]

    def factory(inputs=None, nmode=None, wires=None, cutoff=None, den_mat=False,
                requires_grad=None, noise=False, mu=0, sigma=0.1, **kwargs):
        if noise or den_mat:
            warnings.warn(
                'noise/den_mat on a standalone photonic gate descriptor is accepted for '
                'reference-API parity but ignored: both are properties of the circuit '
                '(QumodeCircuit(den_mat=...), QumodeCircuit(noise=True, '
                'noise_per_forward=...)).', UserWarning, stacklevel=2)
        return _standalone(name, _wires(wires, default_nwires), inputs, reg['npara'],
                           unitary_fn=reg['unitary'], xp_fn=reg['xp'], fock_fn=reg['fock'],
                           requires_grad=requires_grad)

    factory.__name__ = name
    factory.__qualname__ = name
    factory.__doc__ = f'{name} photonic gate descriptor (class-style API).'
    return factory


_NWIRES = {'BeamSplitter': 2, 'MZI': 2, 'Squeezing2': 2, 'ControlledX': 2, 'ControlledZ': 2,
           'CrossKerr': 2}
for _name in PHOTONIC_REGISTRY:
    globals()[_name] = _registry_factory(_name, _NWIRES.get(_name, 1))


def BeamSplitterTheta(inputs=None, nmode=None, wires=None, phi: float = np.pi / 2,
                      requires_grad=None, **kwargs) -> PhotonicOp:
    """A beam splitter with a trainable theta and phi fixed (pi / 2)."""
    return _standalone('BeamSplitterTheta', _wires(wires, 2), inputs, 1,
                       unitary_fn=partial(PG.bs_theta_unitary, phi=phi),
                       requires_grad=requires_grad)


def BeamSplitterPhi(inputs=None, nmode=None, wires=None, theta: float = np.pi / 4,
                    requires_grad=None, **kwargs) -> PhotonicOp:
    """A beam splitter with a trainable phi and theta fixed (pi / 4)."""
    return _standalone('BeamSplitterPhi', _wires(wires, 2), inputs, 1,
                       unitary_fn=partial(PG.bs_phi_unitary, theta=theta),
                       requires_grad=requires_grad)


def BeamSplitterSingle(inputs=None, nmode=None, wires=None, convention: str = 'rx',
                       requires_grad=None, **kwargs) -> PhotonicOp:
    """A one-parameter beam splitter in the rx, ry or h convention."""
    return _standalone(f'BeamSplitterSingle_{convention}', _wires(wires, 2), inputs, 1,
                       unitary_fn=partial(PG.bs_single_unitary, convention=convention),
                       requires_grad=requires_grad)


def UAnyGate(unitary, nmode=None, wires=None, minmax=None, cutoff=None, name='UAnyGate',
             **kwargs) -> PhotonicOp:
    """A fixed passive linear-optical unitary."""
    if torch.is_tensor(unitary):
        unitary = unitary.detach().cpu().numpy()
    u = np.asarray(unitary, dtype=np.complex128)
    if wires is None:
        if minmax is None:
            minmax = [0, u.shape[-1] - 1]
        wires = list(range(minmax[0], minmax[1] + 1))
    return _standalone(name, _wires(wires, 1), None, 0, static_unitary=u)


def PhotonLoss(inputs=None, nmode=None, wires=0, requires_grad=None, **kwargs) -> PhotonicOp:
    """Photon loss of angle theta, transmittance T = cos^2(theta / 2)."""
    if inputs is None:
        inputs = [float(np.random.rand() * np.pi)]
    return _standalone('PhotonLoss', _wires(wires, 1), inputs, 1, kind='loss',
                       requires_grad=False)


def Delay(inputs=None, nmode=None, wires=0, ntau: int = 1, convention: str = 'bs',
          requires_grad=None, **kwargs) -> PhotonicOp:
    """A delay loop of ntau time bins for TDM circuits: two parameters,
    (theta, phi) of the coupling beam splitter and the loop's phase ('bs')
    or of an MZI ('mzi')."""
    if convention not in ('bs', 'mzi'):
        raise ValueError(f'Unknown delay convention {convention}')
    wire = wires if isinstance(wires, int) else wires[0]
    return _standalone(f'Delay_{convention}', [wire], inputs, 2, kind='delay',
                       extra={'ntau': ntau, 'convention': convention},
                       requires_grad=requires_grad)


def DelayBS(inputs=None, nmode=None, wires=0, ntau: int = 1, **kwargs) -> PhotonicOp:
    """A delay loop coupled in by a beam splitter."""
    return Delay(inputs, nmode, wires, ntau, 'bs', **kwargs)


def DelayMZI(inputs=None, nmode=None, wires=0, ntau: int = 1, **kwargs) -> PhotonicOp:
    """A delay loop coupled in by an MZI."""
    return Delay(inputs, nmode, wires, ntau, 'mzi', **kwargs)


def Barrier(nmode=None, wires=None, **kwargs) -> PhotonicOp:
    """A barrier (no operation)."""
    return PhotonicOp('Barrier', _wires(wires, nmode if nmode is not None else 1), (), 0,
                      kind='barrier')
