"""Gate descriptors: the circuit IR.

PyTorch counterpart of ``deepquantum_tpu/gate.py``. A gate is a descriptor:
static metadata (wires, controls, kind) plus a ``matrix_fn`` and indices
into the circuit's flat parameter vector. The simulator walks descriptors
eagerly; nothing is traced.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from .config import cdtype, rdtype, resolve_device
from .ops import gates as G

__all__ = ['GateOp', 'GATE_REGISTRY', 'projection_j_fn', 'latent_fn', 'hamiltonian_fn']


@dataclasses.dataclass
class GateOp:
    """One operation in the circuit IR: kind 'gate' (a unitary), 'channel'
    (a Kraus set, density matrices only), 'barrier', 'reset' (project wires
    on ``extra['postselect']`` and set them to |0>), 'move' (reset the
    second wire, then swap) or 'cut' (a wire-cut marker).

    ``extra`` holds per-op metadata: 'plane' (projection J), 'ham'
    (Hamiltonian gates), 'postselect', and for a standalone descriptor
    (``models.ansatz.make_gate``) its 'inputs' and the circuit that first
    registered its parameters ('_owner'): adding that descriptor to the
    same circuit again shares them."""
    name: str
    wires: tuple
    controls: tuple = ()
    matrix_fn: Callable | None = None      # (params, device) -> (2^k, 2^k) unitary, or a
    #                                        channel's (K, 2^k, 2^k) Kraus set
    static_matrix: Any = None              # fixed matrix when matrix_fn is None
    pidx: tuple = ()                       # indices into the full parameter vector
    npara: int = 0
    kind: str = 'gate'
    condition: bool = False
    requires_grad: bool = True
    inv: bool = False                      # apply the adjoint of the matrix
    extra: dict = dataclasses.field(default_factory=dict)

    def matrix(self, full_params: torch.Tensor | None = None, device=None) -> torch.Tensor:
        """Local unitary on ``full_params``' device: (2^k, 2^k) from a (P,)
        full-parameter vector, a (B, 2^k, 2^k) stack from a (B, P) batch of
        them (a fixed gate stays one (2^k, 2^k) matrix). A channel gives its
        Kraus set, (K, 2^k, 2^k) or (B, K, 2^k, 2^k). Without
        ``full_params`` a standalone descriptor (the class-style API) uses
        its own ``extra['inputs']``, on ``device`` (default: the one it was
        made for, ``extra['device']``, else the default device)."""
        if full_params is None:
            device = resolve_device(self.extra.get('device') if device is None else device)
        else:
            device = full_params.device
        if self.matrix_fn is None:
            mat = torch.as_tensor(np.asarray(self.static_matrix), device=device).to(cdtype())
        else:
            if not self.npara:
                p = None
            elif full_params is None:
                p = torch.as_tensor(np.asarray(self.extra['inputs'], np.float64),
                                    device=device).to(rdtype())
            elif self.pidx == tuple(range(self.pidx[0], self.pidx[0] + len(self.pidx))):
                # a slice: indexing with a host list would copy the index to
                # the device and synchronise the stream on every call
                p = full_params[..., self.pidx[0]:self.pidx[0] + len(self.pidx)]
            else:
                p = full_params[..., list(self.pidx)]
            mat = self.matrix_fn(p, device)
        if self.inv:
            # laid out anew: torch.kron refuses some transposed views
            mat = mat.conj().transpose(-1, -2).contiguous()
        return mat

    def __call__(self, state, device=None) -> torch.Tensor:
        """Apply this gate to a state (the class-style API's standalone use):
        a flat (2^n,) vector, a (2,)*n tensor or a batch (B, 2^n), n from
        ``extra['nqubit']`` (else from the size); the result has the
        state's shape, on the state's device (a tensor) or on ``device``."""
        from .ops.apply import evolve_state_controlled
        if self.kind != 'gate':
            raise ValueError(f'{self.name} cannot be applied standalone')
        if not torch.is_tensor(state):
            state = torch.as_tensor(np.asarray(state), device=resolve_device(
                self.extra.get('device') if device is None else device))
        state = state.to(cdtype())
        n = self.extra.get('nqubit')
        if n is None:
            n = int(round(np.log2(state.numel())))
        x = state.reshape([-1] + [2] * n)
        y = evolve_state_controlled(x, self.matrix(device=state.device), n, list(self.wires),
                                    list(self.controls))
        return y.reshape(state.shape)

    @property
    def all_wires(self) -> tuple:
        return tuple(self.controls) + tuple(self.wires)


@functools.lru_cache(maxsize=None)
def _fixed_matrix(fn, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A fixed gate's matrix, made once per device and dtype: building it
    anew is a host-to-device copy that synchronises the stream. Callers
    must not modify the returned tensor in place. Built outside inference
    mode so that autograd-tracked calls may use it."""
    with torch.inference_mode(False):
        return fn(device)


def _fixed(fn):
    return lambda p, device: _fixed_matrix(fn, torch.device(device), cdtype())


# name -> (nwires, npara, matrix_fn). matrix_fn takes the packed parameter
# subvector p ((npara,) or (B, npara); None for fixed gates) and the target
# device.
GATE_REGISTRY: dict[str, dict] = {
    'U3Gate': dict(nwires=1, npara=3,
                   fn=lambda p, device: G.u3_matrix(p[..., 0], p[..., 1], p[..., 2])),
    'PhaseShift': dict(nwires=1, npara=1, fn=lambda p, device: G.phaseshift_matrix(p[..., 0])),
    'Identity': dict(nwires=1, npara=0, fn=_fixed(G.identity_matrix)),
    'PauliX': dict(nwires=1, npara=0, fn=_fixed(G.paulix_matrix)),
    'PauliY': dict(nwires=1, npara=0, fn=_fixed(G.pauliy_matrix)),
    'PauliZ': dict(nwires=1, npara=0, fn=_fixed(G.pauliz_matrix)),
    'Hadamard': dict(nwires=1, npara=0, fn=_fixed(G.hadamard_matrix)),
    'SGate': dict(nwires=1, npara=0, fn=_fixed(G.s_matrix)),
    'SDaggerGate': dict(nwires=1, npara=0, fn=_fixed(G.sdg_matrix)),
    'TGate': dict(nwires=1, npara=0, fn=_fixed(G.t_matrix)),
    'TDaggerGate': dict(nwires=1, npara=0, fn=_fixed(G.tdg_matrix)),
    'Rx': dict(nwires=1, npara=1, fn=lambda p, device: G.rx_matrix(p[..., 0])),
    'Ry': dict(nwires=1, npara=1, fn=lambda p, device: G.ry_matrix(p[..., 0])),
    'Rz': dict(nwires=1, npara=1, fn=lambda p, device: G.rz_matrix(p[..., 0])),
    'CNOT': dict(nwires=2, npara=0, fn=_fixed(G.cnot_matrix)),
    'Swap': dict(nwires=2, npara=0, fn=_fixed(G.swap_matrix)),
    'ImaginarySwap': dict(nwires=2, npara=0, fn=_fixed(G.iswap_matrix)),
    'Rxx': dict(nwires=2, npara=1, fn=lambda p, device: G.rxx_matrix(p[..., 0])),
    'Ryy': dict(nwires=2, npara=1, fn=lambda p, device: G.ryy_matrix(p[..., 0])),
    'Rzz': dict(nwires=2, npara=1, fn=lambda p, device: G.rzz_matrix(p[..., 0])),
    'Rxy': dict(nwires=2, npara=1, fn=lambda p, device: G.rxy_matrix(p[..., 0])),
    'ReconfigurableBeamSplitter': dict(nwires=2, npara=1,
                                       fn=lambda p, device: G.rbs_matrix(p[..., 0])),
    'Toffoli': dict(nwires=3, npara=0, fn=_fixed(G.toffoli_matrix)),
    'Fredkin': dict(nwires=3, npara=0, fn=_fixed(G.fredkin_matrix)),
}


# matrix functions of the gates built with their own arguments (the plane of
# a projection J, the size of a latent gate, the Hamiltonian): shared by the
# circuit's sugar and ``from_jax``
def projection_j_fn(plane: str):
    return lambda p, device: G.projection_j_matrix(p[..., 0], plane)


def latent_fn(dim: int):
    return lambda p, device: G.latent_matrix(p.reshape(*p.shape[:-1], dim, dim))


def hamiltonian_fn(ham):
    ham = np.asarray(ham, dtype=np.complex128)
    return lambda p, device: G.hamiltonian_matrix(ham, p[..., 0])
