"""DistributedQubitCircuit: the distributed statevector API.

PyTorch counterpart of ``deepquantum_tpu/parallel/circuit.py`` (reference
circuit.py:1625-1770): mesh-sharded, not rank-explicit. One Python process
drives every shard of the mesh; ``world_size=1`` (a one-device mesh) equals
the local engine.
"""

from __future__ import annotations

import torch

from ..circuit import QubitCircuit
from ..config import cdtype, rdtype
from ..ops.planar_gate import from_planar
from .sharded import Mesh, ShardedSimulator, full_params, make_mesh, measure_shards
from .shardmap_engine import ShardMapSimulator

__all__ = ['DistributedQubitCircuit']


class DistributedQubitCircuit(QubitCircuit):
    """Amplitude-sharded statevector circuit over a mesh of torch devices.

    engine='gspmd' runs the gates one by one on complex shards, with the
    exchanges as plain torch copies (autograd differentiates it, at any
    dtype); engine='shardmap' runs the pair-exchange program on float
    planes, every shard's local work through the planar and window
    kernels (K1, K2; K6, or K1 + K5 + K1 with ``fused_bwd = False``, in
    the backward), with one backward across the exchanges
    (shardmap_engine.py). engine='auto' (default) picks 'shardmap' on a
    mesh of CUDA devices under complex64, 'gspmd' elsewhere.
    ``fused_bwd`` is True by default here (the JAX engine's K6 backward).

    The circuit's parameters live on the mesh's first device. ``forward``
    returns the final state flat, (2^n,), gathered on that device, and
    keeps the shards (``shards``, one a device); ``expectation`` and
    ``measure`` work on the shards and never gather the state.
    """

    fused_bwd: bool = True

    def __init__(self, nqubit: int, mesh: Mesh | None = None, name: str | None = None,
                 reupload: bool = False, shots: int = 1024, engine: str = 'auto') -> None:
        if mesh is None:
            mesh = make_mesh()
        super().__init__(nqubit=nqubit, init_state='zeros', name=name, device=mesh.devices[0],
                         reupload=reupload, shots=shots)
        self.mesh = mesh
        self.sim = ShardedSimulator(nqubit, mesh)
        if engine not in ('auto', 'gspmd', 'shardmap'):
            raise ValueError(f"engine must be 'auto', 'gspmd' or 'shardmap', got {engine!r}")
        if engine == 'auto':
            engine = ('shardmap' if all(d.type == 'cuda' for d in mesh.devices)
                      and cdtype() == torch.complex64 else 'gspmd')
        self.engine = engine
        self.shards = None
        self._smap = ShardMapSimulator(nqubit, mesh)

    def _shards_of(self, state):
        """A forward's initial complex shards: |0...0> for None, else the
        state's contiguous slices on the mesh's devices."""
        if state is None:
            return self.sim.init_state()
        from ..state import QubitState
        from .sharded import DistributedQubitState
        if isinstance(state, DistributedQubitState):
            return [s.to(cdtype()) for s in state.shards]
        if isinstance(state, QubitState):
            state = state.state
        return self.sim.shard(torch.as_tensor(state))

    def forward(self, data=None, state=None, params=None) -> torch.Tensor:
        """Run the circuit on the shards; returns the final state, flat
        (2^n,), gathered on the mesh's first device (the shards stay in
        ``shards``)."""
        if self.engine == 'shardmap':
            planes = self._smap.run_shards(self, params, data, state)
            shards = [from_planar(p) for p in planes]
        else:
            shards = self.sim.run(self, full_params(self, params, data), self._shards_of(state))
        self.shards = shards
        self.state = self.sim.gather(shards)
        return self.state

    def expectation(self, data=None, state=None, params=None, shots: int | None = None,
                    adjoint: bool = False):
        """<psi|O|psi> per observable, (n_observables,), from the shards:
        each shard's partial summed (the psum). ``adjoint`` (parameters
        only; data encoders keep their stored values): the adjoint method
        over the shards, whatever the engine. It is the shardmap engine's
        program, whose backward un-applies step by step with nothing kept
        but the final shards: through the kernels where the engine's policy
        allows (a CUDA mesh under complex64), else their plain twins."""
        if not self.observables:
            raise ValueError('There is no observable')
        if shots is not None:
            raise NotImplementedError('DistributedQubitCircuit.expectation(shots=...): sample '
                                      'with measure() in the observable basis')
        if adjoint:
            if data is not None or state is not None:
                raise ValueError('the adjoint path takes parameters only')
            p = self.params if params is None else params
            return self._smap.expectation(self, torch.as_tensor(p, device=self.device)
                                          .to(rdtype()).reshape(-1))
        if self.engine == 'shardmap':
            return self._smap.expectation(self, params, data, state)
        return self.sim.expectation(self, full_params(self, params, data), self._shards_of(state))

    def measure(self, shots: int | None = None, with_prob: bool = False, wires=None,
                generator: torch.Generator | None = None):
        """Sample the last forward's shards by two-level sampling (shard
        masses, then each shard's own draw), from ``generator``:
        {bitstring: count}, or {bitstring: (count, probability)}. None
        before the first forward."""
        if shots is None:
            shots = self.shots
        if self.shards is None:
            return None
        return measure_shards(self.sim.probs(self.shards), self.sim.nglobal,
                              self.sim.nlocal, shots, wires, with_prob, generator)
