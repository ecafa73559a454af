"""Amplitude-sharded statevectors over a mesh of torch devices.

PyTorch counterpart of ``deepquantum_tpu/parallel/sharded.py``. The JAX
package is single-controller SPMD: one process drives every shard of a
``jax.sharding.Mesh`` and GSPMD compiles the collectives. The port keeps
that model with no compiler in between:

- a mesh (``Mesh``) is a tuple of torch devices; the same card may appear
  several times (``make_mesh(devices=['cuda:0'] * 4)``: four shards on one
  card), and ``set_device('cpu')`` then ``make_mesh(8)`` gives eight shards
  on the CPU, the counterpart of the JAX tests' eight virtual devices;
- the 2^n amplitudes are split into ``mesh.size`` contiguous shards, one a
  device: qubits 0..k-1 (the most significant) are global on a 2^k-shard
  mesh, the rest local;
- an exchange between shards is a copy between shard tensors (the pair
  exchanges of ``shardmap_engine.py``), and a psum is a sum of per-shard
  partials.

``ShardedSimulator`` (the ``engine='gspmd'`` engine) runs a circuit gate by
gate on complex shards through ``ops/apply.py``: a gate on local qubits is
one einsum per shard; a global target is first swapped with a free local
qubit (a half-shard exchange) and swapped back after the gate; a global
control selects the shards whose rank bit is 1. Every step is a plain
torch operation, so autograd differentiates it, at any dtype.
"""

from __future__ import annotations

import os

import torch

from ..bitmath import get_bit, is_power_of_2, log_base2
from ..config import cdtype, default_device, rdtype, resolve_device

__all__ = ['Mesh', 'make_mesh', 'ShardedSimulator', 'DistributedQubitState',
           'setup_distributed', 'cleanup_distributed']


class Mesh:
    """A 1-D mesh: the shards' torch devices, in rank order, and the axis
    name of the statevector."""

    def __init__(self, devices, axis_name: str = 'sv') -> None:
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError('a mesh needs at least one device')
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f'Mesh({[str(d) for d in self.devices]}, axis_name={self.axis_name!r})'


def make_mesh(n_devices: int | None = None, axis_name: str = 'sv', devices=None) -> Mesh:
    """1-D mesh over the statevector axis.

    With ``devices`` (a list of devices, repeats allowed), those, or their
    first ``n_devices``. Otherwise on the default device: the first
    ``n_devices`` visible CUDA cards (all of them when None; asking for
    more than are visible raises: a card is never repeated unless the
    caller lists it), or under ``set_device('cpu')`` ``n_devices`` shards
    (default 1) on the CPU."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f'make_mesh({n_devices}): {len(devs)} devices given')
            devs = devs[:n_devices]
        return Mesh(devs, axis_name)
    dev = resolve_device(default_device())
    if dev.type == 'cuda':
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise RuntimeError(f'make_mesh({n}): {count} CUDA card(s) visible; to put several '
                               "shards on one card pass devices=['cuda:0'] * k")
        return Mesh([torch.device('cuda', i) for i in range(n)], axis_name)
    return Mesh([dev] * (1 if n_devices is None else n_devices), axis_name)


def mesh_geometry(nqubit: int, mesh: Mesh):
    """(nglobal, nlocal) of an n-qubit state on the mesh."""
    if not is_power_of_2(mesh.size):
        raise ValueError(f'the mesh size must be a power of 2, got {mesh.size}')
    nglobal = log_base2(mesh.size)
    if nglobal > nqubit:
        raise ValueError(f'{mesh.size} shards for {nqubit} qubits')
    return nglobal, nqubit - nglobal


def rank_bit(rank: int, nglobal: int, gq: int) -> int:
    """Global qubit gq's value on shard ``rank`` (qubit 0 the most
    significant bit of the rank; the JAX engine's ``_gbit``)."""
    return get_bit(rank, nglobal - 1 - gq)


def split_state(state, mesh: Mesh) -> list:
    """A flat (or (2^n, 1)) state as ``mesh.size`` contiguous shards, each
    on its device; differentiable."""
    flat = torch.as_tensor(state).reshape(-1).to(cdtype())
    chunks = flat.chunk(mesh.size)
    return [c.to(d) for c, d in zip(chunks, mesh.devices)]


def full_params(circuit, params=None, data=None) -> torch.Tensor:
    """The circuit's full parameter vector for one forward: data of shape
    (ndata,) only (the sharded engines run one state at a time)."""
    if circuit.ndata == 0:
        data = None
    if data is None:
        return circuit._full_params(params)
    data = torch.as_tensor(data, device=circuit.device).to(rdtype())
    if data.dim() != 1:
        raise ValueError('the sharded engines run one state at a time: data of shape '
                         f'(ndata,), got {tuple(data.shape)}')
    return circuit._full_params(params, data, circuit._data_indices(data.shape[-1]))


def gather(shards, device) -> torch.Tensor:
    """The shards concatenated into the flat state on ``device``."""
    return torch.cat([s.reshape(-1).to(device) for s in shards])


class ShardedSimulator:
    """Applies a circuit's gates to complex amplitude shards (the JAX
    package's GSPMD engine, written as the explicit exchange program)."""

    def __init__(self, nqubit: int, mesh: Mesh, axis_name: str = 'sv') -> None:
        self.nqubit = nqubit
        self.mesh = mesh
        self.axis_name = axis_name
        self.nglobal, self.nlocal = mesh_geometry(nqubit, mesh)

    def init_state(self) -> list:
        """|0...0>: shard 0 holds the amplitude 1."""
        out = []
        for r, dev in enumerate(self.mesh.devices):
            s = torch.zeros(1 << self.nlocal, dtype=cdtype(), device=dev)
            if r == 0:
                s[0] = 1
            out.append(s)
        return out

    def shard(self, state) -> list:
        return split_state(state, self.mesh)

    def gather(self, shards) -> torch.Tensor:
        return gather(shards, self.mesh.devices[0])

    def apply_gate(self, shards, matrix: torch.Tensor, wires, controls=()) -> list:
        """One gate on the shards (a new list)."""
        from ..ops.apply import evolve_state_controlled
        from .shardmap_engine import _swap_gl
        k, nl = self.nglobal, self.nlocal
        wires, controls = list(wires), list(controls)
        gctrl = [c for c in controls if c < k]
        lctrl = [c - k for c in controls if c >= k]
        gtarg = [w for w in wires if w < k]
        used = {w - k for w in wires if w >= k} | set(lctrl)
        free = [q for q in range(nl) if q not in used]
        if len(free) < len(gtarg):
            raise ValueError(f'a gate on wires {wires} needs {len(gtarg)} free local qubits, '
                             f'{len(free)} of {nl} are free')
        swaps = list(zip(gtarg, free))
        remap = dict(swaps)
        lw = [remap[w] if w in remap else w - k for w in wires]
        for gq, lq in swaps:
            shards = _swap_gl(k, nl, shards, gq, lq, in_place=False)
        mats = {}
        out = []
        for r, x in enumerate(shards):
            if all(rank_bit(r, k, c) for c in gctrl):
                m = mats.get(x.device)
                if m is None:
                    m = mats[x.device] = matrix.to(device=x.device, dtype=x.dtype)
                x = evolve_state_controlled(x.reshape([2] * nl), m, nl, lw, lctrl).reshape(-1)
            out.append(x)
        for gq, lq in reversed(swaps):
            out = _swap_gl(k, nl, out, gq, lq, in_place=False)
        return out

    def run(self, circuit, full_params: torch.Tensor, shards) -> list:
        """Apply every gate of a QubitCircuit's op list."""
        for op in circuit.operators:
            if op.kind in ('barrier', 'cut'):
                continue
            if op.kind != 'gate':
                raise ValueError(f'the sharded engine takes unitary gates only, not {op.name}')
            shards = self.apply_gate(shards, op.matrix(full_params).to(cdtype()), op.wires,
                                     op.controls)
        return shards

    def observe(self, obs, shards) -> list:
        """O|psi> of a Pauli-string observable."""
        from ..circuit import _PAULI_FNS
        for wire, b in zip(obs.wires, obs.basis):
            shards = self.apply_gate(shards, _PAULI_FNS[b](self.mesh.devices[0]), [wire[0]])
        return shards

    def inner(self, a, b) -> torch.Tensor:
        """Re<a|b> summed over the shards (the psum), on the first device."""
        dev = self.mesh.devices[0]
        return sum((x.conj() * y).sum().real.to(dev) for x, y in zip(a, b))

    def expectation(self, circuit, full_params: torch.Tensor, shards) -> torch.Tensor:
        """<psi|O|psi> for every observable, psi the circuit on ``shards``."""
        final = self.run(circuit, full_params, shards)
        return torch.stack([self.inner(final, self.observe(obs, final))
                            for obs in circuit.observables], dim=-1)

    def probs(self, shards) -> list:
        return [s.abs() ** 2 for s in shards]


def measure_shards(probs, nglobal: int, nlocal: int, shots: int, wires=None,
                   with_prob: bool = False, generator=None) -> dict:
    """Two-level sampling of sharded probabilities (the reference's
    measure_dist): the shards that agree on the measured global qubits form
    a group; the groups' masses split the shots by one multinomial, and each
    group draws its share from its marginal over the measured local qubits.
    Nothing is gathered but those marginals (each a shard's size at most).
    Returns {bitstring: count}, or {bitstring: (count, probability)}."""
    from ..ops.qmath import marginal_probs
    from ..photonic.circuit import draw_outcomes
    n = nglobal + nlocal
    keep = list(range(n)) if wires is None else ([wires] if isinstance(wires, int)
                                                 else sorted(wires))
    kg = [w for w in keep if w < nglobal]
    kl = [w - nglobal for w in keep if w >= nglobal]
    groups: dict = {}
    for r, p in enumerate(probs):
        key = tuple(rank_bit(r, nglobal, w) for w in kg)
        m = marginal_probs(p.detach().reshape(-1), nlocal, kl) if kl else p.detach().sum()[None]
        if key in groups:
            groups[key] = groups[key] + m.to(groups[key].device)
        else:
            groups[key] = m
    keys = list(groups)
    gdev = generator.device if generator is not None else groups[keys[0]].device
    masses = torch.stack([groups[key].sum().to(gdev, torch.float64) for key in keys])
    split = torch.bincount(torch.multinomial(masses, shots, replacement=True, generator=generator),
                           minlength=len(keys)).tolist()
    total = float(masses.sum())
    out = {}
    for key, count in zip(keys, split):
        if not count:
            continue
        marg = groups[key].to(gdev, torch.float64)
        drawn = draw_outcomes(marg[None], count, generator)[0]
        idx, cnt = torch.unique(drawn, return_counts=True)
        probs_hit = (marg[idx] / total).tolist() if with_prob else None
        head = ''.join(str(b) for b in key)
        for j, (i, c) in enumerate(zip(idx.tolist(), cnt.tolist())):
            bits = head + (format(i, f'0{len(kl)}b') if kl else '')
            out[bits] = (c, probs_hit[j]) if with_prob else c
    return out


class DistributedQubitState:
    """An amplitude-sharded |0...0> statevector (reference distributed.py:22):
    ``shards`` are the mesh's contiguous slices, one a device; ``state``
    gathers them on the mesh's first device."""

    def __init__(self, nqubit: int, mesh: Mesh | None = None, axis_name: str = 'sv') -> None:
        self.nqubit = nqubit
        self.mesh = mesh if mesh is not None else make_mesh(axis_name=axis_name)
        self.simulator = ShardedSimulator(nqubit, self.mesh, axis_name)
        self.shards = self.simulator.init_state()
        self.world_size = self.mesh.size
        self.rank = 0  # single-controller: every shard is driven here

    def reset(self) -> None:
        self.shards = self.simulator.init_state()

    @property
    def state(self) -> torch.Tensor:
        return self.simulator.gather(self.shards)

    @property
    def amps(self) -> torch.Tensor:
        return self.state


def setup_distributed(backend: str | None = None, port: str = '29500'):
    """Join a torch.distributed process group (reference communication.py:9)
    when the environment names one (``WORLD_SIZE`` > 1 and ``RANK``), at
    ``tcp://MASTER_ADDR:MASTER_PORT`` (default ``localhost`` and ``port``):
    NCCL on cards, gloo on the CPU, unless ``backend`` says. Returns (rank,
    world_size, local_device_count); in a single process a no-op."""
    import torch.distributed as dist
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if not dist.is_available():
        return 0, 1, local
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world > 1 and not dist.is_initialized():
        if backend is None:
            backend = 'nccl' if torch.cuda.is_available() else 'gloo'
        addr = os.environ.get('MASTER_ADDR', 'localhost')
        port = os.environ.get('MASTER_PORT', str(port))
        dist.init_process_group(backend, init_method=f'tcp://{addr}:{port}',
                                rank=int(os.environ['RANK']), world_size=world)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), local
    return 0, 1, local


def cleanup_distributed() -> None:
    """Leave the process group (reference communication.py:39); a no-op
    when none was joined."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
