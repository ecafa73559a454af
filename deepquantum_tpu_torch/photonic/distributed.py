"""Distributed Fock-state simulation over a mesh of torch devices.

PyTorch counterpart of ``deepquantum_tpu/photonic/distributed.py``
(reference photonic/distributed.py and circuit.py:2860-2933). The
cutoff^nmode amplitudes are split into k contiguous shards, one a device of
the mesh; k must divide cutoff^nmode, and here it must be cutoff^j * f with
f dividing cutoff (then the split is along modes: modes 0..j-1 one value a
shard, mode j's range cut into f runs).

A shard is a tensor of the modes' extents: cutoff for a whole mode, less for
a sharded one. A gate on modes that every shard holds whole runs on each
shard through ``ops/apply.py`` at ``qudit=cutoff`` (the sharded modes a
batch axis). A gate on a sharded mode first moves the sharding to a mode the
gate does not touch (an all-to-all within each group of shards that differ
in that mode's run: each sends a slice of the other mode and receives a run
of the gate's), then runs, then moves it back. No step holds the whole
tensor on one device; every step is plain torch, so autograd
differentiates the forward.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import cdtype
from ..ops.apply import evolve_state
from ..parallel.sharded import Mesh, make_mesh
from .circuit import QumodeCircuit, draw_outcomes
from .state import FockState

__all__ = ['DistributedFockState', 'DistributedQumodeCircuit']


class _Layout:
    """Which modes are sharded, by how much, in the shard index's radix
    order (the first listed the most significant)."""

    def __init__(self, nmode: int, cutoff: int, parts) -> None:
        self.nmode, self.cutoff = nmode, cutoff
        self.parts = tuple(parts)            # ((mode, factor), ...)

    @classmethod
    def standard(cls, nmode: int, cutoff: int, k: int) -> '_Layout':
        """The layout of k contiguous slices of the flat amplitudes."""
        c = cutoff
        if (c ** nmode) % k:
            raise ValueError(f'the mesh size {k} must divide cutoff^nmode = {c ** nmode}')
        parts, rest = [], k
        while rest % c == 0 and rest > 1:
            parts.append((len(parts), c))
            rest //= c
        if rest > 1:
            if c % rest or len(parts) >= nmode:
                raise ValueError(f'a mesh of {k} shards at cutoff {c}: the size must be '
                                 'cutoff^j times a divisor of the cutoff')
            parts.append((len(parts), rest))
        return cls(nmode, c, parts)

    @property
    def factors(self) -> dict:
        return dict(self.parts)

    def extents(self) -> tuple:
        f = self.factors
        return tuple(self.cutoff // f.get(m, 1) for m in range(self.nmode))

    def digits(self, rank: int) -> dict:
        """mode -> run index of shard ``rank``."""
        out = {}
        for mode, fac in reversed(self.parts):
            out[mode] = rank % fac
            rank //= fac
        return out

    def rank(self, digits: dict) -> int:
        r = 0
        for mode, fac in self.parts:
            r = r * fac + digits[mode]
        return r

    def moved(self, src: int, dst: int) -> '_Layout':
        return _Layout(self.nmode, self.cutoff,
                       [(dst if m == src else m, f) for m, f in self.parts])


def _relayout(shards, layout: _Layout, src: int, dst: int):
    """Move the sharding of mode ``src`` to mode ``dst`` (whole in every
    shard): an all-to-all in each group of shards that differ only in
    ``src``'s run. Returns (shards, the new layout)."""
    fac = layout.factors[src]
    new = layout.moved(src, dst)
    run_src = layout.cutoff // fac
    out = [None] * len(shards)
    for r in range(len(shards)):
        digits = new.digits(r)                 # its run of dst, and the others
        b = digits[dst]
        pieces = []
        for a in range(fac):
            old = dict(digits)
            del old[dst]
            old[src] = a
            x = shards[layout.rank(old)]
            pieces.append(x.narrow(dst, b * run_src, run_src).to(shards[r].device))
        out[r] = torch.cat(pieces, dim=src)
    return out, new


def _apply_shard(x, mat, layout: _Layout, wires):
    """A gate on whole modes of one shard: the sharded modes ride as batch
    axes in front of the qudit axes."""
    sharded = [m for m, _ in layout.parts]
    rest = [m for m in range(layout.nmode) if m not in sharded]
    perm = sharded + rest
    xp = x.permute(perm)
    y = evolve_state(xp, mat, len(rest), [rest.index(w) for w in wires], layout.cutoff)
    inv = [perm.index(m) for m in range(layout.nmode)]
    return y.permute(inv)


def _apply_sharded(shards, layout: _Layout, mat, wires):
    """One gate on the shards; a sharded mode among its wires is made whole
    first and sharded again after."""
    moves = []
    for w in wires:
        if w in layout.factors:
            free = [m for m in range(layout.nmode - 1, -1, -1)
                    if m not in wires and m not in layout.factors]
            if not free:
                raise ValueError(f'a gate on modes {list(wires)}: no whole mode to move the '
                                 'sharding to')
            shards, layout = _relayout(shards, layout, w, free[0])
            moves.append((w, free[0]))
    mats = {}
    out = []
    for x in shards:
        m = mats.get(x.device)
        if m is None:
            m = mats[x.device] = mat.to(x.device)
        out.append(_apply_shard(x, m, layout, list(wires)))
    for w, dst in reversed(moves):
        out, layout = _relayout(out, layout, dst, w)
    return out


class DistributedFockState:
    """A Fock state tensor split over a mesh (reference photonic/state.py:623):
    ``shards`` are the k contiguous slices of the cutoff^nmode amplitudes,
    one a device, each shaped by the modes' extents; ``amps`` gathers them
    flat on the mesh's first device."""

    def __init__(self, state, nmode: int, cutoff: int, mesh: Mesh | None = None,
                 shards=None) -> None:
        self.mesh = make_mesh() if mesh is None else mesh
        self.nmode = nmode
        self.cutoff = cutoff
        self.layout = _Layout.standard(nmode, cutoff, self.mesh.size)
        if shards is not None:
            self.shards = list(shards)
            return
        if isinstance(state, FockState):
            state = state.state
        ints = np.asarray(state, np.int64).reshape(-1)
        idx = 0
        for k in ints:
            idx = idx * cutoff + int(k)
        self._set_basis(idx)

    def _set_basis(self, idx: int) -> None:
        ext = self.layout.extents()
        size = int(np.prod(ext))
        self.shards = []
        for r, dev in enumerate(self.mesh.devices):
            s = torch.zeros(ext, dtype=cdtype(), device=dev)
            if idx // size == r:
                s.view(-1)[idx % size] = 1
            self.shards.append(s)

    @classmethod
    def from_flat(cls, flat, nmode: int, cutoff: int, mesh: Mesh) -> 'DistributedFockState':
        """The contiguous slices of a flat (or (cutoff,)*nmode) tensor."""
        layout = _Layout.standard(nmode, cutoff, mesh.size)
        flat = torch.as_tensor(flat).reshape(-1).to(cdtype())
        shards = [c.to(d).reshape(layout.extents())
                  for c, d in zip(flat.chunk(mesh.size), mesh.devices)]
        return cls(None, nmode, cutoff, mesh, shards)

    def reset(self) -> None:
        self._set_basis(0)

    @property
    def amps(self) -> torch.Tensor:
        dev = self.mesh.devices[0]
        return torch.cat([s.reshape(-1).to(dev) for s in self.shards])


class DistributedQumodeCircuit(QumodeCircuit):
    """Fock-tensor circuit over a sharded amplitude axis (reference
    circuit.py:2860): tensor mode (``basis=False``) on state vectors, gates
    only. ``forward`` returns the final amplitudes flat, (cutoff^nmode,),
    gathered on the mesh's first device, and keeps the shards in
    ``dstate``; ``measure`` samples the shards."""

    def __init__(self, nmode: int, init_state, cutoff: int | None = None,
                 name: str | None = None, mesh: Mesh | None = None, noise: bool = False,
                 mu: float = 0, sigma: float = 0.1, noise_per_forward: bool = False) -> None:
        if mesh is None:
            mesh = make_mesh()
        super().__init__(nmode=nmode, init_state=init_state, cutoff=cutoff, backend='fock',
                         basis=False, name=name, noise=noise, mu=mu, sigma=sigma,
                         noise_per_forward=noise_per_forward, device=mesh.devices[0])
        self.mesh = mesh
        self.layout = _Layout.standard(nmode, self.cutoff, mesh.size)
        self.dstate = None

    def _initial(self, state) -> DistributedFockState:
        if isinstance(state, DistributedFockState):
            return state
        if state is None:
            state = self.init_state
        if isinstance(state, FockState) and state._ints is not None:
            return DistributedFockState(state._ints, self.nmode, self.cutoff, self.mesh)
        if isinstance(state, (list, tuple)) and np.asarray(state).ndim == 1:
            return DistributedFockState(list(state), self.nmode, self.cutoff, self.mesh)
        if isinstance(state, FockState):
            state = state.tensor(self.device, cdtype())
        return DistributedFockState.from_flat(torch.as_tensor(state), self.nmode, self.cutoff,
                                              self.mesh)

    def forward(self, data=None, state=None, is_prob=None, detector=None, sort=True,
                stepwise=False, params=None, noise_generator: torch.Generator | None = None):
        """Evolve the shards; returns the final amplitudes (probabilities
        with ``is_prob``) flat, (cutoff^nmode,), gathered on the mesh's
        first device. ``noise_generator`` draws the per-forward noise."""
        if data is not None and np.ndim(data) > 1:
            raise ValueError('a distributed Fock circuit takes one row of data at a time')
        full = self._fock_full(data, params, self._noise_jitter(noise_generator))
        shards = [s for s in self._initial(state).shards]
        for op, mat in zip(self.operators, self._fock_matrices(full)):
            if op.kind == 'barrier':
                continue
            if op.kind != 'gate':
                raise ValueError(f'a distributed Fock circuit takes gates only, not {op.name}')
            shards = _apply_sharded(shards, self.layout, mat, list(op.wires))
        self.dstate = DistributedFockState(None, self.nmode, self.cutoff, self.mesh, shards)
        self._state_is_prob = bool(is_prob)
        amps = self.dstate.amps
        self.state = amps.abs() ** 2 if is_prob else amps
        return self.state

    def measure(self, shots: int = 1024, with_prob: bool = False, wires=None, detector=None,
                generator: torch.Generator | None = None, mcmc: bool = False):
        """Sample Fock outcomes from the shards: the shards' masses split
        the shots by one multinomial on ``generator``, then each shard draws
        its share from its own probabilities. {FockState: count} (with
        ``with_prob`` {FockState: (count, probability)}); ``wires`` keeps
        those modes' photon numbers."""
        if mcmc:
            raise NotImplementedError('measure(mcmc=True) is not ported (Markov-chain sampling)')
        if self.dstate is None:
            raise RuntimeError('Run the circuit forward before measurement')
        c, n = self.cutoff, self.nmode
        keep = list(range(n)) if wires is None else \
            ([wires] if isinstance(wires, int) else sorted(wires))
        probs = [s.detach().abs().reshape(-1).to(torch.float64) ** 2 for s in self.dstate.shards]
        size = probs[0].numel()
        gdev = generator.device if generator is not None else probs[0].device
        masses = torch.stack([p.sum().to(gdev) for p in probs])
        split = torch.bincount(torch.multinomial(masses, shots, replacement=True,
                                                 generator=generator),
                               minlength=len(probs)).tolist()
        total = float(masses.sum())
        counts, pfull = {}, {}
        for r, (p, k) in enumerate(zip(probs, split)):
            if not k:
                continue
            drawn = draw_outcomes(p.to(gdev)[None], k, generator)[0]
            idx, cnt = torch.unique(drawn, return_counts=True)
            hit = (p.to(gdev)[idx] / total).tolist()
            digits = np.unravel_index(r * size + idx.cpu().numpy(), (c,) * n)
            keys = np.stack([digits[w] for w in keep], -1).tolist()
            for key, m, q in zip(map(tuple, keys), cnt.tolist(), hit):
                counts[key] = counts.get(key, 0) + m
                pfull[key] = pfull.get(key, 0.0) + q
        if with_prob and wires is not None:
            marg = self._marginal(keep)
            pfull = {key: float(marg[key]) for key in counts}
        return {FockState(list(key), len(keep), c): (m, pfull[key]) if with_prob else m
                for key, m in counts.items()}

    def _marginal(self, keep) -> np.ndarray:
        """The probabilities of the kept modes, (cutoff,)*len(keep), summed
        shard by shard (each shard's part placed at its runs)."""
        c, lay = self.cutoff, self.dstate.layout
        out = np.zeros((c,) * len(keep))
        for r, s in enumerate(self.dstate.shards):
            p = s.detach().abs().to(torch.float64) ** 2
            other = tuple(m for m in range(self.nmode) if m not in keep)
            part = (p.sum(other) if other else p).cpu().numpy()
            digits = lay.digits(r)
            sl = tuple(slice(digits[m] * part.shape[i], (digits[m] + 1) * part.shape[i])
                       if m in digits else slice(None) for i, m in enumerate(keep))
            out[sl] += part
        return out / out.sum()
