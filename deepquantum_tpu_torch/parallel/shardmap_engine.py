"""The pair-exchange statevector engine (arXiv:2311.01512) on a torch mesh.

PyTorch counterpart of ``deepquantum_tpu/parallel/shardmap_engine.py``.
Qubits 0..k-1 (the most significant) are global on a 2^k-shard mesh; each
shard holds its 2^(n-k) amplitudes as float32 planes (2, 2^(n-k)) under
complex64 (float64 under complex128). The communication pattern is the
reference's:

- a run of gates on local qubits runs on every shard with no exchange
  (Alg.5), through the local engine's chain helpers: ``planar_apply`` (K1)
  for a gate, ``window_apply`` (K2) for a dense window, ``_rotate_planar``
  for a relabel, or the whole run as one window-chain launch at
  14 <= nlocal <= 19;
- a single-qubit gate on a global qubit is one full-shard pair exchange
  with the rank-bit partner and a 2 x 2 blend (``_g1_apply``, Alg.6);
- a multi-qubit gate with global targets swaps each one with a free local
  qubit (``_swap_gl``, a half-shard exchange), applies locally and swaps
  back (Alg.8-10);
- an expectation is a sum of per-shard partials (the psum).

One process drives every shard; an exchange is a copy between shard
tensors (none at all between two shards on one card, where the partner is
read where it lies), so four shards on one card run the whole exchange
program there, with its kernels.

The circuit compiles into a ``program`` of steps plus their matrix
planes; each maximal run of local gates is one step, scheduled by the
single-card scheduler (``schedule_planar_seq``: relabels and windows),
closing back to the identity labeling, so exchanges always see the
standard layout. Two
``torch.autograd.Function``s span the whole program across all shards,
exchanges included (``shardmap_chain``, ``shardmap_expectation``): the
forward keeps only the final shards, and the backward un-applies each step
(U^H for a gate, the same pattern for an exchange: it is its own inverse),
reduces the matrix cotangent on every shard and sums it over the shards
(what shard_map's transpose does with the JAX program's replicated matrix
inputs), and carries the state cotangent on. A run's backward is the
local engine's (``_chain_backward``): a gate ``planar_bwd_fused`` (K6),
or K1 + K5 + K1 when the circuit's ``fused_bwd`` is False; a window K2 on
W^H plus ``window_grad``.

The ``planar`` policy: on a mesh of CUDA devices under complex64 with at
least 4 local qubits the steps run the kernels; elsewhere the same program
runs through their plain twins (a wrapper given CPU tensors takes its twin
by itself). ``planar=True`` on the CPU schedules and runs the program as on
the card, through the twins.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bitmath import flip_bit
from ..config import cdtype, rdtype
from ..ops.apply import permute_matrix_wires
from ..ops.planar_gate import (_chain_backward, _chain_forward, _conj_t, _flat_planes,
                               _split_planes, from_planar, planar_bwd_fused_plain,
                               planar_evolve_xla, to_planar)
from .sharded import Mesh, full_params, measure_shards, mesh_geometry, rank_bit, split_state

__all__ = ['ShardMapSimulator', 'shardmap_chain', 'shardmap_expectation']


class _Cfg(NamedTuple):
    """Geometry and routes of one engine."""
    nglobal: int
    nlocal: int
    use_kernels: bool
    fused_bwd: bool


# --------------------------------------------------------------- primitives
def _pairs(nglobal: int, gq: int):
    """Alg.6's partner rule: each rank whose global qubit gq is 0 with the
    rank that differs from it in that bit alone."""
    shift = nglobal - 1 - gq
    return [(r, flip_bit(r, shift)) for r in range(1 << nglobal) if not rank_bit(r, nglobal, gq)]


def _cmul(mr, mi, x):
    """(mr + i mi) x on (2, N) planes, m a scalar."""
    return torch.stack([mr * x[0] - mi * x[1], mr * x[1] + mi * x[0]])


def _g1_apply(nglobal: int, shards, mre, mim, gq: int) -> list:
    """A single-qubit gate (planes (2, 2)) on global qubit gq: each shard
    blends itself with its rank-bit partner (one full-shard exchange,
    Alg.6); plain elementwise torch. Returns new shards."""
    out = list(shards)
    for lo, hi in _pairs(nglobal, gq):
        a, b = shards[lo], shards[hi]
        for r, (x0, x1) in ((lo, (a, b.to(a.device))), (hi, (a.to(b.device), b))):
            i = rank_bit(r, nglobal, gq)
            mr, mi = mre.to(x0.device), mim.to(x0.device)
            out[r] = _cmul(mr[i, 0], mi[i, 0], x0) + _cmul(mr[i, 1], mi[i, 1], x1)
    return out


def _swap_gl(nglobal: int, nlocal: int, shards, gq: int, lwire: int, in_place: bool = True) -> list:
    """Swap global qubit gq with local qubit lwire: each pair of partners
    exchanges half a shard (Alg.8). A permutation of the full state, its
    own inverse. The last axis of a shard is its local amplitude index;
    ``in_place`` swaps the halves where they lie, else new tensors
    (autograd's route)."""
    out = list(shards)
    for lo, hi in _pairs(nglobal, gq):
        a, b = shards[lo], shards[hi]
        lead = tuple(a.shape[:-1])
        view = lead + (1 << lwire, 2, 1 << (nlocal - 1 - lwire))
        va, vb = a.view(view), b.view(view)
        if in_place:
            # the low shard's lwire = 1 half becomes the high shard's lwire = 0 half
            tmp = va[..., 1, :].clone()
            va[..., 1, :].copy_(vb[..., 0, :])
            vb[..., 0, :].copy_(tmp)
            continue
        out[lo] = torch.stack([va[..., 0, :], vb[..., 0, :].to(a.device)], -2).reshape(a.shape)
        out[hi] = torch.stack([va[..., 1, :].to(b.device), vb[..., 1, :]], -2).reshape(b.shape)
    return out


def _shard_sum(parts, device):
    """A per-shard partial summed over the shards (the psum), on ``device``."""
    return sum(p.to(device) for p in parts)


def _inner_planes(gr, gi, xr, xi):
    """One entry of the planar cotangent convention: (sum gr xr + gi xi,
    sum gi xr - gr xi)."""
    return (gr * xr + gi * xi).sum(), (gi * xr - gr * xi).sum()


# ------------------------------------------------------------ program steps
# A program is a tuple of hashable steps:
#   ('run', seq)           a maximal run of local gates: seq is the single-card
#                          sequence (sorted local-wire tuples, ('rot', delta)
#                          relabels, ('win', w) windows), run on every shard
#                          by the local engine's chain helpers
#   ('g1', gq)             single-qubit gate on global qubit gq; (2, 2) planes
#   ('remap', swaps, ws, gc)
#                          swaps: ((gq, lwire), ...) applied in order, then a
#                          local apply on sorted wires ws (planes permuted to
#                          that order) on the shards whose global control
#                          qubits gc are all 1, then the swaps undone in
#                          reverse
# Planes are held per slot: one for each entry of a run, one for any other
# step, None at a relabel.
def _step_slots(program) -> list:
    """Each step's slots: a run's entries, else the step itself."""
    return [st[1] if st[0] == 'run' else (st,) for st in program]


def _slots(program) -> tuple:
    return tuple(slot for per in _step_slots(program) for slot in per)


def _by_step(program, seq) -> list:
    """A slot-aligned sequence cut into one list per step."""
    out, i = [], 0
    for per in _step_slots(program):
        out.append(list(seq[i:i + len(per)]))
        i += len(per)
    return out


def _on(planes, device) -> list:
    return [None if m is None else m.to(device) for m in planes]


def _kernel_run(cfg: _Cfg, seq) -> bool:
    """Does a run go through the kernels? Every gate on <= 3 wires."""
    return cfg.use_kernels and all(ws[0] in ('rot', 'win') or len(ws) <= 3 for ws in seq)


def _run_fwd(cfg: _Cfg, x, mres, mims, seq):
    """A run of local gates on one shard, as the local engine's forward
    (K1 a gate, K2 a window, the window-chain kernel at 14 <= nlocal <= 19);
    off the kernels gate by gate through the twin. A new tensor."""
    mres, mims = _on(mres, x.device), _on(mims, x.device)
    if _kernel_run(cfg, seq):
        return _chain_forward(x, mres, mims, cfg.nlocal, seq)
    for mre, mim, ws in zip(mres, mims, seq):
        x = planar_evolve_xla(x, mre, mim, cfg.nlocal, ws)
    return x


def _run_bwd(cfg: _Cfg, y, g, mres, mims, seq):
    """A run's backward on one shard, as the local engine's
    (``_chain_backward``: K6, or K1 + K5 + K1 without ``fused_bwd``;
    windows K2 + ``window_grad``; the window-chain kernel at 14 <= nlocal
    <= 19): (x, g_in, dres, dims), y and g not written."""
    mres, mims = _on(mres, y.device), _on(mims, y.device)
    if _kernel_run(cfg, seq):
        return _chain_backward(y, g, mres, mims, cfg.nlocal, seq, cfg.fused_bwd)
    dres, dims = [None] * len(seq), [None] * len(seq)
    for i in range(len(seq) - 1, -1, -1):
        y, g, dres[i], dims[i] = planar_bwd_fused_plain(y, g, *_conj_t(mres[i], mims[i]),
                                                        cfg.nlocal, seq[i])
    return y, g, dres, dims


def _controlled(cfg: _Cfg, gc):
    """The shards whose global control qubits gc are all 1."""
    return [r for r in range(1 << cfg.nglobal) if all(rank_bit(r, cfg.nglobal, c) for c in gc)]


def _step_apply(cfg: _Cfg, xs, mres, mims, step) -> list:
    """One step on every shard (mres / mims: the step's slots); a remap's
    swaps update the shards in place. Returns the shards."""
    kind = step[0]
    if kind == 'run':
        return [_run_fwd(cfg, x, mres, mims, step[1]) for x in xs]
    if kind == 'g1':
        return _g1_apply(cfg.nglobal, xs, mres[0], mims[0], step[1])
    swaps, ws, gc = step[1:]
    for gq, lw in swaps:
        xs = _swap_gl(cfg.nglobal, cfg.nlocal, xs, gq, lw)
    for r in _controlled(cfg, gc):
        xs[r] = _run_fwd(cfg, xs[r], mres, mims, (ws,))
    for gq, lw in reversed(swaps):
        xs = _swap_gl(cfg.nglobal, cfg.nlocal, xs, gq, lw)
    return xs


def _step_bwd(cfg: _Cfg, ys, gs, mres, mims, step):
    """Reverse one step: from the step's output shards ys and cotangents
    gs, recover its input, the matrix cotangent of each of its slots summed
    over the shards (None at a relabel), and the propagated cotangent.
    Returns (ys, gs, dres, dims)."""
    kind = step[0]
    dev = next(m.device for m in mres if m is not None)
    if kind == 'run':
        outs = [_run_bwd(cfg, y, g, mres, mims, step[1]) for y, g in zip(ys, gs)]
        dres = [None if m is None else _shard_sum([o[2][i] for o in outs], dev)
                for i, m in enumerate(mres)]
        dims = [None if m is None else _shard_sum([o[3][i] for o in outs], dev)
                for i, m in enumerate(mims)]
        return [o[0] for o in outs], [o[1] for o in outs], dres, dims
    if kind == 'g1':
        mre, mim = mres[0], mims[0]
        mre_t, mim_t = _conj_t(mre, mim)
        gq = step[1]
        xs = _g1_apply(cfg.nglobal, ys, mre_t, mim_t, gq)
        # every amplitude of shard r has the gate bit b = r's rank bit, so g
        # has cotangent rows only at b: dm[b, b] from the shard's own x,
        # dm[b, 1 - b] from its partner's
        dre = torch.zeros((2, 2), dtype=mre.dtype, device=dev)
        dim = torch.zeros((2, 2), dtype=mre.dtype, device=dev)
        for lo, hi in _pairs(cfg.nglobal, gq):
            for r, o in ((lo, hi), (hi, lo)):
                b = rank_bit(r, cfg.nglobal, gq)
                g = gs[r]
                for x, col in ((xs[r], b), (xs[o].to(g.device), 1 - b)):
                    re, im = _inner_planes(g[0], g[1], x[0], x[1])
                    dre[b, col] += re.to(dev)
                    dim[b, col] += im.to(dev)
        gs = _g1_apply(cfg.nglobal, gs, mre_t, mim_t, gq)
        return xs, gs, [dre], [dim]
    swaps, ws, gc = step[1:]
    # F = S^-1 A S with S a real permutation => F^H = S^-1 A^H S; a shard
    # whose control bits are not all 1 passes through, with no cotangent
    for gq, lw in swaps:
        ys = _swap_gl(cfg.nglobal, cfg.nlocal, ys, gq, lw)
        gs = _swap_gl(cfg.nglobal, cfg.nlocal, gs, gq, lw)
    dres, dims = [], []
    for r in _controlled(cfg, gc):
        ys[r], gs[r], dr, di = _run_bwd(cfg, ys[r], gs[r], mres, mims, (ws,))
        dres += dr
        dims += di
    for gq, lw in reversed(swaps):
        ys = _swap_gl(cfg.nglobal, cfg.nlocal, ys, gq, lw)
        gs = _swap_gl(cfg.nglobal, cfg.nlocal, gs, gq, lw)
    return ys, gs, [_shard_sum(dres, dev)], [_shard_sum(dims, dev)]


def _run(cfg: _Cfg, xs, mres, mims, program) -> list:
    """The program on the shards; mres / mims slot-aligned."""
    for r, i, step in zip(_by_step(program, mres), _by_step(program, mims), program):
        xs = _step_apply(cfg, xs, r, i, step)
    return xs


def _program_bwd(cfg: _Cfg, ys, gs, mres, mims, program):
    """The whole program's backward: (cotangents of the input shards,
    dres, dims), the last two slot-aligned with None at relabels."""
    rs, is_ = _by_step(program, mres), _by_step(program, mims)
    dres, dims = [None] * len(program), [None] * len(program)
    for k in range(len(program) - 1, -1, -1):
        ys, gs, dres[k], dims[k] = _step_bwd(cfg, ys, gs, rs[k], is_[k], program[k])
    return gs, [d for per in dres for d in per], [d for per in dims for d in per]


def _work(ts) -> list:
    """Contiguous private copies: the engine updates them in place."""
    return [t.detach().clone(memory_format=torch.contiguous_format) for t in ts]


class _Spec(NamedTuple):
    """What a call's Functions need besides their tensor arguments; the
    observables' planes are slot-aligned constants."""
    cfg: _Cfg
    program: tuple
    obs_programs: tuple
    omres: tuple
    omims: tuple
    nshard: int


def _plane_grads(dres, dims, spec: _Spec, planes):
    """Slot-aligned cotangents as the Function's flat plane gradients."""
    return [d.to(p.dtype) for d, p in zip(_flat_planes(dres, dims, _slots(spec.program)), planes)]


class _ShardChain(torch.autograd.Function):
    """The program on every shard; keeps only the final shards."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        ns = spec.nshard
        planes = tensors[ns:]
        mres, mims = _split_planes(planes, _slots(spec.program))
        ys = _run(spec.cfg, _work(tensors[:ns]), mres, mims, spec.program)
        ctx.save_for_backward(*ys, *planes)
        ctx.spec = spec
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        spec = ctx.spec
        ns = spec.nshard
        saved = ctx.saved_tensors
        ys, planes = saved[:ns], saved[ns:]
        mres, mims = _split_planes(planes, _slots(spec.program))
        gs = [torch.zeros_like(y) if g is None else g for g, y in zip(gs, ys)]
        g_in, dres, dims = _program_bwd(spec.cfg, _work(ys), _work(gs), mres, mims, spec.program)
        return (None, *g_in, *_plane_grads(dres, dims, spec, planes))


def _obs_values(spec: _Spec, psi):
    """<psi|O_i|psi> of each observable program, each summed over the
    shards, and the O_i psi shards."""
    dev = psi[0].device
    vals, oxs = [], []
    for oprog, omr, omi in zip(spec.obs_programs, spec.omres, spec.omims):
        ox = _run(spec.cfg, _work(psi), omr, omi, oprog)
        vals.append(_shard_sum([(p[0] * o[0] + p[1] * o[1]).sum() for p, o in zip(psi, ox)], dev))
        oxs.append(ox)
    return vals, oxs


class _ShardExpectation(torch.autograd.Function):
    """Sum over the shards of <psi|O_i|psi> for each observable program;
    the backward recomputes O_i psi from the saved final shards (dE/dpsi =
    2 O psi for a Hermitian O) and un-applies the program."""

    @staticmethod
    def forward(ctx, spec, *tensors):
        ns = spec.nshard
        planes = tensors[ns:]
        mres, mims = _split_planes(planes, _slots(spec.program))
        psi = _run(spec.cfg, _work(tensors[:ns]), mres, mims, spec.program)
        vals, _ = _obs_values(spec, psi)
        ctx.save_for_backward(*psi, *planes)
        ctx.spec = spec
        return torch.stack(vals)

    @staticmethod
    def backward(ctx, ge):
        spec = ctx.spec
        ns = spec.nshard
        saved = ctx.saved_tensors
        psi, planes = saved[:ns], saved[ns:]
        mres, mims = _split_planes(planes, _slots(spec.program))
        _, oxs = _obs_values(spec, psi)
        gs = None
        for oi, ox in enumerate(oxs):
            part = [(2.0 * ge[oi].to(o.device)) * o for o in ox]
            gs = part if gs is None else [a + b for a, b in zip(gs, part)]
        del oxs
        g_in, dres, dims = _program_bwd(spec.cfg, _work(psi), gs, mres, mims, spec.program)
        return (None, *g_in, *_plane_grads(dres, dims, spec, planes))


def shardmap_chain(shards, mres, mims, spec: _Spec) -> tuple:
    """Run a whole program on the shards' planes; differentiable in the
    shards and every plane, with the final shards as its only residual."""
    return _ShardChain.apply(spec, *shards, *_flat_planes(mres, mims, _slots(spec.program)))


def shardmap_expectation(shards, mres, mims, spec: _Spec) -> torch.Tensor:
    """(n_obs,) values <psi|O_i|psi>, psi the program on the shards,
    differentiable in the shards and the program's planes."""
    return _ShardExpectation.apply(spec, *shards, *_flat_planes(mres, mims, _slots(spec.program)))


# ------------------------------------------------------------------- engine
class ShardMapSimulator:
    """Pair-exchange sharded statevector simulator over a 2^k-shard mesh.

    The engine is plane-based throughout; ``planar=True`` (auto on a CUDA
    mesh under complex64 with >= 4 local qubits) schedules each local run
    into relabels and windows and runs it through the kernels (their twins
    on CPU shards); otherwise each fused gate of a run goes through the
    twin at the policy's precision. The circuit's ``fused_bwd`` makes a
    local gate's backward one ``planar_bwd_fused`` launch a shard, else
    ``planar_apply`` + ``planar_grad`` + ``planar_apply``."""

    def __init__(self, nqubit: int, mesh: Mesh, axis_name: str = 'sv',
                 planar: bool | None = None) -> None:
        self.nqubit = nqubit
        self.mesh = mesh
        self.axis_name = axis_name
        self.ndev = mesh.size
        self.nglobal, self.nlocal = mesh_geometry(nqubit, mesh)
        if planar is None:
            planar = (all(d.type == 'cuda' for d in mesh.devices)
                      and cdtype() == torch.complex64 and self.nlocal >= 4)
        self.planar = planar
        self.use_kernels = planar and rdtype() == torch.float32
        self._obs_cache: dict = {}

    def cfg(self, fused_bwd: bool = False) -> _Cfg:
        return _Cfg(self.nglobal, self.nlocal, self.use_kernels, bool(fused_bwd))

    # ---------------------------------------------------------- compilation
    def _build_program(self, gates):
        """(matrix, wires, global controls) list -> (program, mres, mims):
        the steps and their slot-aligned planes, permuted to the order each
        step's apply expects."""
        k, nl = self.nglobal, self.nlocal
        program, mres, mims = [], [], []
        for mat, wires, gc in gates:
            mat = mat.to(cdtype())
            wires = list(wires)
            global_targets = [w for w in wires if w < k]
            if not global_targets and not gc:
                ws = tuple(sorted(w - k for w in wires))
                order = sorted(range(len(wires)), key=lambda i: wires[i])
                mat = permute_matrix_wires(mat, order)
                program.append(('local', ws))
            elif len(wires) == 1 and not gc:
                program.append(('g1', wires[0]))
            else:
                used_local = {w - k for w in wires if w >= k}
                free_local = [q for q in range(nl) if q not in used_local]
                if len(free_local) < len(global_targets):
                    raise ValueError(f'a gate on wires {wires} needs {len(global_targets)} free '
                                     f'local qubits, {len(free_local)} of {nl} are free')
                swaps = tuple(zip(global_targets, free_local))
                remap = dict(swaps)
                new_wires = [remap[w] if w in remap else w - k for w in wires]
                order = sorted(range(len(new_wires)), key=lambda i: new_wires[i])
                mat = permute_matrix_wires(mat, order)
                program.append(('remap', swaps, tuple(sorted(new_wires)), tuple(gc)))
            mres.append(mat.real.to(rdtype()))
            mims.append(mat.imag.to(rdtype()))
        return self._schedule_local_runs(program, mres, mims)

    def _schedule_local_runs(self, program, mres, mims):
        """Each maximal run of consecutive local gates becomes one 'run'
        step. On the kernels it goes through schedule_planar_seq (relabels
        and windows; a gate on more than 3 wires stands alone), so the
        shards take the single-card route; every run closes back to the
        identity labeling, so exchange steps see the standard layout."""
        from ..ops.planar_gate import schedule_planar_seq
        out_p, out_r, out_i = [], [], []
        run = []

        def flush():
            if not run:
                return
            rs, is_, ws = (tuple(r for _, r, _ in run), tuple(i for _, _, i in run),
                           tuple(p[1] for p, _, _ in run))
            if len(run) > 1 and self.use_kernels:
                rs, is_, ws = schedule_planar_seq(rs, is_, ws, self.nlocal)
            out_p.append(('run', tuple(ws)))
            out_r.extend(rs)
            out_i.extend(is_)
            run.clear()

        for p, r, i in zip(program, mres, mims):
            if p[0] == 'local' and (not self.use_kernels or len(p[1]) <= 3):
                run.append((p, r, i))
                continue
            flush()
            if p[0] == 'local':
                out_p.append(('run', (p[1],)))
            else:
                out_p.append(p)
            out_r.append(r)
            out_i.append(i)
        flush()
        return tuple(out_p), tuple(out_r), tuple(out_i)

    def _gate_list(self, circuit, full):
        """The circuit's fused plan as (matrix, wires, global controls). A
        k-wire group needs k free local slots in the worst case, so the
        fusion support is capped at nlocal (Alg.10's condition); an
        unfused gate's global controls stay apart (they select shards), its
        local ones are embedded in its matrix."""
        from ..ops.apply import controlled_matrix
        k = self.nglobal
        old_k = circuit.fuse_max_support
        circuit.fuse_max_support = max(1, min(old_k, self.nlocal))
        try:
            gates = []
            for entry in circuit._fused_plan():
                if entry[0] == 'group' and len(entry[1]) > 1:
                    gates.append((*circuit._op_matrix(entry, full), ()))
                    continue
                op = entry[1] if entry[0] == 'op' else entry[1][0]
                if op.kind != 'gate':
                    raise ValueError(f'the shardmap engine takes unitary gates only, not {op.name}')
                gc = tuple(c for c in op.controls if c < k)
                lc = [c for c in op.controls if c >= k]
                mat = controlled_matrix(op.matrix(full).to(cdtype()), len(lc))
                gates.append((mat, lc + list(op.wires), gc))
            return gates
        finally:
            circuit.fuse_max_support = old_k

    def _obs_programs(self, circuit):
        """Each observable's program (constants, built once per Pauli
        string set, outside inference mode)."""
        from ..circuit import _PAULI_FNS
        key = (tuple((tuple(map(tuple, o.wires)), o.basis) for o in circuit.observables),
               cdtype(), self.use_kernels)
        out = self._obs_cache.get(key)
        if out is None:
            dev = self.mesh.devices[0]
            oprogs, omres, omims = [], [], []
            with torch.inference_mode(False), torch.no_grad():
                for obs in circuit.observables:
                    og = [(_PAULI_FNS[b](dev).to(cdtype()), [w[0]], ())
                          for w, b in zip(obs.wires, obs.basis)]
                    p, r, i = self._build_program(og)
                    oprogs.append(p)
                    omres.append(r)
                    omims.append(i)
            out = self._obs_cache[key] = (tuple(oprogs), tuple(omres), tuple(omims))
        return out

    # ------------------------------------------------------------- plumbing
    def _init_planes(self) -> list:
        """|0...0> planes: shard 0 sets amplitude 0 to 1."""
        out = []
        for r, dev in enumerate(self.mesh.devices):
            z = torch.zeros((2, 1 << self.nlocal), dtype=rdtype(), device=dev)
            if r == 0:
                z[0, 0] = 1
            out.append(z)
        return out

    def init_state(self) -> list:
        """|0...0> as complex shards, one a device."""
        return [from_planar(z) for z in self._init_planes()]

    def _prepare_state(self, state):
        """A flat complex state (tensor, array or QubitState) or a
        DistributedQubitState's shards as plane shards, one a device;
        differentiable. None: |0...0>."""
        if state is None:
            return self._init_planes()
        from ..state import QubitState
        from .sharded import DistributedQubitState
        if isinstance(state, DistributedQubitState):
            return [to_planar(s) for s in state.shards]
        if isinstance(state, QubitState):
            state = state.state
        if not torch.is_tensor(state):
            state = torch.as_tensor(np.asarray(state))
        return [to_planar(s) for s in split_state(state, self.mesh)]

    def _spec(self, circuit, program, with_obs: bool) -> _Spec:
        obs = self._obs_programs(circuit) if with_obs else ((), (), ())
        return _Spec(self.cfg(circuit.fused_bwd), program, *obs, self.ndev)

    # ------------------------------------------------------------------ runs
    def run_shards(self, circuit, params=None, data=None, state=None) -> tuple:
        """The circuit on the shards: the final plane shards (a tuple, one
        a device), differentiable in params, data and state."""
        program, mres, mims = self._build_program(
            self._gate_list(circuit, full_params(circuit, params, data)))
        return shardmap_chain(self._prepare_state(state), mres, mims,
                              self._spec(circuit, program, False))

    def run(self, circuit, params=None, data=None, state=None) -> torch.Tensor:
        """The final state, flat (2^n,) complex, gathered on the mesh's
        first device."""
        from .sharded import gather
        shards = self.run_shards(circuit, params, data, state)
        return gather([from_planar(s) for s in shards], self.mesh.devices[0]).to(cdtype())

    def expectation(self, circuit, params=None, data=None, state=None) -> torch.Tensor:
        """<psi|O|psi> for each observable, summed over the shards (one
        value per observable on the first device); differentiable, with
        the final shards as the only residual."""
        if not circuit.observables:
            raise ValueError('There is no observable')
        program, mres, mims = self._build_program(
            self._gate_list(circuit, full_params(circuit, params, data)))
        return shardmap_expectation(self._prepare_state(state), mres, mims,
                                    self._spec(circuit, program, True))

    def measure(self, circuit, shots: int = 1024, params=None, data=None, state=None,
                wires=None, generator: torch.Generator | None = None) -> dict:
        """Two-level sampling (reference measure_dist): shard masses split
        the shots by one multinomial on ``generator``, then each shard draws
        its share from its own amplitudes. {bitstring: count}."""
        with torch.no_grad():
            shards = self.run_shards(circuit, params, data, state)
        return measure_shards([s[0] ** 2 + s[1] ** 2 for s in shards], self.nglobal, self.nlocal,
                              shots, wires, generator=generator)
