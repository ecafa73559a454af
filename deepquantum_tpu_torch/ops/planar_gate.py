"""Planar-f32 gate engine: the statevector as two float32 planes.

PyTorch counterpart of ``deepquantum_tpu/ops/planar_gate.py`` (forward and
first-order backward). The state lives as (2, 2^n) float32 planes (re, im);
every fused gate group of k <= 3 wires is one in-place pass of the
``planar_apply`` kernel (``csrc/planar_apply.cu`` on a CUDA tensor, the
plain twin ``planar_evolve_xla`` on a CPU tensor). Gate matrices arrive as
real planes in sorted-wire order. Wire 0 is the most significant bit of the
amplitude index (the ``evolve_state`` convention).

A batch of states, as data-encoded QML runs it, is a (B, 2, 2^n) stack with
per-sample (B, K, K) planes (or one (K, K) set shared by every sample, as an
observable's). The three per-gate kernels take the batch as a grid axis,
as the JAX package's kernels do; the chain's Functions carry a batched gate
chain at 8 <= n <= 17 (its backward at n <= 16) as ONE launch per direction
of the batched-chain kernel (ops/planar_chain_batched.py), each sample's
state in shared memory, and walk it gate by gate outside that range.
Windows and the window-chain kernel refuse batched planes, as in JAX.

Gradients come from two ``torch.autograd.Function``s, ``planar_chain`` and
``planar_pauli_expectation``. The chain's backward is the adjoint method:
the forward keeps only the final state, and the backward walks the steps in
reverse, recovering each step's input with U^H, reducing the matrix
cotangent (``planar_grad``, ``csrc/planar_grad.cu``) and carrying the state
cotangent on with U^H; ``planar_bwd_fused`` (``csrc/planar_bwd_fused.cu``)
does the three in one pass. A non-unitary map (a Kraus channel's
superoperator, ``planar_superop``) keeps its input instead of un-applying.

Second derivatives (``create_graph=True``, ``QubitCircuit.hessian``): when
a backward is itself recorded, the chain walks its steps through three
Functions whose backward is written in the same three Functions, so reverse
mode composes to any order (``_ApplyD`` on K1, ``_GradD`` on K5,
``_WinApplyD`` on K2); the one-launch chains and ``planar_bwd_fused`` stand
aside in that walk, and the first-order route is unchanged. The kernel
wrappers themselves are not differentiable: called directly with a tensor
that requires grad, on the card, they raise.

The relabel scheduler (``schedule_rotations``) and its costs are ported line
for line so that the port's step lists equal the JAX package's; they were
tuned on TPU tile geometry, and whether Hopper wants them is a later
measurement. ``_rotate_planar`` stays plain torch, as the JAX package leaves
it to XLA.

In-place rule: ``planar_apply`` and ``planar_bwd_fused`` update their
state arguments. ``planar_chain`` and ``planar_pauli_expectation`` copy the
caller's state (and, in the backward, autograd's cotangent) once into work
buffers and never write to a tensor the caller holds.
"""

from __future__ import annotations

import functools

import torch

__all__ = ['planar_apply', 'planar_evolve_xla', 'planar_grad', 'planar_grad_xla',
           'planar_bwd_fused', 'planar_bwd_fused_plain', 'planar_chain',
           'planar_pauli_expectation', 'planar_superop', 'schedule_planar_seq',
           'schedule_rotations',
           'to_planar', 'to_planar_batched', 'from_planar']

_T_BITS = 7            # TPU lane block (scheduler geometry only)
_RB_BITS_MAX = 7       # TPU row block (scheduler geometry only)


def to_planar(psi: torch.Tensor) -> torch.Tensor:
    """complex (...,) statevector -> contiguous (2, N) real planes."""
    from ..config import rdtype
    flat = psi.reshape(-1)
    return torch.stack([flat.real, flat.imag]).to(rdtype()).contiguous()


def to_planar_batched(psi: torch.Tensor) -> torch.Tensor:
    """complex (B, N) batch -> contiguous (B, 2, N) real planes."""
    from ..config import rdtype
    return torch.stack([psi.real, psi.imag], dim=1).to(rdtype()).contiguous()


def from_planar(x: torch.Tensor) -> torch.Tensor:
    """(..., 2, N) real planes -> complex (..., N) statevector."""
    return torch.complex(x[..., 0, :], x[..., 1, :])


def _sorted_mat_planes(matrix: torch.Tensor, wires):
    """Permute a complex (2^k, 2^k) gate matrix, or a (B, 2^k, 2^k) batch,
    from wires-list order to sorted-wire order and split it into real planes
    (policy real dtype)."""
    from ..config import rdtype
    from .apply import permute_matrix_wires
    ws = list(wires)
    order = sorted(range(len(ws)), key=lambda i: ws[i])
    if order != list(range(len(ws))):
        matrix = permute_matrix_wires(matrix, order)
    return matrix.real.to(rdtype()), matrix.imag.to(rdtype())


# ----------------------------------------------------------------- kernel K1
def _combo_view(x: torch.Tensor, n: int, ws):
    """(..., 2, 2^n) planes -> (..., 2, 2^k, M) with the k sorted wires' bit
    combinations as the second-last axis, plus the map back."""
    k = len(ws)
    lead = tuple(x.shape[:-2])
    nl = len(lead) + 1                  # the batch axes and the re/im axis
    shape = list(x.shape[:-1])
    axes = []
    prev = -1
    for w in ws:
        shape.append(1 << (w - prev - 1))
        shape.append(2)
        axes.append(len(shape) - 1)
        prev = w
    shape.append(1 << (n - 1 - prev))
    rest = [i for i in range(nl, len(shape)) if i not in axes]
    perm = list(range(nl)) + axes + rest
    xv = x.reshape(shape).permute(perm)
    pshape = xv.shape
    inv = sorted(range(len(perm)), key=lambda i: perm[i])

    def restore(y):
        return y.reshape(pshape).permute(inv).reshape(x.shape)

    return xv.reshape(*lead, 2, 1 << k, -1), restore


def planar_evolve_xla(x: torch.Tensor, mre: torch.Tensor, mim: torch.Tensor, n: int, wires):
    """Plain torch twin of the ``planar_apply`` kernel (named after the JAX
    package's XLA twin): y = M x on the sorted wires, real matmuls, returns
    a new tensor. Matrix planes are in sorted-wire order; a (B, 2, 2^n)
    stack takes (B, K, K) planes or one (K, K) set for every sample."""
    xv, restore = _combo_view(x, n, sorted(wires))
    mre = mre.to(x.dtype)
    mim = mim.to(x.dtype)
    xr, xi = xv[..., 0, :, :], xv[..., 1, :, :]
    yr = mre @ xr - mim @ xi
    yi = mre @ xi + mim @ xr
    return restore(torch.stack([yr, yi], dim=-3))


def planar_apply(x: torch.Tensor, mre: torch.Tensor, mim: torch.Tensor, n: int, wires):
    """Apply a k <= 3 wire gate (planes in sorted-wire order) to the planar
    state x = (2, 2^n) in place, and return x. A (B, 2, 2^n) stack takes
    per-sample (B, K, K) planes, or one (K, K) set for every sample.

    A CUDA tensor launches the ``csrc/planar_apply.cu`` kernel (float32
    only; the batch is a grid axis) and raises if the build or the launch
    fails; a CPU tensor takes the twin ``planar_evolve_xla``."""
    ws = tuple(sorted(wires))
    if x.device.type == 'cpu':
        x.copy_(planar_evolve_xla(x, mre, mim, n, ws))
        return x
    from . import _cuda
    k, low, swap, hb = quad_plan('planar_apply', n, ws)
    batch = _cuda.check_state(x, n, 'planar_apply', batched=True, aligned=True)
    (mre, mim), pstride = _cuda.sample_planes('planar_apply', x, batch, (1 << k, 1 << k), mre, mim)
    bps = gate_blocks(n, batch, _cuda.sm_count(x.device),
                      _resident('dq_planar_apply_blocks_per_sm', x.device, k, low))
    _cuda.launch('dq_planar_apply_f32', x.device, x, mre, mim, batch, pstride, n, k, low, swap,
                 *hb, bps)
    if x.dim() == 3:
        planar_apply.batched_launches += 1
    else:
        planar_apply.launches += 1
    return x


planar_apply.launches = 0            # launches on one (2, 2^n) state
planar_apply.batched_launches = 0    # launches on a (B, 2, 2^n) stack


def _gate_bits(name: str, n: int, ws):
    """Validate sorted wires ws on n qubits; the amplitude bits of the wires
    padded to three entries."""
    k = len(ws)
    if not 1 <= k <= 3 or len(set(ws)) != k or not all(0 <= w < n for w in ws):
        raise ValueError(f'{name}: wires {ws} on n={n}')
    return [n - 1 - w for w in ws] + [0] * (3 - k)


# -------------------------------------------- K1 / K5 / K6: the access plan
_GATE_THREADS = 256          # threads per block of K1, K5, K6 (csrc/planar_quad.cuh)
_QUADS_PER_THREAD = 4        # at least this many float4 per plane per thread
_MAX_QUBITS = 33             # 32-bit quad indices (a 2^33 state is 64 GB a tensor)


@functools.lru_cache(maxsize=None)
def quad_plan(name: str, n: int, ws):
    """The 16-byte access plan of K1, K5 and K6 (``csrc/planar_quad.cuh``) for
    the sorted wires ``ws`` on n qubits: (k, low, swap, hb). ``low`` counts
    the gate's amplitude bits among 0-1 (a float4 quad holds its partners
    where low > 0); ``swap`` is 1 where it holds bit 1 but not bit 0 (the
    kernels swap lanes 1 and 2); ``hb`` are its other bits minus 2, the quad
    bits of a unit, descending and padded with 0 to three."""
    bits = _gate_bits(name, n, ws)[:len(ws)]
    if not 2 <= n <= _MAX_QUBITS:
        raise ValueError(f'{name}: the CUDA kernel takes 2 <= n <= {_MAX_QUBITS}, got n={n}')
    low = sum(b < 2 for b in bits)
    swap = int(low == 1 and bits[-1] == 1)
    hb = [b - 2 for b in bits if b >= 2]
    return len(ws), low, swap, tuple(hb + [0] * (3 - len(hb)))


@functools.lru_cache(maxsize=None)
def gate_blocks(n: int, batch: int, sms: int, per_sm: int) -> int:
    """Blocks per sample of K1 / K5 / K6: the grid is sized to the card, not to
    the groups. One wave of ``per_sm`` resident blocks on each of ``sms``
    SMs, shared by the batch (a power of two per sample, so a wave is never
    cut into a second one by rounding up), but no more than leave each
    thread _QUADS_PER_THREAD float4 per plane; at least one."""
    want = max(1, per_sm * sms // batch)
    bps = 1 << (want.bit_length() - 1)
    return max(1, min(bps, (1 << (n - 2)) // (_GATE_THREADS * _QUADS_PER_THREAD)))


@functools.lru_cache(maxsize=None)
def resident_on(entry: str, index: int, *args: int) -> int:
    """Blocks of one kernel instance that an SM of card ``index`` keeps
    resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its registers
    and shared memory decide), asked once per instance and card through the
    entry point ``entry(*args, out)``."""
    from . import _cuda
    out = torch.zeros(1, dtype=torch.int32)
    _cuda.launch_on(entry, index, 0, *args, out)
    if int(out.item()) < 1:
        raise RuntimeError(f'{entry}: the instance for {args} fits no block on an SM')
    return int(out.item())


def _resident(entry: str, device: torch.device, k: int, low: int) -> int:
    """Blocks of one K1 / K5 / K6 instance (k, low) resident on an SM of
    ``device``'s card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return resident_on(entry, index, k, low)


# ----------------------------------------------------------------- kernel K5
_TWIN_BLOCK = 1 << 8    # positions a partial of the twin's reduction sums


def planar_grad_xla(g: torch.Tensor, x: torch.Tensor, n: int, wires):
    """Plain torch twin of the ``planar_grad`` kernel (named after the JAX
    package's XLA twin): matrix-plane cotangents of y = U x from the output
    cotangent g and the gate's input x,
    dRe[i, j] = sum_m gr_i[m] xr_j[m] + gi_i[m] xi_j[m],
    dIm[i, j] = sum_m gi_i[m] xr_j[m] - gr_i[m] xi_j[m],
    over the 2^(n-k) non-gate positions m, rows/columns in sorted-wire order;
    (B, K, K) each for (B, 2, 2^n) stacks.

    The sum runs in blocks: one matmul gives the partials over blocks of
    _TWIN_BLOCK positions, then the partials are summed. A single float32
    matmul over all 2^(n-k) positions may add them one after another, and
    such a sum drifts with the square root of its length (1.4e-5 of the
    float64 sum at n=18 on amplitude bit 0); in blocks of 2^8 it stays
    under 1e-6."""
    ws = sorted(wires)
    gv, _ = _combo_view(g, n, ws)
    xv, _ = _combo_view(x, n, ws)
    m = gv.shape[-1]
    blk = min(m, _TWIN_BLOCK)
    shape = tuple(gv.shape[:-1]) + (m // blk, blk)           # (..., 2, K, nb, blk)
    gv = gv.reshape(shape).transpose(-3, -2)                  # (..., 2, nb, K, blk)
    xv = xv.reshape(shape).transpose(-3, -2)
    gr, gi = gv[..., 0, :, :, :], gv[..., 1, :, :, :]
    xr_t, xi_t = xv[..., 0, :, :, :].transpose(-1, -2), xv[..., 1, :, :, :].transpose(-1, -2)
    dre = (gr @ xr_t + gi @ xi_t).sum(-3)
    dim = (gi @ xr_t - gr @ xi_t).sum(-3)
    return dre, dim


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor, n: int,
                aligned: bool = False) -> int:
    """Two planar states of one kernel call: the same device and batch."""
    from . import _cuda
    batch = _cuda.check_state(a, n, name, batched=True, aligned=aligned)
    if _cuda.check_state(b, n, name, batched=True, aligned=aligned) != batch \
            or a.dim() != b.dim() or a.device != b.device:
        raise ValueError(f'{name}: two states of shapes {tuple(a.shape)}, {tuple(b.shape)} on '
                         f'{a.device}, {b.device}')
    return batch


# (device index, stream) -> (partials, arrival counters) of the kernels that
# finish their sum over blocks inside the launch (K5, K6, K7): allocated once
# and grown, never per call; a launch leaves every counter at 0 again, so
# launches in order on one stream share them
_workspaces: dict = {}


def workspace(device: torch.device, index: int, stream: int, floats: int, batch: int):
    """(float32 partials of at least ``floats``, int32 counters of at least
    ``batch``, all 0) for launches on ``stream`` of card ``index``."""
    parts, count = _workspaces.get((index, stream), (None, None))
    if parts is None or parts.numel() < floats or count.numel() < batch:
        with torch.inference_mode(False):
            if parts is None or parts.numel() < floats:
                parts = torch.empty(floats, dtype=torch.float32, device=device)
            if count is None or count.numel() < batch:
                count = torch.zeros(batch, dtype=torch.int32, device=device)
        _workspaces[(index, stream)] = (parts, count)
    return parts, count


def planar_grad(g: torch.Tensor, x: torch.Tensor, n: int, wires):
    """(dRe, dIm), each (2^k, 2^k), of a k <= 3 wire gate from the planar
    cotangent g and the gate's input x, both (2, 2^n); pure reads. Stacks
    (B, 2, 2^n) give (B, 2^k, 2^k) each.

    CUDA tensors launch ``csrc/planar_grad.cu`` (float32 only) once: its
    blocks sum their partials in a fixed order in the same launch, into the
    one tensor allocated here. It raises if the build or the launch fails;
    CPU tensors take the twin ``planar_grad_xla``."""
    ws = tuple(sorted(wires))
    if g.device.type == 'cpu':
        return planar_grad_xla(g, x, n, ws)
    from . import _cuda
    k, low, swap, hb = quad_plan('planar_grad', n, ws)
    batch = _check_pair('planar_grad', g, x, n, aligned=True)
    kk = 1 << k
    bps = gate_blocks(n, batch, _cuda.sm_count(g.device),
                      _resident('dq_planar_grad_blocks_per_sm', g.device, k, low))
    index, stream = _cuda.stream_of(g.device)
    parts, count = workspace(g.device, index, stream, batch * bps * 2 * kk * kk, batch)
    out = torch.empty(((batch, 2, kk, kk) if g.dim() == 3 else (2, kk, kk)), dtype=torch.float32,
                      device=g.device)
    _cuda.launch_on('dq_planar_grad_f32', index, stream, g, x, out, parts, count, batch, n, k,
                    low, swap, *hb, bps)
    if g.dim() == 3:
        planar_grad.batched_launches += 1
    else:
        planar_grad.launches += 1
    return out.unbind(-3)


planar_grad.launches = 0
planar_grad.batched_launches = 0


# ----------------------------------------------------------------- kernel K6
def planar_bwd_fused_plain(y: torch.Tensor, g: torch.Tensor, mre_t: torch.Tensor,
                           mim_t: torch.Tensor, n: int, wires):
    """Plain torch twin of the ``planar_bwd_fused`` kernel: one backward gate
    step as its three parts. mre_t/mim_t are the U^H planes (U_re^T,
    -U_im^T). Returns new tensors (x, g', dRe, dIm) with x = U^H y,
    g' = U^H g and the cotangent planes reduced from the RAW g against the
    recovered x."""
    x = planar_evolve_xla(y, mre_t, mim_t, n, wires)
    dre, dim = planar_grad_xla(g, x, n, wires)
    return x, planar_evolve_xla(g, mre_t, mim_t, n, wires), dre, dim


def planar_bwd_fused(y: torch.Tensor, g: torch.Tensor, mre_t: torch.Tensor,
                     mim_t: torch.Tensor, n: int, wires):
    """One backward step of a k <= 3 wire gate in one pass: y becomes
    x = U^H y and g becomes U^H g, both in place, and (dRe, dIm) come from
    the raw g and the recovered x. Returns (y, g, dRe, dIm). Stacks
    (B, 2, 2^n) take (B, K, K) planes or one (K, K) set, and give
    (B, K, K) cotangent planes.

    CUDA tensors launch ``csrc/planar_bwd_fused.cu`` (float32 only) and
    raise if the build or the launch fails; CPU tensors take the twin."""
    ws = tuple(sorted(wires))
    if y.device.type == 'cpu':
        x, g2, dre, dim = planar_bwd_fused_plain(y, g, mre_t, mim_t, n, ws)
        y.copy_(x)
        g.copy_(g2)
        return y, g, dre, dim
    from . import _cuda
    k, low, swap, hb = quad_plan('planar_bwd_fused', n, ws)
    batch = _check_pair('planar_bwd_fused', y, g, n, aligned=True)
    if y.data_ptr() == g.data_ptr():
        raise ValueError('planar_bwd_fused: y and g must be two tensors on one device')
    kk = 1 << k
    (mre_t, mim_t), pstride = _cuda.sample_planes('planar_bwd_fused', y, batch, (kk, kk),
                                                  mre_t, mim_t)
    bps = gate_blocks(n, batch, _cuda.sm_count(y.device),
                      _resident('dq_planar_bwd_fused_blocks_per_sm', y.device, k, low))
    index, stream = _cuda.stream_of(y.device)
    parts, count = workspace(y.device, index, stream, batch * bps * 2 * kk * kk, batch)
    out = torch.empty(((batch, 2, kk, kk) if y.dim() == 3 else (2, kk, kk)), dtype=torch.float32,
                      device=y.device)
    _cuda.launch_on('dq_planar_bwd_fused_f32', index, stream, y, g, mre_t, mim_t, out, parts,
                    count, batch, pstride, n, k, low, swap, *hb, bps)
    if y.dim() == 3:
        planar_bwd_fused.batched_launches += 1
    else:
        planar_bwd_fused.launches += 1
    return (y, g, *out.unbind(-3))


planar_bwd_fused.launches = 0
planar_bwd_fused.batched_launches = 0


# ----------------------------------------------------- wire-relabel schedule
_ROT_MIN_BITS = 7      # both runs of the rotation transpose >= 128 elements
_ROLL_LIMIT = _T_BITS + _RB_BITS_MAX   # positions with bit < this needed TPU rolls


def _rotate_planar(x: torch.Tensor, delta: int, n: int) -> torch.Tensor:
    """Cyclically rotate qubit POSITIONS of a planar state left by delta:
    the wire at position delta moves to position 0 ((..., 2, 2^n) -> same).
    A two-run transpose in plain torch; returns a new tensor."""
    delta %= n
    if delta == 0:
        return x
    lead = x.shape[:-1]
    v = x.reshape(lead + (1 << delta, 1 << (n - delta)))
    return v.transpose(-1, -2).reshape(x.shape).contiguous()


def _rot_legal(delta: int, n: int) -> bool:
    delta %= n
    return delta == 0 or _ROT_MIN_BITS <= delta <= n - _ROT_MIN_BITS


def _roll_count(pw, n: int) -> int:
    """Positions of a physical wire set below the TPU kernel's head region."""
    return sum(1 for p in pw if (n - 1 - p) < _ROLL_LIMIT)


def _gate_cost(pw, n: int) -> float:
    """Relative pass cost by roll count (the JAX package's TPU costs, kept
    so that plans are identical)."""
    nr = _roll_count(pw, n)
    return (1.0, 1.0, 3.5, 7.0)[min(nr, 3)]


_ROT_COST = 2.0        # relabel transpose ~1-2 gate passes
_LOOKAHEAD = 24        # groups simulated when scoring a candidate rotation


def _rot_path(cur: int, target: int, n: int):
    """Shortest sequence of LEGAL rotation deltas moving the labeling from
    cur to target (BFS over compositions, depth <= 4). None if unreachable."""
    net = (target - cur) % n
    if net == 0:
        return []
    legal = range(_ROT_MIN_BITS, n - _ROT_MIN_BITS + 1)
    frontier = {0: []}
    for _ in range(4):
        nxt = {}
        for got, path in frontier.items():
            for d in legal:
                g2 = (got + d) % n
                if g2 == net:
                    return path + [d]
                if g2 not in nxt:
                    nxt[g2] = path + [d]
        frontier = nxt
    return None


def schedule_rotations(wires_list, n: int):
    """Host-side relabel scheduler for planar gate chains.

    Returns (plan, changed): plan entries are ('rot', delta) or
    ('gate', idx, phys_wires) with phys_wires in the SAME element order as
    wires_list[idx]. The plan always closes rotated back to the identity
    labeling. changed is False when no rotation was worth emitting.
    """
    H = n - _ROLL_LIMIT                   # head positions [0, H)
    if H < 2 or n < 2 * _ROT_MIN_BITS:
        return ([('gate', i, tuple(ws)) for i, ws in enumerate(wires_list)],
                False)

    def sim_cost(rot, start, budget):
        c = 0.0
        for ws in wires_list[start:start + budget]:
            c += _gate_cost([(w - rot) % n for w in ws], n)
        return c

    rot = 0
    plan = []
    changed = False
    for idx, ws in enumerate(wires_list):
        pw = [(w - rot) % n for w in ws]
        if _roll_count(pw, n) >= 2:
            cands = {(w - back) % n for w in ws for back in range(min(H, 3))}
            best = (sim_cost(rot, idx, _LOOKAHEAD), rot, [])
            for cand in cands:
                path = _rot_path(rot, cand, n)
                if not path:
                    continue
                if _rot_path(cand, 0, n) is None:
                    continue
                cost = _ROT_COST * len(path) + sim_cost(cand, idx, _LOOKAHEAD)
                if cost < best[0] - 1e-9:
                    best = (cost, cand, path)
            _, cand, path = best
            for d in path:
                plan.append(('rot', d))
                changed = True
            rot = cand
            pw = [(w - rot) % n for w in ws]
        plan.append(('gate', idx, tuple(pw)))
    closing = _rot_path(rot, 0, n)
    if closing is None:
        raise RuntimeError(f'no legal closing rotation from {rot} (n={n})')
    for d in closing:
        plan.append(('rot', d))
    return plan, changed


def schedule_planar_seq(mres, mims, wseq, n: int):
    """Insert relabel rotations or dense windows into an already-sorted
    planar chain spec. mres/mims: per-gate (K, K) planes, or (B, K, K) per
    sample, in sorted-LOGICAL wire order; wseq: sorted logical wire tuples.
    Batched planes take no windows (schedule_window_seq refuses them).

    Returns (mres', mims', wseq'): wseq' entries are ('rot', delta) relabels
    (with None planes), ('win', w) dense windows (ops/window_gate.py) or
    sorted physical wire tuples, whose planes are re-permuted to sorted
    PHYSICAL order under the labeling in effect."""
    from .apply import permute_matrix_wires
    from .window_gate import schedule_window_seq
    win = schedule_window_seq(mres, mims, wseq, n)
    if win is not None:
        return win
    plan, changed = schedule_rotations(list(wseq), n)
    if not changed:
        return tuple(mres), tuple(mims), tuple(wseq)
    out_r, out_i, out_w = [], [], []
    for ent in plan:
        if ent[0] == 'rot':
            out_r.append(None)
            out_i.append(None)
            out_w.append(('rot', ent[1]))
            continue
        _, i, pw = ent
        mre, mim = mres[i], mims[i]
        order = sorted(range(len(pw)), key=lambda j: pw[j])
        if order != list(range(len(pw))):
            mre = permute_matrix_wires(mre, order)
            mim = permute_matrix_wires(mim, order)
        out_r.append(mre)
        out_i.append(mim)
        out_w.append(tuple(sorted(pw)))
    return tuple(out_r), tuple(out_i), tuple(out_w)


# --------------------------------------------------------------- gate chains
def _batched_chain(x: torch.Tensor, mres, mims, n: int, wires_seq):
    """The packed one-launch form of a batched gate chain
    (ops/planar_chain_batched.py) when the forward qualifies
    (``batched_chain_ok``), else None. Packed once per call and kept for
    the backward."""
    from .planar_chain_batched import batched_chain_ok, pack_chain
    if x.dtype == torch.float32 and x.dim() == 3 and batched_chain_ok(wires_seq, n, mres):
        return pack_chain(x, mres, mims, n, wires_seq)
    return None


def _chain_forward(x: torch.Tensor, mres, mims, n: int, wires_seq, chain=None) -> torch.Tensor:
    """The chain without autograd: the final state in a new tensor. A
    batched gate chain packed by ``_batched_chain`` runs as ONE launch of
    the batched-chain kernel; a sequence of windows + relabels at
    14 <= n <= 19 as ONE launch of the window-chain kernel
    (ops/chain_kernel.py). Otherwise ``_steps_forward`` walks it."""
    from .chain_kernel import chain_fused_ok, window_chain_fwd
    from .planar_chain_batched import planar_chain_batched
    if chain is not None:
        return planar_chain_batched(x, chain)
    if x.dtype == torch.float32 and chain_fused_ok(wires_seq, n, mres):
        return window_chain_fwd(x, mres, mims, n, wires_seq)
    return _steps_forward(x, mres, mims, n, wires_seq)


def _steps_forward(x: torch.Tensor, mres, mims, n: int, wires_seq) -> torch.Tensor:
    """The per-step forward: x copied once into a work buffer, each step
    its own kernel, in place where the step allows (a gate planar_apply, a
    window window_apply); a relabel (a plain transpose) gives a new
    buffer."""
    from .window_gate import window_apply
    x = x.clone()
    for mre, mim, ws in zip(mres, mims, wires_seq):
        if ws[0] == 'rot':
            x = _rotate_planar(x, ws[1], n)
        elif ws[0] == 'win':
            x = window_apply(x, mre, mim, n, ws[1])
        else:
            x = planar_apply(x, mre, mim, n, ws)
    return x


def _conj_t(mre: torch.Tensor, mim: torch.Tensor):
    """Planes of U^H from the planes of U: (U_re^T, -U_im^T), per sample
    for (B, K, K) planes."""
    return mre.transpose(-1, -2).contiguous(), -mim.transpose(-1, -2)


def _chain_backward(y: torch.Tensor, g: torch.Tensor, mres, mims, n: int, wires_seq,
                    fused_bwd: bool, chain=None):
    """The adjoint recurrence over a scheduled sequence: from the final state
    y and its cotangent g give (x, g_in, dres, dims): the sequence's input
    state, the input cotangent, and dres/dims aligned to the step list with
    None at relabel slots. Neither y nor g is written. A
    packed batched chain whose reverse walk qualifies (n <= 16) is ONE
    launch of the batched-chain kernel, whatever ``fused_bwd`` says; windows
    + relabels at 14 <= n <= 19 ONE launch of the window-chain kernel;
    otherwise ``_steps_backward`` walks it."""
    from .chain_kernel import chain_fused_ok, window_chain_bwd
    from .planar_chain_batched import batched_chain_ok, planar_chain_batched_bwd
    if chain is not None and batched_chain_ok(wires_seq, n, mres, backward=True):
        return planar_chain_batched_bwd(y, g, chain)
    if y.dtype == torch.float32 and chain_fused_ok(wires_seq, n, mres):
        return window_chain_bwd(y, g, mres, mims, n, wires_seq)
    return _steps_backward(y, g, mres, mims, n, wires_seq, fused_bwd)


def _steps_backward(y: torch.Tensor, g: torch.Tensor, mres, mims, n: int, wires_seq,
                    fused_bwd: bool):
    """The per-step adjoint walk, y and g copied once into work buffers: a
    gate step as planar_apply + planar_grad + planar_apply or, with
    ``fused_bwd``, as one planar_bwd_fused; a window as window_apply +
    window_grad + window_apply; a relabel undone on both. Returns (x, g_in,
    dres, dims) as ``_chain_backward``."""
    from .window_gate import window_apply, window_grad
    y = y.clone(memory_format=torch.contiguous_format)
    g = g.clone(memory_format=torch.contiguous_format)
    dres = [None] * len(wires_seq)
    dims = [None] * len(wires_seq)
    for i in range(len(wires_seq) - 1, -1, -1):
        ws = wires_seq[i]
        if ws[0] == 'rot':
            # a relabel is a constant permutation: undo it on both
            y = _rotate_planar(y, -ws[1], n)
            g = _rotate_planar(g, -ws[1], n)
            continue
        mre_t, mim_t = _conj_t(mres[i], mims[i])
        if ws[0] == 'win':
            # recover the window's input, reduce dW = g x^H, carry g on
            window_apply(y, mre_t, mim_t, n, ws[1])
            dres[i], dims[i] = window_grad(g, y, n, ws[1])
            window_apply(g, mre_t, mim_t, n, ws[1])
        elif fused_bwd:
            _, _, dres[i], dims[i] = planar_bwd_fused(y, g, mre_t, mim_t, n, ws)
        else:
            planar_apply(y, mre_t, mim_t, n, ws)
            dres[i], dims[i] = planar_grad(g, y, n, ws)
            planar_apply(g, mre_t, mim_t, n, ws)
    return y, g, dres, dims


def _split_planes(planes, wires_seq):
    """Tensor arguments of a Function back into step-aligned (mres, mims)
    lists with None at relabel slots."""
    half = len(planes) // 2
    it_r, it_i = iter(planes[:half]), iter(planes[half:])
    mres = [None if ws[0] == 'rot' else next(it_r) for ws in wires_seq]
    mims = [None if ws[0] == 'rot' else next(it_i) for ws in wires_seq]
    return mres, mims


def _flat_planes(mres, mims, wires_seq):
    """Step-aligned planes as flat tensor arguments: all re, then all im,
    relabel slots left out."""
    keep = [i for i, ws in enumerate(wires_seq) if ws[0] != 'rot']
    return [mres[i] for i in keep] + [mims[i] for i in keep]


def _first_order_only(backward):
    """Refuse a backward that is itself being recorded (create_graph=True).
    This stands in place of ``once_differentiable``, which only guards
    cotangents that require grad: the photonic kernels' backward through
    their twins also depends on saved inputs, so a second derivative through
    it would silently miss those terms."""
    @functools.wraps(backward)
    def guarded(ctx, *grads):
        if torch.is_grad_enabled():
            raise RuntimeError('the kernel Functions are first order only: their backward '
                               'cannot be differentiated again (create_graph=True)')
        return backward(ctx, *grads)
    return guarded


# ------------------------------------------- reverse-differentiable kernels
# The three Functions below close the derivative algebra over the kernels
# (C: the (K, K) cotangent planes; no unitarity is assumed, M^H is the real
# Jacobian's transpose of the plane algebra):
#
#     VJP of apply(x, M):   dx = apply(g, M^H),   dM = grad(g, x)
#     VJP of grad(g, x):    dg = apply(x, C),     dx = apply(g, C^H)
#
# Each backward calls the Functions again, so a backward run under
# create_graph=True is itself differentiable, to any order.
def _fresh(t: torch.Tensor) -> torch.Tensor:
    """t as a kernel argument: contiguous and on a 16-byte boundary."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _batch_sum(d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A (K, K) plane shared by a batch of states gets the batch's sum."""
    return (d if d.dim() == m.dim() else d.sum(0)).to(m.dtype)


class _ApplyD(torch.autograd.Function):
    """y = M x on a k <= 3 wire group through K1 (``planar_apply``), out of
    place, for any linear M. It keeps its INPUT as the residual, so it is
    also the Function of ``planar_superop``: a non-unitary map must not be
    un-applied by inversion. Planes are (K, K) or (B, K, K) in sorted-wire
    order; ws sorted."""

    @staticmethod
    def forward(ctx, x, mre, mim, n, ws):
        ctx.save_for_backward(x, mre, mim)
        ctx.spec = (n, ws)
        return planar_apply(x.clone(memory_format=torch.contiguous_format), mre, mim, n, ws)

    @staticmethod
    def backward(ctx, g):
        x, mre, mim = ctx.saved_tensors
        n, ws = ctx.spec
        dx = dre = dim = None
        if ctx.needs_input_grad[0]:
            dx = _ApplyD.apply(g, *_conj_t(mre, mim), n, ws)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dre, dim = _GradD.apply(g, x, n, ws)
            dre, dim = _batch_sum(dre, mre), _batch_sum(dim, mim)
        return dx, dre, dim, None, None


class _GradD(torch.autograd.Function):
    """The cotangent planes (dRe, dIm) of y = M x from g and x through K5
    (``planar_grad``), differentiable in g and x."""

    @staticmethod
    def forward(ctx, g, x, n, ws):
        ctx.save_for_backward(g, x)
        ctx.spec = (n, ws)
        return tuple(planar_grad(_fresh(g), _fresh(x), n, ws))

    @staticmethod
    def backward(ctx, cr, ci):
        g, x = ctx.saved_tensors
        n, ws = ctx.spec
        dg = _ApplyD.apply(x, cr, ci, n, ws) if ctx.needs_input_grad[0] else None
        dx = _ApplyD.apply(g, *_conj_t(cr, ci), n, ws) if ctx.needs_input_grad[1] else None
        return dg, dx, None, None


class _WinApplyD(torch.autograd.Function):
    """y = W x on the top w wires through K2 (``window_apply``), out of
    place; dW comes from ``window_grad`` (plain matmuls, differentiable)."""

    @staticmethod
    def forward(ctx, x, mre, mim, n, w):
        from .window_gate import window_apply
        ctx.save_for_backward(x, mre, mim)
        ctx.spec = (n, w)
        return window_apply(x.clone(memory_format=torch.contiguous_format), mre, mim, n, w)

    @staticmethod
    def backward(ctx, g):
        from .window_gate import window_grad
        x, mre, mim = ctx.saved_tensors
        n, w = ctx.spec
        dx = _WinApplyD.apply(g, *_conj_t(mre, mim), n, w)
        dre, dim = window_grad(g, x, n, w)
        return dx, dre, dim, None, None


def _chain_diff(x: torch.Tensor, mres, mims, n: int, wires_seq) -> torch.Tensor:
    """The chain's forward as recorded steps (``_ApplyD``, ``_WinApplyD``
    and differentiable relabels), for a backward under create_graph."""
    for mre, mim, ws in zip(mres, mims, wires_seq):
        if ws[0] == 'rot':
            x = _rotate_planar(x, ws[1], n)
        elif ws[0] == 'win':
            x = _WinApplyD.apply(x, mre, mim, n, ws[1])
        else:
            x = _ApplyD.apply(x, mre, mim, n, ws)
    return x


def _steps_backward_diff(y: torch.Tensor, g: torch.Tensor, mres, mims, n: int, wires_seq):
    """The adjoint walk out of place through the differentiable Functions
    (a backward under create_graph): returns (g_in, dres, dims) as
    ``_chain_backward``. It keeps one state per step for the next order."""
    from .window_gate import window_grad
    dres = [None] * len(wires_seq)
    dims = [None] * len(wires_seq)
    for i in range(len(wires_seq) - 1, -1, -1):
        ws = wires_seq[i]
        if ws[0] == 'rot':
            y = _rotate_planar(y, -ws[1], n)
            g = _rotate_planar(g, -ws[1], n)
            continue
        mre_t, mim_t = _conj_t(mres[i], mims[i])
        if ws[0] == 'win':
            x = _WinApplyD.apply(y, mre_t, mim_t, n, ws[1])
            dres[i], dims[i] = window_grad(g, x, n, ws[1])
            g = _WinApplyD.apply(g, mre_t, mim_t, n, ws[1])
        else:
            x = _ApplyD.apply(y, mre_t, mim_t, n, ws)
            dres[i], dims[i] = _GradD.apply(g, x, n, ws)
            g = _ApplyD.apply(g, mre_t, mim_t, n, ws)
        y = x
    return g, dres, dims


class _PlanarChain(torch.autograd.Function):
    """planar_chain with the adjoint (O(1) memory) backward."""

    @staticmethod
    def forward(ctx, x, n, wires_seq, fused_bwd, *planes):
        mres, mims = _split_planes(planes, wires_seq)
        chain = _batched_chain(x, mres, mims, n, wires_seq)
        y = _chain_forward(x, mres, mims, n, wires_seq, chain)
        ctx.save_for_backward(y, *planes)
        ctx.spec = (n, wires_seq, fused_bwd)
        ctx.chain = chain
        return y

    @staticmethod
    def backward(ctx, g):
        n, wires_seq, fused_bwd = ctx.spec
        y, *planes = ctx.saved_tensors
        mres, mims = _split_planes(planes, wires_seq)
        if torch.is_grad_enabled():
            # create_graph: the recorded walk; the one-launch chains and K6
            # have no derivative of their own and stand aside
            g_in, dres, dims = _steps_backward_diff(y, g, mres, mims, n, wires_seq)
        else:
            _, g_in, dres, dims = _chain_backward(y, g, mres, mims, n, wires_seq, fused_bwd,
                                                  ctx.chain)
        dplanes = [_batch_sum(d, m) for d, m in zip(_flat_planes(dres, dims, wires_seq), planes)]
        return (g_in, None, None, None, *dplanes)


def planar_chain(x: torch.Tensor, mres, mims, n: int, wires_seq,
                 fused_bwd: bool = False) -> torch.Tensor:
    """Apply a scheduled sequence of unitaries to the planar state x and
    return the final state (x is not modified). Differentiable in x and in
    every matrix plane, to any order.

    The forward stores only the FINAL state. The backward walks the steps in
    reverse: it un-applies each unitary to recover its input (U^H y), reduces
    the matrix cotangent and carries the state cotangent on (U^H g). When the
    whole sequence is windows + relabels and 14 <= n <= 19, each direction is
    ONE launch (ops/chain_kernel.py); a batched gate chain at 8 <= n <= 17
    (the backward n <= 16) likewise (ops/planar_chain_batched.py); otherwise
    each step runs its own kernels, a gate step as three launches or, with
    ``fused_bwd``, as the single ``planar_bwd_fused``. A backward under
    create_graph walks every step through the differentiable Functions
    instead. The recurrence is exact for unitary steps only: a non-unitary
    map goes through ``planar_superop``."""
    wires_seq = tuple(wires_seq)
    return _PlanarChain.apply(x, n, wires_seq, bool(fused_bwd),
                              *_flat_planes(mres, mims, wires_seq))


def planar_superop(x: torch.Tensor, mre: torch.Tensor, mim: torch.Tensor, n: int, wires):
    """Apply a general (non-unitary) map on k <= 3 sorted wires (planes in
    sorted-wire order, (K, K) or per sample (B, K, K)) to the planar state
    x and return a new state; one K1 launch. Its backward keeps the input
    as the residual: K5 for the planes (when they need a gradient) and K1
    with M^H for the state, to any order. A density matrix's Kraus channel
    runs as its 4^k superoperator sum_k K (x) conj(K) on the wire pair
    (w, w + n) this way."""
    return _ApplyD.apply(x, mre, mim, n, tuple(sorted(wires)))


class _PauliExpectation(torch.autograd.Function):
    """planar_pauli_expectation: keeps x and Px; d/dx = 2 g Px, no matrix
    cotangent (the observable is constant). Under create_graph Px is
    recomputed through the differentiable chain, so that the next order
    sees d(Px)/dx."""

    @staticmethod
    def forward(ctx, x, n, wires_seq, *planes):
        mres, mims = _split_planes(planes, wires_seq)
        chain = _batched_chain(x, mres, mims, n, wires_seq)
        ox = _chain_forward(x, mres, mims, n, wires_seq, chain)
        ctx.save_for_backward(x, ox, *planes)
        ctx.spec = (n, wires_seq)
        return torch.sum(x[..., 0, :] * ox[..., 0, :] + x[..., 1, :] * ox[..., 1, :], dim=-1)

    @staticmethod
    def backward(ctx, g):
        x, ox, *planes = ctx.saved_tensors
        if torch.is_grad_enabled():
            n, wires_seq = ctx.spec
            ox = _chain_diff(x, *_split_planes(planes, wires_seq), n, wires_seq)
        return (2.0 * g[..., None, None] * ox, None, None, *[None] * len(planes))


def planar_pauli_expectation(x: torch.Tensor, mres, mims, n: int, wires_seq) -> torch.Tensor:
    """Re<x|P|x> for a Hermitian Pauli string P given as a scheduled chain of
    constant k <= 3 wire blocks (relabels close back to the identity
    labeling, so Px ends aligned with x). Differentiable in x to any order:
    the forward keeps Px and the first-order backward is one elementwise
    pass."""
    wires_seq = tuple(wires_seq)
    return _PauliExpectation.apply(x, n, wires_seq, *_flat_planes(mres, mims, wires_seq))
