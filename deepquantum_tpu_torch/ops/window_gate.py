"""Window engine: whole runs of gates fused into one dense 2^w x 2^w unitary.

PyTorch counterpart of ``deepquantum_tpu/ops/window_gate.py``. Runs of gates whose wires sit in the top w qubit positions (after a
cyclic relabel from ops/planar_gate.py) are multiplied into one window W on
the host side of the kernel (small ``torch.matmul`` products, as the JAX
package leaves them to XLA) and applied in one sweep:

    state (2, 2^n) viewed as (2, 2^w, 2^(n-w))  ->  W @ columns

by the ``window_apply`` kernel (``csrc/window_apply.cu``) on a CUDA tensor,
or its plain twin ``window_apply_plain`` on a CPU tensor. ``window_width``
and ``_MIN_COLS`` keep the JAX values (w = 7) so the plans are identical;
whether Hopper prefers another width is a later measurement.

In the backward walk of a per-step chain (n >= 20) a window's input is
recovered with ``window_apply`` on the W^H planes and its cotangent comes
from ``window_grad``: two large real products that the JAX package computes
outside any kernel, so they stay ``torch.matmul`` here (full float32). The
window products are differentiable torch, which carries dW back to the gate
parameters.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['window_apply', 'window_apply_plain', 'window_grad', 'schedule_window_seq',
           'plan_windows', 'window_width']

_MIN_COLS = 7          # keep the column run >= 128: w <= n - 7


def window_width(n: int) -> int:
    """Window width: 128-row windows when the column run allows (w = 7)."""
    return max(1, min(7, n - _MIN_COLS))


# ----------------------------------------------------------------- kernel K2
def window_apply_plain(x: torch.Tensor, mre: torch.Tensor, mim: torch.Tensor, n: int, w: int):
    """Plain torch twin of the ``window_apply`` kernel: y = W x on the top w
    wires in split-plane algebra; returns a new tensor."""
    xv = x.reshape(2, 1 << w, 1 << (n - w))
    mre = mre.to(x.dtype)
    mim = mim.to(x.dtype)
    yr = mre @ xv[0] - mim @ xv[1]
    yi = mre @ xv[1] + mim @ xv[0]
    return torch.stack([yr, yi]).reshape(x.shape)


def window_apply(x: torch.Tensor, mre: torch.Tensor, mim: torch.Tensor, n: int, w: int):
    """Apply the dense unitary (planes mre/mim, (2^w, 2^w)) to the TOP w
    wires of the planar state x = (2, 2^n) in place, and return x.

    A CUDA tensor launches ``csrc/window_apply.cu`` (float32, w = 7) and
    raises if the build or the launch fails; a CPU tensor takes the twin."""
    if x.device.type == 'cpu':
        x.copy_(window_apply_plain(x, mre, mim, n, w))
        return x
    from . import _cuda
    if w != 7 or n < 12:
        raise ValueError(f'window_apply: the CUDA kernel takes w = 7 and n >= 12, got w={w}, n={n}')
    _cuda.check_state(x, n, 'window_apply')
    mre, mim = _cuda.check_planes('window_apply', x, (128, 128), mre, mim)
    _cuda.launch('dq_window_apply_f32', x.device, x, mre, mim, n)
    window_apply.launches += 1
    return x


window_apply.launches = 0


def window_grad(g: torch.Tensor, x: torch.Tensor, n: int, w: int):
    """Window-plane cotangents (dRe, dIm), each (2^w, 2^w), from the output
    cotangent g and the recovered input x: dRe = gr xr^T + gi xi^T,
    dIm = gi xr^T - gr xi^T on the (2^w, 2^(n-w)) views. Plain matmuls on
    any device; pure reads."""
    gv = g.reshape(2, 1 << w, -1)
    xv = x.reshape(2, 1 << w, -1)
    dre = gv[0] @ xv[0].T + gv[1] @ xv[1].T
    dim = gv[1] @ xv[0].T - gv[0] @ xv[1].T
    return dre, dim


# ---------------------------------------------------------------- embedding
@functools.lru_cache(maxsize=None)
def _embed_src_np(pos, w: int) -> np.ndarray:
    """Index map embedding a k-wire gate at window positions `pos` (order =
    the gate matrix's qubit order, values in [0, w)): window basis index ->
    kron(gate, I_rest) basis index."""
    k = len(pos)
    rest = [p for p in range(w) if p not in pos]
    W = 1 << w

    def bits_at(i, positions):
        out = 0
        for p in positions:
            out = (out << 1) | ((i >> (w - 1 - p)) & 1)
        return out

    return np.array([(bits_at(i, pos) << (w - k)) | bits_at(i, rest) for i in range(W)])


@functools.lru_cache(maxsize=None)
def _embed_src(pos, w: int, device: torch.device) -> torch.Tensor:
    """``_embed_src_np`` as an index tensor on ``device`` (cached: one
    host-to-device copy per (pos, w, device)). Built outside inference mode
    so that a later autograd-tracked call may use it."""
    with torch.inference_mode(False):
        return torch.as_tensor(_embed_src_np(pos, w), device=device)


def _embed_window(mre: torch.Tensor, mim: torch.Tensor, pos, w: int):
    """kron-embed (2^k, 2^k) gate planes into (2^w, 2^w) window planes at
    positions `pos` (differentiable: a gather of a kron)."""
    src = _embed_src(tuple(pos), w, mre.device)
    eye = torch.eye(1 << (w - len(pos)), dtype=torch.float32, device=mre.device)
    big_re = torch.kron(mre.to(torch.float32), eye)
    big_im = torch.kron(mim.to(torch.float32), eye)
    return big_re[src][:, src], big_im[src][:, src]


def _window_product(members, mres, mims, wseq, rot: int, n: int, w: int):
    """Accumulate member gates (program order) into one (2^w, 2^w) unitary
    U = E_m ... E_1, E_i the embedded planes of gate i at its physical
    positions under labeling `rot`."""
    device = mres[members[0]].device
    ur = torch.eye(1 << w, dtype=torch.float32, device=device)
    ui = torch.zeros((1 << w, 1 << w), dtype=torch.float32, device=device)
    for idx in members:
        pos = tuple((x - rot) % n for x in wseq[idx])
        er, ei = _embed_window(mres[idx], mims[idx], pos, w)
        ur, ui = er @ ur - ei @ ui, er @ ui + ei @ ur
    return ur, ui


# ---------------------------------------------------------------- scheduler
def plan_windows(wseq, n: int, w: int):
    """Greedy in-order window plan over a gate stream.

    wseq: tuple of sorted logical wire tuples. Returns (plan, n_windowed):
    plan entries are ('rot', delta), ('win', members, rot) with members a
    tuple of gate indices applied under labeling `rot`, or ('gate', idx,
    rot) for gates no legal rotation can bring into the top-w positions.
    The plan closes back to the identity labeling."""
    from .planar_gate import _rot_path

    rot = 0
    plan = []
    open_members = []
    open_rot = 0
    n_windowed = 0

    def fits(ws, r):
        return all((x - r) % n < w for x in ws)

    def flush():
        nonlocal open_members
        if open_members:
            plan.append(('win', tuple(open_members), open_rot))
        open_members = []

    def lookahead(r, start):
        c = 0
        for ws in wseq[start:start + 48]:
            if not fits(ws, r):
                break
            c += 1
        return c

    for idx, ws in enumerate(wseq):
        if fits(ws, rot):
            if not open_members:
                open_rot = rot
            open_members.append(idx)
            n_windowed += 1
            continue
        best = None
        for base in {x % n for x in ws}:
            if not fits(ws, base):
                continue
            path = _rot_path(rot, base, n)
            if path is None:
                continue
            if _rot_path(base, 0, n) is None:
                continue
            score = lookahead(base, idx) - 0.5 * len(path)
            if best is None or score > best[0]:
                best = (score, base, path)
        flush()
        if best is None:
            # cyclic wire span exceeds the window (e.g. cnot(0, n/2)) or no
            # reachable labeling: per-gate planar kernel at current labeling
            plan.append(('gate', idx, rot))
            continue
        _, base, path = best
        for d in path:
            plan.append(('rot', d))
        rot = base
        open_rot = rot
        open_members.append(idx)
        n_windowed += 1
    flush()
    closing = _rot_path(rot, 0, n)
    if closing is None:
        raise RuntimeError(f'no legal closing rotation from {rot} (n={n})')
    for d in closing:
        plan.append(('rot', d))
    return plan, n_windowed


def schedule_window_seq(mres, mims, wseq, n: int):
    """Compile an already-sorted planar chain spec into a window plan:
    (mres', mims', wseq') whose wseq' entries are ('rot', delta) relabels
    (None planes), ('win', w) dense windows, or sorted physical wire tuples
    for fallback gates. Returns None when the window engine does not engage
    (too few qubits for legal rotations, batched planes, or nothing gained)."""
    w = window_width(n)
    if n < 14 or w < 4 or not mres or any(m.dim() != 2 for m in mres):
        return None
    plan, n_windowed = plan_windows(tuple(wseq), n, w)
    if n_windowed == 0:
        return None
    from .apply import permute_matrix_wires

    out_r, out_i, out_w = [], [], []
    for ent in plan:
        if ent[0] == 'rot':
            out_r.append(None)
            out_i.append(None)
            out_w.append(('rot', ent[1]))
        elif ent[0] == 'win':
            _, members, rot = ent
            ur, ui = _window_product(members, mres, mims, wseq, rot, n, w)
            out_r.append(ur)
            out_i.append(ui)
            out_w.append(('win', w))
        else:
            _, idx, rot = ent
            pw = [(x - rot) % n for x in wseq[idx]]
            order = sorted(range(len(pw)), key=lambda j: pw[j])
            mre, mim = mres[idx], mims[idx]
            if order != list(range(len(pw))):
                mre = permute_matrix_wires(mre, order)
                mim = permute_matrix_wires(mim, order)
            out_r.append(mre)
            out_i.append(mim)
            out_w.append(tuple(sorted(pw)))
    return tuple(out_r), tuple(out_i), tuple(out_w)
