"""Window-chain engine: a whole scheduled window sequence in one launch.

PyTorch counterpart of ``deepquantum_tpu/ops/chain_kernel.py``. A sequence of ('win', w) / ('rot', d) steps from
ops/window_gate.py::schedule_window_seq runs as ONE cooperative launch of
``csrc/window_chain.cu`` on a CUDA tensor: the state stays in two ping-pong
buffers that fit the H100's L2 at 14 <= n <= 19 (the counterpart of the TPU
kernel's VMEM-resident state), a device-side step table drives the walk,
and the windows ride as a compact (n_win, 128, 128) stack. On a CPU tensor
the plain twin ``window_chain_plain`` walks the same steps in Python.

The backward, ``window_chain_bwd``, is the adjoint recurrence of
``planar_chain`` over the same sequence in ONE cooperative launch of
``csrc/window_chain_bwd.cu``: it carries the final state y and its
cotangent g (each with a ping-pong partner) through the steps in reverse,
at a window x = W^H y, dW = g x^H, g = W^H g, at a relabel both are
relabelled back. Its table merges each run of consecutive relabels into one
row (``_bwd_rows``), and each block's share of a dW goes to a partial slot
that the kernel reduces in a fixed order. Its twin
``window_chain_bwd_plain`` is the Python loop.

The JAX kernel's per-step zero window blocks at rot steps and its hand-split
bf16 matmuls are TPU artefacts and are not carried over.
"""

from __future__ import annotations

import torch

__all__ = ['chain_fused_ok', 'window_chain_fwd', 'window_chain_plain', 'window_chain_bwd',
           'window_chain_bwd_plain']

_MAX_N = 19
_MIN_N = 14


def chain_fused_ok(wires_seq, n: int, mres) -> bool:
    """A sequence qualifies when every step is ('rot', d) or ('win', w) with
    one common w, there is at least one window, 14 <= n <= 19, and the
    planes are unbatched."""
    if not (_MIN_N <= n <= _MAX_N):
        return False
    ws = {s[1] for s in wires_seq if s[0] == 'win'}
    if len(ws) != 1:
        return False
    if any(s[0] not in ('rot', 'win') for s in wires_seq):
        return False
    return all(m.dim() == 2 for m in mres if m is not None)


def _step_table(wires_seq, n: int, backward: bool = False):
    """Host-side step table, one row per step: (kind, delta, window index),
    kind 1 for a window (its index into the compact stack), 0 for a
    relabel by delta. Returns (rows, window step positions). For the
    backward walk the rows are reversed and every delta inverted (n - d);
    the window indices still count the windows in forward order."""
    rows = []
    win_steps = []
    for i, st in enumerate(wires_seq):
        if st[0] == 'win':
            rows.append((1, 0, len(win_steps)))
            win_steps.append(i)
        else:
            rows.append((0, (n - st[1]) % n if backward else st[1] % n, 0))
    return (rows[::-1] if backward else rows), win_steps


def _bwd_rows(rows, n: int):
    """The backward walk's table with each run of consecutive relabels merged
    into one row: rotations of the qubit positions compose by adding their
    deltas mod n, and a run that adds up to 0 leaves no row."""
    out = []
    for row in rows:
        if row[0] == 0 and out and out[-1][0] == 0:
            d = (out[-1][1] + row[1]) % n
            out.pop()
            if d:
                out.append((0, d, 0))
        else:
            out.append(row)
    return out


def _check_chain(name: str, x: torch.Tensor, mres, n: int, wires_seq, backward: bool):
    """Validate a one-launch call on the card; (table rows, window steps)."""
    from . import _cuda
    if not chain_fused_ok(wires_seq, n, mres):
        raise ValueError(f'{name}: the sequence does not qualify (chain_fused_ok)')
    w = next(s[1] for s in wires_seq if s[0] == 'win')
    if w != 7:
        raise ValueError(f'{name}: the CUDA kernel takes w = 7, got {w}')
    _cuda.check_state(x, n, name)
    rows, win_steps = _step_table(wires_seq, n, backward)
    if any(kind == 0 and not 7 <= d <= n - 7 for kind, d, _ in rows):
        raise ValueError(f'{name}: relabel deltas must lie in [7, n - 7]')
    return rows, win_steps


def window_chain_plain(x: torch.Tensor, mres, mims, n: int, wires_seq) -> torch.Tensor:
    """Plain torch twin of the window-chain kernel: a Python loop of
    window/rot steps; returns a new tensor and leaves x untouched."""
    from .planar_gate import _rotate_planar
    from .window_gate import window_apply_plain
    for mre, mim, st in zip(mres, mims, wires_seq):
        if st[0] == 'win':
            x = window_apply_plain(x, mre, mim, n, st[1])
        else:
            x = _rotate_planar(x, st[1], n)
    return x


def window_chain_fwd(x: torch.Tensor, mres, mims, n: int, wires_seq) -> torch.Tensor:
    """One-launch forward over a qualifying scheduled sequence. x: (2, 2^n)
    planes; returns the final state in a new tensor (x is not modified).

    A CUDA tensor launches ``csrc/window_chain.cu`` (float32, w = 7) and
    raises if the build or the launch fails; a CPU tensor takes the twin."""
    if x.device.type == 'cpu':
        return window_chain_plain(x, mres, mims, n, wires_seq)
    from . import _cuda
    rows, win_steps = _check_chain('window_chain_fwd', x, mres, n, wires_seq, backward=False)
    wre = torch.stack([mres[i] for i in win_steps])
    wim = torch.stack([mims[i] for i in win_steps])
    wre, wim = _cuda.check_planes('window_chain_fwd', x, (len(win_steps), 128, 128), wre, wim)
    table = torch.tensor(rows, dtype=torch.int32).to(x.device)
    # ping-pong buffers: the caller's x is copied once into a, never written
    a = x.clone()
    b = torch.empty_like(x)
    _cuda.launch('dq_window_chain_fwd_f32', x.device, table, len(rows), wre, wim, a, b, n)
    window_chain_fwd.launches += 1
    n_rot = len(rows) - len(win_steps)
    return b if n_rot % 2 else a


window_chain_fwd.launches = 0


def window_chain_bwd_plain(y: torch.Tensor, g: torch.Tensor, mres, mims, n: int, wires_seq):
    """Plain torch twin of the backward window-chain kernel: the reverse
    walk as a Python loop of out-of-place steps. Returns (x, g_in, dres,
    dims) with dres/dims aligned to the step list (None at relabel slots);
    y and g are left untouched."""
    from .planar_gate import _rotate_planar
    from .window_gate import window_apply_plain, window_grad
    dres = [None] * len(wires_seq)
    dims = [None] * len(wires_seq)
    for i in range(len(wires_seq) - 1, -1, -1):
        st = wires_seq[i]
        if st[0] == 'rot':
            y = _rotate_planar(y, -st[1], n)
            g = _rotate_planar(g, -st[1], n)
            continue
        wre_t, wim_t = mres[i].t(), -mims[i].t()
        y = window_apply_plain(y, wre_t, wim_t, n, st[1])
        dres[i], dims[i] = window_grad(g, y, n, st[1])
        g = window_apply_plain(g, wre_t, wim_t, n, st[1])
    return y, g, dres, dims


def _bwd_slots(n: int, sms: int) -> int:
    """The partial slots of one K4 buffer: the column tiles of 2^(n-7)
    columns, 16 wide while they do not outnumber ``sms``, else 32 wide (the
    kernel's own rule). The kernel writes min(tiles, grid) of them."""
    cols = 1 << (n - 7)
    return cols // (16 if cols // 16 <= sms else 32)


def window_chain_bwd(y: torch.Tensor, g: torch.Tensor, mres, mims, n: int, wires_seq):
    """One-launch backward over a qualifying scheduled sequence: from the
    final state y and its cotangent g, both (2, 2^n) planes, give
    (x, g_in, dres, dims): the chain's input state, the input cotangent and
    the window-plane cotangents aligned to the step list (None at relabel
    slots). Neither y nor g is modified: both are copied into work buffers.

    CUDA tensors launch ``csrc/window_chain_bwd.cu`` (float32, w = 7) and
    raise if the build or the launch fails; CPU tensors take the twin."""
    if y.device.type == 'cpu':
        return window_chain_bwd_plain(y, g, mres, mims, n, wires_seq)
    return _window_chain_bwd_cuda(y, g, mres, mims, n, wires_seq)


def _window_chain_bwd_cuda(y, g, mres, mims, n: int, wires_seq, sms: int | None = None):
    """The launch behind ``window_chain_bwd``. ``sms`` caps the
    multiprocessors the grid fills (default: all of the card's); fewer
    stand in for a smaller card, on which a block walks several column
    tiles."""
    from . import _cuda
    if g.device != y.device or tuple(g.shape) != tuple(y.shape):
        raise ValueError(f'window_chain_bwd: g {tuple(g.shape)} on {g.device}, '
                         f'y {tuple(y.shape)} on {y.device}')
    rows, win_steps = _check_chain('window_chain_bwd', y, mres, n, wires_seq, backward=True)
    # the kernel applies W^H as a plain window product with the (W_re^T,
    # -W_im^T) planes: one small transpose of the stack, outside the kernel
    wre_t = torch.stack([mres[i] for i in win_steps]).transpose(1, 2)
    wim_t = -torch.stack([mims[i] for i in win_steps]).transpose(1, 2)
    wre_t, wim_t = _cuda.check_planes('window_chain_bwd', y, (len(win_steps), 128, 128),
                                      wre_t, wim_t)
    rows = _bwd_rows(rows, n)
    table = torch.tensor(rows, dtype=torch.int32).to(y.device)
    # work buffers: y is the saved forward output and g is autograd's (it may
    # arrive non-contiguous); each gets a ping-pong partner
    ya = y.clone()
    ga = g.clone(memory_format=torch.contiguous_format)
    _cuda.check_state(ga, n, 'window_chain_bwd')
    yb = torch.empty_like(ya)
    gb = torch.empty_like(ga)
    dw = torch.empty((2, len(win_steps), 128, 128), dtype=torch.float32, device=y.device)
    if sms is None:
        sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    # two buffers (by window parity) of per-block dW partials
    slots = _bwd_slots(n, sms)
    part = torch.empty((2, slots, 2, 128, 128), dtype=torch.float32, device=y.device)
    _cuda.launch('dq_window_chain_bwd_f32', y.device, table, len(rows), wre_t, wim_t,
                 ya, yb, ga, gb, dw[0], dw[1], part, slots, sms, n)
    window_chain_bwd.launches += 1
    # y and g swap buffers at every relabel row
    n_rot = len(rows) - len(win_steps)
    dres = [None] * len(wires_seq)
    dims = [None] * len(wires_seq)
    for k, i in enumerate(win_steps):
        dres[i] = dw[0, k]
        dims[i] = dw[1, k]
    return (yb if n_rot % 2 else ya), (gb if n_rot % 2 else ga), dres, dims


window_chain_bwd.launches = 0
