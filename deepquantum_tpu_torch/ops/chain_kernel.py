"""Window-chain engine: a whole scheduled window sequence in one launch.

PyTorch counterpart of ``deepquantum_tpu/ops/chain_kernel.py`` (forward
only). A sequence of ('win', w) / ('rot', d) steps from
ops/window_gate.py::schedule_window_seq runs as ONE cooperative launch of
``csrc/window_chain.cu`` on a CUDA tensor: the state stays in two ping-pong
buffers that fit the H100's L2 at 14 <= n <= 19 (the counterpart of the TPU
kernel's VMEM-resident state), a device-side step table drives the walk,
and the windows ride as a compact (n_win, 128, 128) stack. On a CPU tensor
the plain twin ``window_chain_plain`` walks the same steps in Python.

The JAX kernel's per-step zero window blocks at rot steps and its hand-split
bf16 matmuls are TPU artefacts and are not carried over.
"""

from __future__ import annotations

import torch

__all__ = ['chain_fused_ok', 'window_chain_fwd', 'window_chain_plain']

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


def _step_table(wires_seq, n: int):
    """Host-side step table, one row per step: (kind, delta, window index),
    kind 1 for a window (its index into the compact stack), 0 for a
    relabel by delta. Returns (rows, window step positions)."""
    rows = []
    win_steps = []
    for i, st in enumerate(wires_seq):
        if st[0] == 'win':
            rows.append((1, 0, len(win_steps)))
            win_steps.append(i)
        else:
            rows.append((0, st[1] % n, 0))
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
    if not chain_fused_ok(wires_seq, n, mres):
        raise ValueError('window_chain_fwd: the sequence does not qualify (chain_fused_ok)')
    w = next(s[1] for s in wires_seq if s[0] == 'win')
    if w != 7:
        raise ValueError(f'window_chain_fwd: the CUDA kernel takes w = 7, got {w}')
    _cuda.check_state(x, n, 'window_chain_fwd')
    rows, win_steps = _step_table(wires_seq, n)
    if any(kind == 0 and not 7 <= d <= n - 7 for kind, d, _ in rows):
        raise ValueError('window_chain_fwd: relabel deltas must lie in [7, n - 7]')
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
