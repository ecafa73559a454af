"""K8 / K9: the torontonian's powerset sweep, in float64.

For every nonempty subset Z of the m modes of a (2m, 2m) matrix O,
``tor_dets_cuda`` gives det(I - O_Z) and ``tor_dets_quads_cuda`` also the
quadratic form gamma_Z^T (I - O_Z)^{-1} conj(gamma_Z). They are the
counterparts of ``deepquantum_tpu/photonic/tor_kernel.py::tor_dets_pallas``
and ``::tor_dets_quads_pallas``: on a CUDA tensor they launch
``csrc/tor_lu.cu`` (one launch for all subset sizes, one warp per subset,
pivot-free LU with the gather fused in) or raise; on a CPU tensor they take
the plain twins ``tor_dets_plain`` / ``tor_dets_quads_plain``
(``torch.linalg.det`` and ``torch.linalg.solve`` per size group).

The TPU kernels emulate float64 with double-single planes, bucket the
subsets by size to get static shapes, and return lane-padded planes. Here
everything is complex128, one entry per subset in the scaffold's order, and
the sign comes back as it went in. ``idx``, ``valid`` and ``sign`` are the
scaffold of ``torontonian_._padded_tor_indices`` as tensors on O's device:
(S, 2m) int64 rows, (S, 2m, 1) float32 validity, (S,) float64 signs, grouped
by subset size, smallest first.

Gradients: on a CUDA tensor each wrapper is a ``torch.autograd.Function``
whose forward launches the kernel and whose backward is the derivative of
the plain twin, recomputed on the saved inputs (the JAX package's method:
its Pallas torontonian is a ``custom_jvp`` whose tangent comes from the
plain formula). First order only. The raw launch refuses a tensor that
requires grad: only the Function's forward, where grad mode is off, calls
it.
"""

from __future__ import annotations

from math import comb

import torch

from ..ops.planar_gate import _first_order_only

__all__ = ['tor_dets_cuda', 'tor_dets_quads_cuda', 'tor_dets_plain', 'tor_dets_quads_plain',
           'MAX_MODES']

MAX_MODES = 14     # 2m = 28: the largest working matrix csrc/tor_lu.cu holds per warp


def _group_slices(m: int):
    """(size p, first subset, one past the last) of each size group of the
    scaffold, from m alone (no device read)."""
    start = 0
    for k in range(1, m + 1):
        stop = start + comb(m, k)
        yield 2 * k, start, stop
        start = stop


def _check(name: str, o_mat: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
           sign: torch.Tensor) -> int:
    pm = o_mat.shape[-1]
    if o_mat.ndim != 2 or o_mat.shape[0] != pm or pm % 2 or pm < 2 or not o_mat.is_complex():
        raise ValueError(f'{name}: expected a complex (2m, 2m) matrix, got {tuple(o_mat.shape)} '
                         f'{o_mat.dtype}')
    nsub = (1 << (pm // 2)) - 1
    if tuple(idx.shape) != (nsub, pm) or tuple(valid.shape) != (nsub, pm, 1) \
            or tuple(sign.shape) != (nsub,):
        raise ValueError(f'{name}: the scaffold does not belong to m = {pm // 2}: idx '
                         f'{tuple(idx.shape)}, valid {tuple(valid.shape)}, sign {tuple(sign.shape)}')
    for t in (idx, valid, sign):
        if t.device != o_mat.device:
            raise ValueError(f'{name}: scaffold on {t.device}, matrix on {o_mat.device}')
    return pm // 2


def _gathered(o_mat: torch.Tensor, idx: torch.Tensor, p: int, start: int, stop: int):
    """I - O_Z of one size group as (S_p, p, p) complex128."""
    rows = idx[start:stop, :p]
    sub = o_mat.to(torch.complex128)[rows[:, :, None], rows[:, None, :]]
    return torch.eye(p, dtype=torch.complex128, device=o_mat.device) - sub, rows


def tor_dets_plain(o_mat, idx, valid, sign):
    """The plain twin of K8: ``torch.linalg.det`` over the gathered subset
    matrices of each size group, in complex128. Differentiable."""
    m = _check('tor_dets_plain', o_mat, idx, valid, sign)
    dets = [torch.linalg.det(_gathered(o_mat, idx, p, a, b)[0]) for p, a, b in _group_slices(m)]
    return torch.cat(dets), sign


def tor_dets_quads_plain(o_mat, gamma, idx, valid, sign):
    """The plain twin of K9: per size group ``torch.linalg.det`` and
    ``torch.linalg.solve`` against conj(gamma_Z), in complex128; the left
    gamma_Z enters unconjugated. Differentiable."""
    m = _check('tor_dets_quads_plain', o_mat, idx, valid, sign)
    gamma = gamma.to(torch.complex128)
    dets, quads = [], []
    for p, a, b in _group_slices(m):
        mats, rows = _gathered(o_mat, idx, p, a, b)
        g = gamma[rows]                                              # (S_p, p)
        x = torch.linalg.solve(mats, g.conj()[..., None])[..., 0]
        dets.append(torch.linalg.det(mats))
        quads.append((g * x).sum(-1))
    return torch.cat(dets), torch.cat(quads), sign


def _launch(name, o_mat, gamma, idx, valid, sign):
    from ..ops import _cuda
    m = _check(name, o_mat, idx, valid, sign)
    _cuda._no_grad(name, o_mat, *(() if gamma is None else (gamma,)),
                   hint=_cuda.TWIN_BACKWARD_HINT)
    if m > MAX_MODES:
        raise ValueError(f'{name}: the kernel holds 2m <= {2 * MAX_MODES}, got m = {m}')
    if o_mat.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f'{name}: complex64 or complex128, got {o_mat.dtype}')
    if idx.dtype != torch.int64 or valid.dtype != torch.float32:
        raise TypeError(f'{name}: idx must be int64 and valid float32, got {idx.dtype}, '
                        f'{valid.dtype}')
    o_mat = o_mat.contiguous()
    nsub = idx.shape[0]
    det = torch.empty(nsub, dtype=torch.complex128, device=o_mat.device)
    quad = 0
    if gamma is not None:
        if tuple(gamma.shape) != (2 * m,) or gamma.device != o_mat.device:
            raise ValueError(f'{name}: gamma must be ({2 * m},) on {o_mat.device}, got '
                             f'{tuple(gamma.shape)} on {gamma.device}')
        gamma = gamma.to(o_mat.dtype).contiguous()
        quad = torch.empty(nsub, dtype=torch.complex128, device=o_mat.device)
    _cuda.launch('dq_tor_lu', o_mat.device, o_mat, 0 if gamma is None else gamma,
                 int(o_mat.dtype == torch.complex64), idx.contiguous(), valid.contiguous(), det,
                 quad, nsub, 2 * m)
    return det, quad


class _TorDets(torch.autograd.Function):
    """K8 with the twin's derivative as its backward."""

    @staticmethod
    def forward(ctx, o_mat, idx, valid, sign):
        det, _ = _launch('tor_dets_cuda', o_mat, None, idx, valid, sign)
        tor_dets_cuda.launches += 1
        ctx.save_for_backward(o_mat, idx, valid, sign)
        return det

    @staticmethod
    @_first_order_only
    def backward(ctx, g_det):
        o_mat, idx, valid, sign = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        with torch.enable_grad():
            o = o_mat.detach().requires_grad_()
            det, _ = tor_dets_plain(o, idx, valid, sign)
            d_o, = torch.autograd.grad(det, o, g_det)
        return d_o, None, None, None


class _TorDetsQuads(torch.autograd.Function):
    """K9 with the twin's derivative as its backward."""

    @staticmethod
    def forward(ctx, o_mat, gamma, idx, valid, sign):
        det, quad = _launch('tor_dets_quads_cuda', o_mat, gamma, idx, valid, sign)
        tor_dets_quads_cuda.launches += 1
        ctx.save_for_backward(o_mat, gamma, idx, valid, sign)
        return det, quad

    @staticmethod
    @_first_order_only
    def backward(ctx, g_det, g_quad):
        o_mat, gamma, idx, valid, sign = ctx.saved_tensors
        wants = [i for i in (0, 1) if ctx.needs_input_grad[i]]
        if not wants:
            return None, None, None, None, None
        with torch.enable_grad():
            ins = [o_mat.detach().requires_grad_(), gamma.detach().requires_grad_()]
            det, quad, _ = tor_dets_quads_plain(ins[0], ins[1], idx, valid, sign)
            outs = [(t, g) for t, g in ((det, g_det), (quad, g_quad)) if g is not None]
            grads = torch.autograd.grad([t for t, _ in outs], [ins[i] for i in wants],
                                        [g for _, g in outs], allow_unused=True)
        out = [None] * 5
        for i, d in zip(wants, grads):
            out[i] = d
        return tuple(out)


def tor_dets_cuda(o_mat, idx, valid, sign):
    """det(I - O_Z) of every nonempty mode subset of a (2m, 2m) complex
    matrix, m <= 14, as ((S,) complex128, sign).

    A CUDA tensor launches ``csrc/tor_lu.cu`` once and raises if the build
    or the launch fails; its gradient in O is the twin's. A CPU tensor takes
    the twin ``tor_dets_plain``."""
    if o_mat.device.type != 'cuda':
        return tor_dets_plain(o_mat, idx, valid, sign)
    return _TorDets.apply(o_mat, idx, valid, sign), sign


tor_dets_cuda.launches = 0


def tor_dets_quads_cuda(o_mat, gamma, idx, valid, sign):
    """(det(I - O_Z), gamma_Z^T (I - O_Z)^{-1} conj(gamma_Z), sign) of every
    nonempty mode subset, m <= 14; det and the form are (S,) complex128.

    A CUDA tensor launches ``csrc/tor_lu.cu`` once, with conj(gamma_Z) as an
    extra column of each subset's elimination, and raises if the build or
    the launch fails; its gradients in O and gamma are the twin's. A CPU
    tensor takes the twin ``tor_dets_quads_plain``."""
    if o_mat.device.type != 'cuda':
        return tor_dets_quads_plain(o_mat, gamma, idx, valid, sign)
    det, quad = _TorDetsQuads.apply(o_mat, gamma, idx, valid, sign)
    return det, quad, sign


tor_dets_quads_cuda.launches = 0
