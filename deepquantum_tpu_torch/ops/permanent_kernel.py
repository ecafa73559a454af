"""K7: Ryser permanents of a stack of matrices, in float64.

    perm(A) = (-1)^n sum_{S subseteq [n]} (-1)^{|S|} prod_j sum_{i in S} A_ij

``permanent_cuda_batch`` is the counterpart of
``deepquantum_tpu/ops/pallas_kernels.py::permanent_pallas_batch``: on a CUDA
tensor it launches ``csrc/permanent_ryser.cu`` (one launch for the whole
stack) or raises; on a CPU tensor it takes the plain twin
``permanent_plain_batch``. The TPU kernel emulates float64 with
double-single arithmetic on fixed-point planes because that chip has none;
the card has native float64, so every column sum, product and accumulator
here is a float64, whatever the input type (complex64 or complex128), and
none of the plane-splitting machinery is carried over.

The sweep walks the 2^n subsets in Gray-code order, so a step changes the n
column sums by one row (n complex adds) and multiplies them up (n complex
multiplies). A thread owns a run of 2^L consecutive Gray-code indices of one
matrix; ``plan`` picks L so that both a stack of many small matrices and one
large matrix fill the card. The threads' partial sums go to a scratch tensor
that ``torch.sum`` adds in a fixed order: no float atomics, so the result
does not change from run to run.

Gradients: on a CUDA tensor the wrapper is a ``torch.autograd.Function``
whose forward launches the kernel and whose backward is the derivative of
the plain twin, recomputed on the saved stack (first order only). The raw
launch refuses a tensor that requires grad.
"""

from __future__ import annotations

import torch

from ..config import cdtype
from .planar_gate import _first_order_only

__all__ = ['permanent_cuda_batch', 'permanent_plain_batch', 'plan', 'MIN_N', 'MAX_N']

MIN_N = 4            # below: closed forms (photonic/qmath.py)
MAX_N = 26
THREADS = 128        # threads of a block, as in csrc/permanent_ryser.cu
_TARGET_THREADS = 1 << 17
_SMEM_BYTES = 48 * 1024
_TWIN_BYTES = 1 << 28    # the twin's (B, chunk, n) complex128 intermediate


def plan(b: int, n: int) -> tuple[int, int]:
    """(L, partials per matrix) of the kernel's launch for a (b, n, n) stack.

    A thread sweeps 2^L subsets. L aims at about 2^17 threads in all, stays
    at or above 4 (below that the start-up sum of a run outweighs its steps)
    and at or below 16, and shrinks until the matrices that one block's
    threads touch fit 48 KB of shared memory as complex128. A matrix has
    2^(n - L) runs; a warp that lies inside one matrix (32 or more runs)
    adds its lanes' sums first, so it leaves one partial, else a thread
    leaves one."""
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f'permanent kernel: {MIN_N} <= n <= {MAX_N}, got n = {n}')
    want = max(1, (b << n) // _TARGET_THREADS)
    level = max(min(want.bit_length() - 1, 16), 4)
    level = min(level, n)
    while level > 0 and max(1, THREADS >> (n - level)) * n * n * 16 > _SMEM_BYTES:
        level -= 1
    runs = 1 << (n - level)
    return level, (runs // 32 if runs >= 32 else runs)


def permanent_plain_batch(mats: torch.Tensor) -> torch.Tensor:
    """The plain twin of K7: chunked mask-matmul Ryser in complex128.

    The subset masks of a chunk, as a (chunk, n) 0/1 matrix, times the stack
    give every column sum of the chunk in one batched matmul; the chunk is
    sized so that the (B, chunk, n) intermediate stays under 256 MB.
    Differentiable. Returns ``cdtype()``, (B,)."""
    if mats.ndim != 3 or mats.shape[-1] != mats.shape[-2] or not mats.is_complex():
        raise ValueError(f'permanent: expected a complex (B, n, n) stack, got {tuple(mats.shape)} '
                         f'{mats.dtype}')
    b, n, _ = mats.shape
    a = mats.to(torch.complex128)
    chunk = 1 << n
    while chunk > 1 and b * chunk * n * 16 > _TWIN_BYTES:
        chunk >>= 1
    shifts = torch.arange(n, device=mats.device)
    total = torch.zeros(b, dtype=torch.complex128, device=mats.device)
    for start in range(0, 1 << n, chunk):
        idx = torch.arange(start, start + chunk, device=mats.device)
        bits = (idx[:, None] >> shifts[None, :]) & 1                    # (chunk, n)
        sums = bits.to(torch.complex128) @ a                             # (B, chunk, n)
        signs = (1 - 2 * (bits.sum(-1) & 1)).to(torch.float64)           # (-1)^|S|
        total = total + (sums.prod(-1) * signs).sum(-1)                  # the empty set gives 0
    return ((-1) ** n * total).to(cdtype())


def _launch(mats: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on a CUDA stack; (B,) ``cdtype()``."""
    from . import _cuda
    _cuda._no_grad('permanent_cuda_batch', mats, hint=_cuda.TWIN_BACKWARD_HINT)
    if mats.ndim != 3 or mats.shape[-1] != mats.shape[-2]:
        raise ValueError(f'permanent_cuda_batch: expected (B, n, n), got {tuple(mats.shape)}')
    if mats.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f'permanent_cuda_batch: complex64 or complex128, got {mats.dtype}')
    b, n, _ = mats.shape
    level, nparts = plan(b, n)
    if b == 0:
        return torch.zeros(0, dtype=cdtype(), device=mats.device)
    mats = mats.contiguous()
    parts = torch.empty((b, nparts), dtype=torch.complex128, device=mats.device)
    _cuda.launch('dq_permanent_ryser', mats.device, mats, int(mats.dtype == torch.complex64),
                 parts, b, n, level)
    permanent_cuda_batch.launches += 1
    return parts.sum(dim=1).to(cdtype())


class _Permanents(torch.autograd.Function):
    """K7 with the twin's derivative as its backward."""

    @staticmethod
    def forward(ctx, mats):
        ctx.save_for_backward(mats)
        return _launch(mats)

    @staticmethod
    @_first_order_only
    def backward(ctx, g):
        mats, = ctx.saved_tensors
        with torch.enable_grad():
            m = mats.detach().requires_grad_()
            d, = torch.autograd.grad(permanent_plain_batch(m), m, g)
        return d


def permanent_cuda_batch(mats: torch.Tensor) -> torch.Tensor:
    """Ryser permanents of a (B, n, n) complex stack, 4 <= n <= 26, computed
    in float64 and returned as ``cdtype()``, (B,).

    A CUDA tensor launches the ``csrc/permanent_ryser.cu`` kernel once and
    raises if the build or the launch fails; its gradient is the twin's. A
    CPU tensor takes the twin ``permanent_plain_batch``."""
    if mats.device.type != 'cuda':
        return permanent_plain_batch(mats)
    return _Permanents.apply(mats)


permanent_cuda_batch.launches = 0
