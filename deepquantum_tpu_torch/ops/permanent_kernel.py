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
column sums by one row (n complex adds) and multiplies them up (n - 1
complex multiplies). A matrix's subsets are 2^rb runs of 2^L steps, and a
thread walks ``ways`` runs side by side; ``plan`` picks L so that the stack
fills a few waves of the card: one or two threads a matrix where the stack
is large, many threads and blocks to a matrix where it is small. The launch
sums each matrix's runs in a fixed order and writes the (B,) result: one
device operation a call, no float atomics, the same bits from run to run.

Gradients: on a CUDA tensor the wrapper is a ``torch.autograd.Function``
whose forward launches the kernel and whose backward is the derivative of
the plain twin, recomputed on the saved stack (first order only). The raw
launch refuses a tensor that requires grad.
"""

from __future__ import annotations

import torch

from ..config import cdtype
from .planar_gate import _first_order_only, workspace

__all__ = ['permanent_cuda_batch', 'permanent_plain_batch', 'plan', 'MIN_N', 'MAX_N']

MIN_N = 4            # below: closed forms (photonic/qmath.py)
MAX_N = 26
THREADS = 128        # threads of a block, as in csrc/permanent_ryser.cu
_WAVES = 4           # waves of the resident threads a launch may take
_SMEM_BYTES = 96 * 1024   # shared memory a block's matrices may take (the kernel's kSmemMax)
# the kernel's instances: (NMAX, runs a thread walks); n takes the first NMAX >= n
_NMAX_WAYS = ((8, 4), (12, 2), (16, 2), (20, 2), (26, 1))
_TWIN_BYTES = 1 << 28    # the twin's (B, chunk, n) complex128 intermediate


def ways_of(n: int) -> int:
    """Runs a thread of the kernel instance for n walks side by side."""
    return next(w for nmax, w in _NMAX_WAYS if n <= nmax)


def smem_stride(n: int) -> int:
    """complex128 words between two matrices in the kernel's shared memory:
    n^2 made odd, so that threads on different matrices read different banks."""
    return (n * n) | 1


def plan(b: int, n: int, resident: int) -> tuple[int, int, int]:
    """(L, ways, threads per matrix) of the kernel's launch for a (b, n, n)
    stack on a card that keeps ``resident`` threads of the instance.

    A matrix's 2^n subsets are 2^rb runs of 2^L steps (rb + L = n), ``ways``
    runs a thread, so 2^rb / ways threads a matrix (a power of two). rb
    starts at the least that gives a thread its ``ways`` runs and grows
    while the stack's threads stay within _WAVES waves of ``resident`` and
    a run's steps stay at least twice the rb row additions its start-up may
    take, and also while the matrices that one block of THREADS threads
    takes would not fit _SMEM_BYTES as complex128. (tools/perm_sweep.py on
    an H100: one wave leaves SMs with one block beside SMs with two, 1.61
    ms at (1, 26) against 1.12 over four waves; shorter runs lose to their
    start-up sums.)"""
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f'permanent kernel: {MIN_N} <= n <= {MAX_N}, got n = {n}')
    ways = ways_of(n)
    rb = ways.bit_length() - 1
    while rb < n:
        tpm = (1 << rb) // ways
        mats = min(THREADS // tpm, b) if tpm <= THREADS else 1
        if mats * smem_stride(n) * 16 > _SMEM_BYTES or \
                (b * tpm * 2 <= _WAVES * resident and 1 << (n - rb - 1) >= 2 * (rb + 1)):
            rb += 1
            continue
        break
    return n - rb, ways, (1 << rb) // ways


def _resident_threads(device: torch.device, n: int) -> int:
    """Threads of the instance for n that the card keeps resident: blocks an
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) x SMs x THREADS."""
    from . import _cuda
    from .planar_gate import resident_on
    index = device.index if device.index is not None else torch.cuda.current_device()
    return resident_on('dq_permanent_blocks_per_sm', index, n) * _cuda.sm_count(device) * THREADS


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
    if not MIN_N <= n <= MAX_N:
        raise ValueError(f'permanent kernel: {MIN_N} <= n <= {MAX_N}, got n = {n}')
    if b == 0:
        return torch.zeros(0, dtype=cdtype(), device=mats.device)
    level, ways, tpm = plan(b, n, _resident_threads(mats.device, n))
    mats = mats.contiguous()
    out = torch.empty(b, dtype=cdtype(), device=mats.device)
    index, stream = _cuda.stream_of(mats.device)
    parts = count = 0
    if tpm > THREADS:   # a matrix spans blocks: partials and counters
        parts, count = workspace(mats.device, index, stream, 4 * b * (tpm // THREADS), b)
    _cuda.launch_on('dq_permanent_ryser', index, stream, mats, int(mats.dtype == torch.complex64),
                    out, int(out.dtype == torch.complex64), parts, count, b, n, level, ways)
    permanent_cuda_batch.launches += 1
    return out


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
