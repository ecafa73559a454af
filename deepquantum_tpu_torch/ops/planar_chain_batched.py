"""Batched gate chains, one launch per direction: K1b and K6b redesigned.

The JAX package runs a batched gate chain (data-encoded QML: a (B, 2, 2^n)
stack, per-sample (B, K, K) planes) as one Pallas call per gate with the
batch as a grid axis (``deepquantum_tpu/ops/planar_gate.py::_planar_apply``
and ``_planar_bwd_fused``, their batched branches), inside one jitted
program. On the card that shape costs a wrapper call, a launch and a pass
of the stack per gate. Here a whole scheduled chain of k <= 3 wire gate
steps is ONE launch of ``csrc/planar_chain_batched.cu`` per direction, with
each sample's state in the shared memory of a cluster of C blocks:

- forward: x -> y, the steps in order;
- backward: from the output y and its cotangent g, the steps in reverse,
  each un-applying U^H from y, reducing dW = g x^H and carrying U^H g; one
  dW partial per (sample, block) and step, summed here in a fixed order.

``pack_chain`` builds the step table and the packed planes once per call:
one concatenation per plane kind (the per-sample (B, K, K) planes, and the
(K, K) sets that every sample shares, which arrive as stride-0 expands), no
copy per gate. A ``('rot', d)`` relabel from ``schedule_planar_seq`` is
folded into the bit positions of the steps after it (the relabels are a TPU
artefact): the state is never rotated.

Range (``batched_chain_ok``): a block holds at most 2^14 amplitudes of two
planes (128 KB); the backward holds y and g, so 2^13. C = 2^c is at most 8
(the portable cluster size), so the forward runs at 8 <= n <= 17 and the
backward at 8 <= n <= 16. Outside the range the per-step kernels run.

The cluster size (``cluster_bits``): the least C whose blocks fit (C = 1 up
to n=14 forward and n=13 backward, then 2, 4, 8), doubled while the batch's
blocks then still fit the card's multiprocessors one each and a block keeps
2^12 amplitudes or more. A block of 128 KB has its multiprocessor to
itself, and a larger C adds cluster barriers and reads through distributed
shared memory: on the H100 at n=14, B=100 the rule's C = 1 forward and C =
2 backward took 0.167 / 0.583 ms of device time against 0.201 / 0.878 ms at
twice the size; at n=16, B=8 (32 blocks at C = 4 on 132 SMs) the forward
took 0.253 ms at C = 4 and 0.169 ms at C = 8.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
twin ``planar_chain_batched_plain``, which walks the same packed table with
the per-step twins of ``ops/planar_gate.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = ['batched_chain_ok', 'cluster_bits', 'pack_chain', 'BatchedChain', 'planar_chain_batched',
           'planar_chain_batched_bwd', 'planar_chain_batched_plain', 'max_active_clusters']

_MIN_N = 8
_LOCAL_BITS = 14       # amplitudes of a block: 2^14 of two float32 planes, 128 KB
_MAX_C_BITS = 3        # clusters of at most 8 blocks
_COLS = 10             # ints per step-table row (csrc/planar_chain_batched.cu)
_MIN_BLOCK_BITS = 12   # a larger cluster only while a block keeps 2^12 amplitudes


def cluster_bits(n: int, backward: bool = False, batch: int = 0, sms: int = 0) -> int:
    """log2 of the cluster size C for n qubits: the least that keeps a
    block's share of the sample's planes (y and g in the backward) within
    128 KB of shared memory; given the batch and the card's multiprocessors
    (``sms``), doubled (up to 8) while batch * 2C <= sms and a block keeps
    at least 2^12 amplitudes."""
    c = max(0, n - _LOCAL_BITS + int(backward))
    while c < _MAX_C_BITS and 0 < batch << (c + 1) <= sms and n - c - 1 >= _MIN_BLOCK_BITS:
        c += 1
    return c


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _max_n(backward: bool) -> int:
    return _LOCAL_BITS - int(backward) + _MAX_C_BITS


def batched_chain_ok(wires_seq, n: int, mres, backward: bool = False) -> bool:
    """A sequence qualifies for the one-launch batched chain (``backward``:
    its reverse walk) when every step is a gate on 1 to 3 distinct wires or
    a ('rot', d) relabel, the relabels close to the identity labeling, there
    is at least one gate, every gate's planes are a (B, K, K) stack of one
    common B, and 8 <= n <= 17 (the backward 16)."""
    if not _MIN_N <= n <= _max_n(backward):
        return False
    batches, rot = set(), 0
    for m, ws in zip(mres, wires_seq):
        if ws[0] == 'rot':
            rot += ws[1]
            continue
        if ws[0] == 'win' or not 1 <= len(ws) <= 3 or len(set(ws)) != len(ws) \
                or not all(0 <= w < n for w in ws):
            return False
        k = 1 << len(ws)
        if m is None or m.dim() != 3 or tuple(m.shape[1:]) != (k, k):
            return False
        batches.add(m.shape[0])
    return len(batches) == 1 and rot % n == 0


class BatchedChain(NamedTuple):
    """A batched gate chain packed for one launch: ``rows`` (the step table
    on the host, forward order; see ``csrc/planar_chain_batched.cu``),
    ``steps`` (each row's index in the step list of ``nsteps``), ``table``
    (the rows on the device), the per-sample planes ``ps_re`` / ``ps_im``
    (B, pstride) and the shared ones ``sh_re`` / ``sh_im`` (flat), and
    ``fd``, the floats of one (sample, block) row of dW partials."""

    n: int
    batch: int
    nsteps: int
    rows: list
    steps: list
    table: torch.Tensor
    ps_re: torch.Tensor
    ps_im: torch.Tensor
    sh_re: torch.Tensor
    sh_im: torch.Tensor
    pstride: int
    fd: int


def pack_chain(x: torch.Tensor, mres, mims, n: int, wires_seq) -> BatchedChain:
    """Pack a qualifying sequence (``batched_chain_ok``) for a (B, 2, 2^n)
    stack x: the step table, and the planes as float32 in one concatenation
    per plane kind. A gate's planes count as shared when they are a
    stride-0 expand (or B = 1); a relabel moves the bits of every later
    gate: physical wire p under the labeling rotated by R is stored wire
    (p + R) mod n."""
    batch = x.shape[0]
    rows, steps, per, shared = [], [], ([], []), ([], [])
    rot = poff = soff = doff = 0
    for i, ws in enumerate(wires_seq):
        if ws[0] == 'rot':
            rot = (rot + ws[1]) % n
            continue
        k = len(ws)
        kk = 1 << (2 * k)
        obits = [n - 1 - (w + rot) % n for w in ws]
        pad = [0] * (3 - k)
        planes = (mres[i], mims[i])
        if batch == 1 or planes[0].stride(0) == planes[1].stride(0) == 0:
            for dst, m in zip(shared, planes):
                dst.append(m[0].reshape(kk))
            off, soff, one = soff, soff + kk, 1
        else:
            for dst, m in zip(per, planes):
                dst.append(m.reshape(batch, kk))
            off, poff, one = poff, poff + kk, 0
        rows.append([k, one, off, doff] + obits + pad + sorted(obits, reverse=True) + pad)
        steps.append(i)
        doff += 2 * kk
    dev = x.device

    def cat(parts, dim):
        if not parts:
            return torch.zeros(1, dtype=torch.float32, device=dev)
        return torch.cat(parts, dim).to(torch.float32)

    return BatchedChain(
        n=n, batch=batch, nsteps=len(wires_seq), rows=rows, steps=steps,
        table=torch.tensor(rows, dtype=torch.int32).to(dev), ps_re=cat(per[0], 1),
        ps_im=cat(per[1], 1), sh_re=cat(shared[0], 0), sh_im=cat(shared[1], 0), pstride=poff,
        fd=doff)


def _row_planes(chain: BatchedChain, row):
    """A row's planes rearranged for the per-step twins: (mre, mim, sorted
    stored wires, the map of a cotangent plane back to the row's order)."""
    from .apply import permute_matrix_wires
    k, one, off = row[0], row[1], row[2]
    kk, d = 1 << (2 * k), 1 << k
    if one:
        mre, mim = (p[off:off + kk].view(d, d) for p in (chain.sh_re, chain.sh_im))
    else:
        mre, mim = (p[:, off:off + kk].reshape(-1, d, d) for p in (chain.ps_re, chain.ps_im))
    wires = [chain.n - 1 - b for b in row[4:4 + k]]
    order = sorted(range(k), key=lambda j: wires[j])
    back = sorted(range(k), key=lambda j: order[j])
    return (permute_matrix_wires(mre, order), permute_matrix_wires(mim, order),
            tuple(sorted(wires)), lambda dm: permute_matrix_wires(dm, back))


def _unpack_dw(dw: torch.Tensor, chain: BatchedChain):
    """(B, fd) summed partials -> (dres, dims), each step's (B, K, K) planes
    aligned to the step list, None at relabel slots."""
    dres = [None] * chain.nsteps
    dims = [None] * chain.nsteps
    for i, row in zip(chain.steps, chain.rows):
        d = 1 << row[0]
        blk = dw[:, row[3]:row[3] + 2 * d * d].view(-1, 2, d, d)
        dres[i], dims[i] = blk[:, 0], blk[:, 1]
    return dres, dims


def planar_chain_batched_plain(x: torch.Tensor, chain: BatchedChain, g: torch.Tensor = None):
    """Plain torch twin of both kernel entries, over the packed table.
    Without g: the forward, the final state of the stack x (a new tensor).
    With g: the backward from the chain's output x and its cotangent g,
    (x_in, g_in, dres, dims) as ``planar_chain_batched_bwd`` gives them,
    each step by ``planar_bwd_fused_plain`` and its planes summed (one
    partial per sample) in the kernel's order. x and g are not written."""
    from .planar_gate import planar_bwd_fused_plain, planar_evolve_xla
    n = chain.n
    if g is None:
        for row in chain.rows:
            mre, mim, wires, _ = _row_planes(chain, row)
            x = planar_evolve_xla(x, mre, mim, n, wires)
        return x
    blocks = []
    for row in reversed(chain.rows):
        mre, mim, wires, back = _row_planes(chain, row)
        x, g, dre, dim = planar_bwd_fused_plain(x, g, mre.transpose(-1, -2),
                                                -mim.transpose(-1, -2), n, wires)
        blocks.append(torch.cat([back(dre).flatten(1), back(dim).flatten(1)], 1))
    parts = torch.cat(blocks[::-1], 1)[:, None]     # (B, 1, fd): one partial per sample
    return (x, g, *_unpack_dw(parts.sum(1), chain))


def _check(name: str, x: torch.Tensor, chain: BatchedChain, cluster):
    """Validate a launch on the card; (batch, c) with c = log2 of the
    cluster size (the rule of ``cluster_bits``, or ``cluster``: a power of
    two from the least that fits up to 8)."""
    from . import _cuda
    batch = _cuda.check_state(x, chain.n, name, batched=True)
    if x.dim() != 3 or batch != chain.batch:
        raise ValueError(f'{name}: state {tuple(x.shape)} for a chain packed for {chain.batch} '
                         'samples')
    for t in (chain.table, chain.ps_re, chain.ps_im, chain.sh_re, chain.sh_im):
        if t.device != x.device:
            raise ValueError(f'{name}: the packed chain is on {t.device}, the state on {x.device}')
    backward = name.endswith('bwd')
    if chain.n > _max_n(backward):
        raise ValueError(f'{name}: n={chain.n} is past the kernel range (<= {_max_n(backward)})')
    if cluster is None:
        index = x.device.index if x.device.index is not None else torch.cuda.current_device()
        return batch, cluster_bits(chain.n, backward, batch, _sms(index))
    c = int(cluster).bit_length() - 1
    if (1 << c) != cluster or not cluster_bits(chain.n, backward) <= c <= _MAX_C_BITS:
        raise ValueError(f'{name}: cluster {cluster} at n={chain.n}')
    return batch, c


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads and writes the stack in 16-byte vectors."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def planar_chain_batched(x: torch.Tensor, chain: BatchedChain) -> torch.Tensor:
    """The packed chain applied to the (B, 2, 2^n) stack x; the final state
    in a new tensor (x is not written). A CUDA tensor launches the forward
    entry of ``csrc/planar_chain_batched.cu`` (float32) and raises if the
    build or the launch fails; a CPU tensor takes the twin."""
    if x.device.type == 'cpu':
        return planar_chain_batched_plain(x, chain)
    return _planar_chain_batched_cuda(x, chain)


def _planar_chain_batched_cuda(x: torch.Tensor, chain: BatchedChain, cluster=None):
    """The launch behind ``planar_chain_batched``; ``cluster`` sets the
    cluster size (a power of two >= the rule's, <= 8)."""
    from . import _cuda
    batch, c = _check('planar_chain_batched', x, chain, cluster)
    x = _aligned(x)
    y = torch.empty_like(x)
    _cuda.launch('dq_planar_chain_batched_fwd_f32', x.device, chain.table, len(chain.rows),
                 chain.ps_re, chain.ps_im, chain.sh_re, chain.sh_im, chain.pstride, x, y, batch,
                 chain.n, c)
    planar_chain_batched.launches += 1
    return y


planar_chain_batched.launches = 0


def planar_chain_batched_bwd(y: torch.Tensor, g: torch.Tensor, chain: BatchedChain):
    """The reverse walk of the packed chain from its output y and the
    cotangent g, both (B, 2, 2^n): (x, g_in, dres, dims), the chain's input,
    the input cotangent, and every step's (B, K, K) cotangent planes aligned
    to the step list (None at relabel slots). y and g are not written.

    CUDA tensors launch the backward entry of ``csrc/planar_chain_batched.cu``
    (float32), whose per-block partials are summed here in a fixed order,
    and raise if the build or the launch fails; CPU tensors take the twin."""
    if y.device.type == 'cpu':
        return planar_chain_batched_plain(y, chain, g)
    return _planar_chain_batched_bwd_cuda(y, g, chain)


def _planar_chain_batched_bwd_cuda(y: torch.Tensor, g: torch.Tensor, chain: BatchedChain,
                                   cluster=None):
    """The launch behind ``planar_chain_batched_bwd``; ``cluster`` as for
    the forward."""
    from . import _cuda
    name = 'planar_chain_batched_bwd'
    batch, c = _check(name, y, chain, cluster)
    # autograd's cotangent may arrive non-contiguous
    g = _aligned(g.contiguous())
    if g.device != y.device or _check(name, g, chain, cluster)[0] != batch:
        raise ValueError(f'{name}: g {tuple(g.shape)} on {g.device}, y {tuple(y.shape)} on '
                         f'{y.device}')
    y = _aligned(y)
    x_out = torch.empty_like(y)
    g_out = torch.empty_like(y)
    parts = torch.empty((batch, 1 << c, chain.fd), dtype=torch.float32, device=y.device)
    _cuda.launch('dq_planar_chain_batched_bwd_f32', y.device, chain.table, len(chain.rows),
                 chain.ps_re, chain.ps_im, chain.sh_re, chain.sh_im, chain.pstride, y, g, x_out,
                 g_out, parts, chain.fd, batch, chain.n, c)
    planar_chain_batched_bwd.launches += 1
    return (x_out, g_out, *_unpack_dw(parts.sum(1), chain))


planar_chain_batched_bwd.launches = 0


def max_active_clusters(n: int, backward: bool = False, cluster=None) -> int:
    """cudaOccupancyMaxActiveClusters of one direction's kernel at n qubits
    and a cluster size (by default the least that fits) on the current
    card: how many clusters it keeps resident at once."""
    from . import _cuda
    c = cluster_bits(n, backward) if cluster is None else int(cluster).bit_length() - 1
    out = torch.zeros(1, dtype=torch.int32)
    _cuda.launch('dq_planar_chain_batched_clusters', torch.device('cuda'), n, c, int(backward),
                 out)
    return int(out.item())
