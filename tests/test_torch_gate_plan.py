"""The access plan of the per-gate kernels K1 and K5, mirrored on the CPU.

``csrc/planar_apply.cu`` (K1) and ``csrc/planar_grad.cu`` (K5) read the
state as float4 quads (``csrc/planar_quad.cuh``): a thread owns units of
2^(k - low) quads per plane, each holding 4 / 2^low whole groups, and walks
them in a grid-stride loop over a grid that ``planar_gate.gate_blocks``
sizes to the card. The kernels run only on the card; these tests walk a
Python mirror of the same index arithmetic (the grid, the units each thread
takes, the lanes and the lane swap of the bit-1 variant, K5's split rows and
its last block's fixed-order sum) with the plan that ``planar_gate.quad_plan``
hands the kernels, and check that

- every amplitude of every sample is taken exactly once (K5 at k = 3: by
  both threads of a pair, each for its own rows), and each group's 2^k
  partners come in sorted-wire order, the order of the gate's planes;
- walked in float64, the mirror gives the twins' results (to 1e-12);
- the grid: a power of two per sample, no more than one wave of the
  resident blocks, every thread at least 4 quads per plane where the state
  allows, n = 10, k = 3 taken.

No JAX here: the twins are held against the JAX package by
tests/test_torch_planar.py, and the kernels against the twins on the card
by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from deepquantum_tpu_torch.ops import _cuda
from deepquantum_tpu_torch.ops import planar_gate as tpg

T = tpg._GATE_THREADS
SMS = 132
# blocks an SM keeps resident: the card reports them per kernel instance
# (registers decide: 1 at k = 3, 2-4 below); the walks take each
RESIDENT = (1, 2, 4)


def _insert_zeros(u, hb):
    """The kernel's QuadPlan::base: zero bits inserted at hb, lowest first."""
    for b in sorted(hb):
        u = ((u >> b) << (b + 1)) | (u & ((1 << b) - 1))
    return u


def _walk(n, ws, batch, per_sm, split, unroll):
    """The units each thread of one sample takes, as the kernels' loops take
    them: thread t = lb * T + threadIdx.x starts at unit t // split and steps
    by bps * T / split, ``unroll`` units an iteration, then a tail. Returns
    (bps, plan, thread, sub, unit) with one row per visit."""
    k, low, swap, hb = tpg.quad_plan('mirror', n, ws)
    bps = tpg.gate_blocks(n, batch, SMS, per_sm)
    units = (1 << (n - 2)) >> (k - low)
    t = np.arange(bps * T)
    u = t // split
    stride = bps * (T // split)
    rows_t, rows_u = [], []
    while True:
        ok = u + (unroll - 1) * stride < units
        if not ok.any():
            break
        for r in range(unroll):
            rows_t.append(t[ok])
            rows_u.append(u[ok] + r * stride)
        u = np.where(ok, u + unroll * stride, u)
    if unroll > 1:
        ok = u < units
        rows_t.append(t[ok])
        rows_u.append(u[ok])
    thread = np.concatenate(rows_t)
    return bps, (k, low, swap, hb), thread, thread % split, np.concatenate(rows_u)


def _groups(n, plan, unit):
    """(visits, G, 2^k) amplitude indices: each visited unit's groups, their
    partners in gate-index order c = (ch << low) | cl, read through the
    quads and lanes as the kernels read them (lanes 1 and 2 swapped where
    the gate holds bit 1 but not bit 0)."""
    k, low, swap, hb = plan
    h = k - low
    hbs = hb[:h]
    base = _insert_zeros(unit, hbs)
    lanes = [0, 2, 1, 3] if swap else [0, 1, 2, 3]
    g_count = 4 >> low
    out = np.empty((len(unit), g_count, 1 << k), dtype=np.int64)
    for ch in range(1 << h):
        off = sum(((ch >> (h - 1 - j)) & 1) << hbs[j] for j in range(h))
        for lane in range(4):
            s = lane if low == 0 else (lane >> 1 if low == 1 else 0)
            cl = 0 if low == 0 else (lane & 1 if low == 1 else lane)
            out[:, s, (ch << low) | cl] = (base + off) * 4 + lanes[lane]
    return out


def _wire_sets(n):
    """Gates on amplitude bit 0, on bit 1, on bits 0-1, on the top bits and
    in between, k = 1, 2, 3."""
    return [(n - 1,), (n - 2,), (0,), (n - 2, n - 1), (0, 1), (1, n // 2),
            (0, 1, 2), (0, n // 2, n - 1), (1, n - 3, n - 2), (n - 3, n - 2, n - 1)]


CASES = [(n, ws) for n in (10, 12, 16) for ws in _wire_sets(n)]


@pytest.mark.parametrize('batch', [1, 3, 100])
@pytest.mark.parametrize('n,ws', CASES)
def test_walk_covers_every_amplitude_once_in_wire_order(n, ws, batch):
    k = len(ws)
    walks = [(per_sm, 1, 2 if k <= 2 else 1) for per_sm in RESIDENT]          # K1
    walks += [(per_sm, 2 if k == 3 else 1, 2 if k == 1 else 1) for per_sm in RESIDENT]  # K5
    for per_sm, split, unroll in walks:
        bps, plan, thread, sub, unit = _walk(n, ws, batch, per_sm, split, unroll)
        # blocks to samples: sample = blockIdx // bps owns bps consecutive blocks
        blocks = np.arange(batch * bps)
        assert np.array_equal(np.bincount(blocks // bps), np.full(batch, bps))
        # each unit once per row share (sub), the shares of a unit distinct
        units = (1 << (n - 2)) >> (k - plan[1])
        seen = np.zeros((units, split), dtype=np.int64)
        np.add.at(seen, (unit, sub), 1)
        assert (seen == 1).all()
        # every amplitude of the sample once (one row share), partners in order
        amps = _groups(n, plan, unit[sub == 0])
        assert np.array_equal(np.sort(amps.ravel()), np.arange(1 << n))
        bits = [n - 1 - w for w in ws]
        gate_mask = sum(1 << b for b in bits)
        assert (amps & ~gate_mask == (amps[..., :1] & ~gate_mask)).all()
        for c in range(1 << k):
            for j, b in enumerate(bits):
                assert ((amps[..., c] >> b) & 1 == (c >> (k - 1 - j)) & 1).all()


@pytest.mark.parametrize('n,ws,batch', [(10, (0, 5, 9), 3), (10, (8, 9), 1), (12, (1, 10), 3),
                                        (12, (2, 11), 1), (10, (3,), 3), (10, (0, 1, 8), 1)])
def test_mirror_walk_in_float64_gives_the_twins(n, ws, batch):
    rng = np.random.default_rng(n + sum(ws))
    k = len(ws)
    x = rng.standard_normal((batch, 2, 1 << n))
    g = rng.standard_normal((batch, 2, 1 << n))
    m = rng.standard_normal((batch, 1 << k, 1 << k)) + 1j * rng.standard_normal(
        (batch, 1 << k, 1 << k))
    _, plan, _, sub, unit = _walk(n, ws, batch, 4, 1, 2)
    amps = _groups(n, plan, unit).reshape(-1, 1 << k)        # (groups, 2^k)
    xc = x[:, 0] + 1j * x[:, 1]
    gc = g[:, 0] + 1j * g[:, 1]
    y = xc.copy()
    y[:, amps] = np.einsum('bac,bgc->bga', m, xc[:, amps])   # K1: y = M x per group
    want = tpg.planar_evolve_xla(torch.as_tensor(x), torch.as_tensor(m.real),
                                 torch.as_tensor(m.imag), n, ws).numpy()
    np.testing.assert_allclose(np.stack([y.real, y.imag], 1), want, rtol=0, atol=1e-12)

    split = 2 if k == 3 else 1
    _, plan, _, sub, unit = _walk(n, ws, batch, 1, split, 2 if k == 1 else 1)
    rows = (1 << k) // split
    dw = np.zeros((batch, 1 << k, 1 << k), dtype=complex)
    for s in range(split):                                   # K5: each share its rows
        a = _groups(n, plan, unit[sub == s]).reshape(-1, 1 << k)
        r = slice(s * rows, (s + 1) * rows)
        dw[:, r] += np.einsum('bgi,bgj->bij', gc[:, a][..., r], np.conj(xc[:, a]))
    wr, wi = tpg.planar_grad_xla(torch.as_tensor(g), torch.as_tensor(x), n, ws)
    np.testing.assert_allclose(dw.real, wr.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dw.imag, wi.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize('k', [1, 2, 3])
@pytest.mark.parametrize('bps', [1, 2, 5, 64, 256, 512])
def test_last_block_sums_every_partial_once_in_a_fixed_order(k, bps):
    """K5's last block: thread t takes float4 e4 = t % E4 of the partials
    and slice t // E4 of the S = T / E4 slices, adding blocks slice,
    slice + S, ... in batches of 8 loads in ascending order; then element e
    adds the slices' sums in order. Every block's partial is added once per
    element, in an order fixed by the indices alone, whichever block
    arrived last."""
    e_count = 2 * 4 ** k
    e4_count = e_count // 4
    s_count = T // e4_count
    batch = 8
    assert T % e4_count == 0
    taken = np.zeros((e_count, bps), dtype=int)
    for t in range(T):
        e4, sl = t % e4_count, t // e4_count
        order = []
        for b0 in range(sl, bps, batch * s_count):
            order += [b for b in b0 + s_count * np.arange(batch) if b < bps]
        assert order == sorted(order) and len(set(order)) == len(order)
        for c in range(4):
            taken[4 * e4 + c, order] += 1
    assert (taken == 1).all()
    # the slices' sums sit at fin[slice * E + e]: each (slice, e) written once
    fin = np.zeros(s_count * e_count, dtype=int)
    for t in range(T):
        fin[4 * t:4 * t + 4] += 1
    assert (fin == 1).all()


def test_gate_blocks_sizes_the_grid_to_the_card():
    for n in (10, 12, 14, 16, 18, 20, 22):
        for batch in (1, 3, 8, 100, 1000):
            for per_sm in RESIDENT:
                bps = tpg.gate_blocks(n, batch, SMS, per_sm)
                assert bps >= 1 and bps & (bps - 1) == 0
                quads = 1 << (n - 2)
                assert bps == 1 or bps * T * tpg._QUADS_PER_THREAD <= quads
                assert bps == 1 or bps * batch <= per_sm * SMS
    # the main paths' shapes: n=22 alone fills a wave; the QML stacks share one
    assert tpg.gate_blocks(22, 1, SMS, 4) == 512
    assert tpg.gate_blocks(22, 1, SMS, 2) == 256
    assert tpg.gate_blocks(22, 1, SMS, 1) == 128
    assert tpg.gate_blocks(14, 100, SMS, 2) == 2
    assert tpg.gate_blocks(14, 100, SMS, 1) == 1
    assert tpg.gate_blocks(18, 8, SMS, 2) == 32
    assert tpg.gate_blocks(10, 1, SMS, 4) == 1


def test_quad_plan_variants_and_range():
    # n = 10, k = 3: 2^7 groups, taken (the planar engine's floor)
    assert tpg.quad_plan('t', 10, (0, 1, 2)) == (3, 0, 0, (7, 6, 5))
    assert tpg.quad_plan('t', 10, (9,)) == (1, 1, 0, (0, 0, 0))        # bit 0
    assert tpg.quad_plan('t', 10, (8,)) == (1, 1, 1, (0, 0, 0))        # bit 1: swap
    assert tpg.quad_plan('t', 10, (8, 9)) == (2, 2, 0, (0, 0, 0))      # bits 0-1
    assert tpg.quad_plan('t', 10, (0, 7, 8)) == (3, 1, 1, (7, 0, 0))
    assert tpg.quad_plan('t', 2, (0, 1)) == (2, 2, 0, (0, 0, 0))
    for n, ws in ((1, (0,)), (34, (0,)), (10, (3, 3)), (10, (10,))):
        with pytest.raises(ValueError):
            tpg.quad_plan('t', n, ws)


def test_sample_planes_passes_float32_contiguous_planes_as_they_are():
    x = torch.zeros(4, 2, 1 << 10)
    per = torch.randn(4, 2, 2)
    got, pstride = _cuda.sample_planes('t', x, 4, (2, 2), per, per)
    assert pstride == 4 and all(m is per for m in got)
    one = torch.randn(2, 2)
    got, pstride = _cuda.sample_planes('t', x, 4, (2, 2), one.expand(4, 2, 2), one)
    assert pstride == 0 and all(m.data_ptr() == one.data_ptr() for m in got)
    got, pstride = _cuda.sample_planes('t', x, 4, (2, 2), per, one)     # one set broadcast
    assert pstride == 4 and got[0] is per and torch.equal(got[1], one.expand(4, 2, 2))
    got, _ = _cuda.sample_planes('t', x, 4, (2, 2), per.double(), per.transpose(1, 2))
    assert got[0].dtype == torch.float32 and torch.equal(got[0], per)
    assert got[1].is_contiguous() and torch.equal(got[1], per.transpose(1, 2))


def test_grad_workspace_is_kept_and_grown():
    dev = torch.device('cpu')
    key = (-1, 12345)
    tpg._grad_workspaces.pop(key, None)
    try:
        p1, c1 = tpg._grad_workspace(dev, *key, 64, 3)
        p2, c2 = tpg._grad_workspace(dev, *key, 32, 2)
        assert p2 is p1 and c2 is c1 and int(c1.abs().sum()) == 0
        p3, c3 = tpg._grad_workspace(dev, *key, 128, 3)
        assert p3.numel() == 128 and c3 is c1
        _, c4 = tpg._grad_workspace(dev, *key, 16, 8)
        assert c4.numel() == 8 and int(c4.abs().sum()) == 0
    finally:
        tpg._grad_workspaces.pop(key, None)
