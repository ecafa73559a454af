"""The plan and the walk of the permanent kernel K7, mirrored on the CPU.

``csrc/permanent_ryser.cu`` splits a matrix's 2^n subsets into 2^rb runs
of 2^L steps (rb + L = n): run r takes the subsets (r << L) | gray(s), so
its rows >= L are the bits of r, summed once at its start, and step s flips
row ctz(s), the same row with the same sign in every run. A thread walks
``ways`` runs side by side (4, 2 or 1 by n); tpm = 2^rb / ways threads take a matrix, many
matrices to a block of 128 threads or many blocks to a matrix.
``permanent_kernel.plan`` picks L for a stack and a card. The kernel runs
only on the card; these tests walk a Python mirror of its index arithmetic
and check that

- every subset of every matrix is visited exactly once, each run starting
  from the subset its bits give, each step with the kernel's row, sign and
  parity;
- walked in float64 as the kernel walks it (start-up sums, the ways side
  by side, the product of column sums as four chains and a tree, the sum
  over ways, lanes, warps and blocks in the launch's fixed order), the
  mirror gives the twin ``permanent_plain_batch`` to 1e-12 of the terms'
  sizes (the terms cancel);
- the plan at the shapes the photonic paths and ``chip_smoke.py`` give
  the kernel, on a card that keeps 1, 2 or 4 blocks an SM resident: a few
  waves of them, runs long enough for their start-up sums.

No JAX here: the twin is held against the JAX package by
tests/test_torch_photonic_kernels.py, the kernel against the twin on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from deepquantum_tpu_torch.ops import permanent_kernel as pk

T = pk.THREADS
SMS = 132
RESIDENT = (1, 2, 4)       # blocks an SM keeps: the card reports them per instance
# chip_smoke.PERM_SHAPES: (B, n); the first two are path (a)'s and get_amplitude's
PERM_SHAPES = [(12376, 6), (1, 20), (3, 4), (2, 5), (1000, 14), (4, 20), (1, 22), (1, 26)]


def _gray(s):
    return s ^ (s >> 1)


def _threads(b, n, level, ways, tpm):
    """(block, thread, matrix, tin, live) of every thread of the launch, as
    the kernel derives them from blockIdx and threadIdx."""
    rows = []
    if tpm > T:
        bpm = tpm // T
        for blk in range(b * bpm):
            m0, lb = blk // bpm, blk % bpm
            for t in range(T):
                rows.append((blk, t, m0, lb * T + t, True))
    else:
        mpb = T // tpm
        for blk in range(-(-b // mpb)):
            m0 = blk * mpb
            nmat = min(mpb, b - m0)
            for t in range(T):
                rows.append((blk, t, m0 + t // tpm, t % tpm, t // tpm < nmat))
    return rows


def _haar(n, rng):
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.mark.parametrize('b,n,resident', [(5, 6, 4096), (3, 4, 4096), (2, 9, 4096), (1, 12, 4096),
                                          (3, 11, 1 << 20), (1, 14, 1 << 20), (33, 7, 64),
                                          (4, 10, 256)])
def test_walk_visits_every_subset_once(b, n, resident):
    level, ways, tpm = pk.plan(b, n, resident)
    rb = n - level
    assert tpm * ways == 1 << rb and tpm & (tpm - 1) == 0
    seen = np.zeros((b, 1 << n), dtype=np.int64)
    steps = np.arange(1 << level)
    gray = _gray(steps)
    for _, _, m, tin, live in _threads(b, n, level, ways, tpm):
        if not live:
            continue
        for w in range(ways):
            r = tin * ways + w            # way w takes run r0 | w, r0 = tin * ways
            assert r == (tin * ways) | w
            np.add.at(seen[m], (r << level) | gray, 1)
    assert (seen == 1).all()


@pytest.mark.parametrize('n,level', [(4, 2), (6, 4), (9, 5), (12, 5), (14, 8)])
def test_steps_flip_one_row_with_the_kernels_sign_and_parity(n, level):
    """Step s flips row ctz(s) of gray(s - 1) into gray(s), added (+1) where
    the bit turns on; every run's start holds only its own bits >= level;
    the subset's parity is that of the run and of s."""
    rows = np.arange(n)
    for r in (0, 1, 2, 3, (1 << (n - level)) - 1):
        if r >= 1 << (n - level):
            continue
        start = r << level
        assert set(rows[(start >> rows) & 1 == 1]) == {level + i for i in range(n - level)
                                                       if (r >> i) & 1}
        g = 0
        for s in range(1, 1 << level):
            bit = (s & -s).bit_length() - 1
            new = g ^ (1 << bit)
            assert new == _gray(s)                            # one row a step
            sign = 1 if (new >> bit) & 1 else -1
            assert sign == (1 if (_gray(s) >> bit) & 1 else -1)
            subset = start | new
            assert bin(subset).count('1') % 2 == (bin(r).count('1') + s) % 2
            g = new


def _mirror(mats, level, ways, tpm):
    """The kernel's walk and sums in float64: per thread its ways side by
    side (start-up sums, Gray steps, four product chains and a tree, the
    ways added in order), then per matrix its threads in the launch's
    order. Returns (B,) complex128 with the (-1)^n applied."""
    b, n, _ = mats.shape
    thr = _threads(b, n, level, ways, tpm)
    vals = {}
    for blk, t, m, tin, live in thr:
        a = mats[m] if live else mats[0]
        r0 = tin * ways
        sums = []
        base = np.zeros(n, dtype=complex)
        for i in range(n - level):
            if (r0 >> i) & 1:
                base = base + a[level + i]
        for w in range(ways):
            s_w = base.copy()
            for i in range(ways.bit_length() - 1):
                if (w >> i) & 1:
                    s_w = s_w + a[level + i]
            sums.append(s_w)
        par = [bin(r0 | w).count('1') & 1 for w in range(ways)]
        acc = [0j] * ways
        g = 0
        for s in range(1 << level):
            if s:
                bit = (s & -s).bit_length() - 1
                g ^= 1 << bit
                sgn = 1.0 if (g >> bit) & 1 else -1.0
                for w in range(ways):
                    sums[w] = sums[w] + sgn * a[bit]
            for w in range(ways):
                ch = list(sums[w][:4])
                for j in range(4, n):
                    ch[j & 3] = ch[j & 3] * sums[w][j]
                p = (ch[0] * ch[1]) * (ch[2] * ch[3])
                acc[w] = acc[w] - p if par[w] ^ (s & 1) else acc[w] + p
        tot = acc[0]
        for w in range(1, ways):
            tot = tot + acc[w]
        vals[(blk, t)] = tot if live else 0j

    def butterfly(v, span):
        v = list(v)
        o = 1
        while o < span:
            v = [v[i] + v[i ^ o] for i in range(len(v))]
            o <<= 1
        return v

    out = np.zeros(b, dtype=complex)
    blocks = sorted({blk for blk, *_ in thr})
    partials = {}
    for blk in blocks:
        lanes = [vals[(blk, t)] for t in range(T)]
        owners = [(m, tin, live) for bb, t, m, tin, live in thr if bb == blk]
        if tpm == 1:
            for t, (m, _, live) in enumerate(owners):
                if live:
                    out[m] = lanes[t]
        elif tpm < 32:
            for w0 in range(0, T, 32):
                warp = butterfly(lanes[w0:w0 + 32], tpm)
                for t in range(w0, w0 + 32):
                    m, tin, live = owners[t]
                    if live and tin == 0:
                        out[m] = warp[t - w0]
        else:
            warps = [butterfly(lanes[w0:w0 + 32], 32)[0] for w0 in range(0, T, 32)]
            if tpm <= T:
                for t in range(0, T, tpm):
                    m, _, live = owners[t]
                    if live:
                        v = warps[t // 32]
                        for w in range(1, tpm // 32):
                            v = v + warps[t // 32 + w]
                        out[m] = v
            else:
                v = warps[0]
                for w in range(1, T // 32):
                    v = v + warps[w]
                partials[(owners[0][0], owners[0][1] // T)] = v
    if tpm > T:   # the last block: thread i adds partials i, i + T, ..., then the block's sum
        bpm = tpm // T
        for m in range(b):
            lanes = []
            for i in range(T):
                v = 0j
                for p in range(i, bpm, T):
                    v = v + partials[(m, p)]
                lanes.append(v)
            warps = [butterfly(lanes[w0:w0 + 32], 32)[0] for w0 in range(0, T, 32)]
            v = warps[0]
            for w in range(1, T // 32):
                v = v + warps[w]
            out[m] = v
    return (-1) ** n * out


@pytest.mark.parametrize('b,n,resident', [(5, 6, 4096), (3, 4, 4096), (2, 9, 4096), (2, 8, 40),
                                          (1, 11, 1 << 20), (3, 10, 1 << 20), (4, 10, 256),
                                          (1, 14, 1 << 20)])
def test_mirror_walk_in_float64_gives_the_twin(b, n, resident):
    rng = np.random.default_rng(100 * b + n)
    mats = np.stack([_haar(n, rng) for _ in range(b)])
    level, ways, tpm = pk.plan(b, n, resident)
    got = _mirror(mats, level, ways, tpm)
    from deepquantum_tpu_torch import config
    with torch.no_grad():
        prev = config.cdtype()
        config.set_dtype('complex128')
        try:
            want = pk.permanent_plain_batch(torch.as_tensor(mats)).numpy()
        finally:
            config.set_dtype('complex64' if prev == torch.complex64 else 'complex128')
    # the 2^n terms cancel (by up to 1e4 at n = 11): 1e-12 of their sum of sizes
    subsets = (np.arange(1 << n)[:, None] >> np.arange(n)[None, :]) & 1
    scale = np.abs(np.einsum('sn,bnj->bsj', subsets, mats).prod(-1)).sum(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale.max())


@pytest.mark.parametrize('per_sm', RESIDENT)
@pytest.mark.parametrize('b,n', PERM_SHAPES)
def test_plan_at_the_main_shapes(b, n, per_sm):
    resident = per_sm * SMS * T
    level, ways, tpm = pk.plan(b, n, resident)
    rb = n - level
    assert ways == pk.ways_of(n) and tpm * ways == 1 << rb and tpm & (tpm - 1) == 0
    # the block's matrices fit its shared memory as complex128
    mats = min(T // tpm, b) if tpm <= T else 1
    assert mats * pk.smem_stride(n) * 16 <= pk._SMEM_BYTES
    # a few waves: the stack's threads fit _WAVES waves of the resident ones
    # unless the shared memory asks for more threads a matrix, and a run keeps
    # at least twice the rb row additions of its start-up in steps
    if b * tpm > pk._WAVES * resident:
        half = tpm // 2
        assert half >= 1 and min(b, T // half) * pk.smem_stride(n) * 16 > pk._SMEM_BYTES
    elif tpm * ways > ways:
        assert 1 << level >= 2 * rb
        assert b * tpm * 2 > pk._WAVES * resident or 1 << (level - 1) < 2 * (rb + 1)
    # the shapes the paths give: path (a)'s stack two threads a matrix, four
    # runs of 8 steps each; get_amplitude's 20 x 20 over 128 blocks of 32
    # steps; the largest over 512 to 2048 blocks
    if (b, n) == (12376, 6):
        assert (level, ways, tpm) == (3, 4, 2)
    if (b, n) == (1, 20):
        assert (level, ways, tpm) == (5, 2, 16384)
    if (b, n) == (1, 26):
        assert (level, tpm) == {1: (10, 65536), 2: (9, 131072), 4: (8, 262144)}[per_sm]


def test_plan_range_and_instances():
    assert [pk.ways_of(n) for n in (4, 8, 9, 12, 16, 20, 21, 26)] == [4, 4, 2, 2, 2, 2, 1, 1]
    assert pk.smem_stride(6) == 37 and pk.smem_stride(7) == 49
    for n in (3, 27):
        with pytest.raises(ValueError):
            pk.plan(1, n, 4096)
