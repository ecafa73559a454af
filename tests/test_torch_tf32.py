"""The accuracy argument of the tensor-core window kernels, checked on the CPU.

K2 (csrc/window_apply.cu), K3 (csrc/window_chain.cu) and K4
(csrc/window_chain_bwd.cu) run their window products on one body,
csrc/window_mma.cuh: the FP64 tensor cores, float32 operands widened to
f64, exact products, f64 sums chained through C in 8-deep steps, one
float32 rounding to nearest per result. The earlier body was 3xTF32: every
operand a is split into hi = round-to-TF32(a) and lo = a - hi, of which the
tensor core reads the top 10 mantissa bits, and a product is lo*hi + hi*lo
+ hi*hi in 8-deep steps with float32 sums. A numpy emulation of that
arithmetic, with exact products and each product added in float32, is held
here against float64 at n=14: the window product within 1e-6 of max|ref|
(the bar K2 is held to against its twin on the card) and K4's dW within
1e-5.

The tensor core does not round its float32 sums to nearest: it aligns the
products to the largest exponent among them and C and drops the low bits
toward zero. Emulated so, the earlier body, six TF32 products chained
through C per step, drifts over a walk of Haar windows (its error grows
faster than sqrt(2) from 65 to 130 windows: a bias), while the FP64 body,
emulated step by step in the kernels' order, holds 5e-6.

The chains merge each run of consecutive relabels of their walks into one
transpose; the merge is checked against the steps one by one.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import chain_kernel as tck
from deepquantum_tpu_torch.ops.planar_gate import _rotate_planar

# one intra-op thread: the suite's workers share the machine's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope='module')
def _one_blas_thread():
    """numpy's matmuls and QR here on one OpenBLAS thread: with one thread
    per core in each of the suite's workers they spin against each other
    (the FP64 walk took 41.6 s on 6 workers, 0.9 s alone)."""
    with threadpool_limits(limits=1, user_api='blas'):
        yield


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)


def tf32_round(a):
    """Round float32 to 10 mantissa bits, to nearest, ties away from zero:
    the kernels' (bits + 0x1000) & 0xffffe000."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def tensor_core_reads(a):
    """What the tensor core takes of a float32 operand: its top 10 mantissa
    bits."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def split(a):
    a = np.asarray(a, np.float32)
    hi = tf32_round(a)
    return hi, (a - hi).astype(np.float32)


def mma3(a, b):
    """a @ b as the kernels take it: per 8-deep step lo*hi, hi*lo, hi*hi,
    each added to a float32 sum (the products of TF32 values are exact in
    float32)."""
    ah, al = (tensor_core_reads(v) for v in split(a))
    bh, bl = (tensor_core_reads(v) for v in split(b))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            prod = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8].astype(np.float64)
            acc = (acc + prod.astype(np.float32)).astype(np.float32)
    return acc


def window_tf32x3(wr, wi, xr, xi):
    """y = W x in the kernels' split-plane order: yr = Wr xr + (-Wi) xi,
    yi = Wi xr + Wr xi, one float32 accumulator per plane."""
    yr = np.zeros((wr.shape[0], xr.shape[1]), np.float32)
    yi = np.zeros_like(yr)
    for k in range(0, wr.shape[1], 8):
        s = slice(k, k + 8)
        yr = yr + mma3(wr[:, s], xr[s]) + mma3(-wi[:, s], xi[s])
        yi = yi + mma3(wi[:, s], xr[s]) + mma3(wr[:, s], xi[s])
    return yr, yi


def tensor_core_mma(c, a, b):
    """c + a @ b per 8-deep step as the tensor core sums it (Fasi, Higham,
    Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ
    Computer Science 2021): the products are exact, aligned to the largest
    exponent among them and c, their bits below 24 from that exponent's
    leading bit dropped toward zero, and the sum truncated to float32.
    c: (S, M, N), a: (S, M, 8), b: (S, 8, N) float32 tensors of TF32 values
    (their products are exact in float32)."""
    prods = a[:, :, :, None] * b[:, None, :, :]               # (S, M, 8, N)
    top = torch.maximum(c.abs(), prods.abs().amax(dim=2))
    # 2^(24 - e), top = m 2^e with 0.5 <= m < 1: every term times it is below
    # 2^25, and a cast to int32 drops its fraction toward zero; the nine
    # integers sum exactly in int32
    scale = ((151 - torch.frexp(top).exponent) << 23).view(torch.float32)
    total = (c * scale).to(torch.int32) + (prods * scale[:, :, None]).to(torch.int32).sum(
        dim=2, dtype=torch.int32)
    exact = total.double() / scale
    out = exact.float()
    return torch.where(out.double().abs() > exact.abs(), torch.nextafter(out, torch.zeros_like(out)),
                       out)


def window_tf32x3_chained(wr, wi, x):
    """y = W x in the earlier 3xTF32 body: per 8-deep step six TF32 products chained
    through C on a truncating tensor core (lo*hi, hi*lo, hi*hi of Wr xr and
    of (-Wi) xi for the real plane, of Wi xr and Wr xi for the imaginary
    one), each step's sum then added in float32. x: (2, 128, cols)."""
    steps = wr.shape[1] // 8

    def a_ops(w):
        return [torch.as_tensor(tensor_core_reads(v)).reshape(128, steps, 8).transpose(0, 1)
                for v in split(w)]

    def b_ops(v):
        return [torch.as_tensor(tensor_core_reads(p)).reshape(steps, 8, -1) for p in split(v)]

    wr_, wi_, ni_ = a_ops(wr), a_ops(wi), a_ops(-wi)
    xr_, xi_ = b_ops(x[0]), b_ops(x[1])
    step = torch.zeros((2 * steps, 128, x.shape[2]))    # both planes' steps, stacked
    for (ar, br), (ai, bi) in (((wr_, xr_), (wi_, xr_)), ((ni_, xi_), (wr_, xi_))):
        for pa, pb in ((1, 0), (0, 1), (0, 0)):         # lo*hi, hi*lo, hi*hi
            step = tensor_core_mma(step, torch.cat([ar[pa], ai[pa]]), torch.cat([br[pb], bi[pb]]))
    y = torch.zeros((2, 128, x.shape[2]))
    for s in range(steps):
        y = y + step[[s, steps + s]]
    return y.numpy()


def window_fp64(wr, wi, x):
    """y = W x as window_mma.cuh's window_product takes it: per 8-deep step
    four f64 mma chained through C, Wr xr then (-Wi) xi onto the real plane,
    Wi xr then Wr xi onto the imaginary one (float32 operands widened to
    f64, so every product is exact), then one float32 rounding to nearest.
    x: (2, 128, cols)."""
    ar, ai = wr.astype(np.float64), wi.astype(np.float64)
    xr, xi = x[0].astype(np.float64), x[1].astype(np.float64)
    acc = np.zeros((2, ar.shape[0], x.shape[2]))
    for k in range(0, ar.shape[1], 8):
        s = slice(k, k + 8)
        acc[0] = acc[0] + ar[:, s] @ xr[s]
        acc[0] = acc[0] + -ai[:, s] @ xi[s]
        acc[1] = acc[1] + ai[:, s] @ xr[s]
        acc[1] = acc[1] + ar[:, s] @ xi[s]
    return acc.astype(np.float32)


def _haar(k, rng):
    z = rng.standard_normal((k, k)) + 1j * rng.standard_normal((k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_tf32_split_rebuilds_its_operand():
    a = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * np.float32(1e3)
    hi, lo = split(a)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1fff) == 0)   # 13 low mantissa bits zero
    assert np.array_equal(hi + lo, a)                              # a - hi is exact
    assert np.all(np.abs(lo) <= np.abs(a) * 2.0 ** -11)
    # what the tensor core reads of the pair: a to 2^-21
    rel = np.abs((hi.astype(np.float64) + tensor_core_reads(lo)) - a) / np.abs(a)
    assert rel.max() <= 2.0 ** -21


@pytest.mark.parametrize('unitary', [True, False])
def test_window_product_tf32x3_within_1e6(unitary):
    n = 14
    rng = np.random.default_rng(14)
    w = rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))
    if unitary:
        w, _ = np.linalg.qr(w)
    else:
        w = w / 16
    x = rng.standard_normal((2, 128, 1 << (n - 7))).astype(np.float32)
    wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
    yr, yi = window_tf32x3(wr, wi, x[0], x[1])
    ref = (wr.astype(np.float64) + 1j * wi) @ (x[0].astype(np.float64) + 1j * x[1])
    assert _rel(yr + 1j * yi.astype(np.float64), ref) <= 1e-6
    # a single TF32 product would not do: that is why the kernels take three
    hr = tf32_round(wr).astype(np.float64) @ tf32_round(x[0])
    assert _rel(hr, wr.astype(np.float64) @ x[0]) > 1e-4


def test_chain_bwd_dw_tf32x3_within_1e5():
    """dW = g x^H over 2^(n-7) columns as K4 forms it: each block's 16 columns
    in 3xTF32, then the block partials summed in float32 in slot order."""
    n = 14
    rng = np.random.default_rng(15)
    g = rng.standard_normal((2, 128, 1 << (n - 7))).astype(np.float32)
    x = rng.standard_normal((2, 128, 1 << (n - 7))).astype(np.float32)
    dre = np.zeros((128, 128), np.float32)
    dim = np.zeros_like(dre)
    for c in range(0, x.shape[2], 16):
        s = slice(c, c + 16)
        pr = mma3(g[0][:, s], x[0][:, s].T) + mma3(g[1][:, s], x[1][:, s].T)
        pi = mma3(g[1][:, s], x[0][:, s].T) + mma3(-g[0][:, s], x[1][:, s].T)
        dre = (dre + pr).astype(np.float32)
        dim = (dim + pi).astype(np.float32)
    gc = g[0].astype(np.float64) + 1j * g[1]
    xc = x[0].astype(np.float64) + 1j * x[1]
    ref = gc @ xc.conj().T
    assert _rel(dre, ref.real) <= 1e-5
    assert _rel(dim, ref.imag) <= 1e-5


@pytest.mark.parametrize('body', ['tf32x3_chained', 'fp64'])
def test_window_body_under_depth(body):
    """A seeded (2, 128, 32) block through 130 Haar windows, each product
    taken as the body takes it, against the same walk in float64 at 65 and
    130 windows. The chained 3xTF32 drifts: its error grows faster than
    sqrt(2), the growth of a sum of roundings to nearest, from 65 to 130
    windows. The FP64 body the kernels now run holds 5e-6 at 130."""
    product = window_tf32x3_chained if body == 'tf32x3_chained' else window_fp64
    rng = np.random.default_rng(130)
    x = rng.standard_normal((2, 128, 32)).astype(np.float32)
    ref = x[0].astype(np.float64) + 1j * x[1]
    errs = {}
    for k in range(1, 131):
        w = _haar(128, rng)
        wr, wi = w.real.astype(np.float32), w.imag.astype(np.float32)
        ref = (wr.astype(np.float64) + 1j * wi) @ ref
        x = product(wr, wi, x)
        if k in (65, 130):
            errs[k] = _rel(x[0] + 1j * x[1].astype(np.float64), ref)
    if body == 'tf32x3_chained':
        assert errs[130] / errs[65] > np.sqrt(2), errs
    else:
        assert errs[130] <= 5e-6, errs


def _walk(x, rows, n):
    """The layout that each window of the walk sees, and the last one."""
    seen = []
    for kind, d, _ in rows:
        if kind == 0:
            x = _rotate_planar(x, d, n)
        else:
            seen.append(x)
    return seen + [x]


@pytest.mark.parametrize('backward', [False, True])
@pytest.mark.parametrize('n', [16, 18, 19])
def test_merged_relabels_compose(n, backward):
    """The walk's table (K3's forward, K4's backward) with each run of
    relabels merged moves the amplitudes as the runs do step by step, and
    leaves no run of two relabels."""
    cir = dqt.QubitCircuit(n)
    for _ in range(2):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
        cir.cnot_ring()
    cir.init_para(n)
    with torch.no_grad():
        _, _, wseq = cir._planar_seq(cir._full_params())
    wseq = tuple(s for s in wseq if s[0] in ('win', 'rot'))
    rows, _ = tck._step_table(wseq, n, backward=backward)
    merged = tck._merged_rows(rows, n)
    assert len(merged) < len(rows)
    assert all(1 <= d < n for kind, d, _ in merged if kind == 0)
    assert not any(a[0] == b[0] == 0 for a, b in zip(merged, merged[1:]))
    assert [r for r in merged if r[0] == 1] == [r for r in rows if r[0] == 1]
    idx = torch.arange(2 << n, dtype=torch.float64).reshape(2, -1)
    assert all(torch.equal(a, b) for a, b in zip(_walk(idx, merged, n), _walk(idx, rows, n)))


def test_merged_tables_of_the_n18_bench_sequence():
    """The bench ansatz at n=18, 5 layers (rx, rz, rx on every wire and a
    CNOT ring): 86 steps, 33 windows; merged, 66 rows either way, one grid
    barrier per row for K4 and, with none after its last row, 65 for K3."""
    n = 18
    cir = dqt.QubitCircuit(n)
    for _ in range(5):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.init_para(1234)
    with torch.no_grad():
        _, _, wseq = cir._planar_seq(cir._full_params())
    assert len(wseq) == 86 and sum(s[0] == 'win' for s in wseq) == 33
    for backward in (False, True):
        rows = tck._merged_rows(tck._step_table(wseq, n, backward=backward)[0], n)
        assert len(rows) == 66
        assert sum(r[0] for r in rows) == 33
    assert not any(a[0] == b[0] == 1 for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize('n,sms,slots', [(14, 132, 8), (18, 132, 128), (19, 132, 128),
                                         (19, 114, 128), (18, 16, 64)])
def test_bwd_scratch_holds_one_slot_per_tile(n, sms, slots):
    """K4's partial buffers hold one slot per column tile (16 columns while
    those tiles do not outnumber the SMs, else 32), the most slots the
    kernel can fill, whatever the grid."""
    assert tck._bwd_slots(n, sms) == slots
