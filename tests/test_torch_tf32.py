"""The accuracy argument of the tensor-core window kernels, checked on the CPU.

K2 (csrc/window_apply.cu) and K4 (csrc/window_chain_bwd.cu) run their float32
products on the tensor cores in 3xTF32 (csrc/window_mma.cuh): every operand
a is split into hi = round-to-TF32(a) and lo = a - hi, of which the tensor
core reads the top 10 mantissa bits, and a product is lo*hi + hi*lo + hi*hi
in 8-deep steps with float32 sums. A numpy
emulation of that arithmetic, in the kernels' order, is held here against
float64 at n=14: the window product within 1e-6 of max|ref| (the bar K2 is
held to against its twin on the card) and K4's dW within 1e-5. K4 also
merges each run of consecutive relabels of its walk into one transpose;
the merge is checked against the steps one by one.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import chain_kernel as tck
from deepquantum_tpu_torch.ops.planar_gate import _rotate_planar


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


def _walk(x, rows, n):
    """The layout that each window of the walk sees, and the last one."""
    seen = []
    for kind, d, _ in rows:
        if kind == 0:
            x = _rotate_planar(x, d, n)
        else:
            seen.append(x)
    return seen + [x]


@pytest.mark.parametrize('n', [16, 18, 19])
def test_merged_relabels_compose(n):
    """The backward table with each run of relabels merged moves the amplitudes
    as the runs do step by step, and leaves no run of two relabels."""
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
    rows, _ = tck._step_table(wseq, n, backward=True)
    merged = tck._bwd_rows(rows, n)
    assert len(merged) < len(rows)
    assert all(1 <= d < n for kind, d, _ in merged if kind == 0)
    assert not any(a[0] == b[0] == 0 for a, b in zip(merged, merged[1:]))
    assert [r for r in merged if r[0] == 1] == [r for r in rows if r[0] == 1]
    idx = torch.arange(2 << n, dtype=torch.float64).reshape(2, -1)
    assert all(torch.equal(a, b) for a, b in zip(_walk(idx, merged, n), _walk(idx, rows, n)))


@pytest.mark.parametrize('n,sms,slots', [(14, 132, 8), (18, 132, 128), (19, 132, 128),
                                         (19, 114, 128), (18, 16, 64)])
def test_bwd_scratch_holds_one_slot_per_tile(n, sms, slots):
    """K4's partial buffers hold one slot per column tile (16 columns while
    those tiles do not outnumber the SMs, else 32), the most slots the
    kernel can fill, whatever the grid."""
    assert tck._bwd_slots(n, sms) == slots
