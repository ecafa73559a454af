"""PyTorch port vs the JAX package: the window_apply twin and the schedulers.

The port's schedulers are line-for-line ports, so for the bench ansatz
(rx/rz/rx on every wire plus a CNOT ring, 5 layers) they must produce the
same step list as the JAX package, and the same window planes up to float32
product order (1e-6). The JAX window kernel runs in interpret mode.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.ops import planar_gate as jpg
from deepquantum_tpu.ops import window_gate as jwg
from deepquantum_tpu_torch.ops import window_gate as twg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)


@pytest.fixture()
def c64():
    dq.set_dtype('complex64')
    dqt.set_dtype('complex64')
    os.environ['DQ_PLANAR'] = '1'
    yield
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')


def bench(n, layers=5, seed=11):
    cir = dq.QubitCircuit(n)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(seed)
    return cir


def jax_planar_seq(cir):
    """The JAX package's scheduled sequence for a circuit (what
    _sim_planar hands to planar_chain)."""
    full = cir._full_params()
    mres, mims, wseq = [], [], []
    for entry in cir._fused_plan():
        if entry[0] == 'op':
            op = entry[1]
            from deepquantum_tpu.ops.apply import controlled_matrix
            mat = controlled_matrix(jnp.asarray(op.matrix(full), dq.config.cdtype()),
                                    len(op.controls))
            wires = list(op.controls) + list(op.wires)
        else:
            mat, wires = cir._fused_matrix(entry, full)
        mre, mim = jpg._sorted_mat_planes(mat, wires)
        mres.append(mre)
        mims.append(mim)
        wseq.append(tuple(sorted(wires)))
    return jpg.schedule_planar_seq(tuple(mres), tuple(mims), tuple(wseq), cir.nqubit)


def test_window_twin_matches_jax_kernel():
    n = 14
    rng = np.random.default_rng(14)
    z = rng.normal(size=(128, 128)) + 1j * rng.normal(size=(128, 128))
    u = np.linalg.qr(z)[0]
    mre, mim = u.real.astype(np.float32), u.imag.astype(np.float32)
    x = rng.standard_normal((2, 1 << n)).astype(np.float32)
    want = np.asarray(jwg.window_apply(jnp.asarray(x), jnp.asarray(mre), jnp.asarray(mim), n, 7,
                                       interpret=True))
    got = twg.window_apply_plain(torch.as_tensor(x), torch.as_tensor(mre), torch.as_tensor(mim),
                                 n, 7)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    xt = torch.as_tensor(x.copy())
    assert twg.window_apply(xt, torch.as_tensor(mre), torch.as_tensor(mim), n, 7) is xt
    np.testing.assert_array_equal(xt.numpy(), got.numpy())


@pytest.mark.parametrize('pos,w', [((2,), 7), ((0, 6), 7), ((5, 1, 3), 7), ((1, 2), 4)])
def test_embed_src_matches_jax(pos, w):
    np.testing.assert_array_equal(twg._embed_src_np(pos, w), jwg._embed_src(pos, w))


@pytest.mark.parametrize('n', [10, 14, 16, 18, 22])
def test_schedules_match_jax(n, c64):
    """Same step list (windows, relabels, fallback gates) and the same
    window / gate planes as the JAX package, for the bench ansatz."""
    jcir = bench(n)
    jres, jims, jseq = jax_planar_seq(jcir)
    tcir = dqt.from_jax(jcir)
    with torch.inference_mode():
        tres, tims, tseq = tcir._planar_seq(tcir._full_params())
    assert list(tseq) == list(jseq)
    for tr, ti, jr, ji, st in zip(tres, tims, jres, jims, tseq):
        if st[0] == 'rot':
            assert tr is None and ti is None
            continue
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)


@pytest.mark.parametrize('n', [14, 18, 22])
def test_plan_windows_matches_jax_with_long_range_gate(n):
    """A cnot(0, n/2) per layer spans more than the window: both planners
    leave it as a per-gate step at the same place."""
    wseq = []
    for _ in range(3):
        wseq += [(i,) for i in range(n)]
        wseq += [(i, i + 1) for i in range(n - 1)] + [(0, n - 1)]
        wseq.append((0, n // 2))
    wseq = tuple(wseq)
    assert twg.plan_windows(wseq, n, 7) == jwg.plan_windows(wseq, n, 7)
