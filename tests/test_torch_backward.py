"""PyTorch port vs the JAX package: the training path (loss and gradient).

Each backward kernel's plain twin is held against the JAX package's Pallas
kernel in interpret mode on the same numpy inputs; the two autograd
Functions (planar_chain, planar_pauli_expectation) against gradcheck and
against plain autograd through the unrolled steps; and the slice as a whole
(QubitCircuit.expectation(params=p)[0].backward()) against jax.value_and_grad
of the JAX package. On the CPU every kernel wrapper runs its twin.

Tolerances. Cotangent planes are float32 sums of 2^(n-k) products taken in
another order than the reference's: 1e-5 of max|ref|. The JAX window-chain
backward rounds dW through three bf16 passes (about 2^-16 relative), so dW
is held to 1e-4 of max|dW|. Loss 1e-5 and gradient 1e-4 at complex64 are the
bars of tests/test_planar.py.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.ops import chain_kernel as jck
from deepquantum_tpu.ops import planar_gate as jpg
from deepquantum_tpu_torch.ops import chain_kernel as tck
from deepquantum_tpu_torch.ops import planar_gate as tpg
from deepquantum_tpu_torch.ops import window_gate as twg

from test_torch_window import bench, jax_planar_seq

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)


@pytest.fixture()
def c64():
    """Both packages at complex64, the JAX one on its Pallas route."""
    dq.set_dtype('complex64')
    dqt.set_dtype('complex64')
    os.environ['DQ_PLANAR'] = '1'
    yield
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')


@pytest.fixture()
def jax128():
    """The JAX package at complex128 (its exact einsum route) as the
    reference for the port at complex64 (planar route, twins on the CPU)."""
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')
    dqt.set_dtype('complex64')
    yield
    dqt.set_dtype('complex64')


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _state(n, rng):
    return rng.standard_normal((2, 1 << n)).astype(np.float32)


def _close(got, want, rtol):
    """|got - want| <= rtol * max|want|, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rtol * np.abs(want).max())


GATE_CASES = [(10, (0,)), (12, (3, 9)), (12, (10, 11)), (12, (2, 5, 11))]


# ------------------------------------------------------------------ K5 module
@pytest.mark.parametrize('n,wires', GATE_CASES)
def test_planar_grad_twin_matches_jax_kernel(n, wires):
    rng = np.random.default_rng(n * 17 + sum(wires))
    g, x = _state(n, rng), _state(n, rng)
    got = tpg.planar_grad(torch.as_tensor(g), torch.as_tensor(x), n, wires)
    want = jpg._planar_grad(jnp.asarray(g), jnp.asarray(x), n, wires, interpret=True)
    xla = jpg.planar_grad_xla(jnp.asarray(g), jnp.asarray(x), n, wires)
    for a, b, c in zip(got, want, xla):
        assert a.shape == (1 << len(wires),) * 2 and a.dtype == torch.float32
        _close(a.numpy(), b, 1e-5)
        _close(a.numpy(), c, 1e-5)
    # the wrapper takes the twin on CPU tensors
    twin = tpg.planar_grad_xla(torch.as_tensor(g), torch.as_tensor(x), n, wires)
    for a, b in zip(got, twin):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------------ K6 module
@pytest.mark.parametrize('n,wires', GATE_CASES)
def test_planar_bwd_fused_twin_matches_jax_kernel(n, wires):
    rng = np.random.default_rng(n * 19 + sum(wires))
    u = _haar(1 << len(wires), rng).astype(np.complex64)
    mre_t, mim_t = u.real.T.copy(), -u.imag.T.copy()
    y, g = _state(n, rng), _state(n, rng)
    want = jpg._planar_bwd_fused(jnp.asarray(y), jnp.asarray(g), jnp.asarray(mre_t),
                                 jnp.asarray(mim_t), n, wires, interpret=True)
    ty, tg = torch.as_tensor(y.copy()), torch.as_tensor(g.copy())
    tre, tim = torch.as_tensor(mre_t), torch.as_tensor(mim_t)
    got = tpg.planar_bwd_fused(ty, tg, tre, tim, n, wires)
    assert got[0] is ty and got[1] is tg          # in place on both work buffers
    np.testing.assert_allclose(ty.numpy(), np.asarray(want[0]), atol=2e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(want[1]), atol=2e-6)
    _close(got[2].numpy(), want[2], 1e-5)
    _close(got[3].numpy(), want[3], 1e-5)
    # the twin is apply + grad (raw g, recovered x) + apply
    x = tpg.planar_apply(torch.as_tensor(y.copy()), tre, tim, n, wires)
    dre, dim = tpg.planar_grad(torch.as_tensor(g), x, n, wires)
    g2 = tpg.planar_apply(torch.as_tensor(g.copy()), tre, tim, n, wires)
    for a, b in zip(got, (x, g2, dre, dim)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------------------------ K4 module
def _port_seq(n, layers=1, dtype=None):
    cir = dqt.from_jax(bench(n, layers))
    with torch.no_grad():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
    if dtype == torch.float64:
        # float32 planes are unitary to 1e-7 only, and the adjoint recurrence
        # is exact for unitary steps: take the nearest unitary in float64
        mres, mims = list(mres), list(mims)
        for i, (mre, mim) in enumerate(zip(mres, mims)):
            if mre is not None:
                u, _, vh = torch.linalg.svd(torch.complex(mre.double(), mim.double()))
                mres[i], mims[i] = (u @ vh).real.contiguous(), (u @ vh).imag.contiguous()
    return mres, mims, wseq


def test_window_chain_bwd_twin_matches_jax_kernel(c64):
    n = 16
    jres, jims, jseq = jax_planar_seq(bench(n, layers=1))
    assert jck.chain_fused_ok(jseq, n, jres)
    tres, tims, tseq = _port_seq(n)
    assert list(tseq) == list(jseq)
    rng = np.random.default_rng(61)
    x0, g = _state(n, rng), _state(n, rng)
    y = tck.window_chain_fwd(torch.as_tensor(x0), tres, tims, n, tseq)
    tg = torch.as_tensor(g)
    y0 = y.clone()
    want = jck.window_chain_bwd(jnp.asarray(y.numpy()), jnp.asarray(g), jres, jims, n, jseq,
                                interpret=True)
    x, g_in, dres, dims = tck.window_chain_bwd(y, tg, tres, tims, n, tseq)
    np.testing.assert_array_equal(y.numpy(), y0.numpy())    # the saved state is not written
    np.testing.assert_array_equal(tg.numpy(), g)
    np.testing.assert_allclose(x.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(x.numpy(), x0, atol=1e-5)    # the recurrence recovers the input
    np.testing.assert_allclose(g_in.numpy(), np.asarray(want[1]), atol=1e-5)
    n_win = 0
    for st, dr, di, jr, ji in zip(tseq, dres, dims, want[2], want[3]):
        if st[0] == 'rot':
            assert dr is None and di is None
            assert not np.asarray(jr).any()
            continue
        n_win += 1
        _close(dr.numpy(), jr, 1e-4)
        _close(di.numpy(), ji, 1e-4)
    assert n_win == sum(1 for s in tseq if s[0] == 'win') > 0


def test_backward_step_table():
    seq = [('win', 7), ('rot', 9), ('win', 7), ('rot', 7), ('win', 7)]
    rows, win_steps = tck._step_table(seq, 16, backward=True)
    assert rows == [(1, 0, 2), (0, 9, 0), (1, 0, 1), (0, 7, 0), (1, 0, 0)]
    assert win_steps == [0, 2, 4]
    kinds, didx, deltas = jck._step_tables(seq, 16, backward=True)
    assert [r[0] for r in rows] == list(kinds)
    assert [r[1] for r in rows if r[0] == 0] == [deltas[i] for k, i in zip(kinds, didx) if k == 0]


def test_window_grad_matches_jax():
    from deepquantum_tpu.ops import window_gate as jwg
    n = 14
    rng = np.random.default_rng(5)
    g, x = _state(n, rng), _state(n, rng)
    got = twg.window_grad(torch.as_tensor(g), torch.as_tensor(x), n, 7)
    want = jwg.window_grad(jnp.asarray(g), jnp.asarray(x), n, 7)
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-5)


# ------------------------------------------------------------------ Functions
def _hand_seq(n, rng, dtype):
    wseq = ((3,), (2, 7), (0, 5, n - 1))
    mres, mims = [], []
    for ws in wseq:
        u = _haar(1 << len(ws), rng)
        mres.append(torch.tensor(u.real, dtype=dtype, requires_grad=True))
        mims.append(torch.tensor(u.imag, dtype=dtype, requires_grad=True))
    return mres, mims, wseq


@pytest.mark.parametrize('fused', [False, True])
def test_planar_chain_gradcheck(fused):
    """At a unitary point the adjoint recurrence gives the full Jacobian,
    for the state and for every plane."""
    n = 8
    rng = np.random.default_rng(7)
    mres, mims, wseq = _hand_seq(n, rng, torch.float64)
    x = torch.tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float64, requires_grad=True)
    k = len(wseq)

    def fn(x, *planes):
        return tpg.planar_chain(x, planes[:k], planes[k:], n, wseq, fused_bwd=fused)

    assert torch.autograd.gradcheck(fn, (x, *mres, *mims), eps=1e-6, atol=1e-7)


def test_pauli_expectation_gradcheck():
    n = 8
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float64, requires_grad=True)
    pauli = {'x': [[0, 1], [1, 0]], 'y': [[0, -1j], [1j, 0]], 'z': [[1, 0], [0, -1]]}
    mats = [np.kron(pauli['x'], pauli['y']), np.array(pauli['z'])]
    mres = [torch.tensor(np.real(m), dtype=torch.float64) for m in mats]
    mims = [torch.tensor(np.imag(m), dtype=torch.float64) for m in mats]

    def fn(x):
        return tpg.planar_pauli_expectation(x, mres, mims, n, ((1, 6), (7,)))

    assert torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-7)


def _unrolled(x, mres, mims, n, wseq):
    """The same steps with the out-of-place twins, for plain autograd."""
    for mre, mim, ws in zip(mres, mims, wseq):
        if ws[0] == 'rot':
            x = tpg._rotate_planar(x, ws[1], n)
        elif ws[0] == 'win':
            x = twg.window_apply_plain(x, mre, mim, n, ws[1])
        else:
            x = tpg.planar_evolve_xla(x, mre, mim, n, ws)
    return x


@pytest.mark.parametrize('n,dtype,tol', [(14, torch.float64, 1e-10), (16, torch.float32, 1e-5)])
def test_window_routes_match_plain_autograd(n, dtype, tol, c64):
    """n=14 in float64 takes the per-step walk (window_apply, window_grad,
    and per-gate steps for the CNOTs no window holds), n=16 in float32 the
    one-launch backward's twin."""
    mres, mims, wseq = _port_seq(n, dtype=dtype)
    assert any(s[0] == 'win' for s in wseq)
    assert tck.chain_fused_ok(wseq, n, mres) == (n == 16)
    rng = np.random.default_rng(n)
    x0 = rng.standard_normal((2, 1 << n))
    x0 /= np.linalg.norm(x0)
    c = torch.tensor(rng.standard_normal((2, 1 << n)), dtype=dtype)

    def leaves():
        x = torch.tensor(x0, dtype=dtype, requires_grad=True)
        lr = [m if m is None else m.clone().requires_grad_() for m in mres]
        li = [m if m is None else m.clone().requires_grad_() for m in mims]
        return x, lr, li

    x, lr, li = leaves()
    (tpg.planar_chain(x, lr, li, n, wseq) * c).sum().backward()
    xr, rr, ri = leaves()
    (_unrolled(xr, rr, ri, n, wseq) * c).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, atol=tol, rtol=0)
    for a, b in zip(lr + li, rr + ri):
        if a is not None:
            scale = max(1.0, b.grad.abs().max().item())
            torch.testing.assert_close(a.grad, b.grad, atol=tol * scale, rtol=0)


# ------------------------------------------------------------ the whole slice
def _jax_loss_and_grad(jcir):
    fn = jax.jit(jax.value_and_grad(lambda p: jcir.expectation(params=p)[0]))
    loss, grad = fn(jcir.params)
    return float(loss), np.asarray(grad, dtype=np.float64)


def _port_loss_and_grad(tcir, params):
    p = dqt.params_from_numpy(params, requires_grad=True)
    assert p.is_leaf and p.requires_grad
    loss = tcir.expectation(params=p)[0]
    loss.backward()
    return loss.item(), p.grad.numpy().astype(np.float64)


@pytest.mark.parametrize('n,layers', [(10, 2), (12, 2), (14, 1), (15, 1)])
def test_bench_ansatz_loss_and_gradient_match_jax(n, layers, jax128):
    jcir = bench(n, layers)
    want_loss, want_grad = _jax_loss_and_grad(jcir)
    tcir = dqt.from_jax(jcir)
    assert tcir._planar_ok()
    loss, grad = _port_loss_and_grad(tcir, np.asarray(jcir.params))
    assert grad.shape == want_grad.shape and np.abs(want_grad).max() > 1e-3
    assert abs(loss - want_loss) <= 1e-5
    np.testing.assert_allclose(grad, want_grad, atol=1e-4)


def test_bench_ansatz_gradient_matches_jax_pallas_route(c64):
    n = 16
    jcir = bench(n, 1)
    assert jcir._planar_ok()
    want_loss, want_grad = _jax_loss_and_grad(jcir)
    loss, grad = _port_loss_and_grad(dqt.from_jax(jcir), np.asarray(jcir.params))
    assert abs(loss - want_loss) <= 1e-5
    np.testing.assert_allclose(grad, want_grad, atol=1e-4)


def test_fused_backward_gives_the_same_gradient(jax128):
    jcir = bench(12, 2)
    params = np.asarray(jcir.params)
    tcir = dqt.from_jax(jcir)
    assert tcir.fused_bwd is False
    _, grad = _port_loss_and_grad(tcir, params)
    fused = dqt.from_jax(jcir)
    fused.fused_bwd = True
    before = tpg.planar_bwd_fused.launches
    _, grad_fused = _port_loss_and_grad(fused, params)
    assert tpg.planar_bwd_fused.launches == before    # a CPU tensor never counts a launch
    np.testing.assert_allclose(grad_fused, grad, atol=1e-6)


def test_fallback_gate_step_inside_a_window_plan(jax128):
    """cnot(0, 7) at n=14 spans more than the window: its step is a per-gate
    step between windows, so the backward walks step by step."""
    n = 14
    jcir = bench(n, 1)
    jcir.cnot(0, 7)
    jcir.rx(3)
    want_loss, want_grad = _jax_loss_and_grad(jcir)
    tcir = dqt.from_jax(jcir)
    with torch.no_grad():
        mres, _, wseq = tcir._planar_seq(tcir._full_params())
    kinds = {('gate' if isinstance(s[0], int) else s[0]) for s in wseq}
    assert kinds == {'gate', 'win', 'rot'} and not tck.chain_fused_ok(wseq, n, mres)
    loss, grad = _port_loss_and_grad(tcir, np.asarray(jcir.params))
    assert abs(loss - want_loss) <= 1e-5
    np.testing.assert_allclose(grad, want_grad, atol=1e-4)


def test_second_order_raises(jax128, monkeypatch):
    """create_graph=True through planar_chain and planar_pauli_expectation
    gives a gradient that is itself differentiable (a Hessian row of the
    complex128 route's); the photonic kernel Functions (here K7, its launch
    stood in for by the twin on the CPU) still raise."""
    from deepquantum_tpu_torch.ops import permanent_kernel as tpk
    tcir = dqt.from_jax(bench(10, 1))
    rows = []
    for dtype in ('complex64', 'complex128'):
        dqt.set_dtype(dtype)
        tcir._touch()
        p = tcir.params.requires_grad_()
        g, = torch.autograd.grad(tcir.expectation(params=p)[0], p, create_graph=True)
        assert g.requires_grad
        rows.append(torch.autograd.grad(g[3], p)[0].double().numpy())
    np.testing.assert_allclose(rows[0], rows[1], atol=1e-4)

    monkeypatch.setattr(tpk, '_launch', tpk.permanent_plain_batch)
    m = torch.randn(2, 4, 4, dtype=torch.complex128, requires_grad=True)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(tpk._Permanents.apply(m).sum().real, m, create_graph=True)


def test_three_sgd_steps_match_jax(jax128):
    n = 12
    jcir = bench(n, 1)
    tcir = dqt.from_jax(jcir)
    fn = jax.value_and_grad(lambda p: jcir.expectation(params=p)[0])
    jp = jcir.params
    tp = dqt.params_from_numpy(np.asarray(jp), requires_grad=True)
    for _ in range(3):
        _, jg = fn(jp)
        jp = jp - 1e-3 * jg
        tcir.expectation(params=tp)[0].backward()
        with torch.no_grad():
            tp -= 1e-3 * tp.grad
        tp.grad = None
    want = float(jcir.expectation(params=jp)[0])
    with torch.no_grad():
        got = tcir.expectation(params=tp)[0].item()
    assert abs(got - want) <= 1e-5
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-5)


# ------------------------------------------------------------------- hygiene
def test_direct_wrapper_calls_refuse_gradients():
    """Gradients come from the Functions: a kernel wrapper's validation
    refuses a tensor that requires grad (checked before any build), and
    passes with grad mode off, as inside a Function."""
    from deepquantum_tpu_torch.ops import _cuda
    m = torch.eye(2, requires_grad=True)
    x = torch.zeros(2, 1 << 10)
    with pytest.raises(NotImplementedError, match='planar_chain'):
        _cuda.check_planes('planar_bwd_fused', x, (2, 2), m, m)
    with torch.no_grad():
        _cuda.check_planes('planar_bwd_fused', x, (2, 2), m, m)


def test_port_sources_name_no_jax_import():
    pat = re.compile(r'^\s*(import|from)\s+(jax|deepquantum_tpu)(\.|\s|$)', re.M)
    files = sorted((ROOT / 'deepquantum_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
