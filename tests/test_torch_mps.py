"""The port's safe linear algebra and MPS backend, on the CPU:

- ``svd_safe`` and ``qr_stable`` by ``torch.autograd.gradcheck`` in
  complex128 on a wide, a tall and a nearly degenerate matrix, through
  functions that do not depend on the singular vectors' phases;
- MPS circuits against the JAX package at n <= 8 in complex128, without
  and with truncation: the state (up to a global phase, 1e-8), the
  expectation and amplitudes (1e-8). The JAX package's MPS gradient is
  NaN on these circuits (its MPO splits are QRs whose dead channels leave
  the next sweep's R singular), so the port's gradient is held to
  ``jax.grad`` of the JAX package's statevector circuit and to the port's
  own statevector route where nothing is truncated (1e-8), and to central
  differences where it is (1e-6);
- the MPS gradient at angles of 0, where a gate (an Rzz, a crx) is a
  product and the state's bonds are rank-deficient, against ``jax.grad``
  of the JAX package's statevector circuit (1e-10); where truncation would
  have to keep a zero singular value, the backward pass raises;
- ``measure_mps`` by a chi-square on a seeded generator, and the 100-qubit
  GHZ state giving only its two strings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.mps import full_tensor as jax_full_tensor
from deepquantum_tpu_torch.mps import MatrixProductState, full_tensor, measure_mps
from deepquantum_tpu_torch.ops.linalg import qr_stable, safe_inverse, svd_safe

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu_c128():
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _matrix(kind: str) -> torch.Tensor:
    rng = np.random.default_rng({'wide': 0, 'tall': 1, 'degenerate': 2, 'deficient': 3}[kind])
    shape = {'wide': (3, 5), 'tall': (6, 3), 'degenerate': (4, 4), 'deficient': (6, 3)}[kind]
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    if kind == 'degenerate':
        # singular values 2, 1 + 1e-3, 1, 0.5: a pair 1e-3 apart
        u = np.linalg.qr(a)[0]
        v = np.linalg.qr(rng.normal(size=shape) + 1j * rng.normal(size=shape))[0]
        a = u @ np.diag([2.0, 1.0 + 1e-3, 1.0, 0.5]) @ v.conj().T
    if kind == 'deficient':
        a[:, 2] = 0.5 * a[:, 0] - 2j * a[:, 1]      # rank 2
    return torch.tensor(a, dtype=torch.complex128, requires_grad=True)


def _svd_functions(a):
    """Phase-independent functions of the SVD: the reconstruction, the
    polar factor U V^H, the singular values, and |U|^2."""
    u, s, vh = svd_safe(a)
    return (u * s.to(u.dtype)) @ vh, u @ vh, s, u.abs() ** 2


@pytest.mark.parametrize('kind', ['wide', 'tall', 'degenerate'])
def test_svd_safe_gradcheck(kind):
    a = _matrix(kind)
    for i in range(4):
        if kind == 'degenerate' and i == 3:
            continue       # |U|^2 itself moves as 1 / gap there
        assert torch.autograd.gradcheck(lambda x, i=i: _svd_functions(x)[i], (a,),
                                         eps=1e-6, atol=1e-5, rtol=1e-4)
    u, s, vh = svd_safe(a)
    np.testing.assert_allclose(_np((u * s.to(u.dtype)) @ vh), _np(a), atol=1e-12)
    assert s.dtype == torch.float64


@pytest.mark.parametrize('kind', ['wide', 'tall', 'degenerate', 'deficient'])
def test_qr_stable_gradcheck(kind):
    """Q R = A with Q an isometry, with and without autograd; the gradient
    of Q R (the identity) and of the range projector Q Q^H where Q moves
    with A (tall, full rank); where Q is held fixed (square or wide: Q Q^H
    is I; rank-deficient tall: the complete Q, whose extra rows of R are
    zero) the gradient of Q R is still the identity."""
    a = _matrix(kind)
    m, n = a.shape
    for q, r in (qr_stable(a.detach()), qr_stable(a)):
        np.testing.assert_allclose(_np(q @ r), _np(a), atol=1e-12)
        np.testing.assert_allclose(_np(q.mH @ q), np.eye(q.shape[-1]), atol=1e-12)
    q, r = qr_stable(a)
    assert q.shape[-1] == (m if kind == 'deficient' else min(m, n))
    assert torch.autograd.gradcheck(lambda x: (lambda q, r: q @ r)(*qr_stable(x)), (a,),
                                    eps=1e-6, atol=1e-5, rtol=1e-4)
    if kind == 'tall':
        assert torch.autograd.gradcheck(lambda x: (lambda q, r: q @ q.mH)(*qr_stable(x)), (a,),
                                        eps=1e-6, atol=1e-5, rtol=1e-4)
    elif kind != 'deficient':
        np.testing.assert_allclose(_np(q @ q.mH), np.eye(m), atol=1e-12)
    capped = qr_stable(a, max_cols=n)
    if kind == 'deficient':
        assert capped[0].shape[-1] == n
        with pytest.raises(RuntimeError, match='rank-deficient'):
            (capped[0] @ capped[1]).abs().sum().backward()
    else:
        np.testing.assert_allclose(_np(capped[0] @ capped[1]), _np(a), atol=1e-12)


def test_safe_inverse_is_bounded():
    x = torch.tensor([0.0, 1e-9, 1e-3, 2.0], dtype=torch.float64)
    y = safe_inverse(x)
    assert torch.isfinite(y).all() and y[0] == 0
    np.testing.assert_allclose(_np(y[2:]), 1 / _np(x[2:]), rtol=1e-6)


# ---------------------------------------------------------------- circuits
def _random_circuit(cir, n, seed=0):
    """ry at random angles after the h layer, then a CNOT chain, an rx
    layer and a few two- and three-wire gates (states at rank-deficient
    bonds: ``test_mps_gradient_at_zero_angles``)."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        cir.h(i)
    for i in range(n):
        cir.ry(i, inputs=rng.random() * 2 * np.pi)
    for i in range(n - 1):
        cir.cnot(i, i + 1)
    for i in range(n):
        cir.rx(i)
    cir.cnot(0, n - 1)
    cir.rzz([1, 3], inputs=0.4)
    cir.toffoli(0, 1, 2)
    cir.crx(n - 1, 1, inputs=0.9)
    cir.observable(0)
    cir.observable([1, 2], basis='xy')


def _phase_free(psi, ref):
    k = np.argmax(np.abs(ref))
    return psi * (ref[k] / psi[k])


@pytest.mark.parametrize('n,chi', [(6, 64), (8, 4), (5, 2)])
def test_mps_matches_jax(n, chi):
    """State, expectation and amplitudes of the same MPS circuit in both
    packages (chi=4 and 2 truncate); the port's gradient against its
    statevector route (no truncation) or central differences."""
    np.random.seed(n + chi)
    j = dq.QubitCircuit(n, mps=True, chi=chi)
    _random_circuit(j, n)
    t = dqt.from_jax(j)
    assert t.mps and t.chi == chi and isinstance(t.init_state, MatrixProductState)
    want = np.asarray(jax_full_tensor(j.forward()))
    got = _np(full_tensor(t.forward()))
    np.testing.assert_allclose(np.abs(got), np.abs(want), atol=1e-8)
    np.testing.assert_allclose(_phase_free(got, want), want, atol=1e-8)
    np.testing.assert_allclose(_np(t.expectation()), np.asarray(j.expectation()), atol=1e-8)
    for bits in ('0' * n, '1' * n, ('01' * n)[:n]):
        np.testing.assert_allclose(abs(_np(t.get_amplitude(bits))),
                                   abs(np.asarray(j.get_amplitude(bits))), atol=1e-8)
        np.testing.assert_allclose(_np(t.get_prob(bits)), np.asarray(j.get_prob(bits)),
                                   atol=1e-8)
    p = t.params.requires_grad_()
    t.expectation(params=p)[0].backward()
    assert torch.isfinite(p.grad).all()
    if chi < 2 ** (n // 2):
        with torch.no_grad():
            for i in range(p.numel()):
                e = torch.zeros_like(p)
                e[i] = 1e-6
                fd = (t.expectation(params=p + e)[0] - t.expectation(params=p - e)[0]) / 2e-6
                np.testing.assert_allclose(_np(p.grad[i]), _np(fd), atol=1e-6)
    else:
        sv = dqt.QubitCircuit(n)
        _random_circuit(sv, n)
        sv._pvals = list(t._pvals)
        assert sv.npara == t.npara
        psi = _np(sv.forward()).reshape(-1)
        np.testing.assert_allclose(_phase_free(got, psi), psi, atol=1e-10)
        q = sv.params.requires_grad_()
        sv.expectation(params=q)[0].backward()
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), atol=1e-8)
        jsv = dq.QubitCircuit(n)
        _random_circuit(jsv, n)
        jsv._pvals = list(j._pvals)
        want = jax.jit(jax.grad(lambda x: jsv.expectation(params=x)[0]))(jsv.params)
        np.testing.assert_allclose(_np(p.grad), np.asarray(want), atol=1e-8)


def _zero_angle_circuit(cir, kind, n):
    """Gates at angle 0 in a rank-deficient state: |++> through an Rzz;
    a crx whose control is |+> and whose target is an ry-rotated qubit;
    two layers of rx, rz, a CNOT chain and an Rzz chain."""
    if kind == 'rzz':
        cir.h(0)
        cir.h(1)
        cir.rzz([0, 1])
        cir.observable([0, 1], basis='yz')
    elif kind == 'crx':
        for i in range(n):
            cir.h(i)
        cir.ry(1)
        cir.crx(0, 1)
        cir.cnot(1, 2)
        cir.observable(1, basis='y')
        cir.observable([0, 2], basis='zy')
    else:
        for _ in range(2):
            for i in range(n):
                cir.rx(i)
                cir.rz(i)
            for i in range(n - 1):
                cir.cnot(i, i + 1)
            for i in range(n - 1):
                cir.rzz([i, i + 1])
        cir.observable([0, 1], basis='yz')
        cir.observable(n - 1, basis='x')


@pytest.mark.parametrize('kind,n', [('rzz', 2), ('crx', 3), ('layered', 5)])
def test_mps_gradient_at_zero_angles(kind, n):
    """An Rzz at 0 is a product, but its derivative is not: the MPO keeps
    the gate family's bond (2), and the sweeps' factors keep a channel the
    derivative flows through. Gradient of the sum of the observables
    against jax.grad of the JAX statevector circuit (1e-10); the layered
    circuit has half its angles at 0 (a seeded mask)."""
    t = dqt.QubitCircuit(n, mps=True, chi=64)
    _zero_angle_circuit(t, kind, n)
    j = dq.QubitCircuit(n)
    _zero_angle_circuit(j, kind, n)
    assert j.npara == t.npara
    rng = np.random.default_rng(5)
    vals = rng.random(t.npara) * 2 * np.pi
    if kind == 'layered':
        vals[rng.random(t.npara) < 0.5] = 0.0
    else:
        vals[-1] = 0.0          # the Rzz / the crx
    p = torch.tensor(vals, dtype=torch.float64, requires_grad=True)
    t.expectation(params=p).sum().backward()
    want = jax.jit(jax.grad(lambda x: j.expectation(params=x).sum()))(jnp.asarray(vals))
    np.testing.assert_allclose(_np(p.grad), np.asarray(want), atol=1e-10)
    if kind == 'rzz':
        np.testing.assert_allclose(_np(p.grad), [1.0], atol=1e-10)   # d<YZ>/dtheta on |++>
    assert np.abs(np.asarray(want)).max() > 1e-2


def test_mps_gradient_raises_where_truncation_keeps_a_zero():
    """All angles 0 and chi=2: the state is |0...0>, a truncation to 2
    keeps a zero singular value, and the backward pass raises instead of
    returning a gradient that is not the derivative."""
    n = 6
    t = dqt.QubitCircuit(n, mps=True, chi=2)
    _zero_angle_circuit(t, 'layered', n)
    p = torch.zeros(t.npara, dtype=torch.float64, requires_grad=True)
    e = t.expectation(params=p).sum()
    np.testing.assert_allclose(e.item(), 0.0, atol=1e-12)
    with pytest.raises(RuntimeError, match='generic parameters'):
        e.backward()


def test_mps_port_api_and_batched_data():
    """QubitCircuit(mps=True) built in the port: the normalised MPS sweeps,
    data encoders per sample, and an MPS init state."""
    n = 4
    cir = dqt.QubitCircuit(n, mps=True, chi=8)
    cir.rylayer(encode=True)
    cir.cnot_ring()
    cir.observable(1)
    data = torch.tensor([[0.1, 0.2, 0.3, 0.4], [1.0, 0.5, -0.3, 2.0]], dtype=torch.float64)
    batch = cir.expectation(data=data)
    sv = dqt.QubitCircuit(n)
    sv.rylayer(encode=True)
    sv.cnot_ring()
    sv.observable(1)
    np.testing.assert_allclose(_np(batch), _np(sv.expectation(data=data)), atol=1e-10)
    init = MatrixProductState(n, [1, 0, 1, 1], chi=8)
    cir2 = dqt.QubitCircuit(n, init_state=init, mps=True)
    cir2.x(0)
    cir2()
    np.testing.assert_allclose(_np(cir2.get_prob('0011')), 1.0, atol=1e-12)
    mps = MatrixProductState(n, 'zeros', chi=4)
    mps.center_orthogonalization(2)
    assert mps.center == 2 and all(e is None or e < 1e-12
                                   for e in mps.check_center_orthogonality())
    np.testing.assert_allclose(_np(mps.inner(mps)), 1.0, atol=1e-12)


def _chi2(counts, probs, shots):
    exp = shots * probs
    obs = np.zeros(len(probs))
    for k, v in counts.items():
        obs[int(k, 2)] = v
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    dof = int(big.sum()) - 1
    return stat, dof


def test_measure_mps_chi_square():
    n = 6
    cir = dqt.QubitCircuit(n, mps=True, chi=4)
    _random_circuit(cir, n, seed=7)
    tensors = cir()
    probs = np.abs(_np(full_tensor(tensors))) ** 2
    probs /= probs.sum()
    shots = 20000
    counts = measure_mps(tensors, shots=shots, generator=torch.Generator().manual_seed(0))
    assert sum(counts.values()) == shots
    stat, dof = _chi2(counts, probs, shots)
    assert stat <= dof + 6 * np.sqrt(2 * dof), (stat, dof)
    assert all(probs[int(k, 2)] > 0 for k in counts)
    again = cir.measure(shots=shots, generator=torch.Generator().manual_seed(0))
    assert again == counts
    marg = cir.measure(shots=1000, wires=[1, 4], with_prob=True,
                       generator=torch.Generator().manual_seed(1))
    assert all(len(k) == 2 and v[1] is None for k, v in marg.items())


def test_mps_100_qubit_ghz():
    n = 100
    cir = dqt.QubitCircuit(n, mps=True, chi=16)
    cir.h(0)
    for i in range(n - 1):
        cir.cnot(i, i + 1)
    cir()
    res = cir.measure(shots=200, with_prob=True, generator=torch.Generator().manual_seed(2))
    assert set(res) <= {'0' * n, '1' * n} and len(res) == 2
    for count, prob in res.values():
        np.testing.assert_allclose(prob, 0.5, atol=1e-10)
