"""PyTorch port vs the JAX package: noisy circuits (density matrices with
the seven Kraus channels), single and batched, and measurement.

The port runs at complex64 on its planar route where 2n >= 10 (rho a
2n-wire planar state, a channel a superoperator through planar_superop; on
the CPU every kernel wrapper runs its twin), and at complex128 on its
einsum route; the JAX package at complex128 on its einsum route
(DQ_PLANAR unset), the exact reference. Inputs come from numpy seeds.

Tolerances: rho and expectations 1e-6, gradients 1e-5 at complex64 (the
bars of tests/test_planar.py's density-matrix tests, float32 over a few
dozen gates); 1e-10 at complex128. Kraus sets 1e-6 at complex64. Sampled
counts are held to a chi-square bound, dof + 6 sqrt(2 dof) (about six
standard deviations), at a fixed generator seed; a shot estimate to five
standard deviations of the exact value.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import channel as jch
from deepquantum_tpu_torch import channel as tch
from deepquantum_tpu_torch.gate import GateOp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU.
    The JAX package runs its complex128 einsum route."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex64')
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _noisy(pkg, n=6):
    """tests/test_planar.py's density-matrix circuit with channels."""
    cir = pkg.QubitCircuit(n, den_mat=True)
    for i in range(n):
        cir.rx(i)
    cir.cnot_ring()
    cir.bit_flip(0, inputs=0.05)
    for i in range(n):
        cir.ry(i)
    cir.amp_damp(3, inputs=0.1)
    cir.cnot(0, 1)
    cir.observable(0)
    cir.observable([2, 3], basis='zx')
    cir.init_para(7)
    return cir


def _noisy_qml(pkg, n=6):
    """tests/test_planar.py's batched density-matrix circuit."""
    cir = pkg.QubitCircuit(n, den_mat=True)
    for i in range(n):
        cir.ry(i, encode=True)
    for i in range(n):
        cir.rz(i)
    cir.cnot_ring()
    cir.depolarizing(0, inputs=0.02)
    for i in range(n):
        cir.rx(i)
    cir.observable(0)
    cir.observable([1, 2], basis='xz')
    cir.init_para(11)
    return cir


def _jax_grad(cir, p, data=None):
    return np.asarray(jax.grad(lambda q: cir.expectation(data=data, params=q).sum()
                               if data is not None else cir.expectation(params=q)[0])(p))


@pytest.mark.parametrize('fused', [False, True])
def test_density_matrix_with_channels_matches_jax(fused):
    jcir = _noisy(dq)
    tcir = dqt.from_jax(jcir)
    tcir.fused_bwd = fused
    assert tcir._planar_ok()
    p = tcir.params.requires_grad_()
    rho = tcir(params=p)
    e = tcir.expectation()
    e[0].backward()
    jp = jcir.params
    np.testing.assert_allclose(rho.detach().numpy(), np.asarray(jcir(params=jp)), atol=1e-6)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(jcir.expectation()), atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), _jax_grad(jcir, jp), atol=1e-5)


def test_batched_density_matrix_matches_jax():
    n, b = 6, 3
    jcir = _noisy_qml(dq, n)
    tcir = dqt.from_jax(jcir)
    assert tcir._planar_ok()
    data = np.random.default_rng(11).random((b, n))
    p = tcir.params.requires_grad_()
    rho = tcir.forward(data=torch.tensor(data), params=p)
    assert rho.shape == (b, 1 << n, 1 << n)
    e = tcir.expectation()
    e.sum().backward()
    jp, jd = jcir.params, jax.numpy.asarray(data)
    np.testing.assert_allclose(rho.detach().numpy(), np.asarray(jcir.forward(data=jd, params=jp)),
                               atol=1e-6)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(jcir.expectation()), atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), _jax_grad(jcir, jp, jd), atol=1e-5)


CHANNELS = [('bit_flip', 'BitFlip', [0.37]), ('phase_flip', 'PhaseFlip', [0.5]),
            ('depolarizing', 'Depolarizing', [0.8]), ('pauli', 'Pauli', [0.1, 0.2, 0.3, 0.4]),
            ('amp_damp', 'AmplitudeDamping', [0.6]), ('phase_damp', 'PhaseDamping', [0.4]),
            ('gen_amp_damp', 'GeneralizedAmplitudeDamping', [0.3, 0.9])]


def _one_channel(pkg, n, method, theta):
    cir = pkg.QubitCircuit(n, den_mat=True)
    for i in range(n):
        cir.h(i)
        cir.ry(i, inputs=0.3 + 0.1 * i)
    cir.cnot(0, n - 1)
    getattr(cir, method)(1, inputs=theta)
    cir.rx(1, inputs=0.2)
    cir.observable(1, basis='x')
    return cir


@pytest.mark.parametrize('method,name,theta', CHANNELS, ids=[c[0] for c in CHANNELS])
def test_channel_matches_jax(method, name, theta):
    """The Kraus set at complex64 (1e-6) and complex128 (1e-10); rho on the
    port's complex128 einsum route (n=2, 1e-10) and on its planar route as
    a superoperator (n=5, 2n=10, 1e-6)."""
    assert tch.CHANNEL_REGISTRY[name]['npara'] == jch.CHANNEL_REGISTRY[name]['npara']
    want = np.asarray(jch.CHANNEL_REGISTRY[name]['fn'](np.asarray(theta)))
    for dtype, bar in (('complex64', 1e-6), ('complex128', 1e-10)):
        dqt.set_dtype(dtype)
        got = tch.CHANNEL_REGISTRY[name]['fn'](torch.tensor(theta, dtype=torch.float64))
        assert got.dtype == dqt.cdtype()
        np.testing.assert_allclose(got.numpy(), want, atol=bar)
    for n, dtype, bar in ((2, 'complex128', 1e-10), (5, 'complex64', 1e-6)):
        dqt.set_dtype(dtype)
        jcir = _one_channel(dq, n, method, theta)
        tcir = _one_channel(dqt, n, method, theta)
        assert tcir._planar_ok() == (n == 5)
        np.testing.assert_allclose(tcir().numpy(), np.asarray(jcir()), atol=bar)
        np.testing.assert_allclose(tcir.expectation().numpy(), np.asarray(jcir.expectation()),
                                   atol=bar)


def test_from_jax_carries_a_density_matrix_circuit():
    """den_mat, the channels' parameter slots and thetas, and an encoded
    channel (its theta from data): the same rho and expectations."""
    n = 5
    jcir = dq.QubitCircuit(n, den_mat=True, init_state='equal')
    jcir.rylayer(encode=True)
    jcir.cnot_ring()
    jcir.phase_damp(2, encode=True)
    jcir.gen_amp_damp(4, inputs=[0.3, 0.7])
    jcir.rzlayer()
    jcir.observable([0, 4], basis='xy')
    jcir.init_para(3)
    tcir = dqt.from_jax(jcir)
    assert tcir.den_mat and tcir.ndata == jcir.ndata == n + 1 and tcir.npara == jcir.npara
    chans = [op for op in tcir.operators if op.kind == 'channel']
    assert [(op.name, op.pidx) for op in chans] == \
        [(op.name, op.pidx) for op in jcir.operators if op.kind == 'channel']
    assert chans[0] in tcir.encoders
    data = np.random.default_rng(2).random(n + 1)
    for dtype, bar in (('complex64', 1e-6), ('complex128', 1e-10)):
        dqt.set_dtype(dtype)
        tcir._touch()
        assert tcir._planar_ok() == (dtype == 'complex64')
        np.testing.assert_allclose(tcir(data=torch.tensor(data)).numpy(),
                                   np.asarray(jcir(data=jax.numpy.asarray(data))), atol=bar)
        np.testing.assert_allclose(tcir.expectation().numpy(), np.asarray(jcir.expectation()),
                                   atol=bar)


def test_channel_on_two_wires_runs_its_kraus_sum():
    """A channel on two wires (16 x 16 superoperator) leaves the planar
    chain for the Kraus sum on the einsum route; rho equals the complex128
    route's."""
    n = 5
    kraus = lambda p, device=None: torch.stack(   # noqa: E731
        [torch.kron(a, b) for a in tch.depolarizing_kraus(p[..., :1])
         for b in tch.bit_flip_kraus(p[..., 1:])])
    rhos = []
    for dtype in ('complex64', 'complex128'):
        dqt.set_dtype(dtype)
        cir = dqt.QubitCircuit(n, den_mat=True)
        cir.rylayer(inputs=np.linspace(0.2, 1.0, n))
        cir.cnot_ring()
        cir._new_params([0.4, 0.3], False, False)
        cir.operators.append(GateOp(name='Pair', wires=(1, 3), matrix_fn=kraus, pidx=(n, n + 1),
                                    npara=2, kind='channel', requires_grad=False))
        cir.rxlayer(inputs=np.linspace(0.1, 0.5, n))
        cir._touch()
        assert cir._planar_ok() == (dtype == 'complex64')
        rhos.append(cir().numpy())
    np.testing.assert_allclose(rhos[0], rhos[1], atol=1e-6)
    assert abs(np.trace(rhos[1]) - 1) < 1e-12


def _chi2_ok(counts: dict, probs: np.ndarray, shots: int) -> bool:
    """Pearson's chi-square over the outcomes with expected count >= 5
    (the rest pooled) against dof + 6 sqrt(2 dof)."""
    exp = shots * probs
    big = exp >= 5
    obs = np.zeros(len(probs))
    for k, v in counts.items():
        obs[int(k, 2)] = v[0] if isinstance(v, tuple) else v
    stat = np.sum((obs[big] - exp[big]) ** 2 / exp[big])
    if (~big).any() and exp[~big].sum() > 0:
        stat += (obs[~big].sum() - exp[~big].sum()) ** 2 / exp[~big].sum()
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    return stat <= dof + 6 * np.sqrt(2 * dof)


@pytest.mark.parametrize('kind', ['state', 'batch', 'den_mat'])
def test_measure_matches_jax(kind):
    """with_prob probabilities <= 1e-6 of the JAX package's, counts that sum
    to shots with no zero-probability outcome, a chi-square at a fixed
    generator seed; on a state, a batch and a density matrix, on all wires
    and on two of them."""
    n, shots = 4, 4000
    den = kind == 'den_mat'

    def build(pkg):
        cir = pkg.QubitCircuit(n, den_mat=den)
        cir.h(0)
        cir.ry(1, encode=True)
        cir.cnot(0, 2)          # wire 2 copies wire 0: half the outcomes never occur
        cir.rx(3, inputs=0.7)
        if den:
            cir.amp_damp(1, inputs=0.5)
        return cir

    jcir, tcir = build(dq), build(dqt)
    data = np.array([[0.4], [1.3]]) if kind == 'batch' else np.array([0.9])
    jcir(data=jax.numpy.asarray(data))
    tcir(data=torch.tensor(data))
    gen = torch.Generator().manual_seed(1234)
    for wires in (None, [2, 1]):
        got = tcir.measure(shots=shots, with_prob=True, wires=wires, generator=gen)
        want = jcir.measure(shots=shots, with_prob=True, wires=wires,
                            key=jax.random.PRNGKey(0))
        if kind != 'batch':
            got, want = [got], [want]
        assert len(got) == len(want) == len(data)
        for g, w in zip(got, want):
            common = set(g) & set(w)
            assert common
            for k in common:
                assert abs(g[k][1] - float(w[k][1])) <= 1e-6
            assert sum(c for c, _ in g.values()) == shots
            assert all(pr > 0 for _, pr in g.values())
            nb = n if wires is None else len(wires)
            probs = np.zeros(1 << nb)
            for k, (_, pr) in {**w, **g}.items():
                probs[int(k, 2)] = pr
            assert _chi2_ok(g, probs / probs.sum(), shots)
    if kind != 'batch':
        counts = tcir.measure(shots=100, generator=gen)
        assert sum(counts.values()) == 100 and all(k[0] == k[2] for k in counts)


def test_den_mat_measure_after_a_certain_flip():
    """tests/test_channel.py's case: a bit flip with probability 1 leaves
    only '01' and '10'."""
    cir = dqt.QubitCircuit(2, den_mat=True)
    cir.h(0)
    cir.cnot(0, 1)
    cir.bit_flip(0, inputs=np.pi / 2)
    cir()
    res = cir.measure(shots=500, generator=torch.Generator().manual_seed(0))
    assert set(res) <= {'01', '10'} and sum(res.values()) == 500


@pytest.mark.parametrize('den', [False, True])
def test_expectation_from_shots(den):
    """expectation(shots=20000) within 5 sigma of the exact value, sigma =
    sqrt((1 - e^2) / shots), for x, y and z strings; one state, a batch of
    data, and rho on the planar route (n=5)."""
    n, shots = 5, 20000
    cir = dqt.QubitCircuit(n, den_mat=den)
    cir.rylayer(encode=True)
    cir.cnot_ring()
    cir.rxlayer()
    if den:
        cir.depolarizing(2, inputs=0.4)
    cir.observable([0, 3], basis='xz')
    cir.observable(1, basis='y')
    cir.observable([2, 4], basis='zz')
    cir.init_para(4)
    assert cir._planar_ok() == den
    gen = torch.Generator().manual_seed(99)
    for data in (np.linspace(0.1, 1.2, n), np.random.default_rng(1).random((2, n))):
        exact = cir.expectation(data=torch.tensor(data))
        est = cir.expectation(data=torch.tensor(data), shots=shots, generator=gen)
        assert est.shape == exact.shape
        sigma = torch.sqrt((1 - exact.double() ** 2).clamp_min(1e-4) / shots)
        assert ((est.double() - exact.double()).abs() <= 5 * sigma).all()
