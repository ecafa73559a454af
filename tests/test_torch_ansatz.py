"""The port's algorithm circuits, layered ansatz and adjoint expectation
against the JAX package, on the CPU at complex128 (1e-10 unless a test
says otherwise):

- each ansatz class builds the JAX package's op list (names, wires,
  controls, inv flags, parameter slots and values, from the same numpy /
  ``random`` seed) and the same state, at the sizes of
  ``tests/test_ansatz.py`` (the full Shor circuit by its op list only: JAX
  compiles its 379 ops in ~6 s);
- QFT against the analytic transform, and QFT then its inverse;
- QCNN's shared parameters: the count and the gradient;
- ``make_layered_vqe``: value and gradient;
- ``make_adjoint_expectation`` on the einsum route (complex128) and the
  planar route (complex64, its CPU twins, 1e-4) against autograd.
"""

import random

import jax
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.models import ansatz as JA
from deepquantum_tpu.models.layered import make_layered_vqe as jax_layered
from deepquantum_tpu_torch.adjoint import make_adjoint_expectation
from deepquantum_tpu_torch.models import ansatz as TA
from deepquantum_tpu_torch.models import make_layered_vqe

torch.set_num_threads(1)
ATOL = 1e-10


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


_U1 = np.diag([1, np.exp(2j * np.pi * 3 / 16)])
_A = np.array([[1.0, -1 / 3], [-1 / 3, 1.0]])
CASES = {
    'qft': lambda M: M.QuantumFourierTransform(4),
    'qft_reverse_span': lambda M: M.QuantumFourierTransform(5, minmax=[1, 3], reverse=True),
    'qpe': lambda M: M.QuantumPhaseEstimation(nqubit=5, ncount=4, unitary=_U1),
    'qpe_single': lambda M: M.QuantumPhaseEstimationSingleQubit(t=4, phase=1 / 8),
    'hhl': lambda M: M.HHL(ncount=3, mat=_A, t0=3 / 4),
    'number_encoder': lambda M: M.NumberEncoder(4, 11),
    'phi_adder': lambda M: M.PhiAdder(5, 5, minmax=[0, 3], controls=[4]),
    'phi_modular_adder': lambda M: M.PhiModularAdder(5, 3, 5),
    'controlled_multiplier': lambda M: M.ControlledMultiplier(7, 2, 3, controls=[6]),
    'controlled_ua': lambda M: M.ControlledUa(7, 2, 3, controls=[6]),
    'qcnn': lambda M: M.QuantumConvolutionalNeuralNetwork(8, 2),
    'random_g3': lambda M: M.RandomCircuitG3(4, 30),
    'shor15': lambda M: M.ShorCircuitFor15(4, 7),
    'shor': lambda M: M.ShorCircuit(3, 2, 2),
}


def _build(name, module):
    np.random.seed(7)
    random.seed(7)
    return CASES[name](module)


def _ops(cir):
    return [(op.name, tuple(op.wires), tuple(op.controls), op.kind, bool(op.inv),
             tuple(op.pidx), op.npara, bool(op.condition)) for op in cir.operators]


@pytest.mark.parametrize('name', list(CASES))
def test_ansatz_matches_jax(name):
    j, t = _build(name, JA), _build(name, TA)
    assert isinstance(t, TA.Ansatz) and t.nqubit == j.nqubit
    assert _ops(t) == _ops(j)
    np.testing.assert_allclose(t._pvals, j._pvals, atol=0)
    assert t._train_mask == j._train_mask and (t.npara, t.ndata) == (j.npara, j.ndata)
    got = _np(t.forward()).reshape(-1)
    np.testing.assert_allclose(_np(dqt.from_jax(j).forward()).reshape(-1), got, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=ATOL)
    if name != 'shor':
        np.testing.assert_allclose(got, np.asarray(j.forward()).reshape(-1), atol=ATOL)


def test_qft_against_the_analytic_transform():
    n = 6
    dim = 2 ** n
    qft = TA.QuantumFourierTransform(n)
    omega = np.exp(2j * np.pi / dim)
    want = np.array([[omega ** (r * c) for c in range(dim)] for r in range(dim)]) / np.sqrt(dim)
    np.testing.assert_allclose(_np(qft.get_unitary()), want, atol=ATOL)
    x = 37
    ket = np.zeros(dim, complex)
    ket[x] = 1
    out = qft.forward(state=torch.as_tensor(ket))
    np.testing.assert_allclose(_np(out).reshape(-1), want[:, x], atol=ATOL)
    back = qft.inverse().forward(state=out)
    np.testing.assert_allclose(_np(back).reshape(-1), ket, atol=ATOL)
    assert len(qft.operators) == n + n * (n - 1) // 2 + n // 2


def test_qcnn_shared_parameters_gradient():
    np.random.seed(3)
    j = JA.QuantumConvolutionalNeuralNetwork(4, 1)
    np.random.seed(3)
    t = TA.QuantumConvolutionalNeuralNetwork(4, 1)
    for c in (j, t):
        c.observable(0)
    # 2 U3 for the first layer, 3 two-qubit + 2 U3 for the conv, 1 U3 for
    # the pool, then a latent 2-wire gate (16): 3 * 2 + 3 + 3 * 2 + 3 + 16
    assert t.npara == j.npara == 34
    p = t.params.requires_grad_()
    t.expectation(params=p)[0].backward()
    want = jax.grad(lambda q: j.expectation(params=q)[0])(j.params)
    np.testing.assert_allclose(_np(p.grad), np.asarray(want), atol=1e-9)


def test_make_layered_vqe_matches_jax():
    n, layers = 5, 3
    np.random.seed(3)
    jfn, jp = jax_layered(n, layers)
    np.random.seed(3)
    fn, p = make_layered_vqe(n, layers)
    assert tuple(p.shape) == (layers, n, 3)
    np.testing.assert_allclose(_np(p), np.asarray(jp), atol=0)
    p = p.requires_grad_()
    e = fn(p)
    e.backward()
    np.testing.assert_allclose(e.item(), float(jfn(jp)), atol=ATOL)
    np.testing.assert_allclose(_np(p.grad), np.asarray(jax.grad(jfn)(jp)), atol=ATOL)


def _adjoint_circuit(n):
    cir = dqt.QubitCircuit(n)
    rng = np.random.default_rng(1)
    for w in range(n):
        cir.u3(w)
    cir.crx(0, n - 1)
    cir.rzz([1, 2])
    cir.latent(wires=[2, 3, 4], inputs=rng.normal(size=(8, 8)))
    cir.hamiltonian(np.diag([1.0, -1.0, 0.5, 0.2]), wires=[0, 3])
    cir.cswap(1, 0, 4)
    cir.any(np.linalg.qr(rng.normal(size=(16, 16)))[0], wires=[0, 1, 2, 3])
    sub = dqt.QubitCircuit(n)
    sub.ry(2)
    sub.cp(2, 0)
    cir.add(sub.inverse())
    for w in range(n):
        cir.rx(w)
    cir.cnot_ring()
    cir.observable([0, 2], basis='xz')
    cir.observable(1, basis='y')
    cir.init_para(5)
    return cir


@pytest.mark.parametrize('obs', [0, 1])
def test_adjoint_einsum_route_matches_autograd(obs):
    """complex128 (and a 4-wire gate): the adjoint Function over the op
    list, against plain autograd through the circuit."""
    cir = _adjoint_circuit(6)
    assert not cir._planar_ok()
    fn = make_adjoint_expectation(cir, obs)
    p = cir.params.requires_grad_()
    e = fn(p)
    e.backward()
    q = cir.params.requires_grad_()
    ref = cir.expectation(params=q)[obs]
    ref.backward()
    np.testing.assert_allclose(e.item(), ref.item(), atol=ATOL)
    np.testing.assert_allclose(_np(p.grad), _np(q.grad), atol=ATOL)
    assert p.numel() == len(cir._train_idx) == 29


def test_adjoint_planar_route_matches_complex128():
    """complex64 at n=10 every group on <= 3 wires: the callable is the
    planar chain's expectation, whose backward un-applies each step (the
    CPU twins here): against complex128 autograd, 1e-5 / 1e-4."""
    n = 10

    def build():
        cir = dqt.QubitCircuit(n)
        for w in range(n):
            cir.rx(w)
            cir.rz(w)
        cir.crx(0, 9)
        cir.ccx(3, 4, 8)
        cir.cnot_ring()
        cir.observable(list(range(n)), basis='x' * n)
        cir.init_para(11)
        return cir

    ref = build()
    q = ref.params.requires_grad_()
    want = ref.expectation(params=q)[0]
    want.backward()
    dqt.set_dtype('complex64')
    cir = build()
    assert cir._planar_ok()
    fn = make_adjoint_expectation(cir)
    p = cir.params.requires_grad_()
    e = fn(p)
    e.backward()
    np.testing.assert_allclose(e.item(), want.item(), atol=1e-5)
    np.testing.assert_allclose(_np(p.grad), _np(q.grad), atol=1e-4)
