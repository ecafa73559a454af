"""The port's serving slice vs the JAX package: QubitCircuit forward + Pauli
expectation on the bench ansatz (rx/rz/rx per wire plus a CNOT ring,
X string on all wires).

(a) complex128: the port's einsum route against JAX's einsum route, 1e-10.
(b) complex64: the port's planar route (twins on the CPU) against JAX's
    planar route with its Pallas kernels in interpret mode, 1e-5 (float32
    over up to 44 fused gate groups).
"""

import os

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt

from test_torch_window import bench

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)


@pytest.fixture()
def c128():
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')
    dqt.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')


@pytest.fixture()
def c64():
    dq.set_dtype('complex64')
    dqt.set_dtype('complex64')
    os.environ['DQ_PLANAR'] = '1'
    yield
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')


def _run_both(jcir):
    want_state = np.asarray(jcir.forward()).reshape(-1)
    want_e = np.asarray(jcir.expectation())
    tcir = dqt.from_jax(jcir)
    with torch.inference_mode():
        state = tcir.forward().reshape(-1).numpy()
        e = tcir.expectation().numpy()
    return tcir, state, want_state, e, want_e


@pytest.mark.parametrize('n,layers', [(4, 5), (8, 5), (12, 5), (16, 1)])
def test_bench_ansatz_complex128_matches_jax(n, layers, c128):
    jcir = bench(n, layers)
    tcir, state, want_state, e, want_e = _run_both(jcir)
    assert not tcir._planar_ok()
    assert state.dtype == np.complex128
    np.testing.assert_allclose(state, want_state, atol=1e-10)
    np.testing.assert_allclose(e, want_e, atol=1e-10)


# n=12 runs 1 layer here: JAX's interpret-mode reference costs about 15 s a
# layer on the CPU, and at n=12 every fused group is a per-gate step
# whatever the depth (no window plan below n=14).
@pytest.mark.parametrize('n,layers', [(12, 1), (16, 1)])
def test_bench_ansatz_complex64_planar_matches_jax(n, layers, c64):
    jcir = bench(n, layers)
    assert jcir._planar_ok()
    tcir, state, want_state, e, want_e = _run_both(jcir)
    assert tcir._planar_ok()
    assert state.dtype == np.complex64
    np.testing.assert_allclose(state, want_state, atol=1e-5)
    np.testing.assert_allclose(e, want_e, atol=1e-5)


def _mixed(n):
    cir = dq.QubitCircuit(n)
    cir.u3(0)
    cir.rx(n - 1)
    cir.crz(1, n - 2)
    cir.swap([2, n - 1])
    cir.toffoli(0, 3, n - 2)
    cir.cnot(n - 1, 1)
    cir.h(4)
    cir.rzz([0, 5])
    cir.observable([1, n - 1], basis='zy')
    cir.observable(0, basis='x')
    cir.init_para(2)
    return cir


def test_from_jax_mixed_circuit_complex128(c128):
    jcir = _mixed(6)
    _, state, want_state, e, want_e = _run_both(jcir)
    np.testing.assert_allclose(state, want_state, atol=1e-10)
    np.testing.assert_allclose(e, want_e, atol=1e-10)


def test_from_jax_mixed_circuit_complex64_planar(c64):
    jcir = _mixed(10)
    tcir, state, want_state, e, want_e = _run_both(jcir)
    assert tcir._planar_ok() and jcir._planar_ok()
    np.testing.assert_allclose(state, want_state, atol=1e-5)
    np.testing.assert_allclose(e, want_e, atol=1e-5)


def test_from_jax_refuses_unmapped_gates(c128):
    cir = dq.QubitCircuit(3)
    cir.latent([0, 1])
    with pytest.raises(NotImplementedError):
        dqt.from_jax(cir)


def test_port_api_builds_the_same_circuit(c128):
    """A circuit made through the port's own API (no from_jax) gives JAX's
    numbers for the same parameter values."""
    n = 6
    jcir = bench(n, 2)
    tcir = dqt.QubitCircuit(n)
    for _ in range(2):
        for i in range(n):
            tcir.rx(i)
            tcir.rz(i)
            tcir.rx(i)
        tcir.cnot_ring()
    tcir.observable(list(range(n)), basis='x' * n)
    tcir.params = np.asarray(jcir.params)
    p = dqt.params_from_numpy(np.asarray(jcir.params))
    np.testing.assert_allclose(tcir.expectation(params=p).numpy(),
                               np.asarray(jcir.expectation()), atol=1e-10)
    tcir.init_para(11)
    jcir.init_para(11)
    np.testing.assert_allclose(tcir.params.numpy(), np.asarray(jcir.params), atol=0)


def test_state_init_kinds(c128):
    n = 3
    for kind in ('zeros', 'equal', 'ghz'):
        np.testing.assert_allclose(dqt.QubitState(n, kind).state.numpy(),
                                   np.asarray(dq.QubitState(n, kind).state), atol=1e-15)
    amp = np.arange(1, 9, dtype=np.float64)
    np.testing.assert_allclose(dqt.QubitState(n, amp).state.numpy(),
                               np.asarray(dq.QubitState(n, amp).state), atol=1e-15)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    with pytest.raises(RuntimeError):
        dqt.QubitCircuit(10, device='cuda')


def test_default_device_is_the_card():
    """With the default device untouched, a machine without CUDA refuses to
    build a circuit and says how to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a CUDA card')
    dqt.set_device(None)
    assert dqt.default_device().type == 'cuda'
    with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
        dqt.QubitCircuit(4)
    with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
        dqt.params_from_numpy(np.zeros(3))
    assert dqt.QubitCircuit(4, device='cpu').device.type == 'cpu'
