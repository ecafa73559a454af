"""PyTorch port vs the JAX package: gate matrices and the complex einsum engine.

Inputs are made with numpy from a seed and fed to both packages at
complex128; the port must agree to 1e-12 (both compute the same formulas in
double precision).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.gate import GATE_REGISTRY as JAX_REGISTRY
from deepquantum_tpu.ops import apply as japply
from deepquantum_tpu.ops import gates as jgates
from deepquantum_tpu_torch.gate import GATE_REGISTRY
from deepquantum_tpu_torch.ops import apply as tapply
from deepquantum_tpu_torch.ops import gates as tgates

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def c128():
    dq.set_dtype('complex128')
    dqt.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')


def test_registry_names_match():
    assert set(GATE_REGISTRY) == set(JAX_REGISTRY)
    for name, reg in GATE_REGISTRY.items():
        assert (reg['nwires'], reg['npara']) == (JAX_REGISTRY[name]['nwires'],
                                                 JAX_REGISTRY[name]['npara'])


@pytest.mark.parametrize('name', sorted(JAX_REGISTRY))
def test_registry_matrix_matches_jax(name, c128):
    reg = JAX_REGISTRY[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    p = rng.uniform(-2 * np.pi, 2 * np.pi, size=max(reg['npara'], 1))
    want = np.asarray(reg['fn'](jnp.asarray(p)))
    got = GATE_REGISTRY[name]['fn'](torch.as_tensor(p), torch.device('cpu'))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.mark.parametrize('plane', ['xy', 'yz', 'zx'])
def test_projection_j_matches_jax(plane, c128):
    theta = 0.731
    np.testing.assert_allclose(tgates.projection_j_matrix(theta, plane).numpy(),
                               np.asarray(jgates.projection_j_matrix(theta, plane)), atol=1e-12)


def test_hamiltonian_and_latent_match_jax(c128):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    ham = a + a.conj().T
    np.testing.assert_allclose(tgates.hamiltonian_matrix(ham, 0.37).numpy(),
                               np.asarray(jgates.hamiltonian_matrix(ham, 0.37)), atol=1e-12)
    lat = rng.normal(size=(4, 4))
    np.testing.assert_allclose(tgates.latent_matrix(lat).numpy(),
                               np.asarray(jgates.latent_matrix(lat)), atol=1e-12)


def test_gate_matrices_are_differentiable(c128):
    theta = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    m = tgates.rx_matrix(theta)
    m[0, 1].imag.backward()
    assert theta.grad.item() == pytest.approx(-0.5 * np.cos(0.2))


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.mark.parametrize('wires', [(0,), (4,), (3, 1), (0, 4), (2, 0, 3), (4, 1, 2)])
def test_evolve_state_matches_jax(wires, c128):
    n = 5
    rng = np.random.default_rng(len(wires) * 10 + wires[0])
    u = _haar(1 << len(wires), rng)
    psi = rng.normal(size=(2,) * n) + 1j * rng.normal(size=(2,) * n)
    want = np.asarray(japply.evolve_state(jnp.asarray(psi), jnp.asarray(u), n, list(wires)))
    got = tapply.evolve_state(torch.as_tensor(psi), torch.as_tensor(u), n, list(wires))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.mark.parametrize('controls,wires', [((0,), (3,)), ((4, 1), (2,)), ((2,), (0, 4))])
def test_controlled_matches_jax(controls, wires, c128):
    n = 5
    rng = np.random.default_rng(sum(controls) + 7 * sum(wires))
    u = _haar(1 << len(wires), rng)
    np.testing.assert_allclose(
        tapply.controlled_matrix(torch.as_tensor(u), len(controls)).numpy(),
        np.asarray(japply.controlled_matrix(jnp.asarray(u), len(controls))), atol=1e-12)
    psi = rng.normal(size=(2,) * n) + 1j * rng.normal(size=(2,) * n)
    want = np.asarray(japply.evolve_state_controlled(jnp.asarray(psi), jnp.asarray(u), n,
                                                     list(wires), list(controls)))
    got = tapply.evolve_state_controlled(torch.as_tensor(psi), torch.as_tensor(u), n,
                                         list(wires), list(controls))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


@pytest.mark.parametrize('order', [(1, 0), (2, 0, 1), (1, 2, 0)])
def test_permute_matrix_wires_matches_jax(order, c128):
    rng = np.random.default_rng(len(order))
    m = _haar(1 << len(order), rng)
    np.testing.assert_allclose(tapply.permute_matrix_wires(torch.as_tensor(m), order).numpy(),
                               np.asarray(japply.permute_matrix_wires(jnp.asarray(m), order)),
                               atol=1e-12)


def test_port_imports_no_jax():
    code = ('import sys; sys.path.insert(0, sys.argv[1]); import deepquantum_tpu_torch; '
            'import deepquantum_tpu_torch.ops.chain_kernel, deepquantum_tpu_torch.ops._cuda; '
            "bad = [m for m in sys.modules if m in ('jax', 'deepquantum_tpu') or m.startswith(('jax.', "
            "'deepquantum_tpu.'))]; assert not bad, bad")
    subprocess.run([sys.executable, '-c', code, str(ROOT)], check=True, timeout=120)
