"""PyTorch port vs the JAX package: the planar_apply kernel's twin and relabels.

The JAX side runs its Pallas kernel in interpret mode on the CPU (as
tests/test_planar.py does). Inputs are made with numpy from a seed. The
planar engine works in float32; both sides sum at most 8 products per
amplitude, so they agree to 2e-6. The CUDA kernels themselves are held
against the twins by tests/test_torch_cuda.py, which needs a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepquantum_tpu.ops import planar_gate as jpg
from deepquantum_tpu_torch.ops import planar_gate as tpg

torch.set_num_threads(1)


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return (q * (np.diag(r) / np.abs(np.diag(r)))).astype(np.complex64)


def _state(n, rng):
    return rng.standard_normal((2, 1 << n)).astype(np.float32)


# the head / tail / mid / mixed wire regimes of tests/test_planar.py
CASES = [
    (14, (0,)), (14, (13,)), (14, (5,)),
    (14, (0, 1, 2)), (14, (11, 12, 13)), (14, (4, 5, 6)),
    (14, (0, 6, 13)), (12, (3, 11)), (12, (1, 7, 10)),
]


@pytest.mark.parametrize('n,wires', CASES)
def test_planar_twin_matches_jax_kernel(n, wires):
    rng = np.random.default_rng(n * 31 + sum(wires))
    u = _haar(1 << len(wires), rng)
    x = _state(n, rng)
    mre, mim = u.real.copy(), u.imag.copy()
    want = np.asarray(jpg._planar_apply(jnp.asarray(x), jnp.asarray(mre), jnp.asarray(mim), n,
                                        wires, interpret=True))
    got = tpg.planar_evolve_xla(torch.as_tensor(x), torch.as_tensor(mre), torch.as_tensor(mim),
                                n, wires)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # the kernel entry takes the twin on a CPU tensor, in place
    xt = torch.as_tensor(x.copy())
    out = tpg.planar_apply(xt, torch.as_tensor(mre), torch.as_tensor(mim), n, wires)
    assert out is xt
    np.testing.assert_array_equal(xt.numpy(), got.numpy())


@pytest.mark.parametrize('wires', [(3, 1), (7, 2, 5)])
def test_sorted_mat_planes_match_jax(wires):
    rng = np.random.default_rng(len(wires))
    u = _haar(1 << len(wires), rng)
    jre, jim = jpg._sorted_mat_planes(jnp.asarray(u), wires)
    tre, tim = tpg._sorted_mat_planes(torch.as_tensor(u), wires)
    np.testing.assert_array_equal(tre.numpy(), np.asarray(jre))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))


@pytest.mark.parametrize('delta', [7, 8, 11, -7])
def test_rotate_planar_matches_jax(delta):
    n = 18
    x = _state(n, np.random.default_rng(delta + 40))
    want = np.asarray(jpg._rotate_planar(jnp.asarray(x), delta, n))
    got = tpg._rotate_planar(torch.as_tensor(x), delta, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_planar_roundtrip():
    rng = np.random.default_rng(3)
    psi = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    p = tpg.to_planar(torch.as_tensor(psi))
    assert p.shape == (2, 64) and p.dtype == torch.float32 and p.is_contiguous()
    np.testing.assert_array_equal(tpg.from_planar(p).numpy(), psi)


@pytest.mark.parametrize('n,wires_list', [
    (20, [(18, 19), (17, 18), (3, 19), (0, 1), (16, 17), (12, 13), (5, 18), (14, 15)]),
    (16, [(14, 15), (13, 14), (0, 15), (2, 3)]),
    (12, [(10, 11), (0, 11)]),
])
def test_schedule_rotations_matches_jax(n, wires_list):
    assert tpg.schedule_rotations(wires_list, n) == jpg.schedule_rotations(wires_list, n)


def test_cuda_checks_refuse_gradients():
    """A kernel wrapper called directly is not differentiable: it raises
    rather than differentiating through the twin (checked here on the
    argument validation, which runs before any build). Gradients come from
    the planar_chain / planar_pauli_expectation Functions."""
    from deepquantum_tpu_torch.ops import _cuda
    x = torch.zeros(2, 1 << 10, requires_grad=True)
    with pytest.raises(NotImplementedError):
        _cuda.check_state(x, 10, 'planar_apply')
