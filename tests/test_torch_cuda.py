"""The port's CUDA kernels on the card, held against their plain twins.

Every test here is marked `cuda` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 with at most 8 products per amplitude (planar_apply,
2e-6), 128-term sums (window_apply, 1e-5 absolute on unit-variance
states), and up to ~30 chained windows (window_chain_fwd and the slice,
1e-5).
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import chain_kernel as tck
from deepquantum_tpu_torch.ops import planar_gate as tpg
from deepquantum_tpu_torch.ops import window_gate as twg

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dqt.set_dtype('complex64')
    yield torch.device('cuda')
    dqt.set_dtype('complex64')


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planes(u, device):
    return (torch.as_tensor(u.real, dtype=torch.float32, device=device),
            torch.as_tensor(u.imag, dtype=torch.float32, device=device))


def _state(n, rng, device):
    return torch.as_tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float32, device=device)


def _bench(n, layers, device):
    cir = dqt.QubitCircuit(n, device=device)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(n)
    return cir


@pytest.mark.parametrize('n,wires', [(16, (0,)), (16, (15,)), (16, (3, 9)), (16, (0, 8, 15)),
                                     (12, (4, 5, 6))])
def test_planar_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + sum(wires))
    mre, mim = _planes(_haar(1 << len(wires), rng), card)
    x = _state(n, rng, card)
    want = tpg.planar_evolve_xla(x, mre, mim, n, wires)
    before = tpg.planar_apply.launches
    got = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    assert tpg.planar_apply.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_window_kernel_matches_twin(card):
    n = 16
    rng = np.random.default_rng(16)
    mre, mim = _planes(_haar(128, rng), card)
    x = _state(n, rng, card)
    want = twg.window_apply_plain(x, mre, mim, n, 7)
    before = twg.window_apply.launches
    got = twg.window_apply(x.clone(), mre, mim, n, 7)
    assert twg.window_apply.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('n', [16, 19])
def test_chain_kernel_matches_twin(n, card):
    cir = _bench(n, 2, card)
    with torch.inference_mode():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        assert tck.chain_fused_ok(wseq, n, mres)
        x = _state(n, np.random.default_rng(n), card)
        x0 = x.clone()
        want = tck.window_chain_plain(x, mres, mims, n, wseq)
        before = tck.window_chain_fwd.launches
        got = tck.window_chain_fwd(x, mres, mims, n, wseq)
        assert tck.window_chain_fwd.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(x, x0)   # the caller's state is not written


def test_slice_matches_complex128(card):
    n = 16
    cir = _bench(n, 5, card)
    with torch.inference_mode():
        before = tck.window_chain_fwd.launches
        state = cir.forward()
        e = cir.expectation()
        assert tck.window_chain_fwd.launches == before + 2
    dqt.set_dtype('complex128')
    ref = _bench(n, 5, card)
    assert not ref._planar_ok()
    with torch.inference_mode():
        ref_state = ref.forward()
        ref_e = ref.expectation()
    assert (state.to(torch.complex128) - ref_state).abs().max().item() <= 1e-5
    assert abs(e.item() - ref_e.item()) <= 1e-5


def test_cuda_route_refuses_gradients(card):
    cir = _bench(16, 1, card)
    p = cir.params.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        cir.expectation(params=p)


def test_cuda_entry_refuses_batched_state(card):
    x = torch.zeros(3, 2, 1 << 12, device=card)
    m = torch.eye(2, device=card)
    with pytest.raises(NotImplementedError):
        tpg.planar_apply(x, m, m, 12, (0,))
