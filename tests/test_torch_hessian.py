"""PyTorch port vs the JAX package: second derivatives through the planar
engine (QubitCircuit.hessian, create_graph=True through the kernel
Functions).

The port runs at complex64 on its planar route (the kernels' twins on the
CPU); the JAX package at complex128 on its einsum route (DQ_PLANAR unset),
as the exact reference. The second-order Functions (_ApplyD, _GradD,
_WinApplyD) are also held to torch's gradgradcheck in float64, where the
chain's recurrence is exact.

Tolerances: the Hessian is symmetric to 1e-5 and within 1e-4 of the JAX
package's (float32 sums over ~30 steps, as tests/test_planar.py's hessian
test); a central difference of the port's gradient (eps 1e-3, float32)
within 5e-3.
"""

import os

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import permanent_kernel as tpk
from deepquantum_tpu_torch.ops import planar_gate as tpg
from deepquantum_tpu_torch.photonic import tor_kernel as ttk
from deepquantum_tpu_torch.photonic import torontonian_ as tt

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


def _hessian_circuit(pkg, n):
    """tests/test_planar.py's hessian circuit: rx on every wire, a CNOT ring,
    Z on wire 0."""
    cir = pkg.QubitCircuit(n)
    for i in range(n):
        cir.rx(i)
    cir.cnot_ring()
    cir.observable(0, basis='z')
    return cir


def _noisy_circuit(pkg, n):
    cir = pkg.QubitCircuit(n, den_mat=True)
    for i in range(n):
        cir.rx(i)
        cir.ry(i)
    cir.cnot_ring()
    cir.depolarizing(1, inputs=0.3)
    for i in range(n):
        cir.rz(i)
    cir.amp_damp(2, inputs=0.2)
    cir.observable(0, basis='x')
    return cir


def test_hessian_matches_jax_and_a_finite_difference():
    n = 10
    jcir = _hessian_circuit(dq, n)
    tcir = dqt.from_jax(jcir)
    assert tcir._planar_ok()
    h = tcir.hessian().numpy()
    assert h.shape == (n, n)
    np.testing.assert_allclose(h, h.T, atol=1e-5)
    np.testing.assert_allclose(h, np.asarray(jcir.hessian()), atol=1e-4)
    p0 = tcir.params.double().numpy()
    eps, i = 1e-3, 4

    def grad_at(shift):
        q = p0.copy()
        q[i] += shift
        p = dqt.params_from_numpy(q, requires_grad=True)
        tcir.expectation(params=p)[0].backward()
        return p.grad.double().numpy()

    np.testing.assert_allclose((grad_at(eps) - grad_at(-eps)) / (2 * eps), h[i], atol=5e-3)


def test_hessian_through_windows_matches_complex128():
    """n=14: the chain is windows and relabels, so the second-order walk
    runs _WinApplyD (the window product's embedding differentiated again)."""
    n = 14
    cir = _hessian_circuit(dqt, n)
    cir.init_para(3)
    _, _, wseq = cir._planar_seq(cir._full_params())
    assert any(ws[0] == 'win' for ws in wseq)
    p = cir.params
    h = cir.hessian()
    np.testing.assert_allclose(h.numpy(), h.numpy().T, atol=1e-5)
    dqt.set_dtype('complex128')
    cir._touch()
    assert not cir._planar_ok()
    ref = cir.hessian(params=p.double())
    np.testing.assert_allclose(h.double().numpy(), ref.numpy(), atol=1e-4)


def test_density_matrix_hessian_matches_jax():
    """n=5: rho is a 10-wire planar state, two channels as superoperators."""
    jcir = _noisy_circuit(dq, 5)
    tcir = dqt.from_jax(jcir)
    assert tcir._planar_ok()
    h = tcir.hessian().numpy()
    np.testing.assert_allclose(h, h.T, atol=1e-5)
    np.testing.assert_allclose(h, np.asarray(jcir.hessian()), atol=1e-4)


def _gate_seq(n, rng, batch=None):
    wseq = [(0, 3), ('rot', 2), (1, 2, 3)]
    mres, mims = [], []
    for ws in wseq:
        if ws[0] == 'rot':
            mres.append(None)
            mims.append(None)
            continue
        shape = (1 << len(ws),) * 2 if batch is None else (batch,) + (1 << len(ws),) * 2
        mres.append(torch.tensor(rng.standard_normal(shape), dtype=torch.float64,
                                 requires_grad=True))
        mims.append(torch.tensor(rng.standard_normal(shape), dtype=torch.float64,
                                 requires_grad=True))
    return mres, mims, wseq


def test_second_order_functions_gradgradcheck():
    """_ApplyD / _GradD compose to the exact second derivative: the chain
    (recorded walk, relabels included) at a unitary point, and the
    superoperator on a general map, single and batched."""
    n = 4
    rng = np.random.default_rng(3)
    wseq = ((0,), (1, 3), (0, 2, 3))
    mres, mims = [], []
    for ws in wseq:
        z = rng.normal(size=(1 << len(ws),) * 2) + 1j * rng.normal(size=(1 << len(ws),) * 2)
        u = np.linalg.qr(z)[0]
        mres.append(torch.tensor(u.real, requires_grad=True))
        mims.append(torch.tensor(u.imag, requires_grad=True))
    x = torch.tensor(rng.standard_normal((2, 1 << n)), requires_grad=True)
    k = len(wseq)

    def chain(x, *planes):
        return tpg.planar_chain(x, planes[:k], planes[k:], n, wseq)

    assert torch.autograd.gradgradcheck(chain, (x, *mres, *mims), eps=1e-6, atol=1e-6)

    for batch in (None, 2):
        xs = x if batch is None else torch.tensor(rng.standard_normal((batch, 2, 1 << n)),
                                                  requires_grad=True)
        sr, si, sw = _gate_seq(n, rng, batch)

        def superops(x, *planes):
            it = iter(planes)
            for ws in sw:
                if ws[0] == 'rot':
                    x = tpg._rotate_planar(x, ws[1], n)
                else:
                    x = tpg.planar_superop(x, next(it), next(it), n, ws)
            return x

        planes = [m for pair in zip(sr, si) if pair[0] is not None for m in pair]
        assert torch.autograd.gradgradcheck(superops, (xs, *planes), eps=1e-6, atol=1e-6)


def test_pauli_expectation_second_order():
    """d2/dx2 of Re<x|P|x> is 2P: the recomputed Px carries it."""
    n = 6
    rng = np.random.default_rng(4)
    pauli = {'x': [[0, 1], [1, 0]], 'y': [[0, -1j], [1j, 0]], 'z': [[1, 0], [0, -1]]}
    mats = [np.kron(pauli['x'], pauli['y']), np.array(pauli['z'])]
    mres = [torch.tensor(np.real(m), dtype=torch.float64) for m in mats]
    mims = [torch.tensor(np.imag(m), dtype=torch.float64) for m in mats]
    x = torch.tensor(rng.standard_normal((2, 1 << n)), requires_grad=True)

    def fn(x):
        return tpg.planar_pauli_expectation(x, mres, mims, n, ((1, 4), (5,)))

    assert torch.autograd.gradgradcheck(fn, (x,), eps=1e-6, atol=1e-6)


def test_photonic_functions_stay_first_order(monkeypatch):
    """K7-K9 differentiate their twins once; a backward under create_graph
    still raises. On the CPU the kernels' launches are stood in for by
    their twins, so that the Functions themselves run."""
    monkeypatch.setattr(tpk, '_launch', tpk.permanent_plain_batch)
    m = torch.randn(2, 4, 4, dtype=torch.complex128, requires_grad=True)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(tpk._Permanents.apply(m).sum().real, m, create_graph=True)
    # first order still works through the same Function
    g, = torch.autograd.grad(tpk._Permanents.apply(m).sum().real, m)
    ref, = torch.autograd.grad(tpk.permanent_plain_batch(m).sum().real, m)
    torch.testing.assert_close(g, ref)

    def tor_launch(name, o_mat, gamma, idx, valid, sign):
        if gamma is None:
            return ttk.tor_dets_plain(o_mat, idx, valid, sign)[0], None
        return ttk.tor_dets_quads_plain(o_mat, gamma, idx, valid, sign)[:2]

    monkeypatch.setattr(ttk, '_launch', tor_launch)
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 8))
    o = torch.tensor(np.eye(8) - np.linalg.inv(np.eye(8) + a @ a.T), dtype=torch.complex128,
                     requires_grad=True)
    gamma = torch.tensor(rng.standard_normal(8), requires_grad=True)
    scaffold = tt._padded_tor_indices(4, o.device)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(ttk._TorDets.apply(o, *scaffold).sum().real, o, create_graph=True)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(ttk._TorDetsQuads.apply(o, gamma, *scaffold)[1].sum().real, gamma,
                            create_graph=True)
