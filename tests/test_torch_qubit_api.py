"""The rest of the port's QubitCircuit against the JAX package, on the CPU at
complex128 (tolerance 1e-10 unless a test says otherwise):

- conditional gates, ``defer_measure`` and ``post_select`` (one state and a
  batch; the port draws from a seeded ``torch.Generator``, the JAX side is
  sliced on the same bits);
- ``reset`` / ``move``, the zero-probability branch included;
- ``get_unitary``, ``get_amplitude``, ``get_prob``;
- ``inverse``, ``+`` and ``add`` of a circuit and of a shared descriptor;
- every gate-sugar method, built through both APIs and through
  ``from_jax``;
- the small accessors, and the names that are not ported raising by name.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.models.ansatz import make_gate as jax_make_gate
from deepquantum_tpu_torch.models.ansatz import make_gate

torch.set_num_threads(1)
ATOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu_c128():
    """The port's default device is the card and its default dtype
    complex64: these tests ask for the CPU and complex128 (the JAX
    package's test default)."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _prefix(c, n):
    for w in range(n):
        c.ry(w, inputs=0.3 + 0.4 * w)
        c.rz(w, inputs=0.2 - 0.3 * w)


def _both(build, n=4):
    """The same circuit through both APIs (and the port's copy of the JAX
    one): (port, from_jax, jax) final states, flat."""
    j = dq.QubitCircuit(n)
    t = dqt.QubitCircuit(n)
    for c in (j, t):
        _prefix(c, n)
        build(c)
    want = _np(j.forward()).reshape(-1)
    return _np(t.forward()).reshape(-1), _np(dqt.from_jax(j).forward()).reshape(-1), want, t, j


# --------------------------------------------------------- conditional gates
def _conditional(c, n=5):
    for w in range(2):
        c.h(w)
    c.x(2, controls=0, condition=True)
    c.rx(3, inputs=0.7, controls=[0, 1], condition=True)
    c.u3(4, inputs=[0.2, 0.4, 0.6], controls=1, condition=True)
    c.swap([2, 4], controls=0, condition=True)
    c.cnot(3, 4)


def test_conditional_defer_measure_and_post_select():
    n = 5
    j, t = dq.QubitCircuit(n), dqt.QubitCircuit(n)
    for c in (j, t):
        _conditional(c, n)
    want = _np(j.forward()).reshape(-1)
    got = _np(t.forward()).reshape(-1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert t.wires_condition == j.wires_condition == [0, 1]
    assert not t._planar_ok()
    seen = set()
    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        state, bits, prob = t.defer_measure(with_prob=True, generator=gen)
        seen.add(bits)
        np.testing.assert_allclose(_np(state), _np(j.post_select(bits)), atol=ATOL)
        np.testing.assert_allclose(prob, float(j.get_prob(bits, wires=j.wires_condition)),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(t.post_select(bits)), _np(j.post_select(bits)), atol=ATOL)
        assert state.shape == (2 ** (n - 2), 1)
        np.testing.assert_allclose(torch.linalg.vector_norm(state).item(), 1.0, atol=ATOL)
    assert len(seen) > 1
    # the same draws again from the same seed
    again = t.defer_measure(generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(_np(again), _np(t.defer_measure(
        generator=torch.Generator().manual_seed(3))), atol=0)


def test_conditional_batch_defer_measure():
    """A batch of data-encoded states through a conditional circuit."""
    n, bsz = 4, 3
    data = np.random.default_rng(5).random((bsz, n)) * np.pi
    j, t = dq.QubitCircuit(n), dqt.QubitCircuit(n)
    for c in (j, t):
        c.rylayer(encode=True)
        c.x(2, controls=0, condition=True)
        c.ry(3, inputs=0.4, controls=1, condition=True)
    want = _np(j.forward(data=data))
    got = _np(t.forward(data=torch.as_tensor(data)))
    assert got.shape == (bsz, 2 ** n, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    states, bits, probs = t.defer_measure(with_prob=True,
                                          generator=torch.Generator().manual_seed(11))
    assert states.shape == (bsz, 4, 1) and len(bits) == len(probs) == bsz
    for i, b in enumerate(bits):
        want_i = _np(j.post_select(b))[i]
        np.testing.assert_allclose(_np(states[i]), want_i, atol=ATOL)
        np.testing.assert_allclose(_np(t.post_select(b))[i], want_i, atol=ATOL)
        np.testing.assert_allclose(probs[i], float(_np(j.get_prob(b, wires=[0, 1]))[i]),
                                   atol=ATOL)


# ------------------------------------------------------------- reset, move
@pytest.mark.parametrize('case', ['reset0', 'reset1', 'reset_all', 'reset_zero_branch',
                                  'move', 'move1'])
def test_reset_and_move(case):
    def build(c):
        c.cnot(0, 1)
        if case == 'reset0':
            c.reset([1, 3])
        elif case == 'reset1':
            c.reset(2, postselect=1)
        elif case == 'reset_all':
            c.reset()
        elif case == 'reset_zero_branch':
            # wire 3 is |0> here: post-selecting 1 has probability zero
            c.reset(3)
            c.reset(3, postselect=1)
        elif case == 'move':
            c.move(0, 2)
        else:
            c.move(3, 1, postselect=1)
        c.rx(2, inputs=0.3)
    got, via, want, t, _ = _both(build)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(via, want, atol=ATOL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=ATOL)


# ------------------------------------------------------------- inspection
def _mixed(c):
    c.cu(0, 2, inputs=[0.3, 0.5, 0.7])
    c.rxx([1, 3], inputs=0.4)
    c.ccx(0, 1, 3)
    c.crz(3, 0, inputs=0.9)


def test_get_unitary_amplitude_prob():
    n = 4
    got, _, want, t, j = _both(_mixed)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(_np(t.get_unitary()), _np(j.get_unitary()), atol=ATOL)
    u = _np(t.get_unitary())
    np.testing.assert_allclose(u @ u.conj().T, np.eye(16), atol=ATOL)
    for bits in ('0000', '1011', '0110'):
        np.testing.assert_allclose(_np(t.get_amplitude(bits)), _np(j.get_amplitude(bits)),
                                   atol=ATOL)
        np.testing.assert_allclose(_np(t.get_prob(bits)), _np(j.get_prob(bits)), atol=ATOL)
    for bits, wires in (('10', [1, 3]), ('1', [2]), ('011', [3, 0, 1])):
        np.testing.assert_allclose(_np(t.get_prob(bits, wires)), _np(j.get_prob(bits, wires)),
                                   atol=ATOL)
    assert n == t.nqubit


def test_inverse_and_add():
    n = 4
    j, t = dq.QubitCircuit(n), dqt.QubitCircuit(n)
    for c in (j, t):
        _prefix(c, n)
        _mixed(c)
        c.observable(2)
    u = _np(t.get_unitary())
    inv_t, inv_j = t.inverse(), j.inverse()
    np.testing.assert_allclose(_np(inv_t.get_unitary()), u.conj().T, atol=ATOL)
    np.testing.assert_allclose(_np(inv_t.get_unitary()), _np(inv_j.get_unitary()), atol=ATOL)
    np.testing.assert_allclose(_np(dqt.from_jax(inv_j).get_unitary()), u.conj().T, atol=ATOL)
    both_t, both_j = t + inv_t, j + inv_j
    np.testing.assert_allclose(_np(both_t.get_unitary()), np.eye(16), atol=ATOL)
    assert both_t.npara == both_j.npara and len(both_t._pvals) == len(both_j._pvals)
    k, jk = dqt.QubitCircuit(n), dq.QubitCircuit(n)
    for c, mod in ((k, dqt), (jk, dq)):
        c.add(t if c is k else j)
        c.add(mod.Observable(n, 1))
    assert len(k.observables) == 2 and k.npara == t.npara == jk.npara
    np.testing.assert_allclose(_np(k.forward()), _np(t.forward()), atol=ATOL)
    jk.forward()
    np.testing.assert_allclose(_np(k.expectation()), _np(jk.expectation()), atol=ATOL)


def test_add_shares_descriptor_parameters():
    """One descriptor added three times registers its parameters once; the
    gradient of a shared angle is the sum over its uses."""
    n = 3
    j, t = dq.QubitCircuit(n), dqt.QubitCircuit(n)
    for c, mk in ((j, jax_make_gate), (t, make_gate)):
        g = mk('Rx', inputs=[0.37])
        h = mk('U3Gate')
        for w in range(n):
            c.add(g, wires=w)
        c.add(h, wires=2, controls=0)
        c.add(h, wires=1)
        c.observable(1)
    assert t.npara == j.npara == 4
    t._pvals = list(j._pvals)
    np.testing.assert_allclose(_np(t.forward()), _np(j.forward()), atol=ATOL)
    p = t.params.requires_grad_()
    t.expectation(params=p)[0].backward()
    import jax
    want = jax.grad(lambda q: j.expectation(params=q)[0])(j.params)
    np.testing.assert_allclose(_np(p.grad), np.asarray(want), atol=ATOL)


# ------------------------------------------------------------- gate sugar
_HAM = np.array([[1.0, 0.5 - 0.2j, 0, 0.1], [0.5 + 0.2j, -0.3, 0.2j, 0],
                 [0, -0.2j, 0.7, 0.4], [0.1, 0, 0.4, -1.0]])
_U = np.linalg.qr(np.random.default_rng(2).normal(size=(4, 4))
                  + 1j * np.random.default_rng(3).normal(size=(4, 4)))[0]
_LATENT = np.random.default_rng(4).normal(size=(4, 4))
SUGAR = {
    'cu': lambda c: c.cu(0, 2, inputs=[0.3, 0.5, 0.7]),
    'cp': lambda c: c.cp(1, 3, inputs=0.4),
    'ch': lambda c: c.ch(2, 0),
    'cs': lambda c: c.cs(0, 1),
    'csdg': lambda c: c.csdg(3, 1),
    'ct': lambda c: c.ct(1, 2),
    'ctdg': lambda c: c.ctdg(2, 3),
    'crx': lambda c: c.crx(3, 1, inputs=0.3),
    'cry': lambda c: c.cry(0, 3, inputs=1.1),
    'crz': lambda c: c.crz(2, 1, inputs=-0.6),
    'cy': lambda c: c.cy(1, 2),
    'j': lambda c: c.j(2, inputs=0.7, plane='yz'),
    'crxx': lambda c: c.crxx(0, 1, 3, inputs=0.3),
    'cryy': lambda c: c.cryy(2, 0, 3, inputs=0.5),
    'crzz': lambda c: c.crzz(1, 2, 3, inputs=0.8),
    'crxy': lambda c: c.crxy(3, 0, 2, inputs=1.2),
    'ccx': lambda c: c.ccx(0, 1, 3),
    'cswap': lambda c: c.cswap(2, 0, 3),
    'any': lambda c: c.any(unitary=_U, wires=[1, 3], controls=0),
    'latent': lambda c: c.latent(wires=[0, 2], inputs=_LATENT),
    'hamiltonian': lambda c: c.hamiltonian(_HAM, t=0.6, wires=[1, 2]),
    'xlayer': lambda c: c.xlayer([0, 2]),
    'ylayer': lambda c: c.ylayer(),
    'zlayer': lambda c: c.zlayer([1, 3]),
    'hlayer': lambda c: c.hlayer(),
    'u3layer': lambda c: c.u3layer(wires=[0, 1, 3], inputs=np.linspace(0.1, 0.9, 9)),
    'cxlayer': lambda c: c.cxlayer(),
    'cond_x': lambda c: c.x(3, controls=[0, 1], condition=True),
    'cond_rx': lambda c: c.rx(2, inputs=0.3, controls=1, condition=True),
    'cond_p': lambda c: c.p(0, inputs=0.9, controls=3, condition=True),
    'cond_rzz': lambda c: c.rzz([0, 2], inputs=0.4, controls=1, condition=True),
    'inverse_j': lambda c: c.add(_inverted_j(c)),
}


def _inverted_j(c):
    sub = type(c)(c.nqubit)
    sub.j(1, inputs=0.4, plane='zx')
    sub.rbs([0, 3], inputs=0.2)
    return sub.inverse()


@pytest.mark.parametrize('name', list(SUGAR))
def test_gate_sugar_matches_jax(name):
    got, via, want, t, j = _both(SUGAR[name])
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(via, want, atol=ATOL)
    assert t.npara == j.npara and t.max_depth == j.max_depth


def test_controlled_sugar_on_the_planar_route():
    """At complex64 and n=10 a gate of at most 3 wires with its controls
    stays on the planar engine (its twins on the CPU): against the
    complex128 einsum route, 1e-5."""
    n = 10

    def build(c):
        _prefix(c, n)
        c.cu(0, 9, inputs=[0.3, 0.5, 0.7])
        c.crxx(4, 1, 8, inputs=0.3)
        c.ccx(2, 5, 7)
        c.cswap(9, 0, 3)
        c.latent(wires=[2, 6, 7], inputs=np.random.default_rng(0).normal(size=(8, 8)))
        c.hamiltonian(_HAM, t=0.6, wires=[3, 5])
        c.observable(list(range(n)), basis='x' * n)

    ref = dqt.QubitCircuit(n)
    build(ref)
    want = _np(ref.forward()).reshape(-1)
    dqt.set_dtype('complex64')
    cir = dqt.QubitCircuit(n)
    build(cir)
    assert cir._planar_ok()
    np.testing.assert_allclose(_np(cir.forward()).reshape(-1), want, atol=1e-5)
    big = dqt.QubitCircuit(n)
    big.any(np.eye(8), wires=[0, 1, 2], controls=5)
    assert not big._planar_ok()


# ------------------------------------------------------------- accessors
def test_accessors_and_not_ported_names():
    t = dqt.QubitCircuit(3)
    t.h(0)
    t.cnot(0, 1)
    t.cx(1, 2)
    assert t.max_depth == 2
    x = t.forward()
    assert t.tensor_rep(x).shape == (1, 2, 2, 2)
    assert t.vector_rep(x).shape == (1, 8, 1)
    assert t.amplitude_encoding([1, 1]).shape == (8, 1)
    t.observable(0)
    np.testing.assert_allclose(_np(t.expval_fn()(None)), [0.0], atol=ATOL)
    t.reset_observable()
    assert t.observables == []
    np.testing.assert_allclose(_np(t.get_prob('000')), 0.5, atol=ATOL)
    t.reset_circuit()
    assert t.operators == [] and t.npara == 0 and t.max_depth == 0
    t.set_nqubit(5)
    assert t.nqubit == 5 and t.init_state.state.shape == (32, 1)
    # the toolchain methods, ported: each runs (tests/test_torch_periphery.py,
    # test_torch_cutting.py and test_torch_mbqc.py hold them to the JAX package)
    t.h(0)
    t.observable(0)
    assert t.draw(output='str').startswith('q0: ') and t.qasm().startswith('OPENQASM 2.0')
    assert t.qasm3().startswith('OPENQASM 3.0') and len(t.pattern().commands) == 4
    t.cut(0)
    assert t.transform_cut2move().nqubit == 6 and len(t.get_subexperiments()[1]) == 8
    for name in ('Pattern', 'cutting', 'qasm', 'U3Gate', 'GraphState', 'cir_to_qasm3',
                 'DistributedQubitCircuit', 'UnitaryMapper', 'DrawClements', 'setup_distributed'):
        assert hasattr(dqt, name)
    assert dqt.MatrixProductState is dqt.mps.MatrixProductState
    assert dqt.QuantumFourierTransform is dqt.models.QuantumFourierTransform


def test_bitmath_and_qmath_helpers():
    from deepquantum_tpu import bitmath as jb
    from deepquantum_tpu.ops import qmath as jq
    from deepquantum_tpu_torch.ops import qmath as tq
    for num in (0, 5, 22, 1023):
        for bit in (0, 1, 3):
            assert dqt.bitmath.insert_bit(num, bit, 1) == jb.insert_bit(num, bit, 1)
            assert dqt.bitmath.flip_bit(num, bit) == jb.flip_bit(num, bit)
            assert dqt.bitmath.get_bit(num, bit) == jb.get_bit(num, bit)
    assert dqt.bitmath.flip_bit(torch.tensor([5]), 1).item() == 7
    rng = np.random.default_rng(0)
    psi = rng.normal(size=(2, 16)) + 1j * rng.normal(size=(2, 16))
    rho = np.einsum('bi,bj->bij', psi, psi.conj())
    rho /= np.trace(rho, axis1=1, axis2=2)[:, None, None]
    np.testing.assert_allclose(_np(tq.partial_trace(torch.as_tensor(rho), 4, [1, 3])),
                               np.asarray(jq.partial_trace(rho, 4, [1, 3])), atol=ATOL)
    np.testing.assert_allclose(_np(tq.meyer_wallach_measure(torch.as_tensor(psi / np.linalg.norm(
        psi, axis=1, keepdims=True)).reshape(2, 2, 2, 2, 2))),
        np.asarray(jq.meyer_wallach_measure(psi.reshape(2, 2, 2, 2, 2) / np.linalg.norm(
            psi, axis=1).reshape(2, 1, 1, 1, 1))), atol=ATOL)
    np.testing.assert_allclose(_np(tq.slice_state_vector(torch.as_tensor(psi), 4, [2, 0], '10')),
                               np.asarray(jq.slice_state_vector(psi, 4, [2, 0], '10')), atol=ATOL)
    zero = np.zeros((1, 16), complex)
    assert np.isfinite(_np(tq.slice_state_vector(torch.as_tensor(zero), 4, [0], '1'))).all()
    mats = [rng.normal(size=(2, 2)) for _ in range(3)]
    np.testing.assert_allclose(_np(tq.multi_kron([torch.as_tensor(m) for m in mats])),
                               np.asarray(jq.multi_kron(mats)), atol=ATOL)
    assert tq.is_density_matrix(torch.as_tensor(rho)) and tq.is_unitary(_U)
    assert tq.inverse_permutation([2, 0, 1]) == jq.inverse_permutation([2, 0, 1])
    assert tq.int_to_bitstring(13, 6) == jq.int_to_bitstring(13, 6)
