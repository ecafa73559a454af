"""The port's class-style API (api.py, photonic/api.py) against the JAX
package's, on the CPU.

- every gate, layer and channel factory: its matrix (a layer's unitary, a
  channel's Kraus set) against the JAX package's for the same inputs, to
  1e-12 at complex128 and 1e-6 at complex64;
- a circuit built from descriptors against the sugar-built circuit and
  the JAX package's class-built one;
- the oracle-free cases of the JAX package's ``tests/test_api.py``: the
  standalone call and matrix, CombinedSingleGate, layers and channels,
  ``expectation`` on a state vector, a density matrix and an MPS;
- the photonic class-style ops and ``Delay`` against their sugar.
"""

import warnings

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import api as japi
from deepquantum_tpu_torch import api as tapi

torch.set_num_threads(1)
TOL = {'complex128': 1e-12, 'complex64': 1e-6}


@pytest.fixture(autouse=True)
def _cpu_c128():
    """The port's default device is the card and its default dtype
    complex64: these tests ask for the CPU and complex128."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dq.set_dtype('complex128')
    dqt.set_device(None)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _set_dtype(dtype):
    dqt.set_dtype(dtype)
    dq.set_dtype(dtype)


_RNG = np.random.default_rng(16)
_HERM = _RNG.normal(size=(4, 4)) + 1j * _RNG.normal(size=(4, 4))
_HERM = _HERM + _HERM.conj().T
_UNI = np.linalg.qr(_RNG.normal(size=(4, 4)) + 1j * _RNG.normal(size=(4, 4)))[0]
_LATENT = _RNG.normal(size=(4, 4))

# name -> kwargs of the factory (the same for both packages)
GATES = {
    'U3Gate': dict(inputs=[0.3, -0.7, 1.9], wires=1, nqubit=2),
    'PhaseShift': dict(inputs=0.8, wires=0, controls=1),
    'Identity': dict(wires=0), 'PauliX': dict(wires=0), 'PauliY': dict(wires=1, nqubit=2),
    'PauliZ': dict(wires=0), 'Hadamard': dict(wires=0, controls=[1, 2]),
    'SGate': dict(wires=0), 'SDaggerGate': dict(wires=0), 'TGate': dict(wires=0),
    'TDaggerGate': dict(wires=0),
    'Rx': dict(inputs=0.7, wires=0), 'Ry': dict(inputs=-1.3, wires=2), 'Rz': dict(inputs=2.2),
    'CNOT': dict(wires=[1, 0]), 'Swap': dict(wires=[0, 2]), 'ImaginarySwap': dict(wires=[0, 1]),
    'Rxx': dict(inputs=0.4, wires=[0, 1]), 'Ryy': dict(inputs=1.1, wires=[1, 2]),
    'Rzz': dict(inputs=-0.6, wires=[0, 2]), 'Rxy': dict(inputs=0.9, wires=[0, 1]),
    'ReconfigurableBeamSplitter': dict(inputs=0.5, wires=[0, 1]),
    'Toffoli': dict(wires=[0, 1, 2]), 'Fredkin': dict(wires=[2, 0, 1]),
    'ProjectionJ': dict(inputs=0.6, wires=0, plane='yz'),
    'UAnyGate': dict(unitary=_UNI, wires=[1, 2]),
    'LatentGate': dict(inputs=_LATENT, wires=[0, 1]),
    'HamiltonianGate': dict(hamiltonian=_HERM, t=0.45, wires=[0, 1]),
}
CHANNELS = {
    'BitFlip': [0.2], 'PhaseFlip': [0.5], 'Depolarizing': [0.3], 'Pauli': [0.1, 0.2, 0.3, 0.4],
    'AmplitudeDamping': [0.7], 'PhaseDamping': [0.4], 'GeneralizedAmplitudeDamping': [0.3, 0.6],
}
LAYERS = {
    'XLayer': dict(nqubit=3), 'YLayer': dict(nqubit=3, wires=[0, 2]), 'ZLayer': dict(nqubit=2),
    'HLayer': dict(nqubit=3), 'RxLayer': dict(nqubit=3, inputs=[0.1, 0.2, 0.3]),
    'RyLayer': dict(nqubit=3, wires=[1, 2], inputs=[0.4, -0.5]),
    'RzLayer': dict(nqubit=2, inputs=[1.1, 0.7]),
    'U3Layer': dict(nqubit=2, inputs=[0.1, 0.2, 0.3, 0.4, 0.5, 0.6]),
    'CnotLayer': dict(nqubit=4), 'CnotRing': dict(nqubit=4, step=2, reverse=True),
}


def _matrices(name, kwargs, dtype):
    _set_dtype(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = getattr(japi, name)(**kwargs).matrix()
        got = getattr(tapi, name)(**kwargs).matrix()
    return _np(got), _np(want)


@pytest.mark.parametrize('name', sorted(GATES))
def test_gate_factory_matrix(name):
    for dtype in ('complex128', 'complex64'):
        got, want = _matrices(name, GATES[name], dtype)
        assert got.dtype == np.dtype(dtype)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize('name', sorted(CHANNELS))
def test_channel_factory_kraus(name):
    for dtype in ('complex128', 'complex64'):
        got, want = _matrices(name, dict(inputs=CHANNELS[name], wires=1), dtype)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize('name', sorted(LAYERS))
def test_layer_factory_unitary(name):
    for dtype in ('complex128', 'complex64'):
        _set_dtype(dtype)
        got = getattr(tapi, name)(**LAYERS[name])
        want = getattr(japi, name)(**LAYERS[name])
        assert type(got) is dqt.QubitCircuit and got.nqubit == want.nqubit
        np.testing.assert_allclose(_np(got.get_unitary()), np.asarray(want.get_unitary()), rtol=0,
                                   atol=TOL[dtype])


def test_combined_single_gate_and_gate_flags():
    members = [(tapi.Rx(inputs=0.2, wires=0), japi.Rx(inputs=0.2, wires=0)),
               (tapi.Hadamard(wires=0), japi.Hadamard(wires=0)),
               (tapi.Rz(inputs=0.5, wires=0), japi.Rz(inputs=0.5, wires=0))]
    members[1][0].inv = members[1][1].inv = True
    got = tapi.CombinedSingleGate([m[0] for m in members], wires=1)
    want = japi.CombinedSingleGate([m[1] for m in members], wires=1)
    assert got.npara == want.npara == 2 and got.wires == (1,)
    np.testing.assert_allclose(_np(got.matrix()), np.asarray(want.matrix()), atol=1e-12)
    rz_rx = _np(tapi.Rz(inputs=0.5).matrix()) @ _np(tapi.Hadamard().matrix()) \
        @ _np(tapi.Rx(inputs=0.2).matrix())
    np.testing.assert_allclose(_np(got.matrix()), rz_rx, atol=1e-12)
    rx = tapi.Rx(wires=0)
    assert rx.requires_grad and len(rx.extra['inputs']) == 1
    assert not tapi.Rx(inputs=0.1).requires_grad
    with pytest.warns(UserWarning, match='den_mat'):
        tapi.Rx(inputs=0.1, den_mat=True)
    with pytest.raises(ValueError, match='expects 3'):
        tapi.U3Gate(inputs=[0.1, 0.2])
    b = tapi.Barrier(nqubit=3)
    assert b.kind == 'barrier' and b.wires == (0, 1, 2)


def test_class_built_circuit_matches_sugar_and_jax():
    def build(api, c):
        rx = api.Rx(inputs=0.3, wires=0)
        c.add(rx)
        c.add(api.CNOT(wires=[0, 1]))
        c.add(api.U3Gate(inputs=[0.1, 0.2, 0.3], wires=2, controls=1))
        c.add(api.RyLayer(nqubit=3, inputs=[0.4, 0.5, 0.6]))
        c.add(api.CnotRing(nqubit=3))
        c.add(api.HamiltonianGate(_HERM, t=0.3, wires=[1, 2]))
        c.add(rx)                                   # re-adding shares the parameter slice
        c.add(rx, wires=2)
    t, j = dqt.QubitCircuit(3), dq.QubitCircuit(3)
    build(tapi, t)
    build(japi, j)
    ref = dqt.QubitCircuit(3)
    ref.rx(0, inputs=0.3)
    ref.cnot(0, 1)
    ref.u3(2, inputs=[0.1, 0.2, 0.3], controls=1)
    ref.rylayer(inputs=[0.4, 0.5, 0.6])
    ref.cnot_ring()
    ref.hamiltonian(_HERM, t=0.3, wires=[1, 2])
    ref.rx(0, inputs=0.3)
    ref.rx(2, inputs=0.3)
    assert t.npara == j.npara
    got = _np(t.forward()).reshape(-1)
    np.testing.assert_allclose(got, _np(ref.forward()).reshape(-1), atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(j.forward()).reshape(-1), atol=1e-12)


def test_standalone_gate_call_and_matrix():
    h = tapi.Hadamard(wires=0, nqubit=1)
    out = h(np.array([1, 0], complex))
    assert torch.is_tensor(out) and out.device.type == 'cpu'
    np.testing.assert_allclose(_np(out), [2 ** -0.5, 2 ** -0.5], atol=1e-12)
    rx = tapi.Rx(inputs=0.7, wires=0)
    expected = np.array([[np.cos(0.35), -1j * np.sin(0.35)],
                         [-1j * np.sin(0.35), np.cos(0.35)]])
    np.testing.assert_allclose(_np(rx.matrix()), expected, atol=1e-12)
    rng = np.random.default_rng(3)
    psi = rng.normal(size=(2, 8)) + 1j * rng.normal(size=(2, 8))
    for tg, jg in [(tapi.CNOT(wires=[2, 0]), japi.CNOT(wires=[2, 0])),
                   (tapi.Rx(inputs=0.4, wires=1, controls=2), japi.Rx(inputs=0.4, wires=1,
                                                                      controls=2))]:
        got = tg(torch.as_tensor(psi))
        assert got.shape == (2, 8)
        np.testing.assert_allclose(_np(got), np.asarray(jg(psi)), atol=1e-12)
    with pytest.raises(ValueError, match='standalone'):
        tapi.BitFlip(inputs=[0.1])(np.array([1, 0], complex))


def test_layers_and_channels_in_circuits():
    cir = dqt.QubitCircuit(3)
    cir.add(tapi.RxLayer(nqubit=3, inputs=[0.1, 0.2, 0.3]))
    cir.add(tapi.CnotRing(nqubit=3))
    np.testing.assert_allclose(np.linalg.norm(_np(cir())), 1.0, atol=1e-12)
    t, j = dqt.QubitCircuit(2, den_mat=True), dq.QubitCircuit(2, den_mat=True)
    for den, api in ((t, tapi), (j, japi)):
        den.h(0)
        den.add(api.BitFlip(inputs=[0.2], wires=0))
        den.add(api.GeneralizedAmplitudeDamping(inputs=[0.3, 0.6], wires=1))
        den.cnot(0, 1)
    got, want = _np(t.forward()), np.asarray(j.forward())
    np.testing.assert_allclose(np.trace(got).real, 1.0, atol=1e-12)
    np.testing.assert_allclose(got, want.reshape(got.shape), atol=1e-12)
    with pytest.raises(ValueError, match='den_mat'):
        dqt.QubitCircuit(1).add(tapi.BitFlip(inputs=[0.2], wires=0))


def test_expectation_function():
    for dtype in ('complex128', 'complex64'):
        _set_dtype(dtype)
        t, j = dqt.QubitCircuit(3), dq.QubitCircuit(3)
        for c in (t, j):
            c.h(0)
            c.cnot(0, 1)
            c.ry(2, inputs=0.7)
            c.rx(1, inputs=0.3)
        st, jst = t(), j()
        for wires, basis in (([0, 1], 'zz'), ([0, 2], 'xz'), ([1], 'y')):
            got = tapi.expectation(st, dqt.Observable(3, wires=wires, basis=basis))
            want = japi.expectation(jst, dq.Observable(3, wires=wires, basis=basis))
            assert got.shape == ()
            np.testing.assert_allclose(float(got), float(want), atol=TOL[dtype])
        # a batch: one value a state (the JAX function takes one state)
        obs = dqt.Observable(3, wires=[1, 2], basis='yx')
        got = tapi.expectation(torch.stack([st, st.conj()]), obs)
        want = [japi.expectation(s, dq.Observable(3, wires=[1, 2], basis='yx'))
                for s in (np.asarray(jst), np.asarray(jst).conj())]
        assert got.shape == (2,)
        np.testing.assert_allclose(_np(got), np.array(want, np.float64), atol=TOL[dtype])
        td, jd = dqt.QubitCircuit(2, den_mat=True), dq.QubitCircuit(2, den_mat=True)
        for c in (td, jd):
            c.h(0)
            c.cnot(0, 1)
        obs = ([0, 1], 'zz')
        got = tapi.expectation(td(), dqt.Observable(2, *obs), den_mat=True)
        want = japi.expectation(jd(), dq.Observable(2, *obs), den_mat=True)
        np.testing.assert_allclose(float(got), float(want), atol=TOL[dtype])
        assert abs(float(got) - 1.0) < TOL[dtype]


def test_expectation_function_mps():
    def build(c):
        c.h(0)
        for i in range(3):
            c.cnot(i, i + 1)
        c.ry(2, inputs=0.4)
    cir = dqt.QubitCircuit(4, mps=True, chi=16)
    build(cir)
    tensors = cir()
    sv = dqt.QubitCircuit(4)
    build(sv)
    jcir = dq.QubitCircuit(4, mps=True, chi=16)
    build(jcir)
    jt = jcir()
    for wires, basis in (([0, 3], 'zz'), ([2], 'x'), ([1, 2], 'yz')):
        e_mps = tapi.expectation(list(tensors), dqt.Observable(4, wires=wires, basis=basis))
        sv.reset_observable()
        sv.observable(wires, basis=basis)
        want = japi.expectation(list(jt), dq.Observable(4, wires=wires, basis=basis))
        np.testing.assert_allclose(float(e_mps), float(sv.expectation()[0]), atol=1e-12)
        np.testing.assert_allclose(float(e_mps), float(want), atol=1e-12)


def test_photonic_class_style_matches_sugar():
    from deepquantum_tpu_torch.photonic import QumodeCircuit
    from deepquantum_tpu_torch.photonic import api as pa
    cir = QumodeCircuit(nmode=3, init_state=[1, 0, 1], cutoff=3, backend='fock', basis=True)
    cir.add(dqt.photonic.PhaseShift(inputs=0.3, wires=0))
    cir.add(pa.BeamSplitter(inputs=[0.4, 0.5], wires=[0, 1]))
    bst = pa.BeamSplitterTheta(inputs=0.7, wires=[1, 2])
    cir.add(bst)
    cir.add(pa.BeamSplitterPhi(inputs=0.2, wires=[0, 1]))
    cir.add(pa.BeamSplitterSingle(inputs=0.9, wires=[1, 2], convention='ry'))
    cir.add(pa.MZI(inputs=[0.1, 0.6], wires=[0, 1]))
    cir.add(pa.UAnyGate(np.linalg.qr(_RNG.normal(size=(2, 2)))[0], wires=[1, 2]))
    cir.add(pa.Barrier(nmode=3))
    cir.add(bst)
    ref = QumodeCircuit(nmode=3, init_state=[1, 0, 1], cutoff=3, backend='fock', basis=True)
    ref.ps(0, inputs=0.3)
    ref.bs([0, 1], inputs=[0.4, 0.5])
    ref.bs_theta([1, 2], inputs=0.7)
    ref.bs_phi([0, 1], inputs=0.2)
    ref.bs_ry([1, 2], inputs=0.9)
    ref.mzi([0, 1], inputs=[0.1, 0.6])
    ref.any(cir.operators[6].static_unitary, wires=[1, 2])
    ref.barrier()
    ref.bs_theta([1, 2], inputs=0.7)
    assert cir.npara == 8 and cir.npara == ref.npara - 1
    p1, p2 = cir(is_prob=True), ref(is_prob=True)
    assert set(p1) == set(p2)
    for k in p2:
        np.testing.assert_allclose(_np(p1[k]), _np(p2[k]), atol=1e-12)


def test_photonic_gaussian_class_style_and_loss():
    from deepquantum_tpu_torch.photonic import QumodeCircuit
    from deepquantum_tpu_torch.photonic import api as pa
    cir = QumodeCircuit(nmode=2, init_state='vac', cutoff=3, backend='gaussian')
    cir.add(pa.Squeezing(inputs=[0.5, 0.1], wires=0))
    cir.add(pa.Displacement(inputs=[0.3, 0.2], wires=1))
    cir.add(pa.BeamSplitter(inputs=[0.4, 0.5], wires=[0, 1]))
    cir.add(pa.PhotonLoss(inputs=[0.6], wires=1))
    ref = QumodeCircuit(nmode=2, init_state='vac', cutoff=3, backend='gaussian')
    ref.s(0, r=0.5, theta=0.1)
    ref.d(1, r=0.3, theta=0.2)
    ref.bs([0, 1], inputs=[0.4, 0.5])
    ref.loss(1, inputs=[0.6])
    for a, b in zip(cir(), ref()):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-12)


def test_photonic_delay_class_matches_sugar():
    from deepquantum_tpu_torch.photonic import QumodeCircuitTDM
    from deepquantum_tpu_torch.photonic import api as pa
    covs = []
    for use_api in (True, False):
        t = QumodeCircuitTDM(nmode=1, init_state='vac', cutoff=3)
        t.s(0, r=0.5)
        if use_api:
            t.add(pa.DelayBS(inputs=[0.4, 0.2], wires=0, ntau=2))
            t.add(pa.DelayMZI(inputs=[0.3, 0.1], wires=0, ntau=1))
        else:
            t.delay(0, ntau=2, inputs=(0.4, 0.2))
            t.delay(0, ntau=1, inputs=(0.3, 0.1), convention='mzi')
        t.homodyne_x(0)
        covs.append(_np(t.get_symplectic()))
    np.testing.assert_allclose(covs[0], covs[1], atol=1e-12)
    with pytest.raises(ValueError, match='convention'):
        pa.Delay(convention='loop')
