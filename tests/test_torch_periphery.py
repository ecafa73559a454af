"""The port's qubit toolchain against the JAX package, on the CPU at
complex128: QASM 2 / 3 export (the same text for the same circuit, carried
across by ``from_jax``), QASM 3 import (the state of the imported circuit
against the JAX import's, 1e-10 unless a test says otherwise), the text
drawing (character for character), the gradient-free optimizers (the same
trajectory at the same ``random_state`` on a numpy loss, and convergence
on a circuit's), parameter files written by either package and read by
the other, training-state checkpoints and the timing helpers.
"""

import importlib.util

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import optimizer as jopt
from deepquantum_tpu import qasm as jqasm
from deepquantum_tpu_torch import optimizer as topt
from deepquantum_tpu_torch import qasm as tqasm

torch.set_num_threads(1)
ATOL = 1e-10


@pytest.fixture(autouse=True)
def _cpu_c128():
    """The port's default device is the card and its default dtype
    complex64: these tests ask for the CPU and complex128."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _bench(n=4, layers=2):
    cir = dq.QubitCircuit(n)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    return cir


def _build(cir):
    cir.h(0)
    cir.rx(1, inputs=0.3)
    cir.u3(2, inputs=[0.1, 0.2, 0.3])
    cir.cnot(0, 1)
    cir.cp(1, 2, inputs=0.5)
    cir.crz(0, 2, inputs=0.7)
    cir.rzz([0, 1], inputs=0.4)
    cir.toffoli(0, 1, 2)
    cir.swap([1, 2])
    cir.barrier()
    cir.any(np.array([[0, 1j], [1j, 0]]) * np.exp(0.3j), wires=1)
    cir.any(np.diag([1, np.exp(0.4j)]), wires=2, controls=0)


def _fuzz(seed, n=4):
    """The JAX package's randomised circuit family over the exportable gate
    pool (tests/test_periphery.py::test_qasm3_roundtrip_fuzz)."""
    rng = np.random.default_rng(seed)
    one_q = ['h', 'x', 'y', 'z', 's', 't', 'sdg', 'tdg']
    rot_1q = ['rx', 'ry', 'rz', 'p']
    two_q = ['cnot', 'cz', 'cy', 'ch', 'swap']
    rot_2q = ['rxx', 'ryy', 'rzz']
    cir = dq.QubitCircuit(n)
    for _ in range(12):
        kind = rng.integers(0, 6)
        if kind == 0:
            getattr(cir, str(rng.choice(one_q)))(int(rng.integers(n)))
        elif kind == 1:
            getattr(cir, str(rng.choice(rot_1q)))(int(rng.integers(n)),
                                                 inputs=float(rng.random() * 2 * np.pi))
        elif kind == 2:
            a, b = rng.choice(n, 2, replace=False)
            g = str(rng.choice(two_q))
            if g == 'swap':
                cir.swap([int(a), int(b)])
            else:
                getattr(cir, g)(int(a), int(b))
        elif kind == 3:
            a, b = rng.choice(n, 2, replace=False)
            getattr(cir, str(rng.choice(rot_2q)))([int(a), int(b)], inputs=float(rng.random()))
        elif kind == 4:
            a, b, c = rng.choice(n, 3, replace=False)
            cir.toffoli(int(a), int(b), int(c))
        else:
            cir.u3(int(rng.integers(n)), inputs=list(rng.random(3) * np.pi))
    return cir


def _ansatz():
    from deepquantum_tpu.models import (HHL, QuantumFourierTransform,
                                        QuantumPhaseEstimationSingleQubit)
    return [QuantumFourierTransform(4), QuantumPhaseEstimationSingleQubit(3, 0.375),
            HHL(2, np.array([[2.0, 1.0], [1.0, 2.0]]))]


def _circuits():
    named = [('bench', _bench()), ('mixed', dq.QubitCircuit(3))]
    _build(named[1][1])
    named += [(f'fuzz{seed}', _fuzz(seed)) for seed in (17, 18, 19)]
    named += [(type(c).__name__, c) for c in _ansatz()]
    return named


@pytest.fixture(scope='module')
def circuits():
    dq.set_dtype('complex128')
    return _circuits()


def test_qasm_and_drawing_text_equal_the_jax_package(circuits):
    for label, j in circuits:
        t = dqt.from_jax(j, device='cpu')
        assert tqasm.cir_to_qasm3(t) == jqasm.cir_to_qasm3(j), label
        assert t.qasm3() == j.qasm3(), label
        assert t.draw(output='str') == j.draw(output='str'), label
        if label != 'mixed' and 'HHL' not in label and 'Phase' not in label:
            assert t.qasm() == j.qasm(), label
    t = dqt.from_jax(circuits[1][1], device='cpu')
    with pytest.raises(ValueError, match='NOT supported'):
        t.qasm()                                    # a fixed matrix has no QASM 2 name


def test_qasm2_export_and_measure_lines():
    t, j = dqt.QubitCircuit(3), dq.QubitCircuit(3)
    for c in (t, j):
        c.h(0)
        c.cnot(0, 1)
        c.rx(2, inputs=0.25)
        c.crz(0, 2, inputs=0.125)
        c.ccx(0, 1, 2)
    t.measure(wires=[0, 2])
    j.measure(wires=[0, 2])
    assert t.qasm() == j.qasm() and t.qasm3() == j.qasm3()
    assert 'measure q[2] -> c[2];' in t.qasm() and 'c[0] = measure q[0];' in t.qasm3()
    assert t.qasm().startswith('OPENQASM 2.0;') and 'cx q[0],q[1];' in t.qasm()
    assert 'rx(0.25) q[2];' in t.qasm() and 'ccx q[0],q[1],q[2];' in t.qasm()


def test_qasm3_import_matches_the_jax_import(circuits):
    for label, j in circuits:
        text = j.qasm3()
        got = tqasm.qasm3_to_cir(text)
        want = jqasm.qasm3_to_cir(text)
        assert type(got) is dqt.QubitCircuit and got.device.type == 'cpu'
        assert [op.name for op in got.operators] == [op.name for op in want.operators], label
        np.testing.assert_allclose(_np(got.forward()), np.asarray(want.forward()), atol=ATOL,
                                   err_msg=label)
        # and the round trip keeps the state
        np.testing.assert_allclose(_np(got.forward()).reshape(-1),
                                   np.asarray(j.forward()).reshape(-1), atol=1e-8, err_msg=label)


GATE_DEFS = '''
OPENQASM 3.0;
include "stdgates.inc";
qubit[3] q;
bit[3] c;
gate my_rot(theta, phi) a { rx(theta) a; rz(phi) a; }
gate bell a, b { h a; cx a, b; }
gate nested(ang) a, b { my_rot(ang, ang/2) a; bell a, b; }
my_rot(0.3, 0.7) q[0];
bell q[0], q[1];
ctrl @ my_rot(0.5, 0.1) q[2], q[1];
inv @ bell q[1], q[2];
nested(pi/4) q[0], q[2];
pow(2) @ my_rot(0.2, 0.4) q[1];
inv @ s q[0];
ctrl @ ctrl @ x q[0], q[1], q[2];
gphase(0.25);
inv @ u(0.1, 0.2, 0.3) q[2];
barrier q[0], q[1];
c[1] = measure q[1];
'''
POW_NONINT = '''
OPENQASM 3.0;
qubit[2] q;
pow(0.5) @ x q[0];
pow(0.5) @ x q[0];
pow(0.25) @ cx q[1], q[0];
ctrl @ pow(1.5) @ h q[0], q[1];
'''


@pytest.mark.parametrize('text', [GATE_DEFS, POW_NONINT], ids=['gate_definitions', 'pow'])
def test_qasm3_import_programs(text):
    got, want = tqasm.qasm3_to_cir(text), jqasm.qasm3_to_cir(text)
    assert got.wires_measure == want.wires_measure
    assert [op.name for op in got.operators] == [op.name for op in want.operators]
    np.testing.assert_allclose(_np(got.get_unitary()), np.asarray(want.get_unitary()), atol=ATOL)
    np.testing.assert_allclose(_np(got.forward()), np.asarray(want.forward()), atol=ATOL)


@pytest.mark.parametrize('text, match', [
    ('qubit[1] q;\nrx(__import__) q[0];', 'Disallowed token'),
    ('qubit[1] q;\nrx(pi.real) q[0];', 'Disallowed token'),
    ('qubit[1] q;\nrx(1;2) q[0];', 'Cannot resolve'),
    ('qubit[1] q;\nrx(pi % 2) q[0];', 'Disallowed character'),
    ('rx(0.1) q[0];', 'No qubit register'),
    ('qubit[2] q;\nnegctrl @ x q[0], q[1];', 'negctrl'),
    ('qubit[2] q;\ngate g(a) x { rx(a) x; }\ng(0.1, 0.2) q[0];', 'expects 1 params'),
    ('qubit[2] q;\nfoo q[0];', 'Unsupported QASM gate'),
])
def test_qasm3_import_refuses_bad_text(text, match):
    """The importer evaluates expressions from outside the program: what it
    does not understand raises ValueError (also under python -O)."""
    with pytest.raises(ValueError, match=match):
        tqasm.qasm3_to_cir(text)


def test_qasm3_pow_half_twice_is_x():
    cir = dqt.qasm3_to_cir('OPENQASM 3.0;\nqubit[1] q;\npow(0.5) @ x q[0];\npow(0.5) @ x q[0];')
    np.testing.assert_allclose(_np(cir.get_unitary()), [[0, 1], [1, 0]], atol=1e-12)


def test_draw_text():
    cir = dqt.QubitCircuit(3)
    cir.h(0)
    cir.cnot(0, 2)
    cir.rx(1, inputs=0.3)
    cir.cz(1, 2)
    text = cir.draw(output='str')
    assert text.splitlines()[0].startswith('q0: ') and 'H' in text and 'CX' in text
    assert len(text.splitlines()) == 3


# ---------------------------------------------------------------- optimizers
def _numpy_loss(x):
    x = np.asarray(x, np.float64)
    return float(np.sum(np.sin(x) + 0.3 * np.cos(2 * x + 0.1)) + 0.05 * np.sum(x ** 2))


def _trajectory(mod, cls, steps, **kw):
    opt = getattr(mod, cls)(_numpy_loss, [0.4, -1.2, 2.0], **kw)
    path = []
    for _ in range(steps):
        probes = opt.param_suggest()
        opt.param_register(probes, np.array([_numpy_loss(p) for p in probes]))
        path.append(opt.params.copy())
    return np.array(path), opt


@pytest.mark.parametrize('cls, kw', [('OptimizerSPSA', dict(random_state=7)),
                                     ('OptimizerFourier', dict(order=3, lr=0.05))])
def test_optimizer_trajectory_equals_the_jax_package(cls, kw):
    got, t = _trajectory(topt, cls, 40, **kw)
    want, j = _trajectory(jopt, cls, 40, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    assert t.best_target == j.best_target and t.iter == j.iter == 40
    assert t.param_dict.keys() == j.param_dict.keys()
    np.testing.assert_allclose(list(t.best_param_dict.values()), list(j.best_param_dict.values()),
                               atol=1e-10)


def test_spsa_run_converges_on_a_circuit():
    cir = dqt.QubitCircuit(1)
    cir.rx(0)
    cir.observable(0)

    def target(params):
        return float(cir.expectation(params=np.asarray(params))[0])

    opt = topt.OptimizerSPSA(target, [2.0], random_state=0)
    best = opt.run(400)
    assert target(best) < -0.9
    jopt_ = jopt.OptimizerSPSA(target, [2.0], random_state=0)
    np.testing.assert_allclose(best, jopt_.run(400), atol=1e-10)


def test_fourier_run_converges_on_a_circuit():
    cir = dqt.QubitCircuit(1)
    cir.ry(0)
    cir.observable(0)

    def target(params):
        return float(cir.expectation(params=np.asarray(params))[0])

    opt = topt.OptimizerFourier(target, [1.0], order=2, lr=0.2)
    opt.run(30)
    assert target(list(opt.param_dict.values())) < -0.95


def test_bayesian_needs_bayes_opt():
    if importlib.util.find_spec('bayes_opt') is None:
        with pytest.raises(ImportError, match='bayes_opt'):
            topt.OptimizerBayesian(_numpy_loss, [0.1, 0.2])
    else:
        opt = topt.OptimizerBayesian(_numpy_loss, [0.1, 0.2])
        assert len(opt.run(3)) == 2


# ----------------------------------------------------------- parameter files
def test_parameter_files_cross_both_packages(tmp_path):
    from deepquantum_tpu.utils import load_params as jload
    from deepquantum_tpu.utils import save_params as jsave
    from deepquantum_tpu_torch.utils import load_params, save_params

    def build(c):
        c.rx(0, encode=True)
        for w in range(3):
            c.ry(w)
            c.rz(w, inputs=0.1 * w)
        c.cnot_ring()
        c.observable(0)

    np.random.seed(4)
    j = dq.QubitCircuit(3)
    build(j)
    t = dqt.QubitCircuit(3)
    build(t)                          # other random values
    data = np.array([0.6])
    fj, ft = str(tmp_path / 'jax.npz'), str(tmp_path / 'torch.npz')
    jsave(j, fj)
    load_params(t, fj)
    np.testing.assert_allclose(_np(t.forward(data=data)), np.asarray(j.forward(data)), atol=ATOL)
    t.init_para(3)
    save_params(t, ft)
    with np.load(ft) as f:
        assert set(f.files) == {'pvals', 'train_mask', 'enc_pidx'}
        assert f['pvals'].dtype == np.float64 and f['enc_pidx'].dtype == np.int64
    jload(j, ft)
    np.testing.assert_allclose(_np(t.forward(data=data)), np.asarray(j.forward(data)), atol=ATOL)
    with pytest.raises(ValueError, match='parameters'):
        load_params(dqt.QubitCircuit(1), ft)


def test_train_state_checkpoint(tmp_path):
    from deepquantum_tpu_torch.utils import load_train_state, save_train_state
    cir = dqt.QubitCircuit(3)
    for w in range(3):
        cir.rx(w)
    cir.cnot_ring()
    cir.observable(0)
    p = cir.params.requires_grad_()
    opt = torch.optim.Adam([p], lr=0.1)
    for _ in range(3):
        opt.zero_grad()
        cir.expectation(params=p)[0].backward()
        opt.step()
    path = tmp_path / 'state.pt'
    save_train_state(path, {'params': p, 'opt': opt, 'step': 3})
    raw = load_train_state(path)
    assert raw['step'] == 3 and torch.equal(raw['params'], p.detach())
    q = torch.zeros_like(p).requires_grad_()
    opt2 = torch.optim.Adam([q], lr=0.1)
    got = load_train_state(path, {'params': q, 'opt': opt2, 'step': 0})
    assert got['step'] == 3 and got['opt'] is opt2 and got['params'].requires_grad
    assert torch.equal(got['params'].detach(), p.detach())
    assert opt2.state_dict()['state'][0]['step'] == opt.state_dict()['state'][0]['step']


def test_timing_helpers(capsys):
    from deepquantum_tpu_torch.utils import Time, record_time

    @record_time
    def square(x):
        return x * x

    assert square(3) == 9
    with Time('block') as t:
        square(2)
    out = capsys.readouterr().out
    assert out.count('square: ') == 2 and 'block: ' in out and t.elapsed >= 0
