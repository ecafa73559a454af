"""The port's circuit cutting against the JAX package, on the CPU at
complex128 (1e-10 unless a test says otherwise): the subexperiments of a
cut circuit carried across by ``from_jax`` (their number, widths, op
names, coefficients and expectation values), the reconstruction against
the uncut circuit (the oracle-free cases of the JAX package's
``tests/test_cutting.py``, and two cuts into two fragments),
``partition_labels``, and ``transform_cut2move``.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import cutting as jcut
from deepquantum_tpu_torch import cutting as tcut

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


def _reconstruct(subexperiments, coefficients):
    """sum_k coeff_k prod_fragments <O>_k (the product of a fragment's
    observables' values)."""
    total = 0.0
    for k, coeff in enumerate(coefficients):
        prod = 1.0
        for subs in subexperiments.values():
            cir = subs[k]
            if cir.observables:
                cir()
                prod *= float(np.prod(np.asarray(cir.expectation())))
        total += coeff * prod
    return total


def _one_cut(c):
    c.rx(0, inputs=0.3)
    c.ry(1, inputs=0.8)
    c.cnot(0, 1)
    c.cut(1)
    c.rz(1, inputs=0.5)
    c.rx(1, inputs=0.2)


def _two_observables(c):
    c.h(0)
    c.cnot(0, 1)
    c.cut(1)
    c.ry(1, inputs=0.7)


def _two_cuts(c, m=3):
    """Two halves of m wires joined by a cnot each way across the middle,
    the two crossing wires cut: two fragments of m + 1 wires."""
    n = 2 * m
    rng = np.random.default_rng(11)
    for w in range(n):
        c.rx(w, inputs=float(rng.random() * 6))
        c.rz(w, inputs=float(rng.random() * 6))
    c.cnot(m - 1, m)
    c.cut(m)
    for w in range(m):
        c.cnot(w, (w + 1) % m)
        c.cnot(m + w, m + (w + 1) % m)
    c.cut(m - 1)
    c.cnot(m, m - 1)
    for w in range(n):
        c.ry(w, inputs=float(rng.random() * 6))


CASES = {
    'one_cut': (2, _one_cut, [([1], 'z')]),
    'two_observables': (2, _two_observables, [([0], 'z')]),
    'two_cuts': (6, _two_cuts, [([0, 2, 3, 5], 'zxzy')]),
}


def _pair(key):
    n, build, obs = CASES[key]
    j = dq.QubitCircuit(n)
    build(j)
    for wires, basis in obs:
        j.observable(wires, basis=basis)
    return dqt.from_jax(j), j


def _uncut(key):
    n, build, obs = CASES[key]
    u = dqt.QubitCircuit(n)
    build(u)
    u.operators = [op for op in u.operators if op.kind != 'cut']
    u._touch()
    for wires, basis in obs:
        u.observable(wires, basis=basis)
    u()
    return float(u.expectation()[0])


@pytest.mark.parametrize('key', sorted(CASES))
def test_subexperiments_equal_the_jax_package(key):
    t, j = _pair(key)
    assert t._cut_lst == j._cut_lst
    tsub, tco = t.get_subexperiments()
    jsub, jco = j.get_subexperiments()
    assert tco == jco and len(tco) == 8 ** len(t._cut_lst)
    assert sorted(tsub) == sorted(jsub)
    for label in tsub:
        assert len(tsub[label]) == len(tco)
        # every term of one cut; of two cuts the terms (0, 0), (2, 2), (5, 5)
        # and (7, 7) (each JAX circuit is a compile)
        for k in (range(len(tco)) if len(tco) == 8 else (0, 18, 45, 63)):
            tc, jc = tsub[label][k], jsub[label][k]
            assert tc.nqubit == jc.nqubit and tc.device.type == 'cpu'
            assert [(op.name, op.wires, op.controls) for op in tc.operators] == \
                   [(op.name, tuple(op.wires), tuple(op.controls)) for op in jc.operators]
            assert [(o.wires, o.basis) for o in tc.observables] == \
                   [(o.wires, o.basis) for o in jc.observables]
            if tc.observables:
                tc()
                jc()
                np.testing.assert_allclose(np.asarray(tc.expectation()),
                                           np.asarray(jc.expectation()), atol=ATOL)


@pytest.mark.parametrize('key', sorted(CASES))
def test_reconstruction_equals_the_uncut_circuit(key):
    t, _ = _pair(key)
    sub, co = t.get_subexperiments()
    np.testing.assert_allclose(_reconstruct(sub, co), _uncut(key), atol=ATOL)
    # a circuit cut through the port's own API gives the same
    n, build, obs = CASES[key]
    own = dqt.QubitCircuit(n)
    build(own)
    for wires, basis in obs:
        own.observable(wires, basis=basis)
    sub2, co2 = own.get_subexperiments()
    assert co2 == co
    np.testing.assert_allclose(_reconstruct(sub2, co2), _uncut(key), atol=ATOL)


def test_two_cuts_fragments():
    t, _ = _pair('two_cuts')
    sub, co = t.get_subexperiments()
    assert len(co) == 64 and sorted(len(v) for v in sub.values()) == [64, 64]
    assert sorted(c.nqubit for c in (sub[0][0], sub[1][0])) == [4, 4]


def test_partition_labels():
    def labels(mod, c, **kw):
        return mod.partition_labels([mod._IROp(op, c._pvals) for op in c.operators], 5, **kw)

    t, j = dqt.QubitCircuit(5), dq.QubitCircuit(5)
    for c in (t, j):
        c.cnot(0, 1)
        c.cnot(3, 2)
    assert labels(tcut, t) == labels(jcut, j) == [0, 0, 1, 1, None]
    assert labels(tcut, t, keep_idle_wires=True) == labels(jcut, j, keep_idle_wires=True) \
        == [0, 0, 1, 1, 2]
    for c in (t, j):
        c.barrier()                 # no edge, but the wires are no longer idle
        c.rzz([4, 0], inputs=0.1)
    assert labels(tcut, t) == labels(jcut, j) == [0, 0, 1, 1, 0]


def test_transform_cut2move_simulates_the_cut():
    for key in ('one_cut', 'two_cuts'):
        t, j = _pair(key)
        moved = t.transform_cut2move()
        jmoved = j.transform_cut2move()
        assert moved.nqubit == jmoved.nqubit == t.nqubit + len(t._cut_lst)
        assert [op.kind for op in moved.operators] == [op.kind for op in jmoved.operators]
        assert sum(op.kind == 'move' for op in moved.operators) == len(t._cut_lst)
        moved()
        jmoved()
        np.testing.assert_allclose(float(moved.expectation()[0]), _uncut(key), atol=ATOL)
        np.testing.assert_allclose(float(moved.expectation()[0]),
                                   float(jmoved.expectation()[0]), atol=ATOL)
    cut = dqt.QubitCircuit(2)
    cut.rx(0, inputs=0.3)
    cut.cnot(0, 1)
    cut.cut(1)
    cut.ry(1, inputs=0.7)
    cut.observable(1)
    moved = cut.transform_cut2move()
    assert moved.nqubit == 3 and any(o.kind == 'move' for o in moved.operators)
    moved()
    np.testing.assert_allclose(float(moved.expectation()[0]), float(cut.expectation()[0]),
                               atol=ATOL)


def test_a_gate_across_fragments_is_refused():
    cir = dqt.QubitCircuit(3)
    cir.cnot(0, 1)
    cir.cnot(1, 2)
    cir.observable(0)
    with pytest.raises(ValueError, match='wire cuts'):
        tcut.get_subexperiments(cir, qubit_labels=[0, 0, 1])
