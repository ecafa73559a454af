"""The port's MBQC patterns against the JAX package, on the CPU at
complex128.

- ``QubitCircuit.pattern()``'s command list (names, nodes, angles, planes,
  domains, correction bases) equal to the JAX package's, before and after
  ``standardize`` and ``shift_signals``;
- the pattern's output state against the circuit's state (overlap
  >= 1 - 1e-8) at several generator seeds, and against the JAX package's
  pattern output, for the cases of the JAX package's ``tests/test_mbqc.py``:
  single-qubit gates, CNOT, random circuits, teleportation, a
  standardised pattern, data encoding; the outcomes are random, the output
  state is not (the corrections undo the byproducts);
- a pattern built by hand in the JAX package, carried across by
  ``pattern_from_jax``, giving the same output.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.mbqc import Pattern as JPattern
from deepquantum_tpu_torch.mbqc import Pattern

torch.set_num_threads(1)
BAR = 1 - 1e-8
SEEDS = (0, 1, 2)


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


def _overlap(psi, phi):
    psi = psi.detach().cpu().numpy().reshape(-1) if torch.is_tensor(psi) else \
        np.asarray(psi).reshape(-1)
    phi = phi.detach().cpu().numpy().reshape(-1) if torch.is_tensor(phi) else \
        np.asarray(phi).reshape(-1)
    return abs(np.vdot(psi, phi)) / (np.linalg.norm(psi) * np.linalg.norm(phi))


def _commands(pattern):
    """Each command as a plain tuple, comparable across the packages."""
    out = []
    for c in pattern.commands:
        kind = type(c).__name__
        if kind == 'Measurement':
            out.append((kind, tuple(c.nodes), round(float(c.angle), 12), c.plane,
                        tuple(sorted(c.s_domain)), tuple(sorted(c.t_domain)), c.enc_sign))
        elif kind == 'Correction':
            out.append((kind, tuple(c.nodes), c.basis, tuple(sorted(c.domain))))
        else:
            out.append((kind, tuple(c.nodes)))
    return out


def _random_build(seed, n=3):
    """The JAX package's random family (tests/test_mbqc.py:58)."""
    angles = np.random.default_rng(seed).random((2, n)) * 2 * np.pi

    def build(c):
        for i in range(n):
            c.rx(i, inputs=float(angles[0, i]))
        c.cnot(0, 1)
        for i in range(n):
            c.rz(i, inputs=float(angles[1, i]))
        c.cnot(1, 2)
        c.h(0)
    return build


def _single(gate):
    def build(c):
        c.ry(0, inputs=0.4)
        if gate in ('rx', 'ry', 'rz'):
            getattr(c, gate)(0, inputs=0.3 + 0.4 * ('rx', 'ry', 'rz').index(gate))
        else:
            getattr(c, gate)(0)
    return build


def _cnot(c):
    c.h(0)
    c.ry(1, inputs=0.9)
    c.cnot(0, 1)


CIRCUITS = {**{g: (1, _single(g)) for g in ('h', 'x', 'y', 'z', 's', 'rx', 'ry', 'rz')},
            'cnot': (2, _cnot), 'random0': (3, _random_build(5)), 'random1': (3, _random_build(6)),
            'toffoli': (3, lambda c: (c.h(0), c.h(1), c.toffoli(0, 1, 2)))}


def _pair(key):
    n, build = CIRCUITS[key]
    np.random.seed(0)
    t, j = dqt.QubitCircuit(n), dq.QubitCircuit(n)
    build(t)
    np.random.seed(0)
    build(j)
    return t, j


@pytest.mark.parametrize('key', ['h', 'y', 'rx', 'cnot', 'random0', 'toffoli'])
def test_command_lists_equal_the_jax_package(key):
    t, j = _pair(key)
    tp, jp = t.pattern(), j.pattern()
    assert _commands(tp) == _commands(jp)
    assert (tp.npara, tp.ndata, tp.nodes_out_seq) == (jp.npara, jp.ndata, jp.nodes_out_seq)
    assert not tp.is_standard() or key == 'toffoli'
    tp.standardize()
    jp.standardize()
    assert tp.is_standard() and _commands(tp) == _commands(jp)
    tp.shift_signals()
    jp.shift_signals()
    assert _commands(tp) == _commands(jp)


@pytest.mark.parametrize('key', sorted(CIRCUITS))
def test_pattern_output_equals_the_circuit(key):
    t, j = _pair(key)
    target = t.forward()
    seeds = SEEDS if key != 'toffoli' else SEEDS[:1]
    for seed in seeds:
        gen = torch.Generator().manual_seed(seed)
        pat = t.pattern(generator=gen)
        out = pat()
        assert out.full_state.device.type == 'cpu'
        assert _overlap(out.full_state, target) >= BAR, (key, seed)
        pat.standardize()
        assert _overlap(pat().full_state, target) >= BAR, (key, seed, 'standard')
        pat.shift_signals()
        assert _overlap(pat().full_state, target) >= BAR, (key, seed, 'shifted')
    np.random.seed(seeds[0])
    jstate = j.pattern()().full_state
    assert _overlap(pat().full_state, jstate) >= BAR


def test_outcomes_follow_the_generator():
    t, _ = _pair('random0')
    pat = t.pattern()
    pat.standardize()
    runs = []
    for seed in (3, 3, 4):
        pat.generator = torch.Generator().manual_seed(seed)
        g = pat()
        runs.append({k: [int(b) for b in v] for k, v in g.measure_dict.items()})
        assert all(torch.is_tensor(b) for v in g.measure_dict.values() for b in v)
    assert runs[0] == runs[1]
    assert len(runs[0]) == sum(type(c).__name__ == 'Measurement' for c in pat.commands)


def test_teleportation_and_standardize():
    for mod, cls in ((dqt, Pattern), (dq, JPattern)):
        pattern = cls(nodes_state=[0], state='zero')
        pattern.n(1)
        pattern.e(0, 1)
        pattern.m(0, angle=0.0)
        pattern.x(1, domain=0)
        state = pattern().full_state
        assert _overlap(state, np.array([1, 1]) / np.sqrt(2)) >= BAR      # H|0> = |+>
    outs = []
    for cls, kw in ((Pattern, dict(generator=torch.Generator().manual_seed(1))), (JPattern, {})):
        pattern = cls(nodes_state=[0], state='plus', **kw)
        pattern.n(1)
        pattern.e(0, 1)
        pattern.m(0, angle=0.3)
        pattern.x(1, domain=0)
        pattern.n(2)
        pattern.e(1, 2)
        pattern.m(1, angle=0.1)
        pattern.x(2, domain=1)
        assert not pattern.is_standard()
        pattern.standardize()
        assert pattern.is_standard()
        outs.append(pattern().full_state)
    np.testing.assert_allclose(np.linalg.norm(outs[0].numpy()), 1.0, atol=1e-12)
    assert _overlap(outs[0], outs[1]) >= BAR


def test_encode_data_transpile():
    def build(c):
        c.rx(0, encode=True)
        c.rz(0, encode=True)
        c.ry(1, encode=True)
        c.cnot(0, 1)

    data = np.array([0.4, 0.9, 1.3])
    np.random.seed(0)
    t, j = dqt.QubitCircuit(2), dq.QubitCircuit(2)
    build(t)
    build(j)
    target = t(data=data)
    tp, jp = t.pattern(generator=torch.Generator().manual_seed(0)), j.pattern()
    assert (tp.ndata, tp.npara) == (jp.ndata, jp.npara) == (3, 7)
    for d in (data, torch.as_tensor(data)):
        assert _overlap(tp(d).full_state, target) >= BAR
    jp(data)
    assert _commands(tp) == _commands(jp)       # both now hold the data's angles
    re = dqt.QubitCircuit(1, reupload=True)
    re.rx(0, encode=True)
    re.rz(0, encode=True)
    p = re.pattern(generator=torch.Generator().manual_seed(0))
    assert p.reupload
    assert _overlap(p([0.7]).full_state, re(data=[0.7])) >= BAR
    with pytest.raises(ValueError, match='more data'):
        t.pattern()([0.1])


def test_pattern_from_jax_gives_the_same_output():
    # two J steps in the XY plane on an entangled input, each byproduct
    # corrected: the output does not depend on the outcomes
    jp = JPattern(nodes_state=[0, 1], state=np.array([0.6, 0.0, 0.0, 0.8]))
    jp.n([2, 3])
    jp.e(0, 2)
    jp.m(0, angle=0.7)
    jp.x(2, domain=[0])
    jp.e(1, 3)
    jp.e(2, 3)
    jp.m(1, angle=0.2)
    jp.x(3, domain=[1])
    jp.z(2, domain=[1])
    jp.set_nodes_out_seq([3, 2])
    tp = dqt.pattern_from_jax(jp, device='cpu', generator=torch.Generator().manual_seed(0))
    assert _commands(tp) == _commands(jp) and tp.nodes_out_seq == [3, 2]
    assert tp.init_state.subgraphs[0].nodes_state == [0, 1]
    want = jp().full_state
    for seed in SEEDS:
        tp.generator = torch.Generator().manual_seed(seed)
        assert _overlap(tp().full_state, want) >= BAR
    # a transpiled circuit's pattern, carried across
    t, j = _pair('random1')
    tp = dqt.pattern_from_jax(j.pattern(), device='cpu')
    assert _commands(tp) == _commands(t.pattern())
    assert _overlap(tp().full_state, t.forward()) >= BAR


def test_graph_state_full_state_and_compose():
    rng = np.random.default_rng(2)
    psi = rng.normal(size=4) + 1j * rng.normal(size=4)
    edges = [(1, 4), (2, 3), (0, 3), (1, 2, {'cz': False})]
    tg = dqt.SubGraphState(nodes_state=[3, 1], state=psi, edges=edges, nodes=[5])
    from deepquantum_tpu.mbqc import SubGraphState as JSub
    jg = JSub(nodes_state=[3, 1], state=psi, edges=edges, nodes=[5])
    np.testing.assert_allclose(tg.full_state.numpy(), np.asarray(jg.full_state), atol=1e-12)
    assert tg.node2wire_dict == jg.node2wire_dict
    other_t = dqt.SubGraphState(nodes_state=[0], state='minus', edges=[(0, 1)])
    other_j = JSub(nodes_state=[0], state='minus', edges=[(0, 1)])
    ct, cj = tg.compose(other_t), jg.compose(other_j)
    assert list(ct.nodes) == list(cj.nodes) and ct.edges == cj.edges
    np.testing.assert_allclose(ct.full_state.numpy(), np.asarray(cj.full_state), atol=1e-12)
    gs = dqt.GraphState(nodes_state=[0], state='zero')
    gs.add_subgraph(nodes=[1, 2])
    assert gs.node_set() == {0, 1, 2} and gs.find_subgraph(2) == 1 and gs.find_subgraph(7) == -1
    assert gs.full_state.shape == (8, 1)
