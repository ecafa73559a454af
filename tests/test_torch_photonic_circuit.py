"""PyTorch port vs the JAX package: the photonic sampling path as a whole.

Gates, the global unitary and symplectic, the Clements decomposition,
circuits carried across with ``qumode_from_jax``, and the two user calls of
the slice: boson sampling on the Fock backend in basis mode (one permanent
per outcome) and Gaussian boson sampling (the click patterns' torontonians
in one batched call per click count, a hafnian per photon pattern). Both
packages run their complex128 policy on the CPU, where the port's kernel
wrappers take their plain twins, so values are held to 1e-8 (they agree to
about 1e-14); the click tables against the JAX package's vmapped
torontonian to 1e-9.
"""

import itertools
from math import comb

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import photonic as jph
from deepquantum_tpu.photonic import gates as jgates
from deepquantum_tpu.photonic import gaussian_prob as jgp
from deepquantum_tpu.photonic import torontonian_ as jtor
from deepquantum_tpu_torch import photonic as tph
from deepquantum_tpu_torch.ops import permanent_kernel as pk
from deepquantum_tpu_torch.photonic import gates as tgates

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU,
    and both packages run their complex128 policy."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _haar(n, rng):
    z = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _table(out: dict) -> dict:
    """{photon numbers: value} of a forward's dict, as numpy."""
    return {tuple(int(v) for v in k.state): np.asarray(v).reshape(-1) for k, v in out.items()}


def _tables_close(got: dict, want: dict, atol: float):
    got, want = _table(got), _table(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=str(k))


# ---------------------------------------------------------------------- gates
UNITARY_GATES = [('ps_unitary', 1, {}), ('bs_unitary', 2, {}), ('mzi_unitary', 2, {}),
                 ('mzi_unitary', 2, {'phi_first': False}),
                 ('bs_single_unitary', 1, {'convention': 'rx'}),
                 ('bs_single_unitary', 1, {'convention': 'ry'}),
                 ('bs_single_unitary', 1, {'convention': 'h'})]
XP_GATES = [('ps_xp', 1), ('squeeze_xp', 2), ('squeeze2_xp', 2), ('disp_xp', 2),
            ('disp_position_xp', 1), ('disp_momentum_xp', 1)]


@pytest.mark.parametrize('name,npara,kwargs', UNITARY_GATES)
def test_gate_unitaries_match_jax(name, npara, kwargs):
    p = np.random.default_rng(len(name) + npara).uniform(0, 2 * np.pi, npara)
    got = getattr(tgates, name)(torch.as_tensor(p), **kwargs)
    want = np.asarray(getattr(jgates, name)(p, **kwargs))
    assert got.dtype == torch.complex128
    np.testing.assert_allclose(got.numpy(), want, atol=1e-14)
    m, v = tgates.passive_xp_from_unitary(got)
    jm, jv = jgates.passive_xp_from_unitary(want)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-14)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize('name,npara', XP_GATES)
def test_gate_symplectics_match_jax(name, npara):
    p = np.random.default_rng(len(name)).uniform(0.1, 1.5, npara)
    got = getattr(tgates, name)(torch.as_tensor(p))
    want = getattr(jgates, name)(p)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-14)


def test_registry_names_match_jax_and_carry_no_fock():
    for name, reg in tgates.PHOTONIC_REGISTRY.items():
        jreg = jgates.PHOTONIC_REGISTRY[name]
        assert (reg['nwires'], reg['npara']) == (jreg['nwires'], jreg['npara'])
        assert reg['fock'] is None
        assert (reg['unitary'] is None) == (jreg['unitary'] is None)


# ---------------------------------------------------- unitary and symplectic
def _mixed(mod, backend='fock'):
    """Every passive sugar gate once, with fixed angles."""
    rng = np.random.default_rng(1)
    kw = dict(init_state=[1, 0, 1, 0], cutoff=3) if backend == 'fock' else dict(backend=backend)
    cir = mod.QumodeCircuit(4, **kw)
    cir.ps(0, [0.3])
    cir.bs([0, 1], [0.4, 1.1])
    cir.mzi([1, 2], [0.7, 0.2])
    cir.mzi([2, 3], [1.3, 0.5], phi_first=False)
    cir.bs_theta([0, 1], [0.9])
    cir.bs_phi([2, 3], [0.6])
    cir.bs_rx([1, 2], [0.8])
    cir.bs_ry([0, 1], [1.7])
    cir.bs_h([2, 3], [2.1])
    cir.dc([0, 1])
    cir.h([1, 2])
    cir.any(_haar(2, rng), [0, 3])
    cir.any(_haar(4, rng))
    return cir


def test_get_unitary_matches_jax():
    jcir, tcir = _mixed(jph), _mixed(tph)
    want = np.asarray(jcir.get_unitary())
    got = tcir.get_unitary()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-13)
    np.testing.assert_allclose((got @ got.mH).numpy(), np.eye(4), atol=1e-13)
    np.testing.assert_allclose(tcir().numpy(), want, atol=1e-13)   # forward() without is_prob
    assert tcir.npara == jcir.npara == 14


def _gaussian(mod):
    cir = _mixed(mod, backend='gaussian')
    cir.s(0, 0.4, 0.3)
    cir.s2([1, 2], 0.3, 1.2)
    cir.d(3, 0.5, 0.7)
    cir.x(1, [0.2])
    cir.z(2, [-0.3])
    return cir


def test_get_symplectic_displacement_and_state_match_jax():
    jcir, tcir = _gaussian(jph), _gaussian(tph)
    np.testing.assert_allclose(tcir.get_symplectic().numpy(), np.asarray(jcir.get_symplectic()),
                               atol=1e-13)
    mean0 = np.random.default_rng(2).normal(size=(8, 1))
    np.testing.assert_allclose(tcir.get_displacement(mean0).numpy(),
                               np.asarray(jcir.get_displacement(mean0)), atol=1e-13)
    for a, b in zip(tcir(), jcir()):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-13)
    for a, b in zip(tcir.photon_number_mean_var(), jcir.photon_number_mean_var()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)
    # a [cov, mean] list as the input state
    state = [np.eye(8) * 0.7, mean0]
    for a, b in zip(tcir(state=state), jcir(state=state)):
        np.testing.assert_allclose(a.numpy().reshape(-1), np.asarray(b).reshape(-1), atol=1e-13)


def test_trainable_params_data_and_add():
    """Random-initialised gates are trainable; params= and data= overwrite
    their slots for one call; add() appends a circuit with its parameters."""
    def build(mod):
        cir = mod.QumodeCircuit(3, init_state=[1, 1, 0], cutoff=3)
        cir.ps(0)
        cir.bs([0, 1])
        cir.mzi([1, 2], encode=True)
        cir.ps(2, encode=True)
        return cir

    jcir, tcir = build(jph), build(tph)
    assert tcir.npara == jcir.npara == 3 and tcir.ndata == jcir.ndata == 3
    assert tcir.params.shape == (3,) and tcir.params.dtype == torch.float64
    vals, data = np.array([0.3, 1.2, 2.2]), np.array([0.5, 0.9, 1.4])
    want = np.asarray(jcir.get_unitary(params=vals, data=data))
    np.testing.assert_allclose(tcir.get_unitary(params=vals, data=data).numpy(), want, atol=1e-13)
    tcir.params = vals
    tcir.encode(data)
    np.testing.assert_allclose(tcir.get_unitary().numpy(), want, atol=1e-13)
    np.testing.assert_allclose(tcir.params.numpy(), vals)
    with pytest.raises(ValueError, match='more data'):
        tcir.get_unitary(data=data[:2])
    jcir.params = vals
    jcir.encode(data)
    jouter, touter = jph.QumodeCircuit(3, init_state=[1, 1, 0], cutoff=3), \
        tph.QumodeCircuit(3, init_state=[1, 1, 0], cutoff=3)
    for outer, inner in ((jouter, jcir), (touter, tcir)):
        outer.bs_rx([0, 2], [0.4])
        outer.add(inner)
        outer.add(inner)
    assert touter.npara == jouter.npara == 7 and touter.ndata == 6 and len(touter.operators) == 9
    np.testing.assert_allclose(touter.get_unitary().numpy(), np.asarray(jouter.get_unitary()),
                               atol=1e-13)


def test_unitary_is_differentiable_on_the_cpu():
    cir = tph.QumodeCircuit(3, init_state=[1, 1, 0], cutoff=3)
    cir.mzi([0, 1])
    cir.bs([1, 2])
    p = cir.params.requires_grad_()

    def fn(p):
        return torch.view_as_real(cir.get_unitary(params=p))

    assert torch.autograd.gradcheck(fn, (p,))


# ----------------------------------------------------------------- decompose
@pytest.mark.parametrize('n', [2, 5, 6])
def test_clements_reproduces_the_unitary(n):
    u = _haar(n, np.random.default_rng(n))
    info, dic_mzi, dic_pos = tph.UnitaryDecomposer(u).decomp()
    jinfo, jdic, jpos = jph.decompose.UnitaryDecomposer(u).decomp()
    np.testing.assert_allclose(np.array(info['MZI_list']), np.array(jinfo['MZI_list']))
    np.testing.assert_allclose(info['phase_angle'], jinfo['phase_angle'])
    assert dic_pos == jpos and dict(dic_mzi).keys() == dict(jdic).keys()
    cir = tph.QumodeCircuit(n, init_state=[1] + [0] * (n - 1))
    cir.clements(u)
    assert len(cir.operators) == n * (n - 1) // 2 + n and cir.params.numel() == 0
    np.testing.assert_allclose(cir.get_unitary().numpy(), u, atol=1e-10)
    # on a sub-range of wires, as the JAX package places it
    jwide, twide = jph.QumodeCircuit(n + 2, init_state=[0] * (n + 2)), \
        tph.QumodeCircuit(n + 2, init_state=[0] * (n + 2))
    for wide in (jwide, twide):
        wide.clements(u, minmax=[1, n])
    np.testing.assert_allclose(twide.get_unitary().numpy(), np.asarray(jwide.get_unitary()),
                               atol=1e-12)


def test_clements_dict2data_matches_jax():
    rng = np.random.default_rng(3)
    for phi_first in (True, False):
        jc = jph.Clements(4, init_state=[1, 0, 0, 0], phi_first=phi_first)
        tc = tph.Clements(4, init_state=[1, 0, 0, 0], phi_first=phi_first)
        assert tc.ndata == jc.ndata == 16
        ncol = 2 * 4 + 1
        angles = {(i, c): rng.uniform(0, 6) for i in range(4) for c in range(ncol)}
        np.testing.assert_array_equal(tc.dict2data(angles), jc.dict2data(angles))
        data = tc.dict2data(angles)
        np.testing.assert_allclose(tc.get_unitary(data=data).numpy(),
                                   np.asarray(jc.get_unitary(data=data)), atol=1e-13)


# ------------------------------------------------------------------- interop
def test_qumode_from_jax_reproduces_unitary_and_symplectic():
    jcir = _mixed(jph)
    tcir = dqt.qumode_from_jax(jcir)
    assert tcir.device.type == 'cpu' and [op.name for op in tcir.operators] == \
        [op.name for op in jcir.operators]
    np.testing.assert_allclose(tcir.get_unitary().numpy(), np.asarray(jcir.get_unitary()),
                               atol=1e-13)
    jg = _gaussian(jph)
    tg = dqt.qumode_from_jax(jg)
    np.testing.assert_allclose(tg.get_symplectic().numpy(), np.asarray(jg.get_symplectic()),
                               atol=1e-13)
    for a, b in zip(tg(), jg()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-13)


def test_qumode_from_jax_carries_parameters_encoders_and_basis():
    jcir = jph.Clements(4, init_state=[1, 1, 0, 0], cutoff=3)
    jcir.ps(1)                                  # a trainable slot after the encoders
    jcir.set_fock_basis([[1, 1, 0, 0], [0, 0, 1, 1], [2, 0, 0, 0]])
    tcir = dqt.qumode_from_jax(jcir)
    assert (tcir.npara, tcir.ndata) == (jcir.npara, jcir.ndata) == (1, 16)
    assert tcir._enc_pidx == list(jcir._enc_pidx) and len(tcir.encoders) == len(jcir.encoders)
    np.testing.assert_allclose(tcir.params.numpy(), np.asarray(jcir.params))
    np.testing.assert_array_equal(tcir.get_fock_basis(), jcir.get_fock_basis())
    data = np.random.default_rng(4).uniform(0, 6, 16)
    _tables_close(tcir(data=data, is_prob=False), jcir(data=data, is_prob=False), 1e-12)


def test_qumode_from_jax_refuses_what_is_not_ported():
    cases = []
    c = jph.QumodeCircuit(2, init_state=[1, 0])
    c.qp(0, [0.3])                              # a CV gate's Fock matrix
    cases.append(c)
    c = jph.QumodeCircuit(2, init_state=[1, 0], cutoff=3, basis=False)
    c.k(0, [0.3])
    cases.append(c)
    c = jph.QumodeCircuit(2, backend='gaussian', noise=True, noise_per_forward=True)
    c.s(0, 0.3, 0.0)
    cases.append(c)
    c = jph.QumodeCircuit(2, backend='gaussian')
    c.measurements.append(jph.measurement.Generaldyne(np.eye(2), nmode=2, wires=[0]))
    cases.append(c)
    for jcir in cases:
        with pytest.raises(NotImplementedError):
            dqt.qumode_from_jax(jcir)


# ------------------------------------------------- path (a): boson sampling
def test_boson_sampling_matches_jax():
    """Clements mesh, 5 modes, 3 photons and 4 photons: 3 x 3 permanents
    take the closed form, 4 x 4 the Ryser sweep (its twin here)."""
    rng = np.random.default_rng(5)
    for init in ([1, 1, 1, 0, 0], [1, 1, 1, 1, 0]):
        nphoton = sum(init)
        jcir = jph.Clements(5, init_state=init, cutoff=nphoton + 1)
        tcir = tph.Clements(5, init_state=init, cutoff=nphoton + 1)
        data = rng.uniform(0, 2 * np.pi, jcir.ndata)
        before = pk.permanent_cuda_batch.launches
        probs = tcir(data=data, is_prob=True)
        assert pk.permanent_cuda_batch.launches == before   # a CPU tensor never counts a launch
        want = jcir(data=data, is_prob=True)
        _tables_close(probs, want, 1e-8)
        assert abs(sum(float(v) for v in probs.values()) - 1) <= 1e-12
        vals = [float(v) for v in probs.values()]
        assert vals == sorted(vals, reverse=True)           # largest first, as the JAX dict
        _tables_close(tcir(data=data, is_prob=False), jcir(data=data, is_prob=False), 1e-8)
        tcir.encode(data)
        jcir.encode(data)
        final = list(tcir.get_fock_basis()[7])
        amp = tcir.get_amplitude(final)
        assert abs(complex(amp) - complex(jcir.get_amplitude(final))) <= 1e-12
        assert abs(float(tcir.get_prob(final)) - abs(complex(amp)) ** 2) <= 1e-15
        assert complex(tcir.get_amplitude([nphoton + 1, 0, 0, 0, 0])) == 0   # photon number differs


def test_boson_sampling_batched_data_states_and_basis():
    rng = np.random.default_rng(6)
    jcir = jph.Clements(4, init_state=[1, 1, 1, 1], cutoff=5)
    tcir = tph.Clements(4, init_state=[1, 1, 1, 1], cutoff=5)
    data = rng.uniform(0, 2 * np.pi, (2, jcir.ndata))
    got, want = tcir(data=data, is_prob=True), jcir(data=data, is_prob=True)
    assert next(iter(got.values())).shape == (2,)
    _tables_close(got, want, 1e-8)
    basis = [[4, 0, 0, 0], [1, 1, 1, 1]]
    for cir in (jcir, tcir):
        cir.set_fock_basis(basis)
    _tables_close(tcir(data=data[0], is_prob=True), jcir(data=data[0], is_prob=True), 1e-8)
    assert len(tcir.state) == 2
    tcir.set_fock_basis()
    jcir.set_fock_basis()
    # a stack of input states: one dict per row
    rows = np.array([[2, 0, 1, 1], [0, 4, 0, 0]])
    for g, w in zip(tcir(data=data[1], state=rows, is_prob=True),
                    jcir(data=data[1], state=rows, is_prob=True)):
        _tables_close(g, w, 1e-8)


def test_boson_sampling_gradient_on_the_cpu_matches_jax():
    """On the CPU the kernel wrappers take their twins, which are plain
    torch (on the card the wrappers' backward is the twins' derivative)."""
    import jax
    import jax.numpy as jnp
    jcir = jph.Clements(4, init_state=[1, 1, 1, 1], cutoff=5)
    tcir = tph.Clements(4, init_state=[1, 1, 1, 1], cutoff=5)
    data = np.random.default_rng(7).uniform(0, 2 * np.pi, jcir.ndata)
    key = jph.FockState([1, 1, 1, 1])

    def jloss(d):
        return jcir(data=d, is_prob=True, sort=False)[key]

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    d = torch.tensor(data, requires_grad=True)
    tcir(data=d, is_prob=True)[tph.FockState([1, 1, 1, 1])].backward()
    np.testing.assert_allclose(d.grad.numpy(), want, atol=1e-8)


# --------------------------------------------- path (b): Gaussian boson sampling
def _gbs(mod, detector, displaced, nmode=4):
    rng = np.random.default_rng(8)
    cir = mod.GaussianBosonSampling(nmode, rng.uniform(0.2, 0.6, nmode), _haar(nmode, rng),
                                    cutoff=3, detector=detector)
    if displaced:
        cir.d(0, 0.3, 0.4)
        cir.d(nmode // 2, 0.2, 1.0)
    return cir


# 4 modes; the displaced pnrd case runs 3 (27 loop hafnians: the JAX side
# compiles one program over all outcomes, 16 s for the 81 of 4 modes)
@pytest.mark.parametrize('detector,displaced,nmode', [
    ('threshold', False, 4), ('threshold', True, 4), ('pnrd', False, 4), ('pnrd', True, 3)])
def test_gaussian_boson_sampling_matches_jax(detector, displaced, nmode):
    jcir = _gbs(jph, detector, displaced, nmode)
    tcir = _gbs(tph, detector, displaced, nmode)
    got, want = tcir(is_prob=True), jcir(is_prob=True)
    assert len(got) == (2 ** nmode if detector == 'threshold' else 3 ** nmode)
    _tables_close(got, want, 1e-8)
    total = sum(float(v) for v in got.values())
    if detector == 'threshold':
        assert abs(total - 1) <= 1e-10            # every click pattern is there
    else:
        assert 0.8 < total < 1                    # the cutoff drops the tail
    # one outcome alone (each is a program of its own on the JAX side)
    final = [1, 1, 0, 1][:nmode]
    assert abs(float(tcir.get_prob(final)) - float(jcir.get_prob(final))) <= 1e-8
    assert abs(float(tcir.get_prob(final)) - float(_table(got)[tuple(final)][0])) <= 1e-14
    vac = (0,) * nmode
    assert float(tcir.get_prob(vac)) == pytest.approx(float(_table(got)[vac][0]))
    for a, b in zip(tcir.photon_number_mean_var([0, 2]), jcir.photon_number_mean_var([0, 2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)


def _jax_click_table(jcir, nmode, displaced):
    """Every click pattern's probability, in itertools.product order, from
    the JAX package: its Gaussian state and Q matrices, then its vmapped
    torontonian (``torontonian_batch``) once per click count, at
    complex128. The undisplaced case passes gamma = 0, as the JAX
    torontonian does itself at complex128; each stack is padded to C(7, k)
    matrices, so that one compiled program per k serves 6 and 7 modes."""
    import jax
    import jax.numpy as jnp
    cov, mean = jcir()
    _, o_mat, gamma, p_vac = jgp._q_mats(jnp.reshape(cov, (2 * nmode, 2 * nmode)),
                                         jnp.reshape(mean, (2 * nmode, 1)))
    tor_batch = _JAX_TOR.setdefault('fn', jax.jit(jtor.torontonian_batch))
    states = np.array(list(itertools.product((0, 1), repeat=nmode)))
    tor = np.ones(len(states), complex)
    for k in range(1, nmode + 1):
        pos = np.flatnonzero(states.sum(1) == k)
        half = np.stack([np.flatnonzero(f) for f in states[pos]])
        idx = np.concatenate([half, half + nmode], axis=1)
        idx = np.concatenate([idx, np.repeat(idx[:1], comb(7, k) - len(idx), axis=0)])
        g = gamma[idx] if displaced else jnp.zeros(idx.shape, gamma.dtype)
        tor[pos] = np.asarray(tor_batch(o_mat[idx[:, :, None], idx[:, None, :]], g))[:len(pos)]
    return np.abs(np.real(complex(p_vac) * tor)), [tuple(s) for s in states]


_JAX_TOR = {}


@pytest.mark.parametrize('displaced', [False, True])
@pytest.mark.parametrize('nmode', [6, 7])
def test_gbs_click_table_matches_jax_vmapped_torontonian(nmode, displaced, monkeypatch):
    """The port's table (one torontonian_batch per click count: a wrapper
    call for k >= 3, the plain formula below) against the JAX package."""
    from deepquantum_tpu_torch.photonic import gaussian_prob as tgp
    want, states = _jax_click_table(_gbs(jph, 'threshold', displaced, nmode), nmode, displaced)
    calls = []
    batch = tgp.torontonian_batch
    monkeypatch.setattr(tgp, 'torontonian_batch',
                        lambda o, g=None: calls.append(tuple(o.shape)) or batch(o, g))
    tcir = _gbs(tph, 'threshold', displaced, nmode)
    cov, mean = tcir()
    probs, basis = tgp.fock_probs_gaussian(cov, mean, tcir.cutoff, 'threshold')
    assert basis == states                          # the JAX order
    np.testing.assert_allclose(probs.reshape(-1).numpy(), want, rtol=0, atol=1e-9)
    assert calls == [(comb(nmode, k), 2 * k, 2 * k) for k in range(nmode + 1)]
    got = _table(tcir(is_prob=True))                # the circuit's dict holds the same values
    np.testing.assert_allclose(np.concatenate([got[s] for s in states]), want, rtol=0,
                               atol=1e-9)
    assert abs(sum(v[0] for v in got.values()) - 1) <= 1e-10


@pytest.mark.parametrize('displaced', [False, True])
def test_gbs_table_gradient_matches_jax(displaced):
    """d (three patterns' probabilities) / d squeezing, taken from the full
    table, against jax.grad of the JAX package's state and table program."""
    import jax
    import jax.numpy as jnp
    nmode = 4
    jcir, tcir = _gbs(jph, 'threshold', displaced, nmode), _gbs(tph, 'threshold', displaced, nmode)
    for cir in (jcir, tcir):            # the squeezing magnitudes train
        cir._train_mask = [False] * len(cir._train_mask)
        for op in cir.operators[:nmode]:
            cir._train_mask[op.pidx[0]] = True
    states = tuple(itertools.product((0, 1), repeat=nmode))
    pats = [(1, 1, 0, 1), (1, 1, 1, 1), (0, 1, 1, 0)]
    rows = jnp.asarray([states.index(p) for p in pats])
    table = jgp._probs_fn(states, 'threshold', False, displaced)

    def jloss(p):
        cov, mean = jcir(params=p)
        return table(jnp.reshape(cov, (2 * nmode, 2 * nmode)),
                     jnp.reshape(mean, (2 * nmode, 1)))[rows].sum()

    want = np.asarray(jax.grad(jloss)(jcir.params))
    p = tcir.params.requires_grad_()
    probs = tcir(params=p, is_prob=True)
    sum(probs[tph.FockState(list(s))] for s in pats).backward()
    assert p.grad.shape == (nmode,)
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=0, atol=1e-8)


def test_detector_chosen_at_the_call_matches_jax():
    jcir, tcir = _gbs(jph, 'pnrd', True, nmode=2), _gbs(tph, 'pnrd', True, nmode=2)
    _tables_close(tcir(is_prob=True, detector='threshold'),
                  jcir(is_prob=True, detector='threshold'), 1e-8)
    assert len(tcir.state) == 4 and tcir.detector == 'pnrd'


def test_gbs_rejects_a_non_unitary():
    with pytest.raises(ValueError, match='unitary'):
        tph.GaussianBosonSampling(3, [0.1] * 3, np.ones((3, 3)))


# -------------------------------------------------------- not ported options
@pytest.mark.parametrize('kwargs', [dict(basis=False), dict(den_mat=True), dict(mps=True),
                                    dict(backend='gaussian', noise=True), dict(noise=True)])
def test_constructor_options_not_ported_raise(kwargs):
    with pytest.raises(NotImplementedError, match='not ported'):
        tph.QumodeCircuit(2, **kwargs)


# the methods that still raise on a Fock basis-mode circuit (the Fock slice);
# the CV backends run them since the continuous-variable engine was ported
@pytest.mark.parametrize('method', ['delay', 'loss', 'loss_t', 'loss_db', 'homodyne',
                                    'homodyne_x', 'homodyne_p', 'measure_homodyne', 'draw',
                                    'wigner', 'qp', 'cx', 'cz', 'cp', 'k', 'ck',
                                    'quadrature_mean'])
def test_methods_not_ported_raise(method):
    cir = tph.QumodeCircuit(2, init_state=[1, 0])
    with pytest.raises(NotImplementedError, match='(?i)' + method.split('_')[0]):
        getattr(cir, method)(0)


def test_states_not_ported_raise_and_fock_states_hash():
    with pytest.raises(NotImplementedError):
        tph.FockState([1, 0], basis=False)
    with pytest.raises(ValueError, match='backend'):
        tph.QumodeCircuit(2, backend='tensor')
    a, b = tph.FockState([1, 0, 2]), tph.FockState([1, 0, 2], 3, 5)
    assert a == b and hash(a) == hash(b) and repr(a) == '|102>' and a.cutoff == 4
    assert tph.FockState([1], nmode=3).state.tolist() == [0, 0, 1]
    assert tph.GaussianState('vac', 2).is_pure
    assert not tph.GaussianState([np.eye(4) * 2.0, np.zeros((4, 1))]).is_pure
