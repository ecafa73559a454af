"""PyTorch port vs the JAX package: the continuous-variable photonic engine,
part one.

The Gaussian linear algebra (Takagi, Williamson, the Schur form, the
hermitian square root), the quadratic-phase / CX / CZ symplectics and the
phase-shift sugar, the loss channel and its gradient, the composition API
(descriptors, barriers, depth), ``hafnian_batch`` and the pnrd table
grouped by photon number, ``GraphGBS``, the Generaldyne / Homodyne /
GeneralBosonic conditioning with given outcomes, and ``measure()`` on the
Fock basis mode and the Gaussian backend (a chi-square against the table).
Inputs come from numpy seeds; both packages run their complex128 policy on
the CPU and values are held to 1e-10 unless a line says otherwise. The
JAX side stays tiny (<= 3 modes): each new shape is a compile.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import photonic as jph
from deepquantum_tpu.photonic import gates as jgates
from deepquantum_tpu.photonic import hafnian_ as jhaf
from deepquantum_tpu.photonic import measurement as jmeas
from deepquantum_tpu.photonic import qmath as jq
from deepquantum_tpu_torch import photonic as tph
from deepquantum_tpu_torch.photonic import gates as tgates
from deepquantum_tpu_torch.photonic import gaussian_prob as tgp

torch.set_num_threads(1)
ATOL = 1e-10


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


def _jit(fn, *static):
    """A JAX reference function under one jit: one compile, not one per
    primitive as its eager call pays."""
    import jax
    return jax.jit(fn, static_argnames=static)


def _jax_forward(cir, *args, **kwargs):
    """A JAX circuit's forward under one jit, as a tuple (cov, mean[, weight])."""
    return _jit(lambda *a: tuple(cir(*a, **kwargs)))(*args)


def _jax_measure(op, state, samples=None):
    """A JAX measurement under one jit, with given outcomes where there are
    any (the key is fixed: nothing random is compared)."""
    import jax
    return _jit(lambda x, s: tuple(op(list(x), samples=s, key=jax.random.PRNGKey(0))))(
        tuple(state), None if samples is None else np.asarray(samples, np.float64))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape), rtol=0, atol=atol)


def _chi2(counts: dict, probs: dict, shots: int):
    """Pearson's chi-square of counts against probabilities over the cells
    with an expected count >= 5 (the rest pooled), and its bound dof + 6
    sqrt(2 dof)."""
    keys = list(probs)
    exp = shots * np.array([probs[k] for k in keys])
    obs = np.array([counts.get(k, 0) for k in keys], dtype=np.float64)
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any() and exp[~big].sum() > 0:
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / exp[~big].sum())
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    assert sum(counts.values()) == shots
    assert set(counts) <= set(keys)
    return stat, dof + 6 * np.sqrt(2 * dof)


# ----------------------------------------------------- Gaussian linear algebra
@pytest.mark.parametrize('kind', ['complex', 'graph'])
def test_takagi_reconstructs_and_matches_jax(kind):
    rng = np.random.default_rng(11)
    if kind == 'complex':
        z = rng.normal(size=(5, 5)) + 1j * rng.normal(size=(5, 5))
        a = z + z.T
    else:                                     # a graph: degenerate singular values
        a = np.triu((rng.random((6, 6)) < 0.5).astype(float), 1)
        a = a + a.T
    u, s = tph.takagi(a)
    assert u.dtype == torch.complex128 and s.dtype == torch.float64 and u.device.type == 'cpu'
    _close(u @ torch.diag(s.to(u.dtype)) @ u.T, a, 1e-12)
    _close(u.mH @ u, np.eye(len(a)), 1e-12)
    assert (np.diff(s.numpy()) >= -1e-12).all()
    ju, js = jq.takagi(a)
    _close(s, js)
    _close(u, ju)
    # a tensor stays on its device, numpy goes to the default device
    assert tph.takagi(torch.as_tensor(a))[0].device.type == 'cpu'


def test_williamson_reconstructs_and_matches_jax():
    rng = np.random.default_rng(12)
    cir = tph.QumodeCircuit(3, backend='gaussian')
    for i in range(3):
        cir.s(i, rng.uniform(0.2, 0.8), rng.uniform(0, 2))
    cir.bs([0, 1], [0.4, 0.3])
    cir.bs([1, 2], [0.9, 1.1])
    cir.loss(0, [0.7])
    cir.loss(2, [1.3])
    cov = cir()[0][0]
    s, d = tph.williamson(cov)
    _close(s @ torch.diag(torch.cat([d, d])) @ s.T, cov, 1e-12)
    omega = np.block([[np.zeros((3, 3)), np.eye(3)], [-np.eye(3), np.zeros((3, 3))]])
    _close(s @ torch.as_tensor(omega) @ s.T, omega, 1e-12)
    assert (d.numpy() >= 1 - 1e-12).all()              # a physical state: d >= vacuum
    js, jd = jq.williamson(cov.numpy())
    _close(d, jd)
    _close(s, js, 1e-9)


def test_sqrtm_herm_and_schur_anti_symm_even_match_jax():
    rng = np.random.default_rng(13)
    z = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    h = z @ z.conj().T
    r = tph.sqrtm_herm(h)
    _close(r @ r, h, 1e-12)
    _close(r, _jit(jq.sqrtm_herm)(h))
    a = rng.normal(size=(6, 6))
    a = a - a.T
    t, o = tph.schur_anti_symm_even(torch.as_tensor(a))
    jt, jo = _jit(jq.schur_anti_symm_even)(a)
    # O is unique only up to a rotation of each block's pair of columns
    _close(o @ t @ o.T, a, 1e-12)
    _close(o.T @ o, np.eye(6), 1e-12)
    _close(t, jt)
    _close(np.asarray(jo) @ np.asarray(jt) @ np.asarray(jo).T, a, 1e-12)


# --------------------------------------------------------------------- gates
@pytest.mark.parametrize('name,npara', [('quad_phase_xp', 1), ('cx_xp', 1), ('cz_xp', 1),
                                        ('ps_xp', 1), ('squeeze2_xp', 2), ('disp_xp', 2)])
def test_cv_symplectics_match_jax_single_and_batched(name, npara):
    p = np.random.default_rng(len(name)).uniform(-1.5, 1.5, (3, npara))
    fn = getattr(tgates, name)
    batched = fn(torch.as_tensor(p))
    for row in range(3):
        want = getattr(jgates, name)(p[row])
        for got_b, got, w in zip(batched, fn(torch.as_tensor(p[row])), want):
            _close(got, w, 1e-14)
            _close(got_b[row], w, 1e-14)


def _cv_sugar(mod):
    cir = mod.QumodeCircuit(3, backend='gaussian')
    cir.s(0, 0.5, 0.3)
    cir.s(1, 0.4, 1.0)
    cir.d(2, 0.3, 0.2)
    cir.bs([0, 1], [0.4, 0.2])
    cir.qp(0, [0.3])
    cir.cx([0, 1], [0.2])
    cir.cz([1, 2], [0.5])
    cir.r(2, [0.7], inv_mode=True)
    cir.r(0, [0.2])
    cir.f(1)
    cir.barrier()
    cir.loss(0, [0.6])
    cir.loss_db(1, 3.0)
    cir.loss_t(2, 0.8)
    return cir


def test_cv_sugar_loss_and_statistics_match_jax():
    import jax
    jcir, tcir = _cv_sugar(jph), _cv_sugar(tph)
    assert [op.kind for op in tcir.operators] == [op.kind for op in jcir.operators]
    assert (tcir.npara, tcir.ndata, tcir.max_depth) == (jcir.npara, jcir.ndata, jcir.max_depth)
    want = _jax_forward(jcir)
    for a, b in zip(tcir(), want):
        assert a.shape == b.shape
        _close(a, b)
    # the JAX side under one jit each: its eager calls compile op by op
    _close(tcir.get_symplectic(), jax.jit(jcir.get_symplectic)())
    for a, b in zip(tcir.photon_number_mean_var(),
                    jax.jit(jph.qmath.photon_number_mean_var)(*want)):
        _close(a, b)
    jcir.state = list(want)
    _close(tcir.quadrature_mean([0, 2]), jcir.quadrature_mean([0, 2]))
    # carried across, parameters and all
    tcir2 = dqt.qumode_from_jax(jcir)
    assert [op.name for op in tcir2.operators] == [op.name for op in jcir.operators]
    for a, b in zip(tcir2(), want):
        _close(a, b)


def test_loss_alone_matches_the_xy_map():
    rng = np.random.default_rng(14)
    cov0 = rng.normal(size=(4, 4))
    cov0 = cov0 @ cov0.T + np.eye(4)
    mean0 = rng.normal(size=(4, 1))
    cir = tph.QumodeCircuit(2, backend='gaussian')
    cir.loss_t(1, 0.3)
    cov, mean = cir(state=[cov0, mean0])
    x = np.diag([1, np.sqrt(0.3), 1, np.sqrt(0.3)])
    y = np.diag([0, 0.7, 0, 0.7])
    _close(cov, x @ cov0 @ x + y, 1e-12)
    _close(mean, x @ mean0, 1e-12)
    jx, jy = jph.channel.loss_xy([tph.channel.transmittance_to_theta(0.3)])
    tx, ty = tph.channel.loss_xy(torch.tensor([tph.channel.transmittance_to_theta(0.3)],
                                              dtype=torch.float64))
    _close(tx, jx, 1e-14)
    _close(ty, jy, 1e-14)


def test_lossy_photon_number_gradient_matches_jax():
    """d <n> / d (squeezing, angles) of a lossy circuit, against jax.grad."""
    import jax
    import jax.numpy as jnp

    def build(mod):
        cir = mod.QumodeCircuit(2, backend='gaussian')
        cir.add_op('Squeezing', 0, [0.6, 0.2], requires_grad=True)
        cir.add_op('BeamSplitter', [0, 1], [0.5, 0.3], requires_grad=True)
        cir.loss_db(1, 2.0)
        cir.add_op('Displacement', 1, [0.4, 0.9], requires_grad=True)
        cir.loss(0, [0.8])
        return cir

    jcir, tcir = build(jph), build(tph)

    def jloss(p):
        cov, mean = jcir(params=p)
        return jph.qmath.photon_number_mean_var(cov, mean)[0].sum()

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(jcir.params)))
    p = tcir.params.requires_grad_()
    cov, mean = tcir(params=p)
    tph.qmath.photon_number_mean_var(cov, mean)[0].sum().backward()
    _close(p.grad, want)


def test_fock_basis_sugar_and_refusals():
    def build(mod):
        cir = mod.QumodeCircuit(3, init_state=[1, 1, 0], cutoff=3)
        cir.bs([0, 1], [0.4, 0.2])
        cir.r(1, [0.7], inv_mode=True)
        cir.f(0)
        cir.barrier([0, 1])
        cir.mzi([1, 2], [0.3, 1.1])
        return cir

    jcir, tcir = build(jph), build(tph)
    _close(tcir.get_unitary(), _jit(jcir.get_unitary)())
    assert tcir.max_depth == jcir.max_depth == 4
    for method in ('qp', 'cx', 'cz'):
        with pytest.raises(NotImplementedError, match=method):
            getattr(tcir, method)([0, 1] if method != 'qp' else 0, [0.1])
    for method in ('loss', 'delay', 'homodyne'):
        with pytest.raises(NotImplementedError, match=method):
            getattr(tcir, method)(0)


def test_descriptors_share_parameters_and_init_para():
    cir = tph.QumodeCircuit(3, backend='gaussian')
    op = tph.PhotonicOp('BeamSplitter', [0, 1], npara=2,
                        unitary_fn=tgates.bs_unitary,
                        extra={'inputs': [0.3, 0.5], 'requires_grad': True})
    cir.add(op)
    cir.add(op, wires=[1, 2])                 # shared: no new slot
    cir.add(op, wires=[0, 2])
    assert cir.npara == 2 and len(cir._pvals) == 2 and len(cir.operators) == 3
    assert [o.wires for o in cir.operators] == [(0, 1), (1, 2), (0, 2)]
    ref = tph.QumodeCircuit(3, backend='gaussian')
    for w in ([0, 1], [1, 2], [0, 2]):
        ref.bs(w, [0.3, 0.5])
    _close(cir.get_symplectic(), ref.get_symplectic().numpy(), 1e-14)
    cir.init_para()
    assert cir.params.shape == (2,) and not np.allclose(cir.params.numpy(), [0.3, 0.5])
    with pytest.raises(TypeError):
        cir.add('bs')
    # a Clements mesh keeps init_para / max_depth / barrier of the circuit
    mesh = tph.Clements(4, init_state=[1, 0, 1, 0], cutoff=3)
    mesh.barrier()
    mesh.ps(0)
    assert mesh.max_depth == jph.Clements(4, init_state=[1, 0, 1, 0], cutoff=3).max_depth + 1
    mesh.init_para()
    assert mesh.npara == 1


# ------------------------------------------------------------ hafnian_batch
@pytest.mark.parametrize('size,loop', [(4, False), (6, False), (6, True), (5, True), (5, False),
                                       (1, True), (0, False)])
def test_hafnian_batch_matches_jax_hafnian(size, loop):
    rng = np.random.default_rng(size + 10 * loop)
    z = rng.normal(size=(2, size, size)) + 1j * rng.normal(size=(2, size, size))
    mats = z + np.swapaxes(z, 1, 2)
    got = tph.hafnian_batch(mats, loop=loop)
    assert got.shape == (2,)
    want = [complex(_jit(jhaf.hafnian, 'loop')(m, loop=loop)) for m in mats]
    _close(got, np.asarray(want), 1e-10 * max(1.0, np.abs(want).max()))
    for i in range(2):
        _close(tph.hafnian(mats[i], loop=loop), want[i], 1e-10 * max(1.0, abs(want[i])))


def _gbs(mod, displaced):
    rng = np.random.default_rng(21)
    z = rng.normal(size=(3, 3)) + 1j * rng.normal(size=(3, 3))
    u = np.linalg.qr(z)[0]
    cir = mod.GaussianBosonSampling(3, [0.5, 0.3, 0.4], u, cutoff=2, detector='pnrd')
    if displaced:
        cir.d(1, 0.3, 0.4)
    cir.loss(2, [0.5])
    return cir


_JAX_GBS = {}


def _jax_gbs_state(displaced):
    """The JAX package's (cov, mean) of ``_gbs``, one jitted forward per
    circuit for the tests that share it."""
    if displaced not in _JAX_GBS:
        _JAX_GBS[displaced] = _jax_forward(_gbs(jph, displaced))
    return _JAX_GBS[displaced]


@pytest.mark.parametrize('displaced', [False, True])
def test_pnrd_table_grouped_by_photon_number_matches_jax(displaced, monkeypatch):
    tcir = _gbs(tph, displaced)
    calls = []
    real = tgp.hafnian_batch
    monkeypatch.setattr(tgp, 'hafnian_batch', lambda m, loop=False: calls.append(m.shape) or
                        real(m, loop))
    from deepquantum_tpu.photonic import gaussian_prob as jgp
    got = tcir(is_prob=True)
    want, basis = jgp.fock_probs_gaussian(*_jax_gbs_state(displaced), 2, 'pnrd')
    # one hafnian_batch call per photon number 0..3 (lossy: the mixed 2N x 2N route)
    assert sorted(s[0] for s in calls) == [1, 1, 3, 3] and len(got) == 8
    keys = dict(zip(basis, np.asarray(want).reshape(-1)))
    for k, v in got.items():
        _close(v, keys[tuple(k.state.tolist())])
    # one outcome alone (get_prob's call) is a group of one: the same values
    cov, mean = tcir._cv_state
    for fs in [(0, 0, 0), (1, 0, 1), (1, 1, 1)]:
        one = tgp.probs_gaussian_helper([fs], cov[0], mean[0], 'pnrd')[0]
        _close(one, got[tph.FockState(list(fs))], 1e-13)


# ------------------------------------------------------------------ GraphGBS
def test_graph_gbs_squeezing_and_unitary_match_jax():
    rng = np.random.default_rng(22)
    a = np.triu((rng.random((5, 5)) < 0.6).astype(float), 1)
    a = a + a.T
    np.random.seed(0)
    jg = jph.ansatz.GraphGBS(a, mean_photon_num=3, detector='threshold')
    tg = tph.GraphGBS(a, mean_photon_num=3, detector='threshold', rng=np.random.default_rng(0))
    assert abs(tg.c - jg.c) <= 1e-10 and tg.name == 'GraphGBS' and not tg.basis
    _close(tg.get_symplectic(), _jit(jg.get_symplectic)(), 1e-9)
    cov, mean = tg()
    _close(tph.qmath.photon_number_mean_var(cov, mean)[0].sum(), 3.0, 1e-9)
    # the same c from the other package's value: squeezing arctanh(c lambda)
    _, lambd = tph.takagi(a)
    sq = [tg._pvals[op.pidx[0]] for op in tg.operators[:5]]
    _close(torch.tensor(sq, dtype=torch.float64), np.arctanh(lambd.numpy() * jg.c), 1e-9)
    samples = {tph.FockState([1, 1, 0, 0, 0]): 3, tph.FockState([1, 1, 1, 0, 0]): 2,
               tph.FockState([0, 0, 0, 1, 1]): 1}
    two, three = tg.postselect(samples, [2, 3])
    assert sum(two.values()) == 4 and list(three.values()) == [2]
    nx = pytest.importorskip('networkx')
    dens = tg.graph_density(nx.from_numpy_array(a), two)
    assert list(dens.values())[0][1] >= list(dens.values())[-1][1]


# --------------------------------------------------------------- measurements
def _gauss_state(mod):
    cir = mod.QumodeCircuit(3, backend='gaussian')
    cir.s(0, 0.6, 0.2)
    cir.s(1, 0.4, 1.3)
    cir.d(2, 0.5, 0.3)
    cir.bs([0, 1], [0.7, 0.1])
    cir.bs([1, 2], [0.4, 1.2])
    cir.loss(1, [0.5])
    return cir


def test_homodyne_and_generaldyne_conditioning_match_jax():
    jstate = _jax_forward(_gauss_state(jph))
    tstate = _gauss_state(tph)()
    for phi in (0.0, 0.7):
        hj = jmeas.Homodyne(phi=phi, nmode=3, wires=1, eps=1e-3)
        ht = tph.Homodyne(phi=phi, nmode=3, wires=1, eps=1e-3)
        got = ht(tstate, samples=[0.4, -0.2])
        want = _jax_measure(hj, jstate, [0.4, -0.2])
        for a, b in zip(got, want):
            _close(a, b, 1e-9)
        _close(ht.samples, [0.4, -0.2])
    cov_m = np.array([[0.6, 0.1, 0, 0], [0.1, 0.9, 0, 0], [0, 0, 1.2, 0.2], [0, 0, 0.2, 0.7]])
    gj = jmeas.Generaldyne(cov_m, nmode=3, wires=[0, 2])
    gt = tph.Generaldyne(cov_m, nmode=3, wires=[0, 2])
    s = np.array([0.3, -0.1, 0.5, 0.2])
    for a, b in zip(gt(tstate, samples=s), _jax_measure(gj, jstate, s)):
        _close(a, b)
    # a drawn outcome: shapes, and the covariance does not depend on it
    drawn = gt(tstate, generator=torch.Generator().manual_seed(0))
    assert gt.samples.shape == (1, 4)
    _close(drawn[0], gt(tstate, samples=s)[0])


def _bosonic(mod):
    cir = mod.QumodeCircuit(2, backend='bosonic')
    cir.cat(0, r=1.0, theta=0.4, p=1)
    cir.s(1, 0.3, 0.0)
    cir.bs([0, 1], [0.6, 0.2])
    return cir


def test_bosonic_conditioning_matches_jax():
    jstate, tstate = _jax_forward(_bosonic(jph)), _bosonic(tph)()
    hj = jmeas.Homodyne(phi=0.3, nmode=2, wires=1)
    ht = tph.Homodyne(phi=0.3, nmode=2, wires=1)
    for a, b in zip(ht(tstate, samples=[0.8, 0.0]),
                    _jax_measure(hj, jstate, [0.8, 0.0])):
        _close(a, b)
    fock = jph.FockStateBosonic(1, 0.1)
    bj = jmeas.GeneralBosonic(np.asarray(fock.cov)[0], np.asarray(fock.weight)[0], nmode=2,
                              wires=[1])
    bt = tph.GeneralBosonic(np.asarray(fock.cov)[0], np.asarray(fock.weight)[0], nmode=2,
                            wires=[1])
    s = np.array([0.2, -0.3])
    for a, b in zip(bt(tstate, samples=s), _jax_measure(bj, jstate, s)):
        _close(a, b)
    pj = jmeas.PhotonNumberResolvingBosonic(1, nmode=2, wires=0)
    pt = tph.PhotonNumberResolvingBosonic(1, nmode=2, wires=0)
    for a, b in zip(pt(tstate), _jax_measure(pj, jstate)):
        _close(a, b)


def test_conditional_homodyne_in_the_circuit_matches_jax_shapes():
    jcir, tcir = _gauss_state(jph), _gauss_state(tph)
    for cir in (jcir, tcir):
        cir.homodyne_x(0)
        cir.homodyne_p(2)
    tcir()
    got = tcir.measure_homodyne(shots=5, generator=torch.Generator().manual_seed(0))

    def jax_shots():
        import jax
        jcir()
        want = jcir.measure_homodyne(shots=5, key=jax.random.PRNGKey(0))
        return want, jcir.state_measured[0]

    import jax
    want, want_cov = jax.eval_shape(jax_shots)           # traced, not compiled
    assert got.shape == want.shape == (5, 2)
    assert tcir.state_measured[0].shape == want_cov.shape == (5, 6, 6)
    # every shot shares the conditioned covariance; it equals a direct conditioning
    direct = tph.Homodyne(np.pi / 2, 3, 2)(tph.Homodyne(0.0, 3, 0)(tcir.state, samples=[0, 0]),
                                           samples=[0, 0])
    _close(tcir.state_measured[0][3], direct[0][0])
    # without measurements: the x quadratures of the final state
    free = _gauss_state(tph)
    free()
    xs = free.measure_homodyne(shots=20000, wires=[0, 2], generator=torch.Generator().manual_seed(1))
    assert xs.shape == (20000, 4)
    cov, mean = free.state
    idx = [0, 2, 3, 5]
    _close(xs.mean(0), mean[0, idx, 0], 0.05)
    _close(torch.cov(xs.T), cov[0][idx][:, idx], 0.1)


def test_measure_fock_basis_by_chi_square():
    cir = tph.Clements(4, init_state=[1, 1, 0, 0], cutoff=3)
    data = np.random.default_rng(23).uniform(0, 2 * np.pi, cir.ndata)
    probs = cir(data=data, is_prob=True)
    table = {k: float(v) for k, v in probs.items()}
    shots = 20000
    counts = cir.measure(shots=shots, generator=torch.Generator().manual_seed(2))
    stat, bar = _chi2(counts, table, shots)
    assert stat <= bar
    # amplitudes sample the same distribution; with_prob carries p
    cir(data=data, is_prob=False)
    both = cir.measure(shots=100, with_prob=True, generator=torch.Generator().manual_seed(2))
    for k, (c, p) in both.items():
        assert c > 0 and p == pytest.approx(table[k], abs=1e-12)
    # a marginal over wires 0 and 3
    marg = cir.measure(shots=shots, wires=[0, 3], generator=torch.Generator().manual_seed(3))
    want = {}
    for k, p in table.items():
        key = tph.FockState([k.state[0], k.state[3]])
        want[key] = want.get(key, 0.0) + p
    stat, bar = _chi2(marg, want, shots)
    assert stat <= bar
    # a batch of data rows: one dict per row
    cir(data=np.stack([data, data[::-1]]), is_prob=True)
    rows = cir.measure(shots=50, generator=torch.Generator().manual_seed(4))
    assert len(rows) == 2 and all(sum(r.values()) == 50 for r in rows)


@pytest.mark.parametrize('detector', ['threshold', 'pnrd'])
def test_measure_gaussian_by_chi_square(detector):
    tcir = _gbs(tph, True)
    tcir.detector = detector
    tcir()
    shots = 20000
    counts = tcir.measure(shots=shots, generator=torch.Generator().manual_seed(5))
    table = {k: float(v) for k, v in tcir._forward_cv_prob(*tcir.state, detector).items()}
    total = sum(table.values())                # pnrd: the cutoff drops the tail
    stat, bar = _chi2(counts, {k: p / total for k, p in table.items()}, shots)
    assert stat <= bar
    if detector == 'threshold':
        # three patterns of the lossy, displaced table against the JAX package's
        from deepquantum_tpu.photonic import gaussian_prob as jgp
        cov, mean = _jax_gbs_state(True)
        pats = [(0, 0, 0), (1, 0, 1), (1, 1, 1)]
        want = jgp.probs_gaussian_helper(pats, cov.reshape(6, 6), mean.reshape(6, 1), 'threshold')
        for k, v in zip(pats, np.asarray(want)):
            assert abs(table[tph.FockState(list(k))] - float(v)) <= ATOL


def test_importing_the_port_loads_neither_networkx_nor_matplotlib():
    """The card's machine may lack both: graph_density and the Wigner plot
    load them on their call only."""
    import subprocess
    import sys
    from pathlib import Path
    code = ('import sys, deepquantum_tpu_torch, deepquantum_tpu_torch.photonic; '
            'print(sorted(m for m in ("networkx", "matplotlib", "jax") if m in sys.modules))')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, check=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == '[]'


def test_bosonic_probabilities_and_measure_raise():
    cir = _bosonic(tph)
    with pytest.raises(NotImplementedError, match='loop hafnians'):
        cir(is_prob=True)
    cir()
    for call in (lambda: cir.measure(10), lambda: cir.get_prob([1, 0])):
        with pytest.raises(NotImplementedError, match='Bosonic'):
            call()
