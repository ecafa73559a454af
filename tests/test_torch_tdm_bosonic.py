"""PyTorch port vs the JAX package: the continuous-variable photonic engine,
part two.

Time-domain multiplexing (delay loops unrolled onto concurrent modes, the
shift, homodyne feedback, ``global_circuit``, ``QumodeCircuitTDM``), the
Bosonic states (cat, GKP, Fock as Gaussians, their tensor product) and the
Bosonic backend, ``cv_to_wigner``, and the rejection sampler of Bosonic
outcomes held to the true marginal p(x) by a chi-square. Inputs come from
numpy seeds; both packages run their complex128 policy on the CPU; values
are held to 1e-10 unless a line says otherwise (the states to 1e-12). The
JAX side stays tiny (<= 3 modes, <= 6 TDM steps).

The post-measurement covariance of a homodyne does not depend on the
outcome, so the TDM covariance trajectory is a deterministic reference
for the unroll and the shift whatever the samples drawn. The means do
depend on it: the TDM tests drive the JAX package's step with the
port's own outcomes (``_jax_step_given``), so that the homodyne mean
update, the shift of the means and the feedback are held each step too.
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import photonic as jph
from deepquantum_tpu.photonic import wigner as jwig
from deepquantum_tpu.photonic.tdm import QumodeCircuitTDM as JaxTDM
from deepquantum_tpu_torch import photonic as tph

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


def _jax_forward(cir, *args, **kwargs):
    """A JAX circuit's forward under one jit (its eager form compiles op by
    op), as a tuple (cov, mean[, weight])."""
    import jax
    return jax.jit(lambda *a: tuple(cir(*a, **kwargs)))(*args)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape), rtol=0, atol=atol)


# ---------------------------------------------------------------------- TDM
def _tdm(cls, ntau, conv, r=0.8, inputs=(0.6, 0.3)):
    cir = cls(nmode=1, init_state='vac', cutoff=3)
    cir.s(0, r=r)
    cir.delay(0, ntau=ntau, inputs=list(inputs), convention=conv, encode=True)
    cir.homodyne_x(0)
    return cir


DATA = np.array([[[0.7, 0.2], [0.3, 1.1], [1.9, 0.5]]])         # (1, 3, 2)


def _jax_step_given(jcir, data, state, outcomes):
    """One step of the JAX package's ``QumodeCircuitTDM.forward`` (its
    tdm.py:55-64: the unrolled forward, then each homodyne in turn) with
    the (x, p) outcomes given, one array a measurement: the port's, so
    that the two post-measurement states, means included, can be held to
    each other. The step runs under one ``jax.jit`` per circuit (its eager
    form compiles op by op); the key is fixed, as the outcomes are given."""
    import jax
    step = jcir.__dict__.get('_given_step')
    if step is None:
        def run(data, state, outcomes):
            parts = list(jph.QumodeCircuit.forward(jcir, data, state))
            for op_j, s in zip(jcir._measurements_tdm, outcomes):
                parts = op_j(parts, samples=s, key=jax.random.PRNGKey(0))
            return tuple(parts)

        step = jcir._given_step = jax.jit(run)
    return list(step(data, None if state is None else tuple(state), list(outcomes)))


def _outcomes(tcir):
    """The (x, p) outcomes of the port's last TDM step, one per homodyne."""
    return [op.samples.numpy() for op in tcir._measurements_tdm]


@pytest.mark.parametrize('conv', ['bs', 'mzi'])
@pytest.mark.parametrize('ntau', [1, 2])
def test_tdm_covariance_over_six_steps_matches_jax(conv, ntau):
    jcir, tcir = _tdm(JaxTDM, ntau, conv), _tdm(tph.QumodeCircuitTDM, ntau, conv)
    gen = torch.Generator().manual_seed(ntau)
    sj = st = None
    trajectory = []
    for i in range(6):
        st = tcir(data=DATA[:, i % 3:i % 3 + 1], state=st, nstep=1, generator=gen)
        sj = _jax_step_given(jcir, DATA[:, i % 3], sj, _outcomes(tcir))
        assert st[0].shape == (1, 2 * (1 + ntau), 2 * (1 + ntau))
        _close(st[0], sj[0])
        _close(st[1], sj[1])
        trajectory.append(np.asarray(sj[0]))
    # the feedback moved the means: the check above is not one of zeros
    assert np.abs(np.asarray(sj[1])).max() > 0.1
    assert tcir.samples.shape == (1, 1)
    assert float(tcir.samples[0, 0]) == float(tcir._measurements_tdm[0].samples[0, 0])
    # the carried circuit runs the same steps
    carried = dqt.qumode_from_jax(jcir)
    assert isinstance(carried, tph.QumodeCircuitTDM) and carried._nmode_tdm == 1 + ntau
    st = None
    for i in range(3):
        st = carried(data=DATA[:, i:i + 1], state=st, nstep=1)
        _close(st[0], trajectory[i])


def test_tdm_batch_axis_and_many_steps():
    jcir, tcir = _tdm(JaxTDM, 2, 'bs'), _tdm(tph.QumodeCircuitTDM, 2, 'bs')
    data = np.random.RandomState(0).rand(2, 3, 2)
    tcir(data=data, nstep=5, generator=torch.Generator().manual_seed(0))
    assert tuple(tcir.samples.shape) == (2, 5)
    assert tcir.get_samples(0).shape == (2, 1, 5)
    # the covariance does not depend on the outcomes: any will do for JAX
    sj = None
    for i in range(5):
        sj = _jax_step_given(jcir, data[:, i % 3], sj, [np.zeros((2, 2))])
    _close(tcir.state[0], sj[0])
    # a circuit without loops, or with an unmeasured spatial mode, is refused
    with pytest.raises(ValueError, match='delay'):
        tph.QumodeCircuitTDM(1, 'vac')()
    two = tph.QumodeCircuitTDM(2, 'vac')
    two.delay(0, 1, [0.3, 0.1])
    two.homodyne_x(0)
    with pytest.raises(ValueError, match='homodyne'):
        two()


def test_tdm_two_spatial_modes_matches_jax():
    """A small 2-D cluster source: two squeezed modes, one turned by pi / 2,
    a real balanced beam splitter (an EPR pair a step), a delay of 1 on
    mode 0 and of 2 on mode 1, x and p homodyne: the x outcome of one half
    moves the mean of its partner in the other loop."""
    def build(cls):
        cir = cls(nmode=2, init_state='vac', cutoff=3)
        cir.s(0, r=1.0)
        cir.s(1, r=1.0)
        cir.r(0, [np.pi / 2])
        cir.bs([0, 1], [np.pi / 4, 0.0])
        cir.delay(0, ntau=1, inputs=[np.pi / 2, 0.0])
        cir.delay(1, ntau=2, inputs=[np.pi / 2, 0.0])
        cir.homodyne_x(0)
        cir.homodyne_p(1)
        return cir

    jcir, tcir = build(JaxTDM), build(tph.QumodeCircuitTDM)
    gen = torch.Generator().manual_seed(7)
    sj = st = None
    for _ in range(4):
        st = tcir(state=st, nstep=1, generator=gen)
        sj = _jax_step_given(jcir, None, sj, _outcomes(tcir))
        _close(st[0], sj[0])
        _close(st[1], sj[1])
    assert np.abs(np.asarray(sj[1])).max() > 0.1
    assert tcir.samples.shape == (2, 1)


def test_global_circuit_matches_jax_and_the_first_tdm_step():
    import jax
    jcir, tcir = _tdm(JaxTDM, 2, 'bs'), _tdm(tph.QumodeCircuitTDM, 2, 'bs')
    jg, tg = jcir.global_circuit(3), tcir.global_circuit(3)
    assert tg.nmode == jg.nmode == 5 and tg.ndata == jg.ndata == 6
    assert len(tg.measurements) == 3 and [m.wires for m in tg.measurements] == \
        [m.wires for m in jg.measurements]
    _close(tg.get_symplectic(), jax.jit(jg.get_symplectic)())
    data = DATA[0].reshape(-1)
    for a, b in zip(tg(data=data), jax.jit(lambda d: tuple(jg(data=d)))(data)):
        _close(a, b)
    # one step of the global circuit is the TDM step before its shift
    one = tcir.global_circuit(1)
    cov, mean = one(data=DATA[0, 0])
    tcir._forward_cv(DATA[0, 0], None, None, None)
    _close(cov[0], tcir._cv_state[0][0])
    _close(mean[0], tcir._cv_state[1][0])


# --------------------------------------------------------------- the states
@pytest.mark.parametrize('name,args', [
    ('CatState', (1.2, 0.3, 1)), ('CatState', (0.7, 2.0, 0)),
    ('GKPState', (0.4, 0.2, 0.1, 0.1)), ('GKPState', (np.pi / 2, 0.0, 0.2, 0.05)),
    ('FockStateBosonic', (2, 0.05)), ('FockStateBosonic', (3, 0.1))])
def test_bosonic_states_match_jax(name, args):
    got, want = getattr(tph, name)(*args), getattr(jph, name)(*args)
    assert got.ncomb == want.ncomb and got.cutoff == want.cutoff
    for a, b in ((got.cov, want.cov), (got.mean, want.mean), (got.weight, want.weight)):
        assert a.shape == np.asarray(b).shape
        _close(a, b, 1e-12)
    _close(got.weight.sum(), 1.0, 1e-12)


def test_combine_bosonic_states_matches_jax_loop():
    parts_t = [tph.CatState(1.2, 0.3, 1), tph.BosonicState('vac', 1),
               tph.GKPState(0.4, 0.2, 0.2, 0.2), tph.FockStateBosonic(2)]
    parts_j = [jph.CatState(1.2, 0.3, 1), jph.BosonicState('vac', 1),
               jph.GKPState(0.4, 0.2, 0.2, 0.2), jph.FockStateBosonic(2)]
    got = tph.combine_bosonic_states(parts_t)
    want = jph.state.combine_bosonic_states(parts_j)
    assert got.nmode == 4 and got.ncomb == want.ncomb == 4 * parts_t[2].ncomb * 3
    for a, b in ((got.cov, want.cov), (got.mean, want.mean), (got.weight, want.weight)):
        _close(a, b, 1e-12)


def _bosonic(mod):
    cir = mod.QumodeCircuit(3, backend='bosonic')
    cir.cat(0, r=1.0, theta=0.2, p=0)
    cir.gkp(2, 0.3, 0.5, amp_cutoff=0.2, epsilon=0.2)
    cir.bs([0, 1], [0.3, 0.4])
    cir.s(1, 0.3, 0.1)
    cir.qp(1, [0.2])
    cir.loss(2, [0.4])
    cir.bs([1, 2], [0.5, 0.2])
    cir.homodyne_x(2)
    return cir


def test_bosonic_forward_matches_jax():
    jcir, tcir = _bosonic(jph), _bosonic(tph)
    want, got = _jax_forward(jcir), tcir()
    assert len(got) == 3 and got[1].dtype == torch.complex128
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)
    carried = dqt.qumode_from_jax(jcir)
    for a, b in zip(carried(), want):
        _close(a, b)
    # a batch of data rows on the components
    def enc(mod):
        cir = mod.QumodeCircuit(2, backend='bosonic')
        cir.cat(1, r=0.8, theta=0.0, p=1)
        cir.bs([0, 1], encode=True)
        return cir

    data = np.array([[0.3, 0.2], [1.1, 0.4]])
    for a, b in zip(enc(tph)(data=data), _jax_forward(enc(jph), data)):
        assert a.shape == b.shape
        _close(a, b)
    with pytest.raises(ValueError, match='bosonic'):
        tph.QumodeCircuit(1, backend='gaussian').cat(0)


def test_conditional_homodyne_on_the_bosonic_backend():
    tcir = _bosonic(tph)
    tcir()
    xs = tcir.measure_homodyne(shots=7, generator=torch.Generator().manual_seed(0))
    assert xs.shape == (7,)
    cov, mean, weight = tcir.state_measured
    assert cov.shape[:2] == mean.shape[:2] == weight.shape and weight.shape[0] == 7
    _close(weight.sum(-1), np.ones(7), 1e-12)
    # each shot's state is the direct conditioning on its sample
    drawn = tcir.measurements[0].samples                    # (shots, 2): x and p
    _close(drawn[:, 0], xs)
    direct = tph.Homodyne(0.0, 3, 2)(tcir.state, samples=drawn[3])
    for a, b in zip((mean, weight), direct[1:]):
        _close(a[3], b[0], 1e-12)


def test_cv_statistics_of_a_bosonic_state_are_the_mixtures():
    """<x>, <n> and Var n of a displaced cat against the moments of its
    Wigner function on a grid; a Gaussian's against the JAX package."""
    cir = tph.QumodeCircuit(1, backend='bosonic')
    cir.cat(0, r=1.1, theta=0.4, p=1)
    cir.d(0, 0.5, 0.3)
    cir()
    w = cir.wigner(0, xrange=12, prange=12, npoints=301, plot=False)[0].numpy()
    xs = np.linspace(-12, 12, 301)
    gx, gp = np.meshgrid(xs, xs, indexing='ij')
    dx = (xs[1] - xs[0]) ** 2
    n_op = (gx ** 2 + gp ** 2) / 4 - 0.5            # hbar = 2: n = (x^2 + p^2) / 4 - 1/2
    mean_n = (w * n_op).sum() * dx
    # the Weyl symbol of n^2 is |alpha|^4 - |alpha|^2, |alpha|^2 = (x^2 + p^2) / 4
    n2 = (w * ((gx ** 2 + gp ** 2) ** 2 / 16 - (gx ** 2 + gp ** 2) / 4)).sum() * dx
    exp, var = cir.photon_number_mean_var()
    _close(cir.quadrature_mean(), (w * gx).sum() * dx, 1e-6)
    _close(exp, mean_n, 1e-6)
    _close(var, n2 - mean_n ** 2, 1e-5)
    import jax
    jg = jph.QumodeCircuit(2, backend='gaussian')
    tg = tph.QumodeCircuit(2, backend='gaussian')
    for c in (jg, tg):
        c.s(0, 0.4, 0.2)
        c.d(1, 0.6, 1.0)
        c.bs([0, 1], [0.3, 0.2])
    tg()
    jg.state = list(_jax_forward(jg))
    _close(tg.quadrature_mean(), jg.quadrature_mean())
    for a, b in zip(tg.photon_number_mean_var(),
                    jax.jit(jph.qmath.photon_number_mean_var)(*jg.state)):
        _close(a, b)


# -------------------------------------------------------------------- Wigner
@pytest.mark.parametrize('backend', ['gaussian', 'bosonic'])
def test_cv_to_wigner_matches_jax(backend):
    def build(mod):
        cir = mod.QumodeCircuit(2, backend=backend)
        if backend == 'bosonic':
            cir.cat(0, r=1.3, theta=0.5, p=1)
        cir.s(1, 0.5, 0.3)
        cir.bs([0, 1], [0.4, 0.1])
        cir.d(0, 0.2, 0.1)
        return cir

    jcir, tcir = build(jph), build(tph)
    jcir.state = list(_jax_forward(jcir))
    tcir()
    got = tcir.wigner(1, npoints=40, plot=False)
    assert got.shape == (1, 40, 40)
    _close(got.sum() * (20 / 39) ** 2, 1.0, 1e-12)
    raw = tph.cv_to_wigner(tcir.state, 0, xrange=[-8, 8], prange=[-6, 6], npoints=[50, 30],
                           plot=False, normalize=False)
    import jax
    wigner = jax.jit(jwig.cv_to_wigner, static_argnames=('wire', 'xrange', 'prange', 'npoints',
                                                         'plot', 'normalize'))
    want = wigner(jcir.state, wire=0, xrange=(-8, 8), prange=(-6, 6), npoints=(50, 30),
                  plot=False, normalize=False)
    _close(raw, want, 1e-12)
    if backend == 'bosonic':
        assert raw.min() < -1e-3                  # an odd cat's Wigner function goes negative


# ------------------------------------------------------- the Bosonic sampler
def _marginal_chi2(xs, cov, mean, weight, lo, hi, nbins):
    """Pearson's chi-square of 1-D samples against p(x) = Re sum_k w_k
    N(x; mu_k, s_k^2) on nbins equal bins (the tails pooled), and its bound
    dof + 6 sqrt(2 dof)."""
    edges = np.linspace(lo, hi, nbins + 1)
    var, w = cov, weight
    # p(x) integrated numerically on a fine grid
    grid = np.linspace(lo - 20, hi + 20, 40001)
    px = np.real(np.sum(w[:, None] * np.exp(-(grid[None] - mean[:, None]) ** 2 / (2 * var[:, None]))
                        / np.sqrt(2 * np.pi * var[:, None]), 0))
    assert px.min() > -1e-12
    cdf = np.concatenate([[0], np.cumsum((px[1:] + px[:-1]) / 2 * np.diff(grid))])
    probs = np.diff(np.interp(np.concatenate([[grid[0]], edges, [grid[-1]]]), grid, cdf))
    obs = np.histogram(xs, np.concatenate([[-np.inf], edges, [np.inf]]))[0]
    exp = probs / probs.sum() * len(xs)
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any():
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / max(exp[~big].sum(), 1e-300))
    dof = int(big.sum()) + int((~big).any()) - 1
    return stat, dof + 6 * np.sqrt(2 * dof)


@pytest.mark.parametrize('kind', ['cat', 'gkp'])
def test_rejection_sampler_matches_the_marginal(kind):
    """Homodyne x samples of an odd cat (negative interference terms) and of
    a GKP state (negative weights) against p(x), by a chi-square; the
    JAX package's draw by |Re w| would miss both."""
    cir = tph.QumodeCircuit(1, backend='bosonic')
    if kind == 'cat':
        cir.cat(0, r=1.5, theta=0.0, p=1)
    else:
        # a cutoff this small keeps p(x) >= 0 (a coarse one truncates into negative
        # dips, where the sampler can only draw from the positive part)
        cir.gkp(0, theta=np.pi / 2, phi=0.0, amp_cutoff=1e-3, epsilon=0.2)
    cir.homodyne_x(0)
    cir()
    shots = 8000
    xs = cir.measure_homodyne(shots=shots, generator=torch.Generator().manual_seed(7)).numpy()
    cov, mean, weight = (t[0].numpy() for t in cir.state)
    eps2 = cir.measurements[0].cov_m[0, 0]
    stat, bar = _marginal_chi2(xs, cov[:, 0, 0] + eps2, mean[:, 0, 0], weight, -8, 8, 48)
    assert stat <= bar
    if kind == 'cat':
        # without measurements: the ideal homodyne of the same state draws the same law
        free = tph.QumodeCircuit(1, backend='bosonic')
        free._bosonic_states = cir._bosonic_states
        free()
        ys = free.measure_homodyne(shots=shots, generator=torch.Generator().manual_seed(8))
        assert ys.shape == (shots,)                         # the x quadrature
        stat, bar = _marginal_chi2(ys.numpy(), cov[:, 0, 0], mean[:, 0, 0], weight, -8, 8, 48)
        assert stat <= bar
