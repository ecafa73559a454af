"""PyTorch port vs the JAX package: the Fock-tensor photonic engine.

Every Fock gate matrix (one row of parameters and a batch of three), the
loss channel's Kraus operators and superoperator, tensor-mode forwards
(single, ``is_prob``, a data batch) and density matrices with loss, photon
statistics, quadrature means, Wigner functions (from one mode's reduced
density matrix), homodyne on Fock tensors with given outcomes, the Fock
MPS, ``qumode_from_jax`` on each circuit kind, and gradients of the tensor
route against ``jax.grad``. Inputs come from numpy seeds; both packages run
their complex128 policy on the CPU, and values are held to 1e-10. Where
the JAX package is at fault the port is held to the physics instead: the
``wires=`` marginal of ``measure`` (JAX ignores ``wires``) and the width of
the homodyne sampler's pdf (JAX's is sqrt(2) too wide; ROADMAP queue 3).
Each JAX reference runs under one ``jax.jit``, and the circuits are shared
through module fixtures: each new shape is a compile.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import photonic as jph
from deepquantum_tpu.photonic import channel as jch
from deepquantum_tpu.photonic import gates as jgates
from deepquantum_tpu_torch import photonic as tph
from deepquantum_tpu_torch.mps import full_tensor
from deepquantum_tpu_torch.photonic import channel as tch
from deepquantum_tpu_torch.photonic import circuit as tcirc
from deepquantum_tpu_torch.photonic import gates as tgates
from deepquantum_tpu_torch.photonic import measurement as tmeas

ATOL = 1e-10


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """torch and numpy's BLAS on one thread: the suite's workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    """The port's default device is the card; these tests ask for the CPU,
    and both packages run their complex128 policy (for the module: its
    fixtures build circuits once)."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def _jit(fn, *static):
    import jax
    return jax.jit(fn, static_argnames=static)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape), rtol=0, atol=atol)


def _chi2(obs, probs, shots):
    """Pearson's chi-square over the cells with an expected count >= 5 (the
    rest pooled), and its bound dof + 6 sqrt(2 dof)."""
    exp = shots * np.asarray(probs, np.float64) / np.sum(probs)
    obs = np.asarray(obs, np.float64)
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any():
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / max(exp[~big].sum(), 1e-300))
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    return stat, dof + 6 * np.sqrt(2 * dof)


# ----------------------------------------------------------- gate matrices
# (name, npara, cutoff, keyword arguments)
GATES = [('ps_fock', 1, 3, {}), ('bs_fock', 2, 4, {}), ('mzi_fock', 2, 5, {}),
         ('mzi_fock', 2, 3, {'phi_first': False}), ('bs_single_fock', 1, 6, {'convention': 'rx'}),
         ('bs_single_fock', 1, 4, {'convention': 'ry'}),
         ('bs_single_fock', 1, 3, {'convention': 'h'}), ('squeeze_fock', 2, 6, {}),
         ('squeeze2_fock', 2, 4, {}), ('disp_fock', 2, 5, {}), ('disp_position_fock', 1, 3, {}),
         ('disp_momentum_fock', 1, 4, {}), ('quad_phase_fock', 1, 5, {}), ('cx_fock', 1, 3, {}),
         ('cz_fock', 1, 4, {}), ('cubic_phase_fock', 1, 6, {}), ('kerr_fock', 1, 5, {}),
         ('cross_kerr_fock', 1, 3, {})]


def _gate_params():
    rng = np.random.default_rng(11)
    return [rng.uniform(-1.2, 1.2, (3, npara)) for _, npara, _, _ in GATES]


@pytest.fixture(scope='module')
def jax_gates():
    """Every JAX gate matrix at three parameter rows, in one jit program."""
    import jax

    def run(params):
        return [jax.vmap(lambda p, g=g: getattr(jgates, g[0])(p, g[2], **g[3]))(p)
                for g, p in zip(GATES, params)]
    return [np.asarray(m) for m in _jit(run)(_gate_params())]


GATE_IDS = [f'{g[0]}-c{g[2]}-{"".join(map(str, g[3].values()))}' for g in GATES]


@pytest.mark.parametrize('i', range(len(GATES)), ids=GATE_IDS)
def test_fock_gate_matrices_match_jax(i, jax_gates):
    name, npara, cutoff, kwargs = GATES[i]
    p = torch.as_tensor(_gate_params()[i])
    batch = getattr(tgates, name)(p, cutoff, **kwargs)
    one = getattr(tgates, name)(p[1], cutoff, **kwargs)
    k = 1 if batch.dim() == 3 else 2
    assert batch.shape == (3,) + (cutoff,) * (2 * k) and batch.dtype == torch.complex128
    _close(batch, jax_gates[i], 1e-12)
    _close(one, jax_gates[i][1], 1e-12)


def test_uany_fock_matches_jax_and_is_made_once(monkeypatch):
    rng = np.random.default_rng(12)
    for nt, cutoff in ((2, 4), (3, 3)):
        z = rng.normal(size=(nt, nt)) + 1j * rng.normal(size=(nt, nt))
        u = np.linalg.qr(z)[0]
        got = tgates.uany_fock_np(u, nt, cutoff)
        np.testing.assert_allclose(got, jgates.uany_fock_np(u, nt, cutoff), rtol=0, atol=1e-13)
    # the circuit makes it when the gate is added, and the forward reuses it
    cir = tph.QumodeCircuit(3, init_state=[1, 0, 0], cutoff=3, basis=False)
    cir.any(u, [0, 1, 2])
    # a two-mode unitary's tensor is the beam-splitter recurrence's
    u2 = np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0]
    _close(tgates.bs_fock_from_unitary(torch.as_tensor(u2), 5), tgates.uany_fock_np(u2, 2, 5),
           1e-13)
    monkeypatch.setattr(tgates, 'uany_fock_np', None)
    _close(cir().reshape(27), got.reshape(27, 27)[:, 9])


def test_loss_kraus_and_superoperator_match_jax():
    rng = np.random.default_rng(13)
    theta = rng.uniform(0.2, 2.5, (2, 1))
    want = [np.asarray(k) for k in _jit(lambda t: [jch.loss_kraus(r, 5) for r in t])(theta)]
    got = tch.loss_kraus(torch.as_tensor(theta), 5)
    _close(got, np.stack(want))
    # trace preserving below the cutoff: sum_k K^H K = I on n < cutoff
    kk = torch.einsum('bkmn,bkml->bnl', got.conj(), got)
    _close(kk, np.broadcast_to(np.eye(5), (2, 5, 5)), 1e-12)
    # the superoperator on a random rho is the Kraus sum
    a = rng.normal(size=(5, 5)) + 1j * rng.normal(size=(5, 5))
    rho = torch.as_tensor(a @ a.conj().T)
    sup = tch.loss_superop(torch.as_tensor(theta[0]), 5)
    out = (sup @ rho.reshape(-1)).reshape(5, 5)
    _close(out, sum(k @ rho @ k.conj().T for k in got[0]), 1e-12)


# ------------------------------------------------------------ tensor mode
def _unitary2(seed):
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)))[0]


def _all_gates(mod, den_mat=False, mps=False, chi=None):
    """Three modes at cutoff 4, every gate kind (fixed values)."""
    cir = mod.QumodeCircuit(3, init_state=[1, 0, 1], cutoff=4, basis=False, den_mat=den_mat,
                            mps=mps, chi=chi)
    cir.s(0, 0.3, 0.2)
    cir.d(1, 0.4, 0.5)
    cir.bs([0, 1], [0.7, 0.3])
    cir.k(2, [0.4])
    cir.ck([1, 2], [0.3])
    cir.cp(0, [0.2])
    cir.qp(1, [0.3])
    cir.cx([0, 1], [0.2])
    cir.cz([1, 2], [0.4])
    cir.s2([0, 1], 0.2, 0.1)
    cir.mzi([1, 2], [0.3, 0.6], phi_first=False)
    cir.x(2, [0.3])
    cir.z(0, [0.2])
    cir.bs_theta([0, 1], [0.3])
    cir.bs_rx([1, 2], [0.5])
    cir.r(0, [0.4], inv_mode=True)
    cir.any(_unitary2(14), [0, 2])
    cir.barrier()
    return cir


def _trainable(mod, den_mat=False):
    """Two modes at cutoff 5, a CV-QNN layer with trainable parameters
    (and loss on a density matrix)."""
    np.random.seed(15)
    cir = mod.QumodeCircuit(2, init_state=[0, 1], cutoff=5, basis=False, den_mat=den_mat)
    cir.bs([0, 1])
    cir.ps(0)
    cir.s(0, 0.2, 0.3)
    cir.s(1, 0.15, 0.1)
    cir.bs([0, 1])
    cir.d(0, 0.3, 0.4)
    cir.d(1, 0.2, 0.1)
    cir.k(0)
    cir.k(1)
    if den_mat:
        cir.loss_db(0, 1.5)
        cir.loss_t(1, 0.8)
    return cir


def _jax_state(cir, **kwargs):
    return np.asarray(cir(**kwargs))


@pytest.fixture(scope='module')
def pure():
    """The every-gate circuit in both packages, and the JAX state."""
    jcir, tcir = _all_gates(jph), _all_gates(tph)
    return jcir, tcir, _jax_state(jcir)


@pytest.fixture(scope='module')
def mixed():
    """The trainable layer on a density matrix with loss, and the JAX rho."""
    jcir, tcir = _trainable(jph, True), _trainable(tph, True)
    tcir._pvals = list(jcir._pvals)
    return jcir, tcir, _jax_state(jcir)


def test_tensor_forward_matches_jax(pure):
    jcir, tcir, want = pure
    got = tcir()
    assert got.shape == (4, 4, 4) and isinstance(tcir.init_state, tph.FockState)
    _close(got, want)
    # truncated squeezing and displacement are not unitary: the norm falls
    # below 1 and neither package renormalises
    norm = torch.linalg.vector_norm(got).item()
    assert abs(norm - np.linalg.norm(want)) <= ATOL and norm < 0.999
    _close(tcir(is_prob=True), np.abs(want) ** 2)


def test_tensor_forward_data_batch_matches_jax():
    def build(mod):
        cir = mod.QumodeCircuit(2, init_state=[1, 0], cutoff=4, basis=False)
        cir.s(0, encode=True)
        cir.bs([0, 1], [0.6, 0.2])
        cir.d(1, encode=True)
        cir.k(0, encode=True)
        return cir

    jcir, tcir = build(jph), build(tph)
    data = np.random.default_rng(16).uniform(-0.6, 0.6, (3, 5))
    got = tcir(data=data)
    assert got.shape == (3, 4, 4)
    _close(got, np.asarray(jcir(data=data)))
    _close(tcir(data=data[1]), got[1].detach().numpy())


def test_den_mat_with_loss_matches_jax(mixed):
    jcir, tcir, want = mixed
    got = tcir()
    assert got.shape == (5,) * 4
    _close(got, want)
    rho = got.reshape(25, 25)
    _close(rho, rho.mH.resolve_conj().numpy())           # hermitian
    trace = rho.diagonal().sum().real.item()
    assert 0.9 < trace < 1                                # truncation, not renormalised
    assert abs(trace - np.trace(want.reshape(25, 25)).real) <= ATOL
    _close(tcir(is_prob=True), np.abs(np.diagonal(want.reshape(25, 25))).reshape(5, 5))


def test_den_mat_of_a_pure_circuit_is_its_projector(pure):
    _, tcir, want = pure
    dcir = _all_gates(tph, den_mat=True)
    rho = dcir().reshape(64, 64)
    psi = want.reshape(-1)
    _close(rho, np.outer(psi, psi.conj()))


@pytest.mark.parametrize('which', ['pure', 'mixed'])
def test_photon_statistics_quadrature_and_wigner_match_jax(which, request):
    jcir, tcir, _ = request.getfixturevalue(which)
    tcir()
    jn, jv = jcir.photon_number_mean_var()
    tn, tv = tcir.photon_number_mean_var()
    _close(tn, jn)
    _close(tv, jv)
    _close(tcir.quadrature_mean(), jcir.quadrature_mean())
    _close(tcir.photon_number_mean_var(wires=1)[0], np.asarray(jn)[1])
    wire = 1 if which == 'pure' else 0           # one mode of each state
    _close(tcir.wigner(wire, npoints=24, plot=False), jcir.wigner(wire, npoints=24, plot=False))


def test_wigner_through_the_reduced_density_matrix(pure):
    """fock_to_wigner never forms psi psi^H: the reduced density matrix of a
    pure state equals the partial trace of its projector."""
    from deepquantum_tpu_torch.ops.qmath import partial_trace
    from deepquantum_tpu_torch.photonic.wigner import reduced_dm
    _, _, want = pure
    psi = torch.as_tensor(np.array(want))
    rho = torch.outer(psi.reshape(-1), psi.reshape(-1).conj())
    for wire in range(3):
        _close(reduced_dm(psi, wire, 3, 4)[0],
               partial_trace(rho, 3, [i for i in range(3) if i != wire], 4).numpy())


def test_gradients_match_jax_grad():
    """d sum<n> / d params of the tensor route (and of rho with loss)
    against jax.grad of the JAX circuit."""
    import jax
    import jax.numpy as jnp
    for den_mat in (False, True):
        jcir, tcir = _trainable(jph, den_mat), _trainable(tph, den_mat)
        tcir._pvals = list(jcir._pvals)

        def loss(p, jcir=jcir):
            jcir(params=p)
            return jnp.sum(jcir.photon_number_mean_var()[0])

        p0 = np.asarray(jcir.params)
        want = jax.jit(jax.grad(loss))(p0)
        p = dqt.params_from_numpy(p0, requires_grad=True)
        tcir(params=p)
        tcir.photon_number_mean_var()[0].sum().backward()
        _close(p.grad, want, 1e-9)


# --------------------------------------------------------------- homodyne
@pytest.mark.parametrize('den_mat', [False, True])
def test_homodyne_op_fock_with_samples_matches_jax(den_mat):
    def build(mod):
        cir = mod.QumodeCircuit(2, init_state=[1, 0], cutoff=5, basis=False, den_mat=den_mat)
        cir.s(0, 0.3, 0.1)
        cir.bs([0, 1], [0.6, 0.2])
        cir.homodyne(0, phi=0.4)
        return cir

    jcir, tcir = build(jph), build(tph)
    jstate, tstate = jcir(), tcir()
    op_j = jcir.measurements[0]
    import jax
    want = _jit(lambda s, key: op_j(s, samples=[0.7], key=key))(jstate, jax.random.PRNGKey(0))
    got = tcir.measurements[0](tstate, samples=[0.7])
    _close(got, want)
    assert tcir.measurements[0].samples.shape == (1, 1)
    # a batch of two rows, each its own outcome
    two = tcir.measurements[0](torch.stack([tstate, tstate]), samples=[0.7, -0.3])
    _close(two[0], want)
    one = tcir.measurements[0](tstate, samples=[-0.3])
    _close(two[1], one.numpy())
    # conditional measure_homodyne: shots x batch states, each projected
    xs = tcir.measure_homodyne(shots=6, generator=torch.Generator().manual_seed(0))
    assert xs.shape == (6,) and tcir.state_measured.shape == (6,) + tstate.shape


def test_homodyne_sampler_is_held_to_the_physics():
    """The port's pdf on its grid, a chi-square of its shots, and its
    moments against the Gaussian backend (the JAX package's pdf is
    sqrt(2) too wide: vacuum variance 2, not hbar / (4 kappa^2) = 1)."""
    r, theta, alpha = 0.4, 0.3, 0.5
    fock = tph.QumodeCircuit(1, init_state=[0], cutoff=20, basis=False)
    fock.s(0, r, theta)
    fock.d(0, alpha, 0.0)
    gauss = tph.QumodeCircuit(1, backend='gaussian')
    gauss.s(0, r, theta)
    gauss.d(0, alpha, 0.0)
    fock()
    cov, mean = gauss()
    gen = torch.Generator().manual_seed(1)
    shots = 40000
    xs = fock.measure_homodyne(shots=shots, generator=gen)
    assert xs.shape == (shots,)
    np.testing.assert_allclose(xs.mean().item(), mean[0, 0, 0].item(), atol=5 * np.sqrt(
        cov[0, 0, 0].item() / shots))
    assert abs(xs.var().item() / cov[0, 0, 0].item() - 1) <= 0.03
    assert abs(fock.quadrature_mean().item() - mean[0, 0, 0].item()) <= 1e-7   # the cutoff
    # a chi-square against the grid pdf
    from deepquantum_tpu_torch.photonic.wigner import reduced_dm
    pdf = tmeas.homodyne_pdf(reduced_dm(fock.state, 0, 1, 20))[0].numpy()
    grid = tmeas.homodyne_grid('cpu').numpy()
    obs = np.bincount(np.searchsorted(grid, xs.numpy()), minlength=len(grid))
    stat, bound = _chi2(obs, pdf, shots)
    assert stat <= bound
    # and the vacuum: x variance 1
    vac = tph.QumodeCircuit(2, init_state=[0, 0], cutoff=3, basis=False, den_mat=True)
    vac()
    v = vac.measure_homodyne(shots=shots, wires=1, generator=gen)
    assert abs(v.var().item() - 1) <= 0.03


# ---------------------------------------------------------------- measure
def test_measure_fock_tensor_and_rho_chi_square(pure, mixed):
    gen = torch.Generator().manual_seed(2)
    for fixture in (pure, mixed):
        _, tcir, _ = fixture
        tcir()
        probs = tcir(is_prob=True)
        tcir()
        counts = tcir.measure(shots=20000, generator=gen, with_prob=True)
        assert sum(v[0] for v in counts.values()) == 20000
        flat = probs.reshape(-1).numpy()
        c = tcir.cutoff
        obs = np.zeros_like(flat)
        for key, (n, p) in counts.items():
            idx = np.ravel_multi_index(tuple(key.state), (c,) * tcir.nmode)
            obs[idx] = n
            assert abs(p - flat[idx]) <= ATOL
        stat, bound = _chi2(obs, flat, 20000)
        assert stat <= bound


def test_measure_wires_is_the_marginal(pure):
    """The JAX package's Fock-tensor measure ignores ``wires`` (ROADMAP queue
    3); the port samples the marginal of the kept modes."""
    _, tcir, want = pure
    tcir()
    gen = torch.Generator().manual_seed(3)
    counts = tcir.measure(shots=20000, wires=[2, 0], with_prob=True, generator=gen)
    marginal = (np.abs(want) ** 2).sum(1)                # modes 0 and 2
    obs = np.zeros(16)
    for key, (n, p) in counts.items():
        assert key.nmode == 2
        obs[key.state[0] * 4 + key.state[1]] = n
        assert abs(p - marginal[key.state[0], key.state[1]]) <= ATOL
    stat, bound = _chi2(obs, marginal.reshape(-1), 20000)
    assert stat <= bound


def test_measure_searchsorted_branch(pure, monkeypatch):
    """Above torch.multinomial's 2^24 categories the draw takes the
    cumulative sums; the branch, forced at 64 categories, samples the same
    distribution."""
    _, tcir, want = pure
    tcir()
    monkeypatch.setattr(tcirc, 'MULTINOMIAL_MAX', 16)
    probs = torch.as_tensor(np.abs(want.reshape(1, -1)) ** 2)
    gen = torch.Generator().manual_seed(4)
    idx = tcirc.draw_outcomes(probs, 30000, gen)
    assert idx.shape == (1, 30000) and idx.max().item() < 64
    stat, bound = _chi2(np.bincount(idx[0].numpy(), minlength=64), probs[0].numpy(), 30000)
    assert stat <= bound
    counts = tcir.measure(shots=500, generator=gen)
    assert sum(counts.values()) == 500


# -------------------------------------------------------------------- MPS
def test_fock_mps_matches_the_dense_route_and_jax(pure):
    """8 sites would be exact at chi = c^(n/2); at 3 modes, cutoff 4, chi 16
    is exact: the MPS is the dense state, normalised after every gate."""
    _, _, want = pure
    jmps = _all_gates(jph, mps=True, chi=16)
    tmps = dqt.qumode_from_jax(jmps)
    assert tmps.mps and tmps.chi == 16
    got = full_tensor(tmps()).reshape(4, 4, 4)
    _close(got, want / np.linalg.norm(want))
    # measure on the MPS: every outcome's probability, a chi-square
    gen = torch.Generator().manual_seed(5)
    counts = tmps.measure(shots=20000, generator=gen, with_prob=True)
    probs = (np.abs(want) ** 2 / np.sum(np.abs(want) ** 2)).reshape(-1)
    obs = np.zeros(64)
    for key, (n, p) in counts.items():
        idx = np.ravel_multi_index(tuple(key.state), (4, 4, 4))
        obs[idx] = n
        assert abs(p - probs[idx]) <= ATOL
    stat, bound = _chi2(obs, probs, 20000)
    assert stat <= bound


def test_fock_mps_bond_of_a_beam_splitter_is_c_squared():
    cir = tph.QumodeCircuit(4, init_state=[1, 1, 0, 0], cutoff=3, basis=False, mps=True, chi=64)
    cir.bs([1, 2], [0.5, 0.3])
    cir.bs([0, 1], [0.4, 0.2])
    cir.bs([2, 3], [0.3, 0.1])
    sites = cir()
    assert max(t.shape[-1] for t in sites) <= 9
    dense = tph.QumodeCircuit(4, init_state=[1, 1, 0, 0], cutoff=3, basis=False)
    dense._pvals = list(cir._pvals)
    dense.operators = cir.operators
    _close(full_tensor(sites).reshape((3,) * 4), dense().numpy())


# ----------------------------------------------------------- interop, noise
def _kinds():
    """One small JAX circuit of each kind qumode_from_jax carries."""
    np.random.seed(17)
    out = {}
    c = jph.QumodeCircuit(2, init_state=[1, 0], cutoff=4, basis=False)
    c.k(0)
    c.ck([0, 1])
    c.cp(1)
    c.bs([0, 1])
    c.any(_unitary2(18), [0, 1])
    c.clements(_unitary2(19))
    out['tensor'] = c
    c = jph.QumodeCircuit(2, init_state=np.eye(4)[1][:, None] * np.eye(4)[2], cutoff=4,
                          basis=False)
    c.s(0, 0.3, 0.1)
    c.bs([0, 1])
    out['init tensor'] = c
    c = jph.QumodeCircuit(2, init_state=[1, 0], cutoff=4, basis=False, den_mat=True)
    c.d(0, 0.3, 0.2)
    c.bs([0, 1])
    c.loss(1, [0.6])
    c.homodyne(1, phi=0.3)
    out['den_mat, loss, homodyne'] = c
    c = jph.QumodeCircuit(2, init_state=[1, 0], cutoff=4, basis=False, noise=True, sigma=0.05)
    c.bs([0, 1])
    c.k(0)
    out['build-time noise'] = c
    return out


@pytest.mark.parametrize('kind', list(_kinds()))
def test_qumode_from_jax_fock_kinds(kind):
    jcir = _kinds()[kind]
    tcir = dqt.qumode_from_jax(jcir)
    assert (tcir.basis, tcir.den_mat, len(tcir.operators)) == \
        (jcir.basis, jcir.den_mat, len(jcir.operators))
    _close(tcir(), _jit(lambda: jcir())())
    if jcir.measurements:
        assert type(tcir.measurements[0]).__name__ == 'Homodyne'
        assert tcir.measurements[0].den_mat and tcir.measurements[0].phi == 0.3


def test_per_forward_noise_matches_jax_and_is_reproducible():
    import jax.numpy as jnp
    jcir = jph.QumodeCircuit(2, init_state=[1, 0], cutoff=4, basis=False, noise=True,
                             noise_per_forward=True, sigma=0.05)
    jcir.bs([0, 1], [0.6, 0.2])
    jcir.k(0, [0.3])
    tcir = dqt.qumode_from_jax(jcir)
    assert tcir._noise_pidx == [0, 1, 2] and tcir.noise_per_forward
    gen = torch.Generator().manual_seed(6)
    jitter = tcir._noise_jitter(torch.Generator().manual_seed(6))
    got = tcir(noise_generator=gen)
    want = _jit(lambda j: jcir._forward_fock(None, None, None, True, None, j))(
        jnp.asarray(jitter.numpy()))
    _close(got, want)
    again = tcir(noise_generator=torch.Generator().manual_seed(6))
    assert torch.equal(got, again)
    assert not torch.equal(got, tcir(noise_generator=gen))
    # and on the Gaussian backend, the same jitter on the symplectic maps
    gcir = tph.QumodeCircuit(2, backend='gaussian', noise=True, noise_per_forward=True)
    gcir.s(0, 0.3, 0.0)
    cov1 = gcir(noise_generator=torch.Generator().manual_seed(7))[0]
    cov2 = gcir(noise_generator=torch.Generator().manual_seed(7))[0]
    assert torch.equal(cov1, cov2) and gcir._noise_pidx == [0, 1]


def test_build_time_noise_draws_as_jax():
    def build(mod):
        np.random.seed(20)
        cir = mod.QumodeCircuit(2, init_state=[1, 0], cutoff=3, basis=False, noise=True,
                                mu=0.01, sigma=0.05)
        cir.bs([0, 1], [0.6, 0.2])
        cir.s(1, 0.2, 0.1)
        return cir

    jcir, tcir = build(jph), build(tph)
    assert tcir._pvals == jcir._pvals and tcir._pvals[0] != 0.6
    _close(tcir(), _jit(lambda: jcir())())


# ------------------------------------------------------------ delay, states
def test_delay_on_the_fock_backend_runs_through_global_circuit():
    """A delay loop on Fock tensors through global_circuit, held to the
    Gaussian backend's global circuit: mean photon numbers of a weakly
    squeezed source at cutoff 8 (the truncation leaves < 1e-6)."""
    def build(backend, **kwargs):
        np.random.seed(21)
        cir = tph.QumodeCircuit(1, init_state='vac', cutoff=8, backend=backend, **kwargs)
        cir.s(0, 0.15, 0.0)
        cir.delay(0, ntau=1, inputs=[0.7, 0.3])
        return cir

    fock = build('fock', basis=False)
    with pytest.raises(ValueError, match='global_circuit'):
        fock()
    gfock = fock.global_circuit(3)
    assert (gfock.nmode, gfock.basis) == (4, False)
    gfock()
    gauss = build('gaussian').global_circuit(3)
    gauss()
    _close(gfock.photon_number_mean_var()[0][:, 0], gauss.photon_number_mean_var()[0][0], 1e-6)


def test_dense_fock_states():
    s = tph.FockState([1, 0, 2], cutoff=3, basis=False)
    t = s.tensor('cpu')
    assert t.shape == (3, 3, 3) and t[1, 0, 2] == 1 and t.abs().sum() == 1
    assert s.state.shape == (3, 3, 3) and s != tph.FockState([1, 0, 2], cutoff=3, basis=False)
    rho = tph.FockState([1, 0], cutoff=2, basis=False, den_mat=True)
    assert rho.tensor('cpu').shape == (2,) * 4 and rho.tensor('cpu')[1, 0, 1, 0] == 1
    vac = tph.FockState('vac', nmode=2, cutoff=4, basis=False)
    assert vac.tensor('cpu')[0, 0] == 1 and repr(vac).startswith('FockState(tensor')
    dense = tph.FockState(np.ones((2, 2)) / 2, basis=False)
    assert (dense.nmode, dense.cutoff) == (2, 2)
    with pytest.raises(ValueError, match='Fock matrix'):
        tph.QumodeCircuit(1, backend='gaussian').k(0, [0.1])
    with pytest.raises(ValueError, match='tensor mode'):
        tph.QumodeCircuit(2, den_mat=True)
