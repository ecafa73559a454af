"""PyTorch port vs the JAX package: the ten user scripts of ``examples/``.

Each port module (``deepquantum_tpu_torch/examples/``) takes the same
inputs as its JAX script: the same seeds, and parameters carried across
(``params_from_numpy``, ``HybridQNN.load_numpy``). Training is held over
its first Adam steps, the JAX side under one ``jax.jit`` (a ``lax.scan``
over optax's Adam): VQE, QAOA and the hybrid classifier to 1e-4 relative,
the distributed VQE (4 CPU shards) to 1e-5; the GBS tables to 1e-10 at
complex128; the HHL, state-transfer and MBQC states to 1e-6; the mapper's
transfer matrices to 1e-6; SPSA's trajectory from ``random_state=0``. The
scripts that train at import (``hybrid_qnn.py``, ``onchip_optimizer.py``)
are not run: the test builds their JAX circuit itself. The state-transfer
state is held at 20 Trotter steps (the script's 200 compile for ~26 s on
the JAX side); the port's ``main`` runs at each script's own size and
passes its assertions there.
"""

import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.examples import (distributed_vqe, gaussian_boson_sampling, hhl,
                                            hybrid_qnn, mbqc_basic_gates, onchip_optimizer, qaoa,
                                            state_transfer_1d, unitary_mapper, vqe)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ('distributed_vqe', 'gaussian_boson_sampling', 'hhl', 'hybrid_qnn',
            'mbqc_basic_gates', 'onchip_optimizer', 'qaoa', 'state_transfer_1d',
            'unitary_mapper', 'vqe')


@pytest.fixture(autouse=True, scope='module')
def _one_thread():
    """torch and numpy's BLAS on one thread: the suite's workers share the
    machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1, user_api='blas'):
        yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    dqt.set_device('cpu')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


@pytest.fixture
def c128():
    """Both packages at complex128."""
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')


def _script(name: str) -> dict:
    """The JAX script's globals: its module-level code runs, ``main`` does
    not."""
    return runpy.run_path(os.path.join(ROOT, 'examples', f'{name}.py'), run_name=f'jax_{name}')


def _adam_jax(loss, params, lr: float, steps: int) -> np.ndarray:
    """loss at each of ``steps`` optax Adam steps, one jax.jit."""
    opt = optax.adam(lr)

    def body(carry, _):
        p, s = carry
        val, grads = jax.value_and_grad(loss)(p)
        updates, s = opt.update(grads, s)
        return (optax.apply_updates(p, updates), s), val

    run = jax.jit(lambda p: jax.lax.scan(body, (p, opt.init(p)), None, length=steps)[1])
    return np.asarray(run(params))


def _seeded_params(cir, seed: int = 0) -> np.ndarray:
    cir.init_para(seed)
    return cir.params.numpy().astype(np.float64)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_vqe_matches_jax():
    g = _script('vqe')
    p0 = _seeded_params(vqe.build(device='cpu'))
    ref = _adam_jax(g['energy'], jnp.asarray(p0), 0.05, 5)
    out = vqe.main(steps=5, seed=0)
    assert _rel(out['energies'], ref) < 1e-4


def test_qaoa_matches_jax():
    g = _script('qaoa')
    assert qaoa.regular_graph(6) == [tuple(e) for e in g['edges']]
    p0 = _seeded_params(qaoa.build(6, 3, qaoa.EDGES_6, 'cpu'))
    ref = _adam_jax(g['cost'], jnp.asarray(p0), 0.1, 5)
    out = qaoa.main(steps=5, seed=0, generator=torch.Generator().manual_seed(1))
    assert _rel(out['costs'], ref) < 1e-4
    assert sum(out['counts'].values()) == 500 and out['cut'] == (9 - out['costs'][-1]) / 2


def test_qaoa_graphs():
    """The script's graph is networkx's random_regular_graph(3, 6, seed=7);
    past it the pairing model draws simple 3-regular graphs."""
    nx = pytest.importorskip('networkx')
    assert qaoa.EDGES_6 == list(nx.random_regular_graph(3, 6, seed=7).edges)
    for n in (8, 18):
        edges = qaoa.regular_graph(n, seed=7)
        degree = np.bincount(np.asarray(edges).reshape(-1), minlength=n)
        assert len(edges) == 3 * n // 2 == len(set(edges)) and (degree == 3).all()
        assert all(a < b for a, b in edges) and edges == qaoa.regular_graph(n, seed=7)


def test_hybrid_qnn_matches_jax():
    """The script's rings, W and circuit (built here: the script trains at
    import); five Adam epochs on the linear layer and the circuit."""
    n, layers, batch = hybrid_qnn.N, hybrid_qnn.LAYERS, hybrid_qnn.B
    rng = np.random.default_rng(0)
    x, y = hybrid_qnn.rings(rng, batch)
    cir = dq.QubitCircuit(n)
    for _ in range(layers):
        for i in range(n):
            cir.ry(i, encode=True)
        for i in range(n):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0, basis='z')
    w = rng.normal(0, 0.5, (2, n * layers)).astype(np.float32)
    b = np.zeros(n * layers, np.float32)
    q = np.asarray(cir.params)

    def loss(p):
        z = cir.expectation(data=jnp.asarray(x[:batch]) @ p['w'] + p['b'], params=p['q'])[..., 0]
        return jnp.mean(optax.sigmoid_binary_cross_entropy(2.0 * z, jnp.asarray(y[:batch])))

    ref = _adam_jax(loss, {'w': jnp.asarray(w), 'b': jnp.asarray(b), 'q': jnp.asarray(q)}, 0.05, 5)
    model = hybrid_qnn.HybridQNN(n, layers, 'cpu')
    model.load_numpy(w, b, q)
    assert torch.equal(model.linear.weight.detach(), torch.as_tensor(w.T))
    losses = hybrid_qnn.train(model, torch.as_tensor(x[:batch]), torch.as_tensor(y[:batch]), 5)
    assert _rel(losses, ref) < 1e-4


def test_hybrid_qnn_main_at_the_script_size():
    out = hybrid_qnn.main()
    assert out['acc'] > 0.85 and len(out['losses']) == 60 and out['losses'][-1] < out['losses'][0]


def test_distributed_vqe_matches_jax(tmp_path):
    """n=12, 2 layers on 4 CPU shards: two steps, a checkpoint, a restart and
    one more step, against three uninterrupted JAX steps."""
    from deepquantum_tpu.parallel import make_mesh as jax_mesh
    g = _script('distributed_vqe')
    cir = g['build'](12, 2, jax_mesh(4))
    p0 = _seeded_params(distributed_vqe.build(12, 2, dqt.parallel.make_mesh(4)))
    ref = _adam_jax(lambda p: cir.expectation(params=p)[0], jnp.asarray(p0), 0.05, 3)
    out = distributed_vqe.main(12, 2, steps=2, ckpt_every=2, resume_steps=1,
                               mesh=dqt.parallel.make_mesh(4), seed=0, ckpt_dir=str(tmp_path))
    assert out['resumed_at'] == 2 and out['shards'] == 4
    assert np.max(np.abs(np.asarray(out['values'] + out['resumed']) - ref)) < 1e-5


def test_distributed_vqe_resumes_where_it_saved(tmp_path):
    """Five steps with a checkpoint every two resume from step 4, as the
    script does: the resumed steps equal steps 5-6 of an uninterrupted run."""
    mesh = dqt.parallel.make_mesh(2)
    whole = distributed_vqe.main(8, 2, steps=6, ckpt_every=6, resume_steps=0, mesh=mesh, seed=3,
                                 ckpt_dir=str(tmp_path / 'a'))
    cut = distributed_vqe.main(8, 2, steps=5, ckpt_every=2, resume_steps=2, mesh=mesh, seed=3,
                               ckpt_dir=str(tmp_path / 'b'))
    assert cut['resumed_at'] == 4 and whole['resumed'] == []
    np.testing.assert_allclose(cut['resumed'], whole['values'][4:6], rtol=0, atol=1e-12)
    np.testing.assert_allclose(cut['values'], whole['values'][:5], rtol=0, atol=0)


def test_gbs_tables_match_jax(c128):
    from scipy.stats import unitary_group

    from deepquantum_tpu.photonic.ansatz import GaussianBosonSampling
    gbs = GaussianBosonSampling(nmode=4, squeezing=gaussian_boson_sampling.SQUEEZING_4,
                                unitary=unitary_group.rvs(4, random_state=0), cutoff=3,
                                backend='gaussian')
    tables = {'probs': gbs(is_prob=True), 'probs_click': gbs(is_prob=True, detector='threshold')}
    mean, var = (np.asarray(a) for a in gbs.photon_number_mean_var())
    out = gaussian_boson_sampling.main(generator=torch.Generator().manual_seed(0))
    for key, ref in tables.items():
        ref = {tuple(np.asarray(k.state).tolist()): float(np.asarray(v).reshape(()))
               for k, v in ref.items()}
        got = {tuple(np.asarray(k.state).tolist()): float(v) for k, v in out[key].items()}
        assert got.keys() == ref.keys()
        assert max(abs(got[k] - ref[k]) for k in ref) < 1e-10
    np.testing.assert_allclose(out['mean'].numpy(), mean, atol=1e-10)
    np.testing.assert_allclose(out['var'].numpy(), var, atol=1e-10)
    assert sum(out['samples'].values()) == 1000 and abs(out['click_total'] - 1) < 1e-10


def test_hhl_matches_jax(c128):
    g = _script('hhl')
    out = hhl.main()
    np.testing.assert_allclose(out['state'].numpy(), g['state'], atol=1e-6)
    assert abs(out['fidelity'] - g['fidelity']) < 1e-6


def test_state_transfer_matches_jax(c128):
    """The state at 20 Trotter steps against the JAX circuit built as the
    script builds it; the port's main at the script's 200 passes its bars."""
    n, steps = 5, 20
    j, dt = state_transfer_1d.couplings(n), state_transfer_1d.T / steps
    cir = dq.QubitCircuit(n)
    for _ in range(steps):
        for i in range(n - 1):
            cir.rxx([i, i + 1], inputs=j[i] * dt)
            cir.ryy([i, i + 1], inputs=j[i] * dt)
    init = state_transfer_1d.initial_state(n, state_transfer_1d.ALPHA, state_transfer_1d.BETA)
    ref = np.asarray(cir(state=init)).reshape(-1)
    got = state_transfer_1d.build(n, steps, device='cpu')(state=torch.as_tensor(init))
    np.testing.assert_allclose(got.reshape(-1).numpy(), ref, atol=1e-6)
    out = state_transfer_1d.main()
    assert out['leak'] < 1e-3 and out['fidelity'] > 0.999


def _phase_aligned(a, b) -> float:
    a, b = np.asarray(a).reshape(-1), np.asarray(b).reshape(-1)
    phase = np.vdot(a, b) / abs(np.vdot(a, b))
    return float(np.max(np.abs(a * phase - b)))


def test_mbqc_matches_jax(c128):
    """The transpiled pattern's output against the JAX script's (both up to
    the global phase the outcomes leave), and the two teleportations."""
    g = _script('mbqc_basic_gates')
    out = mbqc_basic_gates.main(generator=torch.Generator().manual_seed(5))
    assert _phase_aligned(out['pattern_state'].numpy(), g['state']) < 1e-6
    np.testing.assert_allclose(out['target'].numpy(), np.asarray(g['target']).reshape(-1),
                               atol=1e-6)
    assert min(out['h_overlap'], out['j_overlap'], out['overlap']) > 1 - 1e-6


def test_unitary_mapper_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv('DQ_MAPPER_CACHE', str(tmp_path))
    g = _script('unitary_mapper')
    out = unitary_mapper.main()
    np.testing.assert_allclose(out['cnot_transfer'], g['transfer'], atol=1e-6)
    np.testing.assert_allclose(out['cnot_unitary'], g['u'], atol=1e-6)


def _jax_objective():
    """The JAX script's objective (the script optimises at import)."""
    def neg_target_prob(phases):
        phases = np.asarray(phases, dtype=float).reshape(-1)
        cir = dq.photonic.QumodeCircuit(nmode=4, init_state=[1, 0, 0, 0], cutoff=2,
                                        backend='fock', basis=True)
        k = 0
        for i in range(3):
            for j in range(3 - i):
                cir.mzi([j, j + 1], inputs=[phases[k], phases[k + 1]])
                k += 2
        cir()
        return -float(np.abs(np.asarray(cir.get_amplitude([0, 0, 1, 0]))) ** 2)
    return neg_target_prob


def test_spsa_trajectory_matches_jax(c128):
    from deepquantum_tpu.optimizer import OptimizerSPSA as JaxSPSA
    hyper = {'a': 0.5, 'c': 0.05, 'A': 20, 'nepoch': 300, 'alpha': 0.602, 'gamma': 0.101}
    x0 = np.full(12, 0.3)
    ref = JaxSPSA(_jax_objective(), x0, random_state=0)
    ours = dqt.optimizer.OptimizerSPSA(onchip_optimizer.objective(4, [1, 0, 0, 0], [0, 0, 1, 0],
                                                                  2, 'cpu'), x0, random_state=0)
    for opt in (ref, ours):
        opt.set_hyperparam(hyper)
    for _ in range(4):
        best = [np.asarray(opt.run(1)) for opt in (ref, ours)]
        np.testing.assert_allclose(ours.params, ref.params, rtol=0, atol=1e-10)
        np.testing.assert_allclose(best[1], best[0], rtol=0, atol=1e-10)


def test_onchip_optimizer_main_at_the_script_size():
    out = onchip_optimizer.main()
    assert max(out['results'].values()) > 0.9 and out['initial'] < 0.1


@pytest.mark.parametrize('name', EXAMPLES)
def test_main_raises_without_the_card(name):
    """With the default device (the card) and no card, ``main`` raises
    through ``config.resolve_device``, before any work."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    dqt.set_device(None)
    module = sys.modules[f'deepquantum_tpu_torch.examples.{name}']
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        module.main()


def test_examples_import_no_jax():
    """Importing every example module loads none of jax, optax, flax,
    networkx or deepquantum_tpu, and runs nothing."""
    mods = ', '.join(f'deepquantum_tpu_torch.examples.{n}' for n in EXAMPLES)
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            f'import {mods}; '
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'flax', 'networkx', 'deepquantum_tpu')]; assert not bad, bad")
    out = subprocess.run([sys.executable, '-c', code, ROOT], check=True, timeout=120,
                         capture_output=True, text=True)
    assert out.stdout == ''
