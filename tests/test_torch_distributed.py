"""PyTorch port vs the JAX package: distributed circuits on a CPU mesh.

The port's meshes here are 1, 2, 4 and 8 shards on the CPU
(``set_device('cpu')``, ``make_mesh(k)``), the counterpart of the JAX
tests' 8 virtual devices (tests/conftest.py). Both of the port's engines
('gspmd': complex shards gate by gate under autograd; 'shardmap': the
pair-exchange program on float planes with one backward across the
exchanges) are held to the JAX ``DistributedQubitCircuit`` and to the
port's local engine: states, expectations and gradients at 1e-10 under
complex128. The shardmap engine on the planes at complex64 is held to the
JAX ``ShardMapSimulator(planar=True)`` with its Pallas kernels in
interpret mode (1e-5, the JAX test's bar), its schedule of a 16-qubit
circuit on 2 shards step for step to the JAX program's, and its 'g1' and
'remap' steps' matrix cotangents to autograd through a dense reference.
Samples are held by a chi-square (dof + 6 sqrt(2 dof)). The sharded Fock
tensor is held to the JAX ``DistributedQumodeCircuit``. Each JAX
reference runs under one ``jax.jit``; torch and BLAS use one thread.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.parallel import DistributedQubitCircuit as JDist
from deepquantum_tpu.parallel import make_mesh as jmesh
from deepquantum_tpu_torch.parallel import DistributedQubitCircuit, make_mesh
from deepquantum_tpu_torch.parallel import shardmap_engine as tse
from deepquantum_tpu_torch.parallel.sharded import full_params

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-10
MESHES = (1, 2, 4, 8)


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


def _build(cir, n, angles):
    """tests/test_distributed.py::_build: global and local targets, a
    controlled gate across the mesh and a Toffoli with two global
    controls."""
    k = 0
    for i in range(n):
        cir.rx(i, inputs=angles[k])
        k += 1
    for i in range(n - 1):
        cir.cnot(i, i + 1)
    for i in range(n):
        cir.rz(i, inputs=angles[k])
        k += 1
    cir.crx(0, n - 1, inputs=angles[k])
    cir.ccx(1, 2, 0)
    cir.observable(0, basis='z')
    cir.observable(list(range(n)), basis='x' * n)
    cir._train_mask = [True] * len(cir._pvals)


N_BUILD = 5
_ANGLES = np.random.default_rng(0).random(2 * N_BUILD + 1) * 2 * np.pi


@pytest.fixture(scope='module')
def local_ref():
    """The port's local engine on _build: state, values, gradients of both
    observables."""
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    cir = dqt.QubitCircuit(N_BUILD)
    _build(cir, N_BUILD, _ANGLES)
    state = _np(cir()).reshape(-1)
    vals = _np(cir.expectation())
    grads = []
    for i in range(2):
        p = cir.params.requires_grad_()
        cir.expectation(params=p)[i].backward()
        grads.append(_np(p.grad))
    return state, vals, grads


_JAX_REFS: dict = {}


def _jax_ref(size):
    """The JAX DistributedQubitCircuit on a mesh of ``size`` virtual
    devices: state, values, gradients (one jit each)."""
    if size not in _JAX_REFS:
        import jax
        cir = JDist(N_BUILD, mesh=jmesh(size))
        _build(cir, N_BUILD, _ANGLES)

        def run(q):
            return (cir.forward(params=q), cir.expectation(params=q),
                    jax.jacrev(lambda r: cir.expectation(params=r))(q))

        out = jax.jit(run)(cir.params)
        _JAX_REFS[size] = (cir, *(np.asarray(o) for o in out))
    return _JAX_REFS[size]


@pytest.mark.parametrize('size', MESHES)
@pytest.mark.parametrize('engine', ['gspmd', 'shardmap'])
def test_build_matches_jax_and_local(size, engine, local_ref):
    jcir, jstate, jvals, jgrad = _jax_ref(size)
    cir = DistributedQubitCircuit(N_BUILD, mesh=make_mesh(size), engine=engine)
    _build(cir, N_BUILD, _ANGLES)
    assert cir.engine == engine and len(cir.mesh.devices) == size
    state = _np(cir())
    np.testing.assert_allclose(state, jstate, atol=ATOL)
    np.testing.assert_allclose(state, local_ref[0], atol=ATOL)
    assert len(cir.shards) == size and cir.shards[0].shape == (2 ** N_BUILD // size,)
    vals = _np(cir.expectation())
    np.testing.assert_allclose(vals, jvals, atol=ATOL)
    np.testing.assert_allclose(vals, local_ref[1], atol=ATOL)
    for i in range(2):
        p = cir.params.requires_grad_()
        cir.expectation(params=p)[i].backward()
        np.testing.assert_allclose(_np(p.grad), jgrad[i], atol=ATOL)
        np.testing.assert_allclose(_np(p.grad), local_ref[2][i], atol=ATOL)


_PAR_RNG = np.random.default_rng(11)
_PAR_ANGLES = _PAR_RNG.random(N_BUILD)
_PAR_DATA = _PAR_RNG.random(N_BUILD)
_PAR_INIT = _PAR_RNG.normal(size=1 << N_BUILD) + 1j * _PAR_RNG.normal(size=1 << N_BUILD)
_PAR_INIT /= np.linalg.norm(_PAR_INIT)


def _parity_build(cir, n=N_BUILD):
    for i in range(n):
        cir.rx(i, encode=True)
    for i in range(n - 1):
        cir.cnot(i, i + 1)
    for i in range(n):
        cir.ry(i, inputs=float(_PAR_ANGLES[i]))
    cir.observable(0)
    cir.observable(list(range(n)), basis='z' * n)


@pytest.fixture(scope='module')
def parity_ref():
    """The JAX package's local circuit on the data and initial state:
    state, values and d <Z...Z> / d data."""
    import jax
    jc = dq.QubitCircuit(N_BUILD)
    _parity_build(jc)
    js = np.asarray(jc(data=_PAR_DATA, state=_PAR_INIT)).reshape(-1)
    je, jd = jax.jit(lambda d: (jc.expectation(data=d, state=_PAR_INIT), jax.jacrev(
        lambda x: jc.expectation(data=x, state=_PAR_INIT)[1])(d)))(_PAR_DATA)
    return js, np.asarray(je), np.asarray(jd)


@pytest.mark.parametrize('engine', ['gspmd', 'shardmap'])
def test_data_encoding_and_initial_state(engine, parity_ref):
    """tests/test_distributed.py::_parity_suite through both engines on 8
    shards: encoder data, a custom initial state (flat, and as a
    DistributedQubitState's shards), values and the gradient in the data
    against the JAX package's local circuit; the Z string from 20 000
    samples within 0.05."""
    js, je, jd = parity_ref
    data, init = _PAR_DATA, _PAR_INIT
    cir = DistributedQubitCircuit(N_BUILD, mesh=make_mesh(8), engine=engine)
    _parity_build(cir)
    np.testing.assert_allclose(_np(cir(data=data, state=init)), js, atol=ATOL)
    d = torch.tensor(data, requires_grad=True)
    e = cir.expectation(data=d, state=init)
    e[1].backward()
    np.testing.assert_allclose(_np(e), np.asarray(je), atol=ATOL)
    np.testing.assert_allclose(_np(d.grad), np.asarray(jd), atol=ATOL)
    shards = dqt.DistributedQubitState(N_BUILD, mesh=cir.mesh)
    shards.shards = cir.sim.shard(torch.as_tensor(init))
    np.testing.assert_allclose(_np(cir(data=data, state=shards)), js, atol=ATOL)
    counts = cir.measure(shots=20_000, generator=torch.Generator().manual_seed(0))
    z = sum(c * (-1) ** k.count('1') for k, c in counts.items()) / 20_000
    assert abs(z - float(je[1])) < 0.05


def test_auto_engine_and_mesh():
    mesh = make_mesh(8)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device('cpu')}
    assert make_mesh().size == 1 and make_mesh(devices=['cpu'] * 4, n_devices=2).size == 2
    assert DistributedQubitCircuit(4, mesh=mesh).engine == 'gspmd'     # a CPU mesh
    with pytest.raises(ValueError, match='power of 2'):
        DistributedQubitCircuit(4, mesh=make_mesh(3))
    with pytest.raises(ValueError, match='engine'):
        DistributedQubitCircuit(4, mesh=mesh, engine='xla')
    assert dqt.setup_distributed() == (0, 1, 1)
    dqt.cleanup_distributed()
    state = dqt.DistributedQubitState(4, mesh=make_mesh(4))
    assert state.world_size == 4 and state.rank == 0 and len(state.shards) == 4
    np.testing.assert_allclose(_np(state.amps), np.eye(16)[0])


def test_setup_distributed_gloo_group_and_imports_without_jax(tmp_path):
    """Two processes given WORLD_SIZE / RANK join one gloo group on
    localhost and all-reduce. Each imports the port and every name that
    used to raise, and finds no jax, networkx, matplotlib or JAX package
    loaded."""
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    names = ('DistributedQubitCircuit', 'DistributedQubitState', 'setup_distributed',
             'cleanup_distributed', 'DistributedFockState', 'DistributedQumodeCircuit',
             'UnitaryMapper', 'DrawClements', 'parallel')
    code = ('import sys, torch, torch.distributed as dist, deepquantum_tpu_torch as dqt\n'
            f'for n in {names!r}: getattr(dqt, n)\n'
            'dqt.photonic.DrawCircuit; dqt.photonic.utils; dqt.photonic.mapper\n'
            "bad = [m for m in ('jax', 'networkx', 'matplotlib', 'deepquantum_tpu') "
            'if m in sys.modules]\n'
            'r, w, _ = dqt.setup_distributed()\n'
            't = torch.tensor([float(r + 1)]); dist.all_reduce(t)\n'
            'print(r, w, t.item(), len(bad)); dqt.cleanup_distributed()\n')
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE='2', RANK=str(rank), MASTER_PORT=str(port),
                   PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
        procs.append(subprocess.Popen([sys.executable, '-c', code], env=env, cwd=tmp_path,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(o.split() for o, _ in outs) == [['0', '2', '3.0', '0'], ['1', '2', '3.0', '0']]


def _pallas_circuit(n):
    cir = dq.QubitCircuit(n)
    for i in range(n):
        cir.rx(i)
    cir.cnot(0, 12)             # remap with a kernel local apply
    cir.cnot(5, 6)
    cir.observable(0)
    return cir


def test_shardmap_planes_match_jax_pallas_interpret():
    """complex64, n=13 on 8 shards (nlocal 10): the JAX engine with its
    Pallas kernels in interpret mode, the port's through the wrappers
    (their twins on CPU shards); values and gradients 1e-5."""
    import jax
    from deepquantum_tpu.parallel.shardmap_engine import ShardMapSimulator as JSim
    n = 13
    jc = _pallas_circuit(n)
    p = np.asarray(jc.params)
    dq.set_dtype('complex64')
    try:
        jsim = JSim(n, jmesh(8), planar=True)
        assert jsim.cfg.use_pallas
        je, jg = jax.jit(jax.value_and_grad(lambda q: jsim.expectation(jc, params=q)[0]))(p)
    finally:
        dq.set_dtype('complex128')
    dqt.set_dtype('complex64')
    tc = dqt.from_jax(jc)
    sim = tse.ShardMapSimulator(n, make_mesh(8), planar=True)
    assert sim.use_kernels
    for fused in (True, False):
        tc.fused_bwd = fused
        q = dqt.params_from_numpy(p, requires_grad=True)
        e = sim.expectation(tc, params=q)[0]
        e.backward()
        np.testing.assert_allclose(e.item(), float(je), atol=1e-5)
        np.testing.assert_allclose(_np(q.grad), np.asarray(jg), atol=1e-5)


def _sched_circuit(cls, n):
    cir = cls(n)
    for i in range(n):
        cir.rx(i)
        cir.rz(i)
    for i in range(n - 1):
        cir.cnot(i, i + 1)       # cnot(0, 1) crosses the global qubit
    cir.observable(0)
    cir.init_para(5)
    return cir


def test_scheduled_local_runs_on_two_shards():
    """n=16 on 2 shards: the local runs go through the relabel scheduler and
    the window engine; the program, each run's entries laid out in order,
    is the JAX engine's step for step (the port's 'remap' carries its global
    controls as a fourth field), and values and gradients hold to the
    port's local engine (1e-5)."""
    from deepquantum_tpu.parallel.shardmap_engine import ShardMapSimulator as JSim
    n = 16
    jc = _sched_circuit(dq.QubitCircuit, n)
    p = np.asarray(jc.params)
    dq.set_dtype('complex64')
    try:
        jsim = JSim(n, jmesh(2), planar=True)
        jprog = jsim._build_program(jsim._gate_list(jc, jsim._full(jc, jc.params, None)))[0]
    finally:
        dq.set_dtype('complex128')
    dqt.set_dtype('complex64')
    tc = dqt.from_jax(jc)
    sim = tse.ShardMapSimulator(n, make_mesh(2), planar=True)
    prog = sim._build_program(sim._gate_list(tc, full_params(tc, tc.params)))[0]
    flat = []
    for st in prog:
        if st[0] == 'run':
            flat += [w if w[0] in ('rot', 'win') else ('local', w) for w in st[1]]
        else:
            flat.append(st[:3] if st[0] == 'remap' else st)
    assert 'win' in {st[0] for st in flat}
    assert flat == list(jprog)
    assert all(st[3] == () for st in prog if st[0] == 'remap')
    q = dqt.params_from_numpy(p, requires_grad=True)
    e = sim.expectation(tc, params=q)[0]
    e.backward()
    q0 = dqt.params_from_numpy(p, requires_grad=True)
    e0 = tc.expectation(params=q0)[0]
    e0.backward()
    np.testing.assert_allclose(e.item(), e0.item(), atol=1e-5)
    np.testing.assert_allclose(_np(q.grad), _np(q0.grad), atol=1e-5)


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.mark.parametrize('size', [2, 4])
def test_g1_and_remap_steps_and_their_cotangents(size):
    """A program of 'g1', 'remap' (global targets, a global control) and
    'local' steps on the planes (complex128: float64 planes): the state
    against a dense evolution, and the matrix cotangents of each step, from
    the one backward across the exchanges, against autograd through the
    dense evolution (both from the same leaf planes)."""
    from deepquantum_tpu_torch.ops.apply import evolve_state_controlled
    n = 5
    rng = np.random.default_rng(size)
    layout = [([0], ()), ([1, 3], ()), ([2], (0,)), ([0, 1], ()), ([3, 4], ()), ([1, 4], (0,)),
              ([1], ())]
    leaves = []
    for wires, _ in layout:
        u = _haar(2 ** len(wires), rng)
        leaves.append((torch.tensor(u.real, requires_grad=True),
                       torch.tensor(u.imag, requires_grad=True)))
    psi0 = rng.normal(size=2 ** n) + 1j * rng.normal(size=2 ** n)
    psi0 /= np.linalg.norm(psi0)
    obs = [(np.array([[0, 1], [1, 0]]), 0), (np.array([[1, 0], [0, -1]]), 3)]
    sim = tse.ShardMapSimulator(n, make_mesh(size), planar=False)
    gates = [(torch.complex(r, i), wires, gc) for (r, i), (wires, gc) in zip(leaves, layout)]
    program, mres, mims = sim._build_program(gates)
    kinds = [st[0] for st in program]
    assert 'g1' in kinds and 'remap' in kinds and 'run' in kinds
    oprog, omres, omims = [], [], []
    with torch.no_grad():
        for m, w in obs:
            prg, r, i = sim._build_program([(torch.as_tensor(m, dtype=torch.complex128), [w], ())])
            oprog.append(prg)
            omres.append(r)
            omims.append(i)
    spec = tse._Spec(sim.cfg(), program, tuple(oprog), tuple(omres), tuple(omims), size)
    vals = tse.shardmap_expectation(sim._prepare_state(torch.as_tensor(psi0)), mres, mims, spec)
    vals.sum().backward()
    got = [(_np(r.grad), _np(i.grad)) for r, i in leaves]
    for r, i in leaves:
        r.grad = i.grad = None
    x = torch.as_tensor(psi0).reshape([2] * n)
    for (r, i), (wires, gc) in zip(leaves, layout):
        x = evolve_state_controlled(x, torch.complex(r, i), n, wires, gc)
    ref = sum((x.conj() * evolve_state_controlled(x, torch.as_tensor(m, dtype=x.dtype), n, [w],
                                                  ())).sum().real for m, w in obs)
    ref.backward()
    np.testing.assert_allclose(vals.sum().item(), ref.item(), atol=ATOL)
    for (gr, gi), (r, i) in zip(got, leaves):
        np.testing.assert_allclose(gr, _np(r.grad), atol=ATOL)
        np.testing.assert_allclose(gi, _np(i.grad), atol=ATOL)
    shards = tse.shardmap_chain(sim._prepare_state(torch.as_tensor(psi0)), mres, mims,
                                tse._Spec(sim.cfg(), program, (), (), (), size))
    flat = torch.cat([torch.complex(s[0], s[1]) for s in shards])
    np.testing.assert_allclose(_np(flat), _np(x).reshape(-1), atol=ATOL)


def _chi2(counts, probs, shots):
    exp = shots * probs / probs.sum()
    obs = np.zeros(len(probs))
    for k, v in counts.items():
        obs[int(k, 2)] = v
    big = exp >= 5
    stat = float(np.sum((obs[big] - exp[big]) ** 2 / exp[big]))
    if (~big).any():
        stat += float((obs[~big].sum() - exp[~big].sum()) ** 2 / max(exp[~big].sum(), 1e-300))
    dof = max(int(big.sum()) + int((~big).any()) - 1, 1)
    return stat, dof + 6 * np.sqrt(2 * dof)


@pytest.mark.parametrize('engine', ['gspmd', 'shardmap'])
def test_measure_marginals(engine, local_ref):
    """Two-level sampling on 4 shards: the marginal of wires spanning the
    global and local qubits by a chi-square against the local state's,
    the probabilities returned with the counts equal to it, counts seeded
    by the generator."""
    cir = DistributedQubitCircuit(N_BUILD, mesh=make_mesh(4), engine=engine)
    _build(cir, N_BUILD, _ANGLES)
    assert cir.measure(10) is None
    cir()
    probs = np.abs(local_ref[0]) ** 2
    shots = 20_000
    for wires in ([0, 2, 4], [1], None):
        keep = list(range(N_BUILD)) if wires is None else wires
        marg = probs.reshape([2] * N_BUILD).transpose(
            keep + [w for w in range(N_BUILD) if w not in keep]).reshape(2 ** len(keep), -1).sum(1)
        gen = torch.Generator().manual_seed(7)
        counts = cir.measure(shots, with_prob=True, wires=wires, generator=gen)
        assert sum(c for c, _ in counts.values()) == shots
        for k, (_, pr) in counts.items():
            np.testing.assert_allclose(pr, marg[int(k, 2)], atol=ATOL)
        stat, bar = _chi2({k: c for k, (c, _) in counts.items()}, marg, shots)
        assert stat <= bar, (wires, stat, bar)
        again = cir.measure(shots, wires=wires, generator=torch.Generator().manual_seed(7))
        assert again == {k: c for k, (c, _) in counts.items()}


def _adj_build(c, n=5):
    for i in range(n):
        c.ry(i, inputs=0.2 + 0.1 * i)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    for i in range(n):
        c.rz(i, inputs=0.1 * i)
    c.crx(0, 3, inputs=0.4)
    c.observable(0, basis='z')
    c.observable([1, 2], basis='xy')
    c._train_mask = [True] * len(c._pvals)


@pytest.fixture(scope='module')
def adjoint_ref():
    """The JAX package's local circuit: values and their jacobian."""
    import jax
    jc = dq.QubitCircuit(5)
    _adj_build(jc)
    fn = jax.jit(lambda q: (jc.expectation(params=q), jax.jacrev(
        lambda r: jc.expectation(params=r))(q)))
    return tuple(np.asarray(o) for o in fn(jc.params))


@pytest.mark.parametrize('engine', ['gspmd', 'shardmap'])
def test_expectation_adjoint_on_the_mesh(engine, adjoint_ref):
    """tests/test_distributed.py::test_distributed_adjoint_expectation_on_mesh
    on 8 shards: expectation(adjoint=True) against autograd of the same
    mesh and of the JAX package's local circuit, values and gradients."""
    je, jg = adjoint_ref
    cir = DistributedQubitCircuit(5, mesh=make_mesh(8), engine=engine)
    _adj_build(cir)
    np.testing.assert_allclose(_np(cir.expectation(adjoint=True)), je, atol=1e-8)
    for i in range(2):
        p = cir.params.requires_grad_()
        cir.expectation(params=p, adjoint=True)[i].backward()
        q = cir.params.requires_grad_()
        cir.expectation(params=q)[i].backward()
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), atol=1e-8)
        np.testing.assert_allclose(_np(p.grad), jg[i], atol=1e-8)


def _vqe(cls, nqubit, **kw):
    """__graft_entry__._build_vqe(nqubit, 2, cls, **kw)."""
    cir = cls(nqubit, **kw)
    for _ in range(2):
        for i in range(nqubit):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(nqubit)), basis='x')
    return cir


def test_dryrun_multichip_step_matches_jax():
    """__graft_entry__.dryrun_multichip(8): n=6 on 8 shards, one SGD step
    (lr 0.05) through both engines; the JAX circuits are carried across by
    from_jax (same parameters, engine and mesh size), and the port's losses
    and updated parameters equal the JAX package's."""
    import jax
    nqubit = 6
    jcir = _vqe(JDist, nqubit, mesh=jmesh(8))
    p0 = np.asarray(jcir.params)
    jval, jgrad = jax.jit(jax.value_and_grad(lambda q: jcir.expectation(params=q)[0]))(p0)
    for engine in ('gspmd', 'shardmap'):
        cir = dqt.from_jax(_vqe(JDist, nqubit, mesh=jmesh(8), engine=engine), device='cpu')
        cir.params = p0
        assert isinstance(cir, DistributedQubitCircuit) and cir.mesh.size == 8
        assert cir.engine == engine
        p = dqt.params_from_numpy(p0, requires_grad=True)
        loss = cir.expectation(params=p)[0]
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jval), atol=ATOL)
        np.testing.assert_allclose(_np(p - 0.05 * p.grad), p0 - 0.05 * np.asarray(jgrad), atol=ATOL)
        cir.forward()
        assert sum(cir.measure(shots=16).values()) == 16


def test_from_jax_keeps_engine_and_mesh():
    jcir = JDist(4, mesh=jmesh(4), engine='gspmd')
    jcir.rx(0, inputs=0.3)
    jcir.cnot(0, 3)
    jcir.observable(3)
    mesh = make_mesh(2)
    cir = dqt.from_jax(jcir, mesh=mesh)
    assert cir.mesh is mesh and cir.engine == 'gspmd'
    cir2 = dqt.from_jax(jcir, device='cpu')
    assert cir2.mesh.size == 4
    np.testing.assert_allclose(_np(cir2.expectation()), np.asarray(jcir.expectation()), atol=ATOL)


def _fock_build(c):
    c.ps(0, inputs=0.3)
    c.bs([0, 1], inputs=[0.4, 0.5])
    c.s(1, r=0.2, theta=0.1)
    c.d(2, r=0.3, theta=0.7)
    c.bs([1, 2], inputs=[0.8, 0.1])
    if c.nmode > 3:
        c.bs([2, 3], inputs=[0.3, 0.2])
        c.k(0, inputs=[0.05])


@pytest.mark.parametrize('nmode,cutoff,size', [(3, 3, 3), (4, 4, 2)])
def test_distributed_qumode_matches_jax(nmode, cutoff, size):
    """tests/test_distributed.py::test_distributed_fock_matches_local: the
    sharded Fock tensor against the JAX DistributedQumodeCircuit (carried
    across by qumode_from_jax) and the port's local tensor; gates on the
    sharded leading mode move the sharding and back; the forward's
    gradient against the local one; measure's mode-0 marginal by a
    chi-square."""
    from deepquantum_tpu.photonic.distributed import DistributedQumodeCircuit as JFock
    from deepquantum_tpu_torch.photonic.distributed import DistributedQumodeCircuit
    init = [1] + [0] * (nmode - 1)
    jc = JFock(nmode=nmode, init_state=init, cutoff=cutoff, mesh=jmesh(size))
    _fock_build(jc)
    jstate = np.asarray(jc()).reshape(-1)
    cir = dqt.qumode_from_jax(jc, device='cpu')
    assert isinstance(cir, DistributedQumodeCircuit) and cir.mesh.size == size
    state = cir()
    np.testing.assert_allclose(_np(state), jstate, atol=ATOL)
    local = dqt.QumodeCircuit(nmode, init_state=init, cutoff=cutoff, basis=False)
    _fock_build(local)
    for c in (cir, local):
        c._train_mask = [True] * len(c._pvals)
    grads = []
    for c in (cir, local):
        p = c.params.requires_grad_()
        out = c(params=p).reshape(-1)
        (out.abs() ** 2 * torch.arange(out.numel())).sum().backward()
        grads.append(_np(p.grad))
    np.testing.assert_allclose(grads[0], grads[1], atol=ATOL)
    cir()
    shots = 20_000
    res = cir.measure(shots=shots, generator=torch.Generator().manual_seed(3))
    assert sum(res.values()) == shots
    marg = (np.abs(jstate) ** 2).reshape([cutoff] * nmode).sum(tuple(range(1, nmode)))
    marg /= marg.sum()                  # the truncated state's norm is below 1
    obs = np.zeros(cutoff)
    for k, v in res.items():
        obs[k.state[0]] += v
    stat, bar = _chi2({format(i, 'b'): int(v) for i, v in enumerate(obs)}, marg, shots)
    assert stat <= bar
    one = cir.measure(shots=100, wires=[0], with_prob=True, generator=torch.Generator())
    for k, (_, pr) in one.items():
        np.testing.assert_allclose(pr, marg[k.state[0]], atol=ATOL)


def test_distributed_fock_noise_and_state():
    from deepquantum_tpu_torch.photonic.distributed import (DistributedFockState,
                                                            DistributedQumodeCircuit)
    mesh = make_mesh(2)
    st = DistributedFockState([0, 1, 1], 3, 4, mesh)
    flat = np.zeros(64)
    flat[5] = 1
    np.testing.assert_allclose(_np(st.amps), flat)
    cir = DistributedQumodeCircuit(3, [0, 1, 1], cutoff=4, mesh=mesh, noise=True,
                                   noise_per_forward=True, sigma=0.05)
    _fock_build(cir)
    a = cir(noise_generator=torch.Generator().manual_seed(1))
    b = cir(noise_generator=torch.Generator().manual_seed(1))
    c = cir(noise_generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match='divide'):
        DistributedQumodeCircuit(3, [0, 0, 0], cutoff=3, mesh=mesh)
