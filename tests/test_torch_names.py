"""Every public name of the JAX package resolves on the port.

The walk imports each module of ``deepquantum_tpu`` and reads on the port's
module of the same path: in a package, every name of ``dir()`` that is the
package's own (a module, function or class of ``deepquantum_tpu``, or plain
data); in a module, its ``__all__`` (else the names it defines) and its
lazy names; and each public attribute of those classes. The names left out
by design are listed with their reasons. Each name the port gained for
this is then held to the JAX package's value on the same inputs.
"""

import importlib
import inspect
import pkgutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt

# label (module path below the package, or Class.attribute) -> why the port has no such name
BY_DESIGN = {
    'ops.df32': 'double-single float32 arithmetic for the TPU: the card has native float64',
    'ops.pallas_kernels': "the Pallas Ryser permanent: ops/permanent_kernel.py's CUDA kernel "
                          'does its job',
    'utils.compat': 'transfer shims for a TPU attachment without complex transfers',
    'utils.to_device': 'a TPU transfer shim (utils/compat.py)',
    'utils.to_numpy': 'a TPU transfer shim (utils/compat.py)',
    'ShardedSimulator.constrain': 'a JAX sharding-constraint hook: torch shards are explicit',
    'ShardedSimulator.init_state_traced': 'a JAX hook that builds |0> inside a traced program',
    'ops.planar_gate.fwd_ad_active': 'detects JAX forward-mode tracers; the port has no '
                                     'forward-mode rules (its Hessian is reverse over reverse)',
    'photonic.tor_kernel.tor_dets_pallas': 'the Pallas entry point: tor_dets_cuda, the CUDA '
                                           'kernel, takes its place',
    'photonic.tor_kernel.tor_dets_quads_pallas': 'the Pallas entry point: tor_dets_quads_cuda, '
                                                 'the CUDA kernel, takes its place',
}


def _own(obj) -> bool:
    if isinstance(obj, types.ModuleType):
        return obj.__name__.startswith('deepquantum_tpu')
    module = getattr(obj, '__module__', None)
    if callable(obj) and module is not None:
        return module.startswith('deepquantum_tpu')
    return type(obj).__module__ == 'builtins'


def _public(mod) -> list:
    names = vars(mod)
    lazy = set(dir(mod)) - set(names)
    if hasattr(mod, '__path__'):            # a package: what it exports
        out = {a for a in dir(mod) if _own(getattr(mod, a))}
    elif '__all__' in names:
        out = set(names['__all__']) | lazy
    else:
        out = {a for a, o in names.items() if getattr(o, '__module__', None) == mod.__name__}
        out |= lazy
    return sorted(a for a in out if not a.startswith('_'))


def test_every_jax_name_resolves_on_the_port():
    missing, excused = [], set()
    paths = ['deepquantum_tpu'] + [m.name for m in pkgutil.walk_packages(dq.__path__,
                                                                        'deepquantum_tpu.')]
    for path in paths:
        short = path[len('deepquantum_tpu.'):]
        try:
            ours = importlib.import_module('deepquantum_tpu_torch' + path[len('deepquantum_tpu'):])
        except ModuleNotFoundError:
            (excused.add if short in BY_DESIGN else missing.append)(short)
            continue
        ref = importlib.import_module(path)
        for name in _public(ref):
            obj = getattr(ref, name)
            label = f'{short}.{name}'.lstrip('.')
            if not hasattr(ours, name):
                (excused.add if label in BY_DESIGN else missing.append)(label)
                continue
            if inspect.isclass(obj) and obj.__module__.startswith('deepquantum_tpu.'):
                for attr in dir(obj):
                    if not attr.startswith('_') and not hasattr(getattr(ours, name), attr):
                        label = f'{obj.__name__}.{attr}'
                        (excused.add if label in BY_DESIGN else missing.append)(label)
    assert not missing, missing
    assert excused == set(BY_DESIGN), set(BY_DESIGN) - excused    # each exception still applies


def _haar(k: int, rng) -> np.ndarray:
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


@pytest.fixture
def c128():
    dqt.set_device('cpu')
    dqt.set_dtype('complex128')
    dq.set_dtype('complex128')
    yield
    dqt.set_dtype('complex64')
    dqt.set_device(None)


def test_dtype_map_and_api_cdtype(c128):
    assert dqt.dtype_map == {torch.float32: torch.complex64, torch.float64: torch.complex128}
    for (jr, jc), (tr, tc) in zip(dq.dtype_map.items(), dqt.dtype_map.items(), strict=True):
        assert (np.dtype(jr).name, np.dtype(jc).name) == (str(tr)[6:], str(tc)[6:])
    assert dqt.api.cdtype() == torch.complex128 and np.dtype(dq.api.cdtype()) == np.complex128


@pytest.mark.parametrize('name, theta', [('BitFlip', [0.3]), ('Pauli', [0.1, 0.2, 0.3, 0.4]),
                                         ('GeneralizedAmplitudeDamping', [0.5, 1.1])])
def test_channel_prob_matches_jax(name, theta, c128):
    ref = np.asarray(dq.channel.channel_prob(name, np.asarray(theta)))
    got = dqt.channel.channel_prob(name, torch.tensor(theta, dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-15)
    if name == 'Pauli':
        assert abs(got.sum().item() - 1) < 1e-15


def test_quadrature_conventions_match_jax(c128):
    """hbar / kappa and set_hbar / set_kappa, the orderings and the ladder
    transforms (the lazy quadrature_ladder_transform is quadrature_to_ladder)."""
    jp, tp = dq.photonic, dqt.photonic
    assert (tp.hbar, tp.kappa) == (jp.hbar, jp.kappa)
    rng = np.random.default_rng(11)
    m = rng.normal(size=(6, 6))
    v = rng.normal(size=(6, 1))
    for fn in ('xpxp_to_xxpp', 'xxpp_to_xpxp'):
        for a in (m, v):
            np.testing.assert_array_equal(getattr(tp, fn)(torch.as_tensor(a)).numpy(),
                                          np.asarray(getattr(jp, fn)(jnp.asarray(a))))
    assert tp.quadrature_ladder_transform is tp.quadrature_to_ladder
    try:
        for hbar, kappa in ((2.0, 2 ** -0.5), (1.0, 0.5)):
            jp.set_hbar(hbar), jp.set_kappa(kappa), tp.set_hbar(hbar), tp.set_kappa(kappa)
            assert (tp.hbar, tp.kappa) == (hbar, kappa)
            for a in (m, v):
                for fn in ('quadrature_to_ladder', 'ladder_to_quadrature'):
                    ref = np.asarray(getattr(jp, fn)(jnp.asarray(a)))
                    np.testing.assert_allclose(getattr(tp, fn)(torch.as_tensor(a)).numpy(), ref,
                                               atol=1e-14)
            np.testing.assert_allclose(
                tp.quadrature_to_ladder(torch.as_tensor(m), symplectic=True).numpy(),
                np.asarray(jp.quadrature_to_ladder(jnp.asarray(m), symplectic=True)), atol=1e-14)
    finally:
        for mod in (jp, tp):
            mod.set_hbar(2.0)
            mod.set_kappa(2 ** -0.5)


@pytest.mark.parametrize('den_mat', [False, True])
def test_qumode_tensor_rep_matches_jax(den_mat, c128):
    x = np.arange(2 * 3 ** (4 if den_mat else 2), dtype=np.float64)
    ref = dq.photonic.QumodeCircuit(2, [1, 0], cutoff=3, backend='fock', basis=False,
                                    den_mat=den_mat).tensor_rep(jnp.asarray(x))
    got = dqt.photonic.QumodeCircuit(2, [1, 0], cutoff=3, backend='fock', basis=False,
                                     den_mat=den_mat).tensor_rep(torch.as_tensor(x))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture
def c64():
    """The JAX planar kernels run on float32 planes (the complex64 policy)."""
    dq.set_dtype('complex64')
    yield
    dq.set_dtype('complex128')


def test_planar_entries_match_jax(c64):
    """planar_evolve and planar_superop_matrix (JAX: its Pallas kernel in
    interpret mode) and planar_supported."""
    from deepquantum_tpu.ops import planar_gate as jpg
    from deepquantum_tpu_torch.ops import planar_gate as tpg
    rng = np.random.default_rng(3)
    n, wires = 10, (7, 2)
    x = rng.standard_normal((2, 1 << n)).astype(np.float32)
    u = _haar(4, rng)
    mre, mim = (m.astype(np.float32) for m in (u.real, u.imag))
    # planes in sorted-wire order: the matrix on (2, 7) as given
    ref = np.asarray(jpg.planar_evolve(jnp.asarray(x), jnp.asarray(mre), jnp.asarray(mim), n,
                                       (2, 7), True))
    got = tpg.planar_evolve(torch.as_tensor(x), torch.as_tensor(mre), torch.as_tensor(mim), n,
                            (2, 7))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
    k = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    ref = np.asarray(jpg.planar_superop_matrix(jnp.asarray(x), jnp.asarray(k.astype(np.complex64)),
                                               n, list(wires), True))
    got = tpg.planar_superop_matrix(torch.as_tensor(x), torch.as_tensor(k.astype(np.complex64)),
                                    n, list(wires))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    for n_, ws in ((10, (0,)), (9, (0,)), (12, (1, 2, 3, 4)), (12, (3, 3))):
        assert tpg.planar_supported(n_, ws) == jpg.planar_supported(n_, ws)


def test_qmath_evolve_and_shardmap_init_state_match_jax(c128):
    from deepquantum_tpu.ops import qmath as jq
    from deepquantum_tpu.parallel import make_mesh as jax_mesh
    from deepquantum_tpu.parallel.shardmap_engine import ShardMapSimulator as JaxSim
    from deepquantum_tpu_torch.ops import qmath as tq
    from deepquantum_tpu_torch.parallel.shardmap_engine import ShardMapSimulator as TorchSim
    rng = np.random.default_rng(5)
    u = _haar(4, rng)
    psi = rng.normal(size=(2,) * 3) + 1j * rng.normal(size=(2,) * 3)
    rho = rng.normal(size=(2,) * 6) + 1j * rng.normal(size=(2,) * 6)
    np.testing.assert_allclose(tq.evolve_state(torch.as_tensor(psi), torch.as_tensor(u), 3,
                                               [2, 0]).numpy(),
                               np.asarray(jq.evolve_state(jnp.asarray(psi), jnp.asarray(u), 3,
                                                          [2, 0])), atol=1e-14)
    np.testing.assert_allclose(tq.evolve_den_mat(torch.as_tensor(rho), torch.as_tensor(u), 3,
                                                 [1, 2]).numpy(),
                               np.asarray(jq.evolve_den_mat(jnp.asarray(rho), jnp.asarray(u), 3,
                                                            [1, 2])), atol=1e-14)
    ref = np.asarray(JaxSim(5, jax_mesh(4)).init_state())
    shards = TorchSim(5, dqt.parallel.make_mesh(4)).init_state()
    assert len(shards) == 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), ref)
