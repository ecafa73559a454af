"""PyTorch port vs the JAX package: the photonic kernels' modules.

The same inputs, made from a seed with numpy and rounded to complex64 where
the TPU kernel takes complex64, go through the JAX function and its
counterpart in the port. On the CPU every kernel wrapper of the port runs
its plain twin; the JAX side runs its Pallas kernels in interpret mode, or
its complex128 route as the exact reference.

Tolerances. The Pallas kernels compute in double-single arithmetic (about
2^-48 per operation): the permanent is held to 1e-8 and the torontonian
through the epilogue to 1e-6, the bars of tests/test_photonic.py. Against
the JAX complex128 routes both sides are float64 and differ only in the
order of sums that cancel: 1e-9 relative.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu.ops.pallas_kernels import permanent_pallas_batch
from deepquantum_tpu.photonic import hafnian_ as jhaf
from deepquantum_tpu.photonic import qmath as jqm
from deepquantum_tpu.photonic import tor_kernel as jtk
from deepquantum_tpu.photonic import torontonian_ as jtor
from deepquantum_tpu_torch.ops import permanent_kernel as pk
from deepquantum_tpu_torch.photonic import hafnian_ as thaf
from deepquantum_tpu_torch.photonic import qmath as tqm
from deepquantum_tpu_torch.photonic import tor_kernel as ttk
from deepquantum_tpu_torch.photonic import torontonian_ as ttor

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device('cpu')


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


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ------------------------------------------------------------------ K7 module
@pytest.mark.parametrize('n', [4, 6, 10])
def test_permanent_twin_matches_pallas_kernel(n):
    rng = np.random.default_rng(100 + n)
    mats = np.stack([_haar(n, rng) for _ in range(3)]).astype(np.complex64)
    # the interpreter takes one matrix (one grid program) at a time: a longer
    # grid compiles for minutes on the CPU
    want = np.concatenate([np.asarray(permanent_pallas_batch(jnp.asarray(m[None]), interpret=True))
                           for m in mats])
    exact = np.asarray(jqm.permanent_batch(jnp.asarray(mats.astype(np.complex128))))
    t = torch.as_tensor(mats)
    got = pk.permanent_cuda_batch(t)                  # a CPU tensor takes the twin
    assert got.dtype == torch.complex128 and got.shape == (3,)
    assert _rel(got.numpy(), want) <= 1e-8
    assert _rel(got.numpy(), exact) <= 1e-9
    np.testing.assert_array_equal(got.numpy(), pk.permanent_plain_batch(t).numpy())
    # the public route, at either input type
    assert _rel(tqm.permanent_batch(t).numpy(), exact) <= 1e-9
    assert _rel(tqm.permanent(t[1].to(torch.complex128)).numpy(), exact[1]) <= 1e-9


@pytest.mark.parametrize('n', [0, 1, 2, 3])
def test_permanent_closed_forms(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    want = sum(np.prod([a[i, s[i]] for i in range(n)]) for s in itertools.permutations(range(n)))
    before = pk.permanent_cuda_batch.launches
    got = tqm.permanent(a)
    assert abs(complex(got) - want) <= 1e-12
    assert abs(complex(got) - complex(jqm.permanent(jnp.asarray(a)))) <= 1e-12
    assert pk.permanent_cuda_batch.launches == before


def test_permanent_twin_chunks_and_policy():
    """The twin chunks the subsets when the stack is large, and the result
    follows the dtype policy while the sweep stays float64."""
    rng = np.random.default_rng(3)
    mats = torch.as_tensor(np.stack([_haar(8, rng) for _ in range(2)]))
    whole = pk.permanent_plain_batch(mats)
    old = pk._TWIN_BYTES
    pk._TWIN_BYTES = 2 * 16 * 8 * 16          # chunks of 16 subsets
    try:
        chunked = pk.permanent_plain_batch(mats)
    finally:
        pk._TWIN_BYTES = old
    assert _rel(chunked.numpy(), whole.numpy()) <= 1e-13
    dqt.set_dtype('complex64')
    assert tqm.permanent_batch(mats).dtype == torch.complex64
    with pytest.raises(ValueError, match='n <= 26'):
        tqm.permanent_batch(torch.zeros((1, 27, 27), dtype=torch.complex64))


@pytest.mark.parametrize('b,n', [(12376, 6), (3, 4), (2, 5), (1000, 14), (4, 20), (1, 22),
                                  (1, 26), (10 ** 6, 10), (1, 16)])
def test_permanent_launch_plan(b, n):
    """Every stack gets runs of 2^L subsets that tile 2^n, a block's matrices
    fit 48 KB of shared memory, and the partials match the kernel's layout."""
    level, nparts = pk.plan(b, n)
    assert 0 <= level <= min(n, 16)
    runs = 1 << (n - level)
    assert nparts == (runs // 32 if runs >= 32 else runs)
    per_block = max(1, pk.THREADS // runs)
    assert per_block * n * n * 16 <= 48 * 1024
    if b * runs >= 1 << 18:
        assert level >= 4 or per_block * 2 * n * n * 16 > 48 * 1024


def test_permanent_twin_is_differentiable():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(_haar(4, rng)[None]).requires_grad_()
    assert torch.autograd.gradcheck(lambda m: torch.view_as_real(pk.permanent_cuda_batch(m)), (a,))


# -------------------------------------------------------------- K8, K9 modules
def _tor_inputs(m, rng, perturb, c64=False):
    mm = rng.standard_normal((2 * m, 2 * m)) * 0.1
    o = (np.eye(2 * m) - np.linalg.inv(np.eye(2 * m) + mm @ mm.T)).astype(np.complex128)
    if perturb:
        o = o + 0.01 * (rng.standard_normal((2 * m, 2 * m))
                        + 1j * rng.standard_normal((2 * m, 2 * m)))
    gam = rng.standard_normal(2 * m) * 0.1 + 0.05j * rng.standard_normal(2 * m)
    if c64:
        o = o.astype(np.complex64).astype(np.complex128)
        gam = gam.astype(np.complex64).astype(np.complex128)
    return o, gam


def test_tor_twins_match_pallas_kernels_through_the_epilogue():
    # m = 2 (subsets of size 2 and 4): the interpreter traces every size
    # bucket's unrolled double-single elimination, about 3 minutes at m = 5
    m = 2
    o, gam = _tor_inputs(m, np.random.default_rng(7), perturb=False, c64=True)
    jidx, jvalid, jsign = jtor._padded_tor_indices(m)
    oc64 = jnp.asarray(o, jnp.complex64)
    det, psign = jtk.tor_dets_pallas(oc64, jidx, jvalid, jsign, interpret=True)
    want = complex(np.asarray(jtor._tor_epilogue(det, psign, m)))
    det2, quad, psign2 = jtk.tor_dets_quads_pallas(oc64, jnp.asarray(gam, jnp.complex64), jidx,
                                                   jvalid, jsign, interpret=True)
    want_loop = complex(np.asarray(jtor._tor_epilogue(det2, psign2, m, quad=quad)))

    idx, valid, sign = ttor._padded_tor_indices(m, CPU)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(sign.numpy(), jsign)
    t_o, t_g = torch.as_tensor(o).to(torch.complex64), torch.as_tensor(gam).to(torch.complex64)
    tdet, tsign = ttk.tor_dets_cuda(t_o, idx, valid, sign)         # CPU tensors: the twins
    assert tdet.dtype == torch.complex128 and tdet.shape == (3,) and tsign is sign
    got = complex(ttor._tor_epilogue(tdet, tsign, m))
    assert abs(got - want) / abs(want) <= 1e-6
    tdet2, tquad, _ = ttk.tor_dets_quads_cuda(t_o, t_g, idx, valid, sign)
    np.testing.assert_allclose(tdet2.numpy(), tdet.numpy(), rtol=1e-13)
    got_loop = complex(ttor._tor_epilogue(tdet2, tsign, m, quad=tquad))
    assert abs(got_loop - want_loop) / abs(want_loop) <= 1e-6
    # the public route (the plain formula at this size) gives the same values
    assert abs(complex(ttor.torontonian(t_o)) - got) <= 1e-12 * abs(got)
    assert abs(complex(ttor.torontonian(t_o, t_g)) - got_loop) <= 1e-12 * abs(got_loop)


def test_tor_twins_against_a_host_loop():
    """Per-subset determinants and quadratic forms of a non-symmetric O, in
    the scaffold's order: gamma_Z enters unconjugated on the left."""
    m = 3
    o, gam = _tor_inputs(m, np.random.default_rng(11), perturb=True)
    idx, valid, sign = ttor._padded_tor_indices(m, CPU)
    det, quad, _ = ttk.tor_dets_quads_plain(torch.as_tensor(o), torch.as_tensor(gam), idx, valid,
                                            sign)
    s = 0
    for r in range(1, m + 1):
        for sub in itertools.combinations(range(m), r):
            ii = np.sort(np.concatenate([np.array(sub), np.array(sub) + m]))
            ci = np.eye(2 * r) - o[np.ix_(ii, ii)]
            assert abs(complex(det[s]) - np.linalg.det(ci)) <= 1e-13
            assert abs(complex(quad[s]) - gam[ii] @ np.linalg.solve(ci, np.conj(gam[ii]))) <= 1e-13
            assert sign[s].item() == (-1.0) ** (m - r)
            s += 1
    assert s == 7


@pytest.mark.parametrize('with_gamma', [False, True])
@pytest.mark.parametrize('m', [0, 1, 3, 4, 6])
def test_torontonian_matches_jax_complex128(m, with_gamma):
    """m <= 2: the plain formula; from m = 3 the per-subset twins. O is not
    symmetric: a row-for-column mistake in an elimination would show."""
    o, gam = _tor_inputs(m, np.random.default_rng(20 + m), perturb=True)
    gam = gam if with_gamma else None
    want = complex(jtor.torontonian(jnp.asarray(o), None if gam is None else jnp.asarray(gam)))
    got = ttor.torontonian(o, gam)
    assert got.dtype == torch.complex128
    assert abs(complex(got) - want) <= 1e-9 * abs(want)
    dqt.set_dtype('complex64')                # the policy decides the result's type only
    got64 = ttor.torontonian(o, gam)
    assert got64.dtype == torch.complex64
    assert abs(complex(got64) - want) <= 1e-6 * abs(want)


def test_torontonian_batch_and_large_m_route():
    rng = np.random.default_rng(5)
    pairs = [_tor_inputs(3, rng, perturb=True) for _ in range(2)]
    os_, gs = np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])
    want = np.asarray(jtor.torontonian_batch(jnp.asarray(os_), jnp.asarray(gs)))
    assert _rel(ttor.torontonian_batch(os_, gs).numpy(), want) <= 1e-9
    want0 = np.asarray(jtor.torontonian_batch(jnp.asarray(os_)))
    assert _rel(ttor.torontonian_batch(os_).numpy(), want0) <= 1e-9
    # beyond the kernel's limit the plain formula runs, whatever the device
    old = ttor.MAX_MODES
    ttor.MAX_MODES = 2
    try:
        assert abs(complex(ttor.torontonian(os_[0], gs[0])) - want[0]) <= 1e-9 * abs(want[0])
    finally:
        ttor.MAX_MODES = old


def _stack(m, b, seed, c64=False):
    rng = np.random.default_rng(seed)
    pairs = [_tor_inputs(m, rng, perturb=True, c64=c64) for _ in range(b)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def test_batched_tor_twins_match_vmapped_pallas_kernels_through_the_epilogue():
    """The JAX package's vmapped torontonian puts the batch on a grid axis
    of each size bucket's pallas_call; its values per matrix, through the
    epilogue, against the port's batched twins (one call on the stack)."""
    m, b = 2, 3
    os_, gs = _stack(m, b, 17, c64=True)
    jidx, jvalid, jsign = jtor._padded_tor_indices(m)

    def click(o):
        det, psign = jtk.tor_dets_pallas(o, jidx, jvalid, jsign, interpret=True)
        return jtor._tor_epilogue(det, psign, m)

    def loop(o, g):
        det, quad, psign = jtk.tor_dets_quads_pallas(o, g, jidx, jvalid, jsign, interpret=True)
        return jtor._tor_epilogue(det, psign, m, quad=quad)

    want = np.asarray(jax.vmap(click)(jnp.asarray(os_, jnp.complex64)))
    want_loop = np.asarray(jax.vmap(loop)(jnp.asarray(os_, jnp.complex64),
                                          jnp.asarray(gs, jnp.complex64)))
    idx, valid, sign = ttor._padded_tor_indices(m, CPU)
    t_o, t_g = torch.as_tensor(os_).to(torch.complex64), torch.as_tensor(gs).to(torch.complex64)
    det, _ = ttk.tor_dets_cuda(t_o, idx, valid, sign)            # CPU tensors: the twins
    det2, quad, _ = ttk.tor_dets_quads_cuda(t_o, t_g, idx, valid, sign)
    assert det.shape == quad.shape == (b, 3) and det.dtype == torch.complex128
    assert _rel(ttor._tor_epilogue(det, sign, m).numpy(), want) <= 1e-6
    assert _rel(ttor._tor_epilogue(det2, sign, m, quad=quad).numpy(), want_loop) <= 1e-6


@pytest.mark.parametrize('with_gamma', [False, True])
@pytest.mark.parametrize('m', [3, 4])
def test_torontonian_batch_matches_jax_vmapped(m, with_gamma, monkeypatch):
    """One wrapper call for the whole stack, the same values as the JAX
    package's vmapped torontonian at complex128."""
    os_, gs = _stack(m, 4, 40 + m)
    gs = gs if with_gamma else None
    want = np.asarray(jtor.torontonian_batch(jnp.asarray(os_),
                                             None if gs is None else jnp.asarray(gs)))
    calls = []
    name = 'tor_dets_quads_cuda' if with_gamma else 'tor_dets_cuda'
    wrapper = getattr(ttor, name)
    monkeypatch.setattr(ttor, name, lambda o, *a: calls.append(o.shape) or wrapper(o, *a))
    got = ttor.torontonian_batch(os_, gs)
    assert got.dtype == torch.complex128 and got.shape == (4,)
    assert _rel(got.numpy(), want) <= 1e-9
    assert calls == [(4, 2 * m, 2 * m)]
    # the single torontonian is the same code on one (2m, 2m) matrix
    one = complex(ttor.torontonian(os_[1], None if gs is None else gs[1]))
    assert abs(one - complex(got[1])) <= 1e-12 * abs(want[1])
    assert calls[1] == (2 * m, 2 * m)


def test_batched_tor_twins_match_a_loop_of_single_twins():
    m, b = 4, 5
    os_, gs = _stack(m, b, 23)
    idx, valid, sign = ttor._padded_tor_indices(m, CPU)
    o, g = torch.as_tensor(os_), torch.as_tensor(gs)
    det, s = ttk.tor_dets_plain(o, idx, valid, sign)
    det9, quad, _ = ttk.tor_dets_quads_plain(o, g, idx, valid, sign)
    assert s is sign and det.shape == det9.shape == quad.shape == (b, 15)
    for i in range(b):
        d1, _ = ttk.tor_dets_plain(o[i], idx, valid, sign)
        d2, q2, _ = ttk.tor_dets_quads_plain(o[i], g[i], idx, valid, sign)
        for got, want in ((det[i], d1), (det9[i], d2), (quad[i], q2)):
            assert ((got - want).abs() / want.abs()).max().item() <= 1e-13


def test_tor_wrappers_check_the_scaffold():
    o = torch.zeros((6, 6), dtype=torch.complex128)
    idx, valid, sign = ttor._padded_tor_indices(4, CPU)
    with pytest.raises(ValueError, match='scaffold'):
        ttk.tor_dets_cuda(o, idx, valid, sign)
    with pytest.raises(ValueError, match=r'\(2m, 2m\)'):
        ttk.tor_dets_plain(torch.zeros((6, 6)), idx, valid, sign)


# -------------------------------------------------------------------- hafnian
@pytest.mark.parametrize('loop', [False, True])
@pytest.mark.parametrize('size', [0, 3, 4, 6])
def test_hafnian_matches_jax(size, loop):
    rng = np.random.default_rng(size)
    a = rng.normal(size=(size, size)) + 1j * rng.normal(size=(size, size))
    a = a + a.T
    want = complex(jhaf.hafnian(jnp.asarray(a), loop=loop))
    got = thaf.hafnian(a, loop=loop)
    assert got.dtype == torch.complex128
    assert abs(complex(got) - want) <= 1e-10 * max(1.0, abs(want))


# ---------------------------------------------------------------------- qmath
def test_quadrature_conversions_match_jax():
    rng = np.random.default_rng(12)
    mat, vec = rng.normal(size=(6, 6)), rng.normal(size=(6, 1))
    for name in ('xxpp_to_xpxp', 'xpxp_to_xxpp'):
        for x in (mat, vec):
            got = getattr(tqm, name)(torch.as_tensor(x))
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jqm, name)(x)))
    for x in (mat, vec):
        lad = tqm.quadrature_to_ladder(x)
        np.testing.assert_allclose(lad.numpy(), np.asarray(jqm.quadrature_to_ladder(x)),
                                   atol=1e-14)
        np.testing.assert_allclose(tqm.ladder_to_quadrature(lad).numpy(),
                                   np.asarray(jqm.ladder_to_quadrature(jnp.asarray(lad.numpy()))),
                                   atol=1e-14)
    np.testing.assert_allclose(
        tqm.quadrature_to_ladder(mat, symplectic=True).numpy(),
        np.asarray(jqm.quadrature_to_ladder(mat, symplectic=True)), atol=1e-14)


def test_fock_utilities_match_jax():
    assert tqm.fock_combinations(4, 3, 3) == jqm.fock_combinations(4, 3, 3)
    assert tqm.fock_combinations(3, 2) == jqm.fock_combinations(3, 2)
    u = _haar(4, np.random.default_rng(2))
    got = tqm.sub_matrix(u, [1, 0, 2, 0], [0, 1, 1, 1])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jqm.sub_matrix(u, [1, 0, 2, 0], [0, 1, 1, 1])))
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 6))
    cov, mean = a @ a.T + np.eye(6), rng.normal(size=(6, 1))
    for g, w in zip(tqm.photon_number_mean_var(cov, mean),
                    jqm.photon_number_mean_var(jnp.asarray(cov), jnp.asarray(mean))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12)


def test_hbar_and_kappa_are_settable():
    from deepquantum_tpu_torch import config
    assert (config.HBAR, config.KAPPA) == (dq.config.HBAR, dq.config.KAPPA)
    dqt.set_hbar(1.0)
    dqt.set_kappa(1.0)
    try:
        vac = dqt.GaussianState('vac', 2)
        np.testing.assert_allclose(vac.cov[0], np.eye(4) / 4)
    finally:
        dqt.set_hbar(2.0)
        dqt.set_kappa(2 ** (-0.5))


# -------------------------------------------------------------------- hygiene
def test_photonic_sources_import_no_jax_and_no_networkx():
    pat = re.compile(r'^\s*(import|from)\s+(jax|deepquantum_tpu|networkx)(\.|\s|$)', re.M)
    files = sorted((ROOT / 'deepquantum_tpu_torch').rglob('*.py')) + [ROOT / 'chip_smoke.py']
    assert sum('photonic' in f.parts for f in files) >= 10
    for f in files:
        assert not pat.search(f.read_text()), f


def test_new_kernels_are_registered_and_call_no_library():
    from deepquantum_tpu_torch.ops import _cuda
    for entry in ('dq_permanent_ryser', 'dq_tor_lu'):
        assert entry in _cuda._SIGNATURES
    for name, entry in (('permanent_ryser.cu', 'dq_permanent_ryser'), ('tor_lu.cu', 'dq_tor_lu')):
        text = (_cuda.CSRC_DIR / name).read_text()
        assert f'extern "C" int {entry}(' in text
        assert not re.search(r'cublas|cusolver|cutlass|#include\s*<torch', text, re.I)
