"""PyTorch port vs the JAX package: batched, data-encoded QML training.

The batched forms of the three per-gate kernels (K1 planar_apply, K5
planar_grad, K6 planar_bwd_fused on a (B, 2, 2^n) stack with (B, K, K)
planes) are held, through their plain twins, against the JAX package's
Pallas kernels in interpret mode on the same numpy inputs. The slice as a
whole, ``QubitCircuit.forward / expectation(data=(B, ndata), params=p)`` and
its gradients in the parameters and in the data, runs through ``from_jax``
against the JAX package's exact route: complex128 with its planar engine off
(``DQ_PLANAR`` unset: on the CPU the JAX circuit takes its einsum route under
``jax.vmap``; its interpret-mode kernels would take minutes for the
gradients). The photonic gradients (K7-K9 are differentiated through their
twins) are held against ``jax.grad`` of the JAX package's same circuits.
On the CPU every kernel wrapper runs its twin.

Tolerances. States against the interpret-mode kernel: float32 with at most
8 products per amplitude, 2e-6 of max|ref|; cotangent planes: float32 sums of
2^(n-k) products in another order, 2e-4 of max|ref| (the bars of
tests/test_planar.py). The slice at complex64 against complex128: states,
expectations and gradients 1e-5 (float32 over a few dozen gates); at
complex128 against complex128: 1e-10. Photonic gradients: both packages in
complex128, 1e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu import photonic as jph
from deepquantum_tpu.ops import planar_gate as jpg
from deepquantum_tpu.ops import qmath as jqm
from deepquantum_tpu_torch import photonic as tph
from deepquantum_tpu_torch.ops import planar_gate as tpg

torch.set_num_threads(1)

B = 3


@pytest.fixture(autouse=True)
def _cpu():
    """The port's default device is the card; these tests ask for the CPU.
    Both packages end at their defaults (JAX complex128, the port complex64)."""
    dqt.set_device('cpu')
    yield
    dqt.set_dtype('complex64')
    dq.set_dtype('complex128')
    dqt.set_device(None)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ kernel twins
@pytest.mark.parametrize('wires', [(3,), (0, 9), (2, 5, 7)])
def test_batched_twins_match_jax_kernels(wires):
    """K1, K5 and K6 on a (3, 2, 2^10) stack with per-sample planes (K1 also
    with one (K, K) set for every sample) against the JAX kernels' batched
    grid axis in interpret mode."""
    n, k = 10, len(wires)
    kk = 1 << k
    rng = np.random.default_rng(k)
    x = rng.standard_normal((B, 2, 1 << n)).astype(np.float32)
    g = rng.standard_normal((B, 2, 1 << n)).astype(np.float32)
    mre = rng.standard_normal((B, kk, kk)).astype(np.float32)
    mim = rng.standard_normal((B, kk, kk)).astype(np.float32)
    jx, jg, jre, jim = (jnp.asarray(a) for a in (x, g, mre, mim))
    t = [torch.tensor(a) for a in (x, g, mre, mim)]

    want = jpg._planar_apply(jx, jre, jim, n, wires, interpret=True)
    got = tpg.planar_apply(t[0].clone(), t[2], t[3], n, wires)
    assert got.shape == (B, 2, 1 << n)
    assert _rel(got, want) <= 2e-6

    shared = jpg._planar_apply(jx, jnp.broadcast_to(jre[0], jre.shape),
                               jnp.broadcast_to(jim[0], jim.shape), n, wires, interpret=True)
    assert _rel(tpg.planar_apply(t[0].clone(), t[2][0], t[3][0], n, wires), shared) <= 2e-6
    expanded = tpg.planar_apply(t[0].clone(), t[2][0].expand(B, kk, kk),
                                t[3][0].expand(B, kk, kk), n, wires)
    assert _rel(expanded, shared) <= 2e-6

    want = jpg._planar_grad(jg, jx, n, wires, interpret=True)
    got = tpg.planar_grad(t[1], t[0], n, wires)
    for a, b in zip(got, want):
        assert a.shape == (B, kk, kk)
        assert _rel(a, b) <= 2e-4

    want = jpg._planar_bwd_fused(jx, jg, jre, jim, n, wires, interpret=True)
    y, gg = t[0].clone(), t[1].clone()
    got = tpg.planar_bwd_fused(y, gg, t[2], t[3], n, wires)
    assert got[0] is y and got[1] is gg
    for a, b, bar in zip(got, want, (2e-6, 2e-6, 2e-4, 2e-4)):
        assert _rel(a, b) <= bar


def test_sample_planes_tells_shared_from_per_sample():
    """The kernels' plane argument: one (K, K) set or an expand of it is
    shared (stride 0 between samples), a real (B, K, K) stack is not, and
    any other shape is refused."""
    from deepquantum_tpu_torch.ops import _cuda
    x = torch.zeros(B, 2, 1 << 10)
    m = torch.eye(4)
    (a, b), stride = _cuda.sample_planes('planar_apply', x, B, (4, 4), m, m)
    assert stride == 0 and a.shape == (4, 4)
    (a, _), stride = _cuda.sample_planes('planar_apply', x, B, (4, 4), m.expand(B, 4, 4),
                                         m.expand(B, 4, 4))
    assert stride == 0 and a.shape == (4, 4)
    (a, b), stride = _cuda.sample_planes('planar_apply', x, B, (4, 4), m.repeat(B, 1, 1), m)
    assert stride == 16 and a.shape == b.shape == (B, 4, 4) and a.is_contiguous()
    with pytest.raises(ValueError, match='matrix planes'):
        _cuda.sample_planes('planar_apply', x, B, (4, 4), m.repeat(B + 1, 1, 1), m)
    # a batch of one sample takes its (1, K, K) planes as one set
    (a, _), stride = _cuda.sample_planes('planar_apply', x[:1], 1, (4, 4), m[None], m[None])
    assert stride == 0 and a.shape == (4, 4)
    with pytest.raises(ValueError, match='matrix planes'):
        _cuda.sample_planes('planar_apply', x[0], 1, (4, 4), m[None], m[None])


# ------------------------------------------------------------------- slice
def _qml(mod, n: int, layers: int):
    """bench_batched_qml's circuit (benchmarks/bench_suite.py): layers of
    ry(encode) on every wire, rz and ry on every wire, a CNOT ring; with
    reupload the n features wrap around the n * layers encoders. Two
    observables, so that expectations are (B, 2)."""
    cir = mod.QubitCircuit(n, reupload=True)
    for _ in range(layers):
        for i in range(n):
            cir.ry(i, encode=True)
        for i in range(n):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0)
    cir.observable([1, 2], basis='xy')
    cir.init_para(5)
    return cir


SLICES = [(10, 2), (11, 1)]


@pytest.fixture(scope='module', params=SLICES, ids=[f'n{n}-l{l}' for n, l in SLICES])
def jax_slice(request):
    """The JAX package's forward states, expectations, and the gradients of
    a weighted sum of the expectations in the parameters and in the data,
    at complex128 on its exact route (computed once per slice)."""
    n, layers = request.param
    os.environ.pop('DQ_PLANAR', None)
    dq.set_dtype('complex128')
    cir = _qml(dq, n, layers)
    rng = np.random.default_rng(n)
    data = rng.uniform(0, np.pi, (B, n))
    w = rng.standard_normal((B, 2))
    p = cir.params
    states = np.asarray(cir.forward(data=jnp.asarray(data), params=p))
    exps = np.asarray(cir.expectation())

    def loss(q, d):
        return jnp.sum(cir.expectation(data=d, params=q) * w)

    gp, gd = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(data))
    return dict(cir=cir, n=n, layers=layers, data=data, w=w, p=np.asarray(p), states=states,
                exps=exps, gp=np.asarray(gp), gd=np.asarray(gd))


@pytest.mark.parametrize('dtype,bar', [('complex64', 1e-5), ('complex128', 1e-10)])
def test_batched_slice_matches_jax(jax_slice, dtype, bar):
    """forward states (B, 2^n, 1), expectations (B, 2), and the gradients in
    the parameters and in the data, through from_jax. complex64 takes the
    planar route (the batched twins), complex128 the einsum route."""
    r = jax_slice
    dqt.set_dtype(dtype)
    cir = dqt.from_jax(r['cir'])
    n = r['n']
    assert cir.reupload and cir.ndata == n * r['layers'] and cir.npara == 2 * n * r['layers']
    assert len(cir.encoders) == n * r['layers'] and cir._enc_pidx == r['cir']._enc_pidx
    assert cir._planar_ok() == (dtype == 'complex64')
    p = dqt.params_from_numpy(r['p'], requires_grad=True)
    d = torch.tensor(r['data'], dtype=dqt.rdtype(), requires_grad=True)
    states = cir.forward(data=d, params=p)
    assert states.shape == (B, 1 << n, 1) and cir.state is states
    np.testing.assert_allclose(states.detach().numpy(), r['states'], atol=bar)
    exps = cir.expectation()
    assert exps.shape == (B, 2)
    np.testing.assert_allclose(exps.detach().numpy(), r['exps'], atol=bar)
    torch.sum(cir.expectation(data=d, params=p) * torch.tensor(r['w'], dtype=exps.dtype)).backward()
    np.testing.assert_allclose(p.grad.numpy(), r['gp'], atol=bar * 10)
    np.testing.assert_allclose(d.grad.numpy(), r['gd'], atol=bar * 10)


def test_one_row_of_data_is_one_row_of_the_batch(jax_slice):
    """1-D data takes the single-state route and gives that row of the
    batch; a (B, 2^n) stack of initial states gives the same as one shared
    initial state broadcast over it."""
    r = jax_slice
    cir = dqt.from_jax(r['cir'])
    data = torch.tensor(r['data'], dtype=torch.float32)
    with torch.no_grad():
        batch = cir.expectation(data=data)
        one = cir.forward(data=data[1])
        assert one.shape == (1 << r['n'], 1)
        np.testing.assert_allclose(cir.expectation().numpy(), batch[1].numpy(), atol=2e-6)
        zeros = torch.zeros(B, 1 << r['n'], dtype=torch.complex64)
        zeros[:, 0] = 1
        np.testing.assert_allclose(cir.expectation(data=data, state=zeros).numpy(),
                                   batch.numpy(), atol=1e-7)
    np.testing.assert_allclose(batch.numpy(), r['exps'], atol=1e-5)


def test_fused_backward_equals_the_default_route():
    """fused_bwd runs a gate step as planar_bwd_fused instead of apply +
    grad + apply: the same gradients in the parameters and the data, and
    through a classical layer in front of the circuit (feats = x W + b)."""
    n = 10
    cir = dqt.from_jax(_qml(dq, n, 2))
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((B, 4)), dtype=torch.float32)
    w0 = torch.tensor(rng.standard_normal((4, n)) * 0.5, dtype=torch.float32)
    b0 = torch.tensor(rng.standard_normal(n), dtype=torch.float32)
    grads = []
    for fused in (False, True):
        cir.fused_bwd = fused
        p = cir.params.requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        cir.expectation(data=x @ w + b, params=p).sum().backward()
        grads.append([p.grad, w.grad, b.grad])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_second_order_through_the_batch_raises():
    cir = dqt.from_jax(_qml(dq, 10, 1))
    p = cir.params.requires_grad_()
    loss = cir.expectation(data=torch.rand(B, 10), params=p).sum()
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(loss, p, create_graph=True)


# ------------------------------------------------------------ parameter API
def test_encoders_and_parameters_match_jax():
    """encode= registers data slots, not trainable ones; encode() writes
    them (wrapping with reupload); init_encoder redraws only them."""
    for reupload in (False, True):
        jc, tc = dq.QubitCircuit(4, reupload=reupload), dqt.QubitCircuit(4, reupload=reupload)
        for c in (jc, tc):
            c.rylayer(encode=True)
            c.rx(0, encode=True)
            c.rz(1)
            c.rxx([2, 3], inputs=[0.3])
            c.u3(2)
        tc._pvals = list(jc._pvals)
        assert (tc.ndata, tc.npara, tc._enc_pidx, tc._train_mask) == \
            (jc.ndata, jc.npara, jc._enc_pidx, jc._train_mask) == \
            (5, 5, [0, 1, 2, 3, 4], [False] * 5 + [True, False, True, True, True])
        data = [0.1, 0.2, 0.3, 0.4] + ([] if reupload else [0.5])
        jc.encode(data)
        tc.encode(data)
        assert tc._pvals == jc._pvals
        assert tc._data_indices(4 if reupload else 5) == jc._data_indices(4 if reupload else 5)
        before = list(tc._pvals)
        tc.init_encoder()
        assert tc._pvals[5:] == before[5:] and tc._pvals[:5] != before[:5]
    with pytest.raises(ValueError, match='more data'):
        tc = dqt.QubitCircuit(2)
        tc.rylayer(encode=True)
        tc.forward(data=[0.1])


def test_amplitude_encoding_matches_jax():
    rng = np.random.default_rng(3)
    for data in (rng.standard_normal(5), rng.standard_normal((4, 11)), np.zeros(3),
                 rng.standard_normal((6, 1))):
        got = dqt.amplitude_encoding(torch.tensor(data), 3).numpy()
        want = np.asarray(jqm.amplitude_encoding(data, 3))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-7)


def test_batched_gate_matrices_are_the_single_ones():
    """A (B,) angle gives B matrices, each the one of its angle alone (to
    the last bit but one: a vectorised exp may round the last bit apart)."""
    from deepquantum_tpu_torch.ops import gates as G
    theta = torch.tensor([0.3, -1.2, 2.5])
    for fn in (G.rx_matrix, G.ry_matrix, G.rz_matrix, G.phaseshift_matrix, G.rxx_matrix,
               G.ryy_matrix, G.rzz_matrix, G.rxy_matrix, G.rbs_matrix,
               lambda t: G.u3_matrix(t, 2 * t, -t), lambda t: G.projection_j_matrix(t, 'yz')):
        stack = fn(theta)
        assert stack.shape[0] == 3
        for i in range(3):
            torch.testing.assert_close(stack[i], fn(theta[i]), rtol=0, atol=1e-7)


# ---------------------------------------------------------- photonic grads
def _gbs(mod, displaced: bool, nmode: int = 4):
    """A threshold GBS whose squeezing magnitudes are the trainable
    parameters (both packages read ``_train_mask`` for ``params``)."""
    rng = np.random.default_rng(11)
    z = rng.normal(size=(nmode, nmode)) + 1j * rng.normal(size=(nmode, nmode))
    u, _ = np.linalg.qr(z)
    cir = mod.GaussianBosonSampling(nmode, rng.uniform(0.2, 0.6, nmode), u, detector='threshold')
    if displaced:
        cir.d(0, 0.3, 0.4)
        cir.d(nmode // 2, 0.2, 1.0)
    cir._train_mask = [False] * len(cir._pvals)
    for op in cir.operators[:nmode]:
        cir._train_mask[op.pidx[0]] = True
    return cir


@pytest.mark.parametrize('displaced', [False, True])
def test_gbs_squeezing_gradient_matches_jax(displaced):
    """d P / d squeezing, P summed over click patterns of 3 and 4 clicks
    (torontonians of size 6 and 8: the K8 route, K9 when displaced)."""
    dq.set_dtype('complex128')
    dqt.set_dtype('complex128')
    from deepquantum_tpu.photonic import gaussian_prob as jgp
    keys = ((1, 1, 0, 1), (1, 1, 1, 1), (0, 1, 1, 1))
    jcir, tcir = _gbs(jph, displaced), _gbs(tph, displaced)
    # the JAX package's probability program for these patterns, with the
    # state's purity and displacement given (its public call reads them on
    # the host, which a gradient trace cannot)
    probs = jgp._probs_fn(keys, 'threshold', True, displaced)

    def jloss(q):
        cov, mean = jcir(params=q)
        return jnp.sum(probs(cov.reshape(8, 8), mean.reshape(8, 1)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(jcir.params)))
    p = tcir.params.requires_grad_()
    out = tcir(params=p, is_prob=True)
    sum(out[tph.FockState(list(k))] for k in keys).real.backward()
    assert p.grad.shape == (4,) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-8)


def test_clements_angle_gradient_matches_jax():
    """d P / d angles of two outcomes of a 5-mode, 3-photon mesh (3 x 3
    permanents: the closed form; the 4-photon test in
    tests/test_torch_photonic_circuit.py takes the Ryser route)."""
    dq.set_dtype('complex128')
    dqt.set_dtype('complex128')
    init = [1, 1, 1, 0, 0]
    jcir = jph.Clements(5, init_state=init, cutoff=4)
    tcir = tph.Clements(5, init_state=init, cutoff=4)
    data = np.random.default_rng(12).uniform(0, 2 * np.pi, jcir.ndata)
    keys = [[1, 0, 1, 0, 1], [0, 1, 1, 1, 0]]

    def jloss(d):
        out = jcir(data=d, is_prob=True, sort=False)
        return sum(out[jph.FockState(k)] for k in keys)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(data)))
    d = torch.tensor(data, requires_grad=True)
    out = tcir(data=d, is_prob=True)
    sum(out[tph.FockState(k)] for k in keys).backward()
    np.testing.assert_allclose(d.grad.numpy(), want, atol=1e-8)
