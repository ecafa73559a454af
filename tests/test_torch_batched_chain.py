"""PyTorch port vs the JAX package: the batched gate chain in one launch.

A batched gate chain (``QubitCircuit.forward / expectation(data=(B, ndata))``
on the planar engine) runs on the card as one launch per direction of
``csrc/planar_chain_batched.cu``; on the CPU its plain twin
``planar_chain_batched_plain`` walks the same packed step table with the
per-step twins, so these tests cover the packing, the fold of the
scheduler's relabels into the table's bits and the shared-plane handling.

- Values through the public API against the JAX package's own batched
  planar route (``_sim_planar_batched``: its Pallas kernels in interpret
  mode, ``DQ_PLANAR=1``, complex64), as its tests run it on the CPU.
- Gradients in the parameters and in the data against the JAX package's
  exact route (complex128, ``DQ_PLANAR`` unset: its interpret-mode kernels
  would take minutes for a gradient).
- A sequence with ('rot', d) relabels (n=16) against the JAX exact route
  and against the port's per-step route, which really relabels the state.
- A Python mirror of the kernel's walk (block r of a sample's cluster of
  C = 2^c blocks owns groups r 2^(n-k-c) ... ; an amplitude index is
  (cluster rank, local offset) = (idx >> (n - c), idx mod 2^(n-c))): a
  bijection onto the amplitudes for C in {1, 2, 4, 8}, local exactly where
  the table says, and, walked in float64, the twin's forward and backward.

Tolerances: float32 against the interpret-mode kernels, at most 8 products
per amplitude per step over a few steps, 2e-6; complex64 against complex128
over a few dozen gates, values 1e-5 and gradients 1e-4 (as
tests/test_torch_batched.py); the float64 mirror against the float32 twin
1e-5 (states) and 1e-4 (cotangent planes: sums of up to 2^7 products).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepquantum_tpu as dq
import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
from deepquantum_tpu_torch.ops import planar_gate as tpg

torch.set_num_threads(1)

B = 4


@pytest.fixture(autouse=True)
def _cpu():
    dqt.set_device('cpu')
    yield
    dqt.set_dtype('complex64')
    dq.set_dtype('complex128')
    dqt.set_device(None)


def _small(mod):
    """Per-sample planes (encoders, a controlled encoder on two wires) and
    shared ones (fixed and trainable gates), a Toffoli on unsorted wires
    (k = 3); two observables."""
    cir = mod.QubitCircuit(10)
    cir.ry(0, encode=True)
    cir.ry(6, controls=2, encode=True)
    cir.toffoli(8, 1, 5)
    cir.rxx([2, 7])
    cir.observable(0)
    cir.observable([1, 2], basis='xy')
    cir.init_para(3)
    return cir


def _data():
    return np.random.default_rng(0).uniform(0, np.pi, (B, 2))


@pytest.fixture(scope='module')
def jax_small():
    """The JAX package's values on its batched planar route (interpret
    mode), then its gradients of a weighted sum of the expectations on its
    exact route (complex128)."""
    data = _data()
    w = np.arange(1.0, 2 * B + 1).reshape(B, 2)
    os.environ['DQ_PLANAR'] = '1'
    dq.set_dtype('complex64')
    try:
        cir = _small(dq)
        assert cir._planar_ok()
        states = np.asarray(cir.forward(data=jnp.asarray(data, jnp.float32), params=cir.params))
        exps = np.asarray(cir.expectation())
    finally:
        os.environ.pop('DQ_PLANAR', None)
        dq.set_dtype('complex128')
    cir = _small(dq)

    def loss(q, d):
        return jnp.sum(cir.expectation(data=d, params=q) * w)

    gp, gd = jax.grad(loss, argnums=(0, 1))(cir.params, jnp.asarray(data))
    return dict(cir=cir, data=data, w=w, p=np.asarray(cir.params), states=states, exps=exps,
                gp=np.asarray(gp), gd=np.asarray(gd))


def _spy(monkeypatch):
    """Count the twin's forward and backward walks and the per-step walks."""
    calls = {'fwd': 0, 'bwd': 0, 'steps': 0}
    plain, steps_f, steps_b = (pcb.planar_chain_batched_plain, tpg._steps_forward,
                               tpg._steps_backward)

    def chain(x, chain_, g=None):
        calls['bwd' if g is not None else 'fwd'] += 1
        return plain(x, chain_, g)

    def count(fn):
        def inner(*args, **kwargs):
            calls['steps'] += 1
            return fn(*args, **kwargs)
        return inner

    monkeypatch.setattr(pcb, 'planar_chain_batched_plain', chain)
    monkeypatch.setattr(tpg, '_steps_forward', count(steps_f))
    monkeypatch.setattr(tpg, '_steps_backward', count(steps_b))
    return calls


def test_chain_values_match_jax_planar_route(jax_small, monkeypatch):
    """forward states and expectations through the chain's twin against the
    JAX package's batched planar route (interpret mode): one forward walk
    for the gates and one for each observable's chain, no per-step walk."""
    r = jax_small
    cir = dqt.from_jax(r['cir'])
    assert cir._planar_ok()
    calls = _spy(monkeypatch)
    data = torch.tensor(r['data'], dtype=torch.float32)
    with torch.no_grad():
        states = cir.forward(data=data, params=dqt.params_from_numpy(r['p']))
        exps = cir.expectation()
    assert calls == {'fwd': 3, 'bwd': 0, 'steps': 0}
    assert states.shape == (B, 1 << 10, 1) and exps.shape == (B, 2)
    np.testing.assert_allclose(states.numpy(), r['states'], atol=2e-6)
    np.testing.assert_allclose(exps.numpy(), r['exps'], atol=2e-6)


@pytest.mark.parametrize('fused', [False, True])
def test_chain_gradients_match_jax(jax_small, fused, monkeypatch):
    """the gradients in the parameters (shared planes) and in the data
    (per-sample planes) against the JAX exact route: one backward walk,
    whatever fused_bwd says."""
    r = jax_small
    cir = dqt.from_jax(r['cir'])
    cir.fused_bwd = fused
    calls = _spy(monkeypatch)
    p = dqt.params_from_numpy(r['p'], requires_grad=True)
    d = torch.tensor(r['data'], dtype=torch.float32, requires_grad=True)
    exps = cir.expectation(data=d, params=p)
    torch.sum(exps * torch.tensor(r['w'], dtype=torch.float32)).backward()
    assert calls == {'fwd': 3, 'bwd': 1, 'steps': 0}
    np.testing.assert_allclose(p.grad.numpy(), r['gp'], atol=1e-4)
    np.testing.assert_allclose(d.grad.numpy(), r['gd'], atol=1e-4)


def _qml16(mod):
    cir = mod.QubitCircuit(16, reupload=True)
    for i in range(16):
        cir.ry(i, encode=True)
    for i in range(16):
        cir.rz(i)
        cir.ry(i)
    cir.cnot_ring()
    cir.observable(0)
    cir.init_para(1)
    return cir


def test_relabels_fold_into_the_table(monkeypatch):
    """At n=16 the scheduler puts ('rot', d) relabels into the batched
    sequence (as the JAX package's does); the table folds them into the
    later steps' bits and the state is never relabelled. States against the
    JAX exact route; states and gradients against the port's per-step route
    (which relabels the state, as the JAX planar engine does)."""
    n = 16
    data = np.random.default_rng(1).uniform(0, np.pi, (2, n))
    jcir = _qml16(dq)
    want = np.asarray(jcir.forward(data=jnp.asarray(data), params=jcir.params))
    cir = dqt.from_jax(jcir)
    d = torch.tensor(data, dtype=torch.float32)
    mres, mims, wseq = cir._planar_seq_batched(cir._full_params(None, d, cir._data_indices(n)))
    rots = [ws for ws in wseq if ws[0] == 'rot']
    assert rots and pcb.batched_chain_ok(wseq, n, mres, backward=True)
    chain = pcb.pack_chain(torch.zeros(2, 2, 1 << n), mres, mims, n, wseq)
    assert len(chain.rows) == len(wseq) - len(rots)
    gates = [ws for ws in wseq if ws[0] != 'rot']
    assert any([n - 1 - b for b in row[4:4 + row[0]]] != list(ws)
               for row, ws in zip(chain.rows, gates))

    out = {}
    for route in ('chain', 'steps'):
        if route == 'steps':
            monkeypatch.setattr(tpg, '_batched_chain', lambda *a, **k: None)
        p = cir.params.requires_grad_()
        dd = d.clone().requires_grad_()
        states = cir.forward(data=dd, params=p)
        cir.expectation().sum().backward()
        out[route] = (states.detach(), p.grad, dd.grad)
    np.testing.assert_allclose(out['chain'][0].numpy(), want, atol=1e-5)
    for a, b in zip(out['chain'], out['steps']):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# ----------------------------------------------------- the kernel's walk
def _kernel_groups(n: int, c: int, row):
    """Mirror of the kernel's walk of one table row: for block r and its
    j-th group, the indices of the group's 2^k amplitudes in the planes'
    row order, as an array (2^c, 2^(n-k-c), 2^k)."""
    k, obits, sbits = row[0], row[4:4 + row[0]], row[7:7 + row[0]]
    lbits = n - c
    g = np.arange(1 << (n - k)).reshape(1 << c, 1 << (lbits - k))
    base = g.copy()
    for b in reversed(sbits):               # the lowest bit first
        base = ((base >> b) << (b + 1)) | (base & ((1 << b) - 1))
    idx = np.repeat(base[..., None], 1 << k, axis=-1)
    for a in range(1 << k):
        for j, b in enumerate(obits):
            idx[..., a] |= ((a >> (k - 1 - j)) & 1) << b
    return idx


def _row_planes64(chain, row):
    k, one, off = row[0], row[1], row[2]
    d = 1 << k
    if one:
        re, im = (p[off:off + d * d].double().numpy().reshape(1, d, d)
                  for p in (chain.sh_re, chain.sh_im))
    else:
        re, im = (p[:, off:off + d * d].double().numpy().reshape(-1, d, d)
                  for p in (chain.ps_re, chain.ps_im))
    return re + 1j * im


@pytest.mark.parametrize('c', [0, 1, 2, 3])
def test_kernel_index_map_is_a_bijection(c):
    """C = 2^c blocks a sample: every row's groups cover the 2^n amplitudes
    once; a row the kernel walks locally (its highest bit below n - c)
    keeps every group in its owner's block, and a row it walks through the
    cluster reaches another block. Walked in float64 with that map (the
    backward: U^H from U's planes, one dW partial per block, summed), the
    chain gives the twin's forward and backward."""
    n, b = 8, 3
    rng = np.random.default_rng(c)
    wseq = ((0,), (3, 7), ('rot', 3), (1, 2, 6), (5,), (0, 7), ('rot', 5), (0, 4), (2, 6, 7),
            (6,))
    mres, mims = [], []
    for i, ws in enumerate(wseq):
        if ws[0] == 'rot':
            mres.append(None)
            mims.append(None)
            continue
        k = 1 << len(ws)
        z = rng.standard_normal((1 if i % 2 else b, k, k, 2)) @ np.array([1, 1j])
        u = np.linalg.qr(z)[0]                  # unitary: the states keep their norm
        mres.append(torch.tensor(u.real, dtype=torch.float32).expand(b, k, k))
        mims.append(torch.tensor(u.imag, dtype=torch.float32).expand(b, k, k))
    assert pcb.batched_chain_ok(wseq, n, mres, backward=True)
    x = torch.tensor(rng.standard_normal((b, 2, 1 << n)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((b, 2, 1 << n)), dtype=torch.float32)
    chain = pcb.pack_chain(x, mres, mims, n, wseq)
    assert chain.pstride > 0 and chain.sh_re.numel() > 1

    lbits = n - c
    walks = []
    for row in chain.rows:
        idx = _kernel_groups(n, c, row)
        assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << n))
        owner = np.arange(1 << c)[:, None, None]
        local = np.all(idx >> lbits == owner)
        assert local == (row[7] < lbits)
        walks.append((idx, _row_planes64(chain, row)))

    # forward: the groups of every block at once
    psi = x[:, 0].double().numpy() + 1j * x[:, 1].double().numpy()
    for idx, u in walks:
        v = psi[:, idx]                                     # (b, C, groups, D)
        psi[:, idx] = np.einsum('bac,brgc->brga', np.broadcast_to(u, (b,) + u.shape[1:]), v)
    y = pcb.planar_chain_batched_plain(x, chain)
    np.testing.assert_allclose(psi.real, y[:, 0].numpy(), atol=1e-5)
    np.testing.assert_allclose(psi.imag, y[:, 1].numpy(), atol=1e-5)

    # backward from the twin's output
    x_in, g_in, dres, dims = pcb.planar_chain_batched_plain(y, chain, g)
    st = y[:, 0].double().numpy() + 1j * y[:, 1].double().numpy()
    ct = g[:, 0].double().numpy() + 1j * g[:, 1].double().numpy()
    parts = {}
    for row, (idx, u) in zip(reversed(chain.rows), reversed(walks)):
        uh = np.conj(np.swapaxes(np.broadcast_to(u, (b,) + u.shape[1:]), -1, -2))
        xv = np.einsum('bac,brgc->brga', uh, st[:, idx])
        gv = ct[:, idx]
        # dRe + i dIm = g x^H per block, then the blocks in order
        parts[row[3]] = np.einsum('brga,brgc->brac', gv, np.conj(xv)).sum(axis=1)
        st[:, idx] = xv
        ct[:, idx] = np.einsum('bac,brgc->brga', uh, gv)
    np.testing.assert_allclose(st.real, x_in[:, 0].numpy(), atol=1e-5)
    np.testing.assert_allclose(st.imag, x_in[:, 1].numpy(), atol=1e-5)
    np.testing.assert_allclose(ct.real, g_in[:, 0].numpy(), atol=1e-5)
    np.testing.assert_allclose(ct.imag, g_in[:, 1].numpy(), atol=1e-5)
    for i, row in zip(chain.steps, chain.rows):
        np.testing.assert_allclose(parts[row[3]].real, dres[i].numpy(), atol=1e-4)
        np.testing.assert_allclose(parts[row[3]].imag, dims[i].numpy(), atol=1e-4)
    assert all(dres[i] is None for i, ws in enumerate(wseq) if ws[0] == 'rot')


def test_pack_keeps_each_shared_plane_set_once():
    """stride-0 planes (a fixed gate's matrix expanded over the batch) are
    packed once; per-sample planes sit sample by sample; the table's
    offsets walk both buffers and the partials in step order."""
    n, b = 9, 5
    eye, rnd = torch.eye(2), torch.randn(b, 4, 4)
    mres = [eye.expand(b, 2, 2), rnd, None, eye.expand(b, 2, 2)]
    mims = [torch.zeros(2, 2).expand(b, 2, 2), rnd * 2, None, torch.zeros(2, 2).expand(b, 2, 2)]
    wseq = ((0,), (2, 5), ('rot', 4), (8,))
    assert pcb.batched_chain_ok(wseq, n, mres) is False            # the relabel does not close
    wseq = ((0,), (2, 5), ('rot', 9), (8,))
    assert pcb.batched_chain_ok(wseq, n, mres)
    chain = pcb.pack_chain(torch.zeros(b, 2, 1 << n), mres, mims, n, wseq)
    assert chain.pstride == 16 and chain.ps_re.shape == (b, 16) and chain.sh_re.shape == (8,)
    assert torch.equal(chain.ps_im.view(b, 4, 4), rnd * 2)
    assert [r[:4] for r in chain.rows] == [[1, 1, 0, 0], [2, 0, 0, 8], [1, 1, 4, 40]]
    assert [r[4:] for r in chain.rows] == [[8, 0, 0, 8, 0, 0], [6, 3, 0, 6, 3, 0],
                                           [0, 0, 0, 0, 0, 0]]
    assert chain.steps == [0, 1, 3] and chain.fd == 48 and chain.table.dtype == torch.int32


def test_chain_range_and_cluster_size():
    """The kernel's range: 8 <= n <= 17 forward, <= 16 backward, a block's
    planes within 128 KB (C = 1 up to n=14 forward, n=13 backward, then
    2, 4, 8, more for a small batch); windows, repeated wires and unbatched
    planes are refused, and a CPU tensor never reaches the launch."""
    assert [pcb.cluster_bits(n) for n in (10, 14, 15, 16, 17)] == [0, 0, 1, 2, 3]
    assert [pcb.cluster_bits(n, True) for n in (10, 13, 14, 15, 16)] == [0, 0, 1, 2, 3]
    # a small batch spreads over more blocks while they fit the card's 132
    # multiprocessors and a block keeps 2^12 amplitudes
    assert [pcb.cluster_bits(n, False, b, 132) for n, b in
            ((14, 100), (16, 8), (13, 3), (10, 3), (17, 2))] == [0, 3, 1, 0, 3]
    assert [pcb.cluster_bits(n, True, b, 132) for n, b in ((14, 100), (14, 3), (16, 8))] == \
        [1, 2, 3]
    m3 = [torch.eye(2).expand(3, 2, 2)]
    assert [pcb.batched_chain_ok(((1,),), n, m3) for n in (7, 8, 17, 18)] == \
        [False, True, True, False]
    assert [pcb.batched_chain_ok(((1,),), n, m3, True) for n in (8, 16, 17)] == \
        [True, True, False]
    assert not pcb.batched_chain_ok(((1,),), 12, [torch.eye(2)])
    assert not pcb.batched_chain_ok((('win', 7),), 14, [torch.eye(128).expand(3, 128, 128)])
    assert not pcb.batched_chain_ok(((1, 1),), 12, [torch.eye(4).expand(3, 4, 4)])
    with pytest.raises(ValueError, match='state must be a CUDA tensor'):
        chain = pcb.pack_chain(torch.zeros(3, 2, 1 << 12), m3, m3, 12, ((1,),))
        pcb._planar_chain_batched_cuda(torch.zeros(3, 2, 1 << 12), chain)
