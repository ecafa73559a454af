"""The port's CUDA kernels on the card, held against their plain twins.

Every test here is marked `cuda` and skips without a CUDA card. The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: float32 with at most 8 products per amplitude (planar_apply,
2e-6), 128-term sums (window_apply, 1e-5 absolute on unit-variance
states), up to ~30 chained windows (window_chain_fwd, window_chain_bwd and
the slice, 1e-5), and cotangent planes that sum 2^(n-k) products in another
order than the twin's matmul (1e-5 of max|ref|; the H100 reads 2e-6 at n=22).
"""

import numpy as np
import pytest
import torch

import deepquantum_tpu_torch as dqt
from deepquantum_tpu_torch.ops import chain_kernel as tck
from deepquantum_tpu_torch.ops import planar_gate as tpg
from deepquantum_tpu_torch.ops import window_gate as twg

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dqt.set_dtype('complex64')
    yield torch.device('cuda')
    dqt.set_dtype('complex64')


def _haar(k, rng):
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planes(u, device):
    return (torch.as_tensor(u.real, dtype=torch.float32, device=device),
            torch.as_tensor(u.imag, dtype=torch.float32, device=device))


def _state(n, rng, device):
    return torch.as_tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float32, device=device)


def _bench(n, layers, device=None, extra_cnot=None):
    """The bench ansatz; with no device it lands on the default device,
    which is the card."""
    cir = dqt.QubitCircuit(n, device=device)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
        if extra_cnot is not None:
            cir.cnot(*extra_cnot)
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(n)
    return cir


def _plane_close(got, want):
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


def _grad(cir):
    p = cir.params.requires_grad_()
    loss = cir.expectation(params=p)[0]
    loss.backward()
    return loss.detach(), p.grad


@pytest.fixture()
def twin_route(monkeypatch):
    """Run the planar engine's steps through the plain twins on the card."""
    def planar(x, mre, mim, n, wires):
        return x.copy_(tpg.planar_evolve_xla(x, mre, mim, n, wires))

    def window(x, mre, mim, n, w):
        return x.copy_(twg.window_apply_plain(x, mre, mim, n, w))

    def bwd_fused(y, g, mre_t, mim_t, n, wires):
        x, g2, dre, dim = tpg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
        return y.copy_(x), g.copy_(g2), dre, dim

    def enter():
        monkeypatch.setattr(tpg, 'planar_apply', planar)
        monkeypatch.setattr(twg, 'window_apply', window)
        monkeypatch.setattr(tck, 'window_chain_fwd', tck.window_chain_plain)
        monkeypatch.setattr(tck, 'window_chain_bwd', tck.window_chain_bwd_plain)
        monkeypatch.setattr(tpg, 'planar_grad', tpg.planar_grad_xla)
        monkeypatch.setattr(tpg, 'planar_bwd_fused', bwd_fused)

    return enter


@pytest.mark.parametrize('n,wires', [(16, (0,)), (16, (15,)), (16, (3, 9)), (16, (0, 8, 15)),
                                     (12, (4, 5, 6))])
def test_planar_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + sum(wires))
    mre, mim = _planes(_haar(1 << len(wires), rng), card)
    x = _state(n, rng, card)
    want = tpg.planar_evolve_xla(x, mre, mim, n, wires)
    before = tpg.planar_apply.launches
    got = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    assert tpg.planar_apply.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_window_kernel_matches_twin(card):
    n = 16
    rng = np.random.default_rng(16)
    mre, mim = _planes(_haar(128, rng), card)
    x = _state(n, rng, card)
    want = twg.window_apply_plain(x, mre, mim, n, 7)
    before = twg.window_apply.launches
    got = twg.window_apply(x.clone(), mre, mim, n, 7)
    assert twg.window_apply.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize('n', [12, 13, 16, 20])
def test_window_kernel_non_unitary_in_place(n, card):
    rng = np.random.default_rng(100 + n)
    w = (rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))) / 16
    mre, mim = _planes(w, card)
    x = _state(n, rng, card)
    want = twg.window_apply_plain(x, mre, mim, n, 7)
    before = twg.window_apply.launches
    got = twg.window_apply(x, mre, mim, n, 7)
    assert got is x
    assert twg.window_apply.launches == before + 1
    # the bar of chip_smoke.py at n=24: 3xTF32 on the tensor cores against float32 matmuls
    err = (x - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-6, err


@pytest.mark.parametrize('n', [16, 19])
def test_chain_kernel_matches_twin(n, card):
    cir = _bench(n, 2, card)
    with torch.inference_mode():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        assert tck.chain_fused_ok(wseq, n, mres)
        x = _state(n, np.random.default_rng(n), card)
        x0 = x.clone()
        want = tck.window_chain_plain(x, mres, mims, n, wseq)
        before = tck.window_chain_fwd.launches
        got = tck.window_chain_fwd(x, mres, mims, n, wseq)
        assert tck.window_chain_fwd.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(x, x0)   # the caller's state is not written


def test_slice_matches_complex128(card):
    n = 16
    cir = _bench(n, 5, card)
    with torch.inference_mode():
        before = tck.window_chain_fwd.launches
        state = cir.forward()
        e = cir.expectation()
        assert tck.window_chain_fwd.launches == before + 2
    dqt.set_dtype('complex128')
    ref = _bench(n, 5, card)
    assert not ref._planar_ok()
    with torch.inference_mode():
        ref_state = ref.forward()
        ref_e = ref.expectation()
    assert (state.to(torch.complex128) - ref_state).abs().max().item() <= 1e-5
    assert abs(e.item() - ref_e.item()) <= 1e-5


GATE_CASES = [(16, (0,)), (16, (15,)), (16, (3, 9)), (16, (0, 8, 15)), (12, (4, 5, 6)),
              (10, (9,)), (10, (2, 5, 9))]


@pytest.mark.parametrize('n,wires', GATE_CASES)
def test_planar_grad_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + sum(wires))
    g, x = _state(n, rng, card), _state(n, rng, card)
    want = tpg.planar_grad_xla(g, x, n, wires)
    before = tpg.planar_grad.launches
    got = tpg.planar_grad(g, x, n, wires)
    assert tpg.planar_grad.launches == before + 1
    for a, b in zip(got, want):
        _plane_close(a, b)
    again = tpg.planar_grad(g, x, n, wires)     # the sum's order is fixed
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize('n,wires', GATE_CASES)
def test_planar_bwd_fused_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + 3 * sum(wires))
    u = _haar(1 << len(wires), rng)
    mre_t, mim_t = _planes(u.conj().T, card)
    y, g = _state(n, rng, card), _state(n, rng, card)
    want = tpg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
    before = tpg.planar_bwd_fused.launches
    got = tpg.planar_bwd_fused(y, g, mre_t, mim_t, n, wires)
    assert tpg.planar_bwd_fused.launches == before + 1
    assert got[0] is y and got[1] is g          # in place on both
    torch.testing.assert_close(y, want[0], atol=2e-6, rtol=0)
    torch.testing.assert_close(g, want[1], atol=2e-6, rtol=0)
    _plane_close(got[2], want[2])
    _plane_close(got[3], want[3])


@pytest.mark.parametrize('n', [14, 16, 19])
def test_chain_bwd_kernel_matches_twin(n, card):
    cir = _bench(n, 2, card)
    with torch.no_grad():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        if n == 14:     # the bench plan has per-gate steps at n=14: keep its windows and relabels
            keep = [i for i, s in enumerate(wseq) if s[0] in ('win', 'rot')]
            mres, mims = [mres[i] for i in keep], [mims[i] for i in keep]
            wseq = tuple(wseq[i] for i in keep)
        assert tck.chain_fused_ok(wseq, n, mres)
        rng = np.random.default_rng(n)
        x0 = _state(n, rng, card)
        y = tck.window_chain_plain(x0, mres, mims, n, wseq)
        g = _state(n, rng, card).t().contiguous().t()    # autograd may hand over any strides
        assert not g.is_contiguous()
        y0, g0 = y.clone(), g.clone()
        want = tck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
        before = tck.window_chain_bwd.launches
        got = tck.window_chain_bwd(y, g, mres, mims, n, wseq)
        assert tck.window_chain_bwd.launches == before + 1
    assert torch.equal(y, y0) and torch.equal(g, g0)     # neither input is written
    torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=0)
    # the round trip (twin forward, kernel backward) passes twice the windows, each a
    # 128-term float32 sum on unit-variance amplitudes: 1.24e-5 on the H100 at n=19
    torch.testing.assert_close(got[0], x0, atol=5e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    for st, dr, di, wr, wi in zip(wseq, got[2], got[3], want[2], want[3]):
        if st[0] == 'rot':
            assert dr is None and di is None
        else:
            _plane_close(dr, wr)
            _plane_close(di, wi)


@pytest.mark.parametrize('n', [14, 19])
def test_chain_bwd_kernel_is_bitwise_reproducible(n, card):
    cir = _bench(n, 2, card)
    with torch.no_grad():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        keep = [i for i, s in enumerate(wseq) if s[0] in ('win', 'rot')]
        mres, mims = [mres[i] for i in keep], [mims[i] for i in keep]
        wseq = tuple(wseq[i] for i in keep)
        rng = np.random.default_rng(n + 1)
        y, g = _state(n, rng, card), _state(n, rng, card)
        first = tck.window_chain_bwd(y, g, mres, mims, n, wseq)
        second = tck.window_chain_bwd(y, g, mres, mims, n, wseq)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for a, b in zip(first[2] + first[3], second[2] + second[3]):
        assert (a is None and b is None) or torch.equal(a, b)   # partials summed in a fixed order


@pytest.mark.parametrize('n,sms', [(19, 114), (18, 16)])
def test_chain_bwd_kernel_on_fewer_sms(n, sms, card):
    """A grid capped below the column tiles (n=19 on the 114 SMs of an H100
    PCIe: 128 tiles; n=18 on 16: 4 tiles a block): a block walks several
    tiles and adds their dW onto its slot. Twin within the same bars, and
    bitwise equal over two launches."""
    cir = _bench(n, 2, card)
    with torch.no_grad():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        keep = [i for i, s in enumerate(wseq) if s[0] in ('win', 'rot')]
        mres, mims = [mres[i] for i in keep], [mims[i] for i in keep]
        wseq = tuple(wseq[i] for i in keep)
        assert tck._bwd_slots(n, sms) > sms          # more tiles than blocks
        rng = np.random.default_rng(n + 2)
        y, g = _state(n, rng, card), _state(n, rng, card)
        want = tck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
        before = tck.window_chain_bwd.launches
        first = tck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        second = tck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        assert tck.window_chain_bwd.launches == before + 2
        too_many = torch.cuda.get_device_properties(card).multi_processor_count + 1
        with pytest.raises(RuntimeError):
            tck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=too_many)
    torch.testing.assert_close(first[0], want[0], atol=1e-5, rtol=0)
    torch.testing.assert_close(first[1], want[1], atol=1e-5, rtol=0)
    for dr, di, wr, wi in zip(first[2], first[3], want[2], want[3]):
        if wr is not None:
            _plane_close(dr, wr)
            _plane_close(di, wi)
    for a, b in zip(first[:2] + tuple(first[2] + first[3]), second[:2] + tuple(second[2] + second[3])):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize('n,layers,extra,fused', [(16, 2, None, False), (12, 2, None, False),
                                                  (12, 2, None, True), (20, 1, (0, 10), False),
                                                  (20, 1, (0, 10), True)])
def test_gradient_kernel_route_matches_twin_route(n, layers, extra, fused, card, twin_route):
    """The training path on the default device: one-launch chain (n=16),
    per-gate steps (n=12), windows + a gate no window holds (n=20)."""
    cir = _bench(n, layers, None, extra)
    assert cir.device.type == 'cuda'
    cir.fused_bwd = fused
    names = {'chain_bwd': tck.window_chain_bwd, 'grad': tpg.planar_grad,
             'fused': tpg.planar_bwd_fused}
    before = {k: fn.launches for k, fn in names.items()}
    loss, grad = _grad(cir)
    torch.cuda.synchronize()
    used = {k: fn.launches - before[k] for k, fn in names.items()}
    if n == 16:
        assert used == {'chain_bwd': 1, 'grad': 0, 'fused': 0}
    elif fused:
        assert used['fused'] > 0 and used['grad'] == 0 and used['chain_bwd'] == 0
    else:
        assert used['grad'] > 0 and used['fused'] == 0 and used['chain_bwd'] == 0
    twin_route()
    twin_loss, twin_grad = _grad(cir)
    assert {k: fn.launches - before[k] for k, fn in names.items()} == used
    assert abs(loss.item() - twin_loss.item()) <= 1e-5
    torch.testing.assert_close(grad, twin_grad, atol=1e-5, rtol=0)


def test_training_step_matches_complex128(card):
    n = 16
    cir = _bench(n, 5)
    before = tck.window_chain_fwd.launches, tck.window_chain_bwd.launches
    loss, grad = _grad(cir)
    assert (tck.window_chain_fwd.launches, tck.window_chain_bwd.launches) == \
        (before[0] + 2, before[1] + 1)
    dqt.set_dtype('complex128')
    ref = _bench(n, 5)
    assert not ref._planar_ok()
    ref_loss, ref_grad = _grad(ref)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5
    assert (grad.double() - ref_grad).abs().max().item() <= 1e-4


def test_second_order_raises_on_the_card(card):
    cir = _bench(16, 1)
    p = cir.params.requires_grad_()
    loss = cir.expectation(params=p)[0]
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(loss, p, create_graph=True)


def test_direct_wrapper_call_refuses_gradients(card):
    """Gradients come from the Functions; a kernel wrapper called directly
    with a tensor that requires grad raises instead of taking the twin."""
    x = torch.zeros(2, 1 << 12, device=card, requires_grad=True)
    m = torch.eye(2, device=card)
    with pytest.raises(NotImplementedError):
        tpg.planar_apply(x, m, m, 12, (0,))
    with pytest.raises(NotImplementedError):
        tpg.planar_grad(x, x.detach(), 12, (0,))


def test_cuda_tensor_never_reaches_a_twin(card):
    """What a kernel does not take raises: a CUDA tensor of the wrong dtype
    or shape is not handed to the plain version."""
    m = torch.eye(2, device=card)
    x64 = torch.zeros(2, 1 << 12, device=card, dtype=torch.float64)
    x32 = torch.zeros(2, 1 << 12, device=card)
    for call in (lambda: tpg.planar_apply(x64, m, m, 12, (0,)),
                 lambda: tpg.planar_grad(x64, x64, 12, (0,)),
                 lambda: tpg.planar_bwd_fused(x64, x64.clone(), m, m, 12, (0,))):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: tpg.planar_grad(x32, x32[:, :1 << 11], 12, (0,)),
                 lambda: tpg.planar_bwd_fused(x32, x32, m, m, 12, (0,)),
                 lambda: tpg.planar_grad(x32[:, :1 << 8], x32[:, :1 << 8], 8, (0, 1, 2)),
                 lambda: tpg.planar_bwd_fused(x32, x32.clone(), torch.eye(4, device=card), m, 12,
                                              (0,))):
        with pytest.raises(ValueError):
            call()


def test_cuda_entry_refuses_batched_state(card):
    """The per-gate kernels take a (B, 2, 2^n) stack; the window kernels do
    not, and planes whose batch is not the state's are refused."""
    x = torch.zeros(3, 2, 1 << 12, device=card)
    m = torch.eye(2, device=card)
    with pytest.raises(ValueError, match='matrix planes'):
        tpg.planar_apply(x, m.expand(4, 2, 2).contiguous(), m, 12, (0,))
    with pytest.raises(ValueError, match='two states'):
        tpg.planar_grad(x, x[0], 12, (0,))
    with pytest.raises(ValueError, match=r'\(2, 2\^12\)'):
        twg.window_apply(x, torch.eye(128, device=card), torch.zeros(128, 128, device=card), 12, 7)


# -------------------------------------------------------------- batched forms
# The batched K1 / K5 / K6: a (B, 2, 2^n) stack with per-sample (B, K, K)
# planes, or one (K, K) set for every sample; bars as for the single forms.
BATCH_CASES = [(12, 5, (0,), False), (12, 5, (11,), True), (14, 7, (3, 9), False),
               (14, 7, (0, 13), True), (13, 3, (0, 6, 12), False), (13, 3, (4, 5, 6), True),
               (10, 40, (2, 5, 9), False), (12, 1, (3, 7), False)]


def _batch(n, b, k, rng, device, shared):
    x = torch.as_tensor(rng.standard_normal((b, 2, 1 << n)), dtype=torch.float32, device=device)
    us = [_haar(1 << k, rng) for _ in range(1 if shared else b)]
    mre = torch.as_tensor(np.stack([u.real for u in us]), dtype=torch.float32, device=device)
    mim = torch.as_tensor(np.stack([u.imag for u in us]), dtype=torch.float32, device=device)
    if shared:
        return x, mre[0], mim[0]
    return x, mre, mim


@pytest.mark.parametrize('n,b,wires,shared', BATCH_CASES)
def test_batched_kernels_match_twins(n, b, wires, shared, card):
    rng = np.random.default_rng(n * b + sum(wires))
    x, mre, mim = _batch(n, b, len(wires), rng, card, shared)
    g = torch.as_tensor(rng.standard_normal(x.shape), dtype=torch.float32, device=card)
    counts = [fn.batched_launches for fn in (tpg.planar_apply, tpg.planar_grad,
                                             tpg.planar_bwd_fused)]
    single = [fn.launches for fn in (tpg.planar_apply, tpg.planar_grad, tpg.planar_bwd_fused)]

    y = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    torch.testing.assert_close(y, tpg.planar_evolve_xla(x, mre, mim, n, wires), atol=2e-6, rtol=0)
    for a, w in zip(tpg.planar_grad(g, x, n, wires), tpg.planar_grad_xla(g, x, n, wires)):
        assert a.shape == (b, 1 << len(wires), 1 << len(wires))
        _plane_close(a, w)
    mre_t, mim_t = mre.transpose(-1, -2).contiguous(), (-mim.transpose(-1, -2)).contiguous()
    want = tpg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
    wy, wg = y.clone(), g.clone()
    got = tpg.planar_bwd_fused(wy, wg, mre_t, mim_t, n, wires)
    torch.cuda.synchronize()
    assert got[0] is wy and got[1] is wg
    torch.testing.assert_close(wy, want[0], atol=2e-6, rtol=0)
    torch.testing.assert_close(wg, want[1], atol=2e-6, rtol=0)
    torch.testing.assert_close(wy, x, atol=2e-6, rtol=0)       # U^H U x = x
    _plane_close(got[2], want[2])
    _plane_close(got[3], want[3])
    assert [fn.batched_launches for fn in (tpg.planar_apply, tpg.planar_grad,
                                           tpg.planar_bwd_fused)] == [c + 1 for c in counts]
    assert [fn.launches for fn in (tpg.planar_apply, tpg.planar_grad,
                                   tpg.planar_bwd_fused)] == single


def test_batched_apply_past_the_block_cap(card):
    """160 states of 22 qubits at k = 1: 160 x 2^21 groups need 1.3M blocks
    of 256 threads, past the kernel's 2^20 cap, so each sample's blocks walk
    its groups; every sample still gets its own planes."""
    n, b, wires = 22, 160, (7,)
    rng = np.random.default_rng(22)
    x, mre, mim = _batch(n, b, 1, rng, card, False)
    assert b * (1 << (n - 1)) > (1 << 20) * 256
    y = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    torch.testing.assert_close(y, tpg.planar_evolve_xla(x, mre, mim, n, wires), atol=2e-6, rtol=0)
    g = torch.randn_like(x)
    for a, w in zip(tpg.planar_grad(g, x, n, wires), tpg.planar_grad_xla(g, x, n, wires)):
        _plane_close(a, w)


@pytest.mark.parametrize('wires', [(5,), (0, 13), (1, 7, 12)])
def test_batched_dw_is_bitwise_reproducible(wires, card):
    n, b = 14, 100
    rng = np.random.default_rng(len(wires))
    x, mre, mim = _batch(n, b, len(wires), rng, card, False)
    g = torch.randn_like(x)
    first = tpg.planar_grad(g, x, n, wires)
    assert all(torch.equal(a, c) for a, c in zip(first, tpg.planar_grad(g, x, n, wires)))
    outs = [tpg.planar_bwd_fused(x.clone(), g.clone(), mre, mim, n, wires) for _ in range(2)]
    assert all(torch.equal(a, c) for a, c in zip(*outs))


def _qml(n, layers, device=None):
    cir = dqt.QubitCircuit(n, device=device, reupload=True)
    for _ in range(layers):
        for i in range(n):
            cir.ry(i, encode=True)
        for i in range(n):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0)
    cir.init_para(n)
    return cir


@pytest.mark.parametrize('fused', [False, True])
def test_batched_qml_step_matches_complex128(fused, card):
    """The data-encoded step on the default device: batched K1 and K5 (K6
    with fused_bwd), no window or chain kernel; loss and the gradients in
    the parameters and the data against the complex128 einsum route."""
    n, b = 14, 12
    feats = np.random.default_rng(3).uniform(0, np.pi, (b, n))
    names = {'apply': tpg.planar_apply, 'grad': tpg.planar_grad, 'fused': tpg.planar_bwd_fused}
    windows = (twg.window_apply, tck.window_chain_fwd, tck.window_chain_bwd)
    before = {k: fn.batched_launches for k, fn in names.items()}
    before_win = [fn.launches for fn in windows]
    out = {}
    for dtype in ('complex64', 'complex128'):
        dqt.set_dtype(dtype)
        cir = _qml(n, 2)
        cir.fused_bwd = fused
        p = cir.params.requires_grad_()
        d = torch.tensor(feats, dtype=dqt.rdtype(), device=card, requires_grad=True)
        loss = cir.expectation(data=d, params=p).sum()
        loss.backward()
        out[dtype] = (loss.item(), p.grad.double(), d.grad.double())
        if dtype == 'complex64':
            used = {k: fn.batched_launches - before[k] for k, fn in names.items()}
    assert used['apply'] > 0 and [fn.launches for fn in windows] == before_win
    assert (used['fused'] > 0 and used['grad'] == 0) if fused else \
        (used['grad'] > 0 and used['fused'] == 0)
    (l64, p64, d64), (l128, p128, d128) = out['complex64'], out['complex128']
    assert abs(l64 - l128) <= 1e-5 * b
    assert (p64 - p128).abs().max().item() <= 1e-4
    assert (d64 - d128).abs().max().item() <= 1e-4


# ------------------------------------------------------------------ photonic
# K7-K9 compute in float64 against float64 twins: 1e-10 on the permanent at
# these sizes, 1e-9 on per-subset determinants and quadratic forms.
@pytest.fixture()
def card128(card):
    dqt.set_dtype('complex128')
    yield card


def _tor_inputs(m, rng, device, dtype=torch.complex128):
    mm = rng.standard_normal((2 * m, 2 * m)) * 0.1
    o = np.eye(2 * m) - np.linalg.inv(np.eye(2 * m) + mm @ mm.T) \
        + 0.01 * (rng.standard_normal((2 * m, 2 * m)) + 1j * rng.standard_normal((2 * m, 2 * m)))
    g = rng.standard_normal(2 * m) * 0.1 + 0.05j * rng.standard_normal(2 * m)
    return (torch.as_tensor(o, device=device).to(dtype),
            torch.as_tensor(g, device=device).to(dtype))


@pytest.mark.parametrize('b,n,dtype', [(3, 4, torch.complex128), (2, 5, torch.complex64),
                                       (500, 6, torch.complex128), (7, 9, torch.complex64),
                                       (1, 13, torch.complex128), (2, 17, torch.complex128)])
def test_permanent_kernel_matches_twin(card128, b, n, dtype):
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    rng = np.random.default_rng(b * 31 + n)
    mats = torch.as_tensor(np.stack([_haar(n, rng) for _ in range(b)]), device=card128).to(dtype)
    before = pk.permanent_cuda_batch.launches
    got = pk.permanent_cuda_batch(mats)
    torch.cuda.synchronize()
    assert pk.permanent_cuda_batch.launches == before + 1
    assert got.dtype == torch.complex128 and got.shape == (b,)
    ref = pk.permanent_plain_batch(mats)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-10
    # run to run the same bits: no float atomics
    assert torch.equal(got, pk.permanent_cuda_batch(mats))


@pytest.mark.parametrize('m', [3, 5, 9])
@pytest.mark.parametrize('dtype', [torch.complex128, torch.complex64])
def test_tor_kernels_match_twins(card, m, dtype):
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    from deepquantum_tpu_torch.photonic import torontonian_ as tt
    o, g = _tor_inputs(m, np.random.default_rng(m), card, dtype)
    idx, valid, sign = tt._padded_tor_indices(m, card)
    c8, c9 = tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches
    det, s8 = tk.tor_dets_cuda(o, idx, valid, sign)
    det9, quad, _ = tk.tor_dets_quads_cuda(o, g, idx, valid, sign)
    torch.cuda.synchronize()
    assert (tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches) == (c8 + 1, c9 + 1)
    assert s8 is sign and det.dtype == torch.complex128 and det.shape == ((1 << m) - 1,)
    ref, _ = tk.tor_dets_plain(o, idx, valid, sign)
    ref9, refq, _ = tk.tor_dets_quads_plain(o, g, idx, valid, sign)
    for a, b in ((det, ref), (det9, ref9), (quad, refq)):
        assert ((a - b).abs() / b.abs()).max().item() <= 1e-9
    assert torch.equal(det, det9)


def test_torontonian_routes_on_the_card(card128):
    """Size >= 6 launches K8 (no gamma) or K9; below, the plain formula."""
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    o, g = _tor_inputs(4, np.random.default_rng(1), card128)
    c8, c9 = tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches
    t0, t1 = dqt.torontonian(o), dqt.torontonian(o, g)
    assert (tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches) == (c8 + 1, c9 + 1)
    r0, r1 = dqt.torontonian(o.cpu()), dqt.torontonian(o.cpu(), g.cpu())
    assert abs(complex(t0) - complex(r0)) <= 1e-9 * abs(complex(r0))
    assert abs(complex(t1) - complex(r1)) <= 1e-9 * abs(complex(r1))
    dqt.torontonian(o[:4, :4])
    assert tk.tor_dets_cuda.launches == c8 + 1


def test_photonic_wrappers_refuse_wrong_inputs(card128):
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    from deepquantum_tpu_torch.photonic import torontonian_ as tt
    with pytest.raises(ValueError, match='n <= 26|4 <= n'):
        pk.permanent_cuda_batch(torch.zeros((1, 27, 27), dtype=torch.complex128, device=card128))
    with pytest.raises(ValueError, match=r'\(B, n, n\)'):
        pk.permanent_cuda_batch(torch.zeros((4, 5), dtype=torch.complex128, device=card128))
    with pytest.raises(TypeError, match='complex'):
        pk.permanent_cuda_batch(torch.zeros((1, 4, 4), dtype=torch.float64, device=card128))
    o, g = _tor_inputs(3, np.random.default_rng(2), card128)
    idx, valid, sign = tt._padded_tor_indices(3, card128)
    cpu_scaffold = tt._padded_tor_indices(3, torch.device('cpu'))
    with pytest.raises(ValueError, match='scaffold on cpu'):
        tk.tor_dets_cuda(o, *cpu_scaffold)
    with pytest.raises(ValueError, match='gamma'):
        tk.tor_dets_quads_cuda(o, g[:4], idx, valid, sign)
    with pytest.raises(TypeError, match='int64'):
        tk.tor_dets_cuda(o, idx.int(), valid, sign)


def test_photonic_wrappers_refuse_gradients(card128):
    """The raw launches refuse a tensor that requires grad; the wrappers
    are Functions whose backward is the twin's derivative, recomputed on
    the saved inputs (the forward values stay the kernel's)."""
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    from deepquantum_tpu_torch.photonic import torontonian_ as tt
    rng = np.random.default_rng(3)
    mats = torch.as_tensor(np.stack([_haar(5, rng) for _ in range(3)]), device=card128)
    mats.requires_grad_()
    with pytest.raises(NotImplementedError, match='twin'):
        pk._launch(mats)
    got = pk.permanent_cuda_batch(mats)
    assert got.requires_grad and torch.equal(got.detach(), pk.permanent_cuda_batch(mats.detach()))
    w = torch.as_tensor(rng.standard_normal(3) + 1j * rng.standard_normal(3), device=card128)
    d_got, = torch.autograd.grad((got * w).sum().real, mats)
    d_want, = torch.autograd.grad((pk.permanent_plain_batch(mats) * w).sum().real, mats)
    torch.testing.assert_close(d_got, d_want, atol=1e-12, rtol=0)

    o, g = _tor_inputs(4, np.random.default_rng(4), card128)
    o.requires_grad_()
    g.requires_grad_()
    scaffold = tt._padded_tor_indices(4, card128)
    with pytest.raises(NotImplementedError, match='twin'):
        tk._launch('tor_dets_cuda', o, None, *scaffold)
    for route, plain in ((lambda: tk.tor_dets_cuda(o, *scaffold)[:1],
                          lambda: tk.tor_dets_plain(o, *scaffold)[:1]),
                         (lambda: tk.tor_dets_quads_cuda(o, g, *scaffold)[:2],
                          lambda: tk.tor_dets_quads_plain(o, g, *scaffold)[:2])):
        outs, refs = route(), plain()
        loss = sum((t * (1 + 0.5j)).sum().real for t in outs)
        ref = sum((t * (1 + 0.5j)).sum().real for t in refs)
        for a, c in zip(torch.autograd.grad(loss, (o, g), allow_unused=True),
                        torch.autograd.grad(ref, (o, g), allow_unused=True)):
            assert (a is None) == (c is None)
            if a is not None:
                torch.testing.assert_close(a, c, atol=1e-10 * c.abs().max().item(), rtol=0)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(tk.tor_dets_cuda(o, *scaffold)[0].sum().real, o, create_graph=True)


def test_photonic_paths_on_the_card(card128):
    """Both user calls land on the card by default and agree with the CPU."""
    rng = np.random.default_rng(5)
    cir = dqt.photonic.Clements(6, init_state=[1, 1, 1, 1, 0, 0], cutoff=5)
    assert cir.device.type == 'cuda'
    data = rng.uniform(0, 2 * np.pi, cir.ndata)
    probs = cir(data=data, is_prob=True)
    ref = dqt.photonic.Clements(6, init_state=[1, 1, 1, 1, 0, 0], cutoff=5, device='cpu')(
        data=data, is_prob=True)
    got = {tuple(k.state.tolist()): v.item() for k, v in probs.items()}
    for k, v in ref.items():
        assert abs(got[tuple(k.state.tolist())] - v.item()) <= 1e-10
    sq, u = rng.uniform(0.2, 0.6, 5), _haar(5, rng)
    gbs = dqt.photonic.GaussianBosonSampling(5, sq, u, detector='threshold')
    gbs.d(1, 0.3, 0.2)
    out = gbs(is_prob=True)
    ref = dqt.photonic.GaussianBosonSampling(5, sq, u, detector='threshold', device='cpu')
    ref.d(1, 0.3, 0.2)
    want = {tuple(k.state.tolist()): v.item() for k, v in ref(is_prob=True).items()}
    assert next(iter(out.values())).device.type == 'cuda'
    for k, v in out.items():
        assert abs(v.item() - want[tuple(k.state.tolist())]) <= 1e-10
    assert abs(sum(v.item() for v in out.values()) - 1) <= 1e-10
