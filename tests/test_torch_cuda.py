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


# the wire sets of chip_smoke.py's n=22 rows (K1 and K5 walk them on the
# float4 plan): amplitude bits 0, 1, 0-1, the top bits and between, k = 1-3
GATE_WIRE_SETS_22 = [(22, w) for w in [(0,), (21,), (10,), (0, 1), (3, 17), (20, 21),
                                       (0, 10, 21), (5, 6, 7)]]


@pytest.mark.parametrize('n,wires', [(16, (0,)), (16, (15,)), (16, (3, 9)), (16, (0, 8, 15)),
                                     (12, (4, 5, 6)), (10, (0, 1, 2)), (10, (7, 8, 9)),
                                     (10, (1, 8))] + GATE_WIRE_SETS_22)
def test_planar_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + sum(wires))
    mre, mim = _planes(_haar(1 << len(wires), rng), card)
    x = _state(n, rng, card)
    want = tpg.planar_evolve_xla(x, mre, mim, n, wires)
    before = tpg.planar_apply.launches
    got = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    assert tpg.planar_apply.launches == before + 1
    # n=22: chip_smoke.py's bar, 1e-6 of max|ref| (2^21 groups reach further
    # into the tails of the rounding than the smaller states)
    atol = 1e-6 * want.abs().max().item() if n == 22 else 2e-6
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


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
    # the bar of chip_smoke.py at n=24: the FP64 tensor cores against float32 matmuls
    err = (x - want).abs().max().item() / want.abs().max().item()
    assert err <= 1e-6, err


def _chain_seq(cir):
    """The circuit's window sequence, its windows and relabels only (the
    bench plan at n=14 also has per-gate steps)."""
    mres, mims, wseq = cir._planar_seq(cir._full_params())
    keep = [i for i, s in enumerate(wseq) if s[0] in ('win', 'rot')]
    return [mres[i] for i in keep], [mims[i] for i in keep], tuple(wseq[i] for i in keep)


@pytest.mark.parametrize('n', [16, 19, 14, 18])
def test_chain_kernel_matches_twin(n, card):
    cir = _bench(n, 2, card)
    with torch.inference_mode():
        mres, mims, wseq = _chain_seq(cir)
        assert tck.chain_fused_ok(wseq, n, mres)
        x = _state(n, np.random.default_rng(n), card)
        x0 = x.clone()
        want = tck.window_chain_plain(x, mres, mims, n, wseq)
        before = tck.window_chain_fwd.launches
        got = tck.window_chain_fwd(x, mres, mims, n, wseq)
        assert tck.window_chain_fwd.launches == before + 1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(x, x0)   # the caller's state is not written


@pytest.mark.parametrize('n,sms', [(19, 114), (18, 16)])
def test_chain_kernel_on_fewer_sms(n, sms, card):
    """K3 on a grid capped below the column tiles: a block walks several
    tiles and keeps each window for all of them."""
    cir = _bench(n, 2, card)
    with torch.no_grad():
        mres, mims, wseq = _chain_seq(cir)
        assert tck._bwd_slots(n, sms) > sms          # more tiles than blocks
        x = _state(n, np.random.default_rng(n + 5), card)
        want = tck.window_chain_plain(x, mres, mims, n, wseq)
        before = tck.window_chain_fwd.launches
        got = tck._window_chain_fwd_cuda(x, mres, mims, n, wseq, sms=sms)
        assert tck.window_chain_fwd.launches == before + 1
        too_many = torch.cuda.get_device_properties(card).multi_processor_count + 1
        with pytest.raises(RuntimeError):
            tck._window_chain_fwd_cuda(x, mres, mims, n, wseq, sms=too_many)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope='module')
def depth_walks():
    """The bench sequence at n=18 with 10 and 20 layers, a seeded state and
    cotangent, and the twin's walks in float32 and in float64:
    {layers: (sequence, x, y, g, y64, bwd32, bwd64)}."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    n, out = 18, {}
    dqt.set_dtype('complex64')
    with torch.no_grad():
        for layers in (10, 20):
            mres, mims, wseq = _chain_seq(_bench(n, layers, torch.device('cuda')))
            d64 = [[None if m is None else m.double() for m in ms] for ms in (mres, mims)]
            rng = np.random.default_rng(40 + layers)
            x = _state(n, rng, 'cuda')
            g = _state(n, rng, 'cuda')
            y = tck.window_chain_plain(x, mres, mims, n, wseq)
            out[layers] = ((mres, mims, wseq), x, y, g,
                           tck.window_chain_plain(x.double(), *d64, n, wseq),
                           tck.window_chain_bwd_plain(y, g, mres, mims, n, wseq),
                           tck.window_chain_bwd_plain(y.double(), g.double(), *d64, n, wseq))
    return out


def _rel_max(got, want):
    return max((a.double() - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(got, want) if b is not None)


@pytest.mark.parametrize('kernel', ['window_apply', 'window_chain_fwd', 'window_chain_bwd'])
def test_window_kernels_under_depth(kernel, depth_walks, card):
    """K2 (window by window, the twin's relabels between), K3 and K4 over the
    bench sequence at n=18 with 10 and 20 layers (65 and 130 windows):
    within 1e-5 of the float32 twin (dW too), and against the twin run in
    float64 within 5e-6 at 20 layers, grown by at most 1.6 from 10 layers
    (a bias that grows linearly gives 2.0, rounding to nearest about 1.4)."""
    n, errs = 18, {}
    with torch.no_grad():
        for layers, ((mres, mims, wseq), x, y, g, y64, bwd, bwd64) in depth_walks.items():
            if kernel == 'window_chain_bwd':
                got = tck.window_chain_bwd(y, g, mres, mims, n, wseq)
                got = list(got[:2]) + got[2] + got[3]
                want = list(bwd[:2]) + bwd[2] + bwd[3]
                exact = list(bwd64[:2]) + bwd64[2] + bwd64[3]
            else:
                if kernel == 'window_chain_fwd':
                    st = tck.window_chain_fwd(x, mres, mims, n, wseq)
                else:
                    st = x.clone()
                    for mre, mim, step in zip(mres, mims, wseq):
                        if step[0] == 'win':
                            twg.window_apply(st, mre, mim, n, 7)
                        else:
                            st = tpg._rotate_planar(st, step[1], n)
                got, want, exact = [st], [y], [y64]
            assert _rel_max(got, want) <= 1e-5
            errs[layers] = _rel_max(got, exact)
    assert errs[20] <= 5e-6, errs
    assert errs[20] / errs[10] <= 1.6, errs


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


@pytest.mark.parametrize('n,wires', GATE_CASES + [(10, (0, 1, 2)), (10, (7, 8, 9)),
                                                  (10, (1, 8))] + GATE_WIRE_SETS_22)
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


# K6 on the float4 plan: every (k, low) variant, down to n = 2 (the per-thread
# kernel it replaces took n - k >= 8 only), and the n=22 wire sets
@pytest.mark.parametrize('n,wires', GATE_CASES + [(10, (0, 1, 2)), (10, (7, 8, 9)), (10, (1, 8)),
                                                  (10, (0, 7, 8)), (9, (4, 7, 8)), (2, (0,)),
                                                  (2, (0, 1)), (3, (0, 1, 2)), (5, (1,)),
                                                  (6, (0, 3, 5))] + GATE_WIRE_SETS_22)
def test_planar_bwd_fused_kernel_matches_twin(n, wires, card):
    rng = np.random.default_rng(n + 3 * sum(wires))
    u = _haar(1 << len(wires), rng)
    mre_t, mim_t = _planes(u.conj().T, card)
    y, g = _state(n, rng, card), _state(n, rng, card)
    y0, g0 = y.clone(), g.clone()
    want = tpg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
    before = tpg.planar_bwd_fused.launches
    got = tpg.planar_bwd_fused(y, g, mre_t, mim_t, n, wires)
    assert tpg.planar_bwd_fused.launches == before + 1
    assert got[0] is y and got[1] is g          # in place on both
    torch.testing.assert_close(y, want[0], atol=2e-6, rtol=0)
    torch.testing.assert_close(g, want[1], atol=2e-6, rtol=0)
    _plane_close(got[2], want[2])
    _plane_close(got[3], want[3])
    # the sum over blocks ends in the launch in a fixed order
    again = tpg.planar_bwd_fused(y0, g0, mre_t, mim_t, n, wires)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
    """create_graph=True through the planar Functions differentiates again
    on the card: a Hessian row at n=16 (the one-launch chain forward, the
    recorded walk on K2 / K1 / K5 backward) equals the complex128 route's;
    the photonic kernel Functions (here K7) still raise."""
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    rows = []
    for dtype in ('complex64', 'complex128'):
        dqt.set_dtype(dtype)
        cir = _bench(16, 1)
        assert cir._planar_ok() == (dtype == 'complex64')
        p = cir.params.requires_grad_()
        g, = torch.autograd.grad(cir.expectation(params=p)[0], p, create_graph=True)
        rows.append(torch.autograd.grad(g[5], p)[0].double())
    assert (rows[0] - rows[1]).abs().max().item() <= 1e-4
    mats = torch.randn(2, 5, 5, dtype=torch.complex128, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match='first order only'):
        torch.autograd.grad(pk.permanent_cuda_batch(mats).sum().real, mats, create_graph=True)


@pytest.mark.parametrize('batch', [None, 8])
def test_planar_superop_matches_twin(batch, card):
    """planar_superop on a non-unitary map: forward K1 (K1b), backward K1
    with M^H for the state and K5 (K5b) for the planes, against the same on
    CPU copies (the twins)."""
    n, wires = 12, (2, 8)
    rng = np.random.default_rng(31)
    shape = (2, 1 << n) if batch is None else (batch, 2, 1 << n)
    pshape = (4, 4) if batch is None else (batch, 4, 4)
    host = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
            for s in (shape, pshape, pshape, shape)]
    outs = []
    for device in (card, torch.device('cpu')):
        x, mre, mim, c = [t.to(device).requires_grad_(i < 3) for i, t in enumerate(host)]
        counts = (tpg.planar_apply.launches + tpg.planar_apply.batched_launches,
                  tpg.planar_grad.launches + tpg.planar_grad.batched_launches)
        y = tpg.planar_superop(x, mre, mim, n, wires)
        grads = torch.autograd.grad((y * c).sum(), (x, mre, mim))
        if device.type == 'cuda':
            assert (tpg.planar_apply.launches + tpg.planar_apply.batched_launches,
                    tpg.planar_grad.launches + tpg.planar_grad.batched_launches) == \
                (counts[0] + 2, counts[1] + 1)
        outs.append([t.detach().cpu() for t in (y, *grads)])
    for i, (got, want) in enumerate(zip(*outs)):
        bar = (2e-6 if i < 2 else 1e-5) * want.abs().max().item()
        torch.testing.assert_close(got, want, atol=bar, rtol=0)


def test_second_order_walk_matches_twin(card, twin_route):
    """The recorded walk (_ApplyD on K1, _GradD on K5, _WinApplyD on K2) at
    n=12: a Hessian-vector product of a chain of a window, gates and
    relabels, in the state and every plane, against the same on the twins
    on the card."""
    n = 12
    rng = np.random.default_rng(41)
    wseq = (('win', 7), (2,), ('rot', 5), (0, 9), (4, 5, 11), ('rot', 7), (1, 6))
    host = [_planes(_haar(1 << (7 if ws[0] == 'win' else len(ws)), rng), 'cpu')
            for ws in wseq if ws[0] != 'rot']
    x0 = torch.as_tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float32)
    c0 = torch.as_tensor(rng.standard_normal((2, 1 << n)), dtype=torch.float32)
    vs = [torch.as_tensor(rng.standard_normal(m.shape), dtype=torch.float32)
          for pair in host for m in pair]

    def hvp():
        planes = [m.to(card).requires_grad_() for pair in host for m in pair]
        x = x0.to(card).requires_grad_()
        it = iter(planes)
        mres, mims = [], []
        for ws in wseq:
            pair = (None, None) if ws[0] == 'rot' else (next(it), next(it))
            mres.append(pair[0])
            mims.append(pair[1])
        y = tpg.planar_chain(x, mres, mims, n, wseq)
        g = torch.autograd.grad((y * c0.to(card)).sum(), planes, create_graph=True)
        dot = sum((a * v.to(card)).sum() for a, v in zip(g, vs))
        return [t.cpu() for t in torch.autograd.grad(dot, [x] + planes)]

    before = (tpg.planar_apply.launches, tpg.planar_grad.launches, twg.window_apply.launches)
    got = hvp()
    after = (tpg.planar_apply.launches, tpg.planar_grad.launches, twg.window_apply.launches)
    assert all(a > b for a, b in zip(after, before))
    twin_route()
    want = hvp()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(), rtol=0)


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


# K1b / K5b on odd batches, at n = 10 with k = 3 (2^7 groups a sample), and at
# the wide QML path's (18, 8) on amplitude bit 0, bits 0-1 and the top bit
PLAN_CASES = [(10, 3, (0, 1, 2)), (10, 7, (7, 8, 9)), (12, 3, (10, 11)), (12, 7, (10,)),
              (13, 7, (1, 6, 11)), (18, 8, (17,)), (18, 8, (16, 17)), (18, 8, (0, 8, 16)),
              (18, 8, (0,))]


@pytest.mark.parametrize('n,b,wires', PLAN_CASES)
def test_batched_gate_kernels_on_the_quad_plan(n, b, wires, card):
    """One launch each, against the twins; K5b's planes bitwise equal over
    two launches (its last block sums the partials in a fixed order). K5b
    is held to the twin run in float64: at (18, 8) on bit 0 the float32
    twin's batched matmul sums 2^17 products in an order that leaves it
    ~1e-5 from the exact planes itself."""
    rng = np.random.default_rng(n * b + len(wires))
    x, mre, mim = _batch(n, b, len(wires), rng, card, False)
    g = torch.randn_like(x)
    counts = (tpg.planar_apply.batched_launches, tpg.planar_grad.batched_launches)
    y = tpg.planar_apply(x.clone(), mre, mim, n, wires)
    torch.testing.assert_close(y, tpg.planar_evolve_xla(x, mre, mim, n, wires), atol=2e-6, rtol=0)
    got = tpg.planar_grad(g, x, n, wires)
    for a, w in zip(got, tpg.planar_grad_xla(g.double(), x.double(), n, wires)):
        assert a.shape == (b, 1 << len(wires), 1 << len(wires))
        _plane_close(a.double(), w)
    assert all(torch.equal(a, c) for a, c in zip(got, tpg.planar_grad(g, x, n, wires)))
    assert (tpg.planar_apply.batched_launches, tpg.planar_grad.batched_launches) == (
        counts[0] + 1, counts[1] + 2)


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
    """The data-encoded step on the default device: at n=14 the gate chain
    is one planar_chain_batched launch and its backward one
    planar_chain_batched_bwd launch (the observable's chain one more
    forward launch), with no per-step batched K1 / K5 / K6, window or chain
    kernel, fused_bwd or not; loss and the gradients in the parameters and
    the data against the complex128 einsum route."""
    from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
    n, b = 14, 12
    feats = np.random.default_rng(3).uniform(0, np.pi, (b, n))
    names = {'apply': tpg.planar_apply, 'grad': tpg.planar_grad, 'fused': tpg.planar_bwd_fused}
    chains = (pcb.planar_chain_batched, pcb.planar_chain_batched_bwd)
    windows = (twg.window_apply, tck.window_chain_fwd, tck.window_chain_bwd)
    before = {k: fn.batched_launches for k, fn in names.items()}
    before_win = [fn.launches for fn in windows]
    before_chain = [fn.launches for fn in chains]
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
            used_chain = [fn.launches - c for fn, c in zip(chains, before_chain)]
    assert used == {'apply': 0, 'grad': 0, 'fused': 0} and used_chain == [2, 1]
    assert [fn.launches for fn in windows] == before_win
    (l64, p64, d64), (l128, p128, d128) = out['complex64'], out['complex128']
    assert abs(l64 - l128) <= 1e-5 * b
    assert (p64 - p128).abs().max().item() <= 1e-4
    assert (d64 - d128).abs().max().item() <= 1e-4


@pytest.mark.parametrize('fused', [False, True])
def test_batched_qml_step_outside_the_chain_range(fused, card):
    """At n=18, past the batched chain's range, the step walks the gates
    with the per-step batched kernels (K1 and K5, K6 with fused_bwd) and
    launches no chain kernel; gradients against complex128."""
    from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
    n, b = 18, 3
    feats = np.random.default_rng(4).uniform(0, np.pi, (b, n))
    names = {'apply': tpg.planar_apply, 'grad': tpg.planar_grad, 'fused': tpg.planar_bwd_fused}
    chains = (pcb.planar_chain_batched, pcb.planar_chain_batched_bwd)
    before = {k: fn.batched_launches for k, fn in names.items()}
    before_chain = [fn.launches for fn in chains]
    grads = {}
    for dtype in ('complex64', 'complex128'):
        dqt.set_dtype(dtype)
        cir = _qml(n, 1)
        cir.fused_bwd = fused
        p = cir.params.requires_grad_()
        cir.expectation(data=torch.tensor(feats, device=card), params=p).sum().backward()
        grads[dtype] = p.grad.double()
        if dtype == 'complex64':
            used = {k: fn.batched_launches - before[k] for k, fn in names.items()}
    assert [fn.launches for fn in chains] == before_chain
    assert used['apply'] > 0
    assert (used['fused'] > 0 and used['grad'] == 0) if fused else \
        (used['grad'] > 0 and used['fused'] == 0)
    assert (grads['complex64'] - grads['complex128']).abs().max().item() <= 1e-4


# The batched gate chain (csrc/planar_chain_batched.cu): the QML ansatz's
# scheduled sequence at n with Haar planes, per sample where the ansatz's
# planes are per sample (the encoders), one set elsewhere; relabels from
# n=16 on, folded into the table. Bars as for the chain kernels: 1e-5 of
# max|ref| over a few dozen steps, planes as _plane_close.
CHAIN_CASES = [(12, 5), (14, 3), (16, 2), (17, 2)]


def _chain_inputs(n, b, rng, device):
    cir = _qml(n, 2, device)
    data = torch.as_tensor(rng.uniform(0, np.pi, (b, n)), dtype=torch.float32, device=device)
    mres, mims, wseq = cir._planar_seq_batched(cir._full_params(None, data, cir._data_indices(n)))
    out_r, out_i = [], []
    for m, ws in zip(mres, wseq):
        if ws[0] == 'rot':
            out_r.append(None)
            out_i.append(None)
            continue
        k = 1 << len(ws)
        us = np.stack([_haar(k, rng) for _ in range(1 if m.stride(0) == 0 else b)])
        out_r.append(torch.as_tensor(us.real, dtype=torch.float32, device=device).expand(b, k, k))
        out_i.append(torch.as_tensor(us.imag, dtype=torch.float32, device=device).expand(b, k, k))
    x = torch.as_tensor(rng.standard_normal((b, 2, 1 << n)), dtype=torch.float32, device=device)
    g = torch.as_tensor(rng.standard_normal((b, 2, 1 << n)), dtype=torch.float32, device=device)
    return out_r, out_i, wseq, x, g


def _rel_close(got, want, bar=1e-5):
    torch.testing.assert_close(got, want, atol=bar * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize('n,b', CHAIN_CASES)
def test_batched_chain_matches_twin_and_steps(n, b, card):
    """Both entries against the twin and against the per-step kernels (K1b
    forward; K1b + K5b + K1b and K6b backward, n <= 16), one launch each,
    the inputs unwritten."""
    from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
    rng = np.random.default_rng(n * 7 + b)
    mres, mims, wseq, x, g = _chain_inputs(n, b, rng, card)
    assert (any(ws[0] == 'rot' for ws in wseq)) == (n >= 16)
    chain = pcb.pack_chain(x, mres, mims, n, wseq)
    x0, g0 = x.clone(), g.clone()
    before = (pcb.planar_chain_batched.launches, pcb.planar_chain_batched_bwd.launches)
    y = pcb.planar_chain_batched(x, chain)
    torch.cuda.synchronize()
    _rel_close(y, pcb.planar_chain_batched_plain(x, chain))
    _rel_close(y, tpg._steps_forward(x, mres, mims, n, wseq))
    assert pcb.planar_chain_batched.launches == before[0] + 1
    if not pcb.batched_chain_ok(wseq, n, mres, backward=True):
        assert n == 17
        with pytest.raises(ValueError, match='past the kernel range'):
            pcb.planar_chain_batched_bwd(y, g, chain)
        return
    got = pcb.planar_chain_batched_bwd(y, g, chain)
    torch.cuda.synchronize()
    assert pcb.planar_chain_batched_bwd.launches == before[1] + 1
    assert torch.equal(x, x0) and torch.equal(g, g0)
    want = pcb.planar_chain_batched_plain(y, chain, g)
    _rel_close(got[0], want[0])
    _rel_close(got[0], x)
    _rel_close(got[1], want[1])
    gates = [i for i, ws in enumerate(wseq) if ws[0] != 'rot']
    for j in (2, 3):
        for i in gates:
            _plane_close(got[j][i], want[j][i])
    for fused in (False, True):
        _, g_in, dres, dims = tpg._steps_backward(y, g, mres, mims, n, wseq, fused)
        _rel_close(got[1], g_in)
        for i in gates:
            _plane_close(got[2][i], dres[i])
            _plane_close(got[3][i], dims[i])


def test_batched_chain_dw_is_bitwise_reproducible(card):
    from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
    n, b = 14, 100
    mres, mims, wseq, x, g = _chain_inputs(n, b, np.random.default_rng(14), card)
    chain = pcb.pack_chain(x, mres, mims, n, wseq)
    first, again = (pcb.planar_chain_batched_bwd(x, g, chain) for _ in range(2))
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert all(torch.equal(a, c) for j in (2, 3) for a, c in zip(first[j], again[j])
               if a is not None)


@pytest.mark.parametrize('n', [13, 14, 16])
def test_batched_chain_cluster_sizes_agree(n, card):
    """A larger cluster than the rule's (a block holds a smaller share of
    the sample): the forward gives the same bits (each group's arithmetic
    is the same wherever it runs), the backward the same within the bars."""
    from deepquantum_tpu_torch.ops import planar_chain_batched as pcb
    mres, mims, wseq, x, g = _chain_inputs(n, 3, np.random.default_rng(n), card)
    chain = pcb.pack_chain(x, mres, mims, n, wseq)
    cf, cb = 1 << pcb.cluster_bits(n), 1 << pcb.cluster_bits(n, True)
    assert torch.equal(pcb._planar_chain_batched_cuda(x, chain, cluster=cf),
                       pcb._planar_chain_batched_cuda(x, chain, cluster=2 * cf))
    got = pcb._planar_chain_batched_bwd_cuda(x, g, chain, cluster=cb)
    if 2 * cb <= 8:
        other = pcb._planar_chain_batched_bwd_cuda(x, g, chain, cluster=2 * cb)
        _rel_close(other[1], got[1])
        for j in (2, 3):
            for a, c in zip(other[j], got[j]):
                if a is not None:
                    _plane_close(a, c)
    with pytest.raises(ValueError, match='cluster'):
        pcb._planar_chain_batched_cuda(x, chain, cluster=3)
    assert pcb.max_active_clusters(n, False) > 0 and pcb.max_active_clusters(n, True) > 0


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


@pytest.mark.parametrize('b,n', [(300, 6), (5, 13), (1, 16), (3, 11)])
def test_permanent_kernel_writes_complex64(card, b, n):
    """At the complex64 policy the launch writes complex64 itself: a whole
    matrix a thread, a few lanes, a block and several blocks a matrix."""
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    rng = np.random.default_rng(b + n)
    mats = torch.as_tensor(np.stack([_haar(n, rng) for _ in range(b)]), device=card).to(
        torch.complex64)
    got = pk.permanent_cuda_batch(mats)
    assert got.dtype == torch.complex64 and got.shape == (b,)
    ref = pk.permanent_plain_batch(mats.to(torch.complex128)).to(torch.complex128)
    assert ((got.to(torch.complex128) - ref).abs().max() / ref.abs().max()).item() <= 1e-6
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


@pytest.mark.parametrize('b,m', [(45, 8), (7, 14)])
@pytest.mark.parametrize('dtype', [torch.complex128, torch.complex64])
def test_batched_tor_kernels_match_batched_twins(card, b, m, dtype):
    """A (B, 2m, 2m) stack in one wrapper call (batched_launches), per
    subset <= 1e-9 of the batched twin; two launches give the same bits."""
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    from deepquantum_tpu_torch.photonic import torontonian_ as tt
    rng = np.random.default_rng(b + m)
    pairs = [_tor_inputs(m, rng, card, dtype) for _ in range(b)]
    o, g = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    idx, valid, sign = tt._padded_tor_indices(m, card)
    single = (tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches)
    c8, c9 = tk.tor_dets_cuda.batched_launches, tk.tor_dets_quads_cuda.batched_launches
    det, s8 = tk.tor_dets_cuda(o, idx, valid, sign)
    det9, quad, _ = tk.tor_dets_quads_cuda(o, g, idx, valid, sign)
    torch.cuda.synchronize()
    assert (tk.tor_dets_cuda.batched_launches, tk.tor_dets_quads_cuda.batched_launches) == \
        (c8 + 1, c9 + 1)
    assert (tk.tor_dets_cuda.launches, tk.tor_dets_quads_cuda.launches) == single
    assert s8 is sign and det.dtype == torch.complex128 and det.shape == (b, (1 << m) - 1)
    ref, _ = tk.tor_dets_plain(o, idx, valid, sign)
    ref9, refq, _ = tk.tor_dets_quads_plain(o, g, idx, valid, sign)
    for a, c in ((det, ref), (det9, ref9), (quad, refq)):
        assert ((a - c).abs() / c.abs()).max().item() <= 1e-9
    assert torch.equal(det, det9)
    again, _ = tk.tor_dets_cuda(o, idx, valid, sign)
    again9, againq, _ = tk.tor_dets_quads_cuda(o, g, idx, valid, sign)
    assert torch.equal(det, again) and torch.equal(det9, again9) and torch.equal(quad, againq)


def test_torontonian_batch_is_one_call_on_the_card(card128):
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    rng = np.random.default_rng(6)
    pairs = [_tor_inputs(5, rng, card128) for _ in range(6)]
    o, g = torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])
    c8, c9 = tk.tor_dets_cuda.batched_launches, tk.tor_dets_quads_cuda.batched_launches
    t0, t1 = dqt.photonic.torontonian_batch(o), dqt.photonic.torontonian_batch(o, g)
    assert (tk.tor_dets_cuda.batched_launches, tk.tor_dets_quads_cuda.batched_launches) == \
        (c8 + 1, c9 + 1)
    for i in range(6):
        r0, r1 = dqt.torontonian(o[i].cpu()), dqt.torontonian(o[i].cpu(), g[i].cpu())
        assert abs(complex(t0[i]) - complex(r0)) <= 1e-9 * abs(complex(r0))
        assert abs(complex(t1[i]) - complex(r1)) <= 1e-9 * abs(complex(r1))


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


# ------------------------------------------------ the rest of the qubit engine
def _engine_circuit(n, device):
    cir = dqt.QubitCircuit(n, device=device)
    for w in range(n):
        cir.ry(w, inputs=0.3 + 0.1 * w)
    cir.cu(0, n - 1, inputs=[0.3, 0.5, 0.7])
    cir.crxx(4, 1, 8, inputs=0.3)
    cir.ccx(2, 5, 7)
    cir.latent(wires=[2, 6, 7], inputs=np.random.default_rng(0).normal(size=(8, 8)))
    cir.hamiltonian(np.diag([1.0, -1.0, 0.5, 0.2]), t=0.6, wires=[3, 5])
    cir.any(_haar(4, np.random.default_rng(1)), wires=[1, 9], controls=0)
    cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    return cir


def test_controlled_sugar_planar_on_the_card(card):
    """Controlled, latent, Hamiltonian and fixed gates on <= 3 wires stay on
    the kernel route at n=12: against the CPU's complex128 route, 1e-5."""
    cir = _engine_circuit(12, None)
    assert cir.device.type == 'cuda' and cir._planar_ok()
    got = cir.forward().reshape(-1).cpu()
    dqt.set_dtype('complex128')
    want = _engine_circuit(12, 'cpu').forward().reshape(-1)
    assert (got.to(torch.complex128) - want).abs().max().item() <= 1e-5


def test_qft_and_inverse_on_the_card(card):
    from deepquantum_tpu_torch.models import QuantumFourierTransform
    n, x = 16, 12345
    qft = QuantumFourierTransform(n)
    ket = torch.zeros(1 << n, dtype=torch.complex64, device=card)
    ket[x] = 1
    twg.window_apply.launches = 0
    out = qft.forward(state=ket).reshape(-1)
    assert twg.window_apply.launches > 0
    j = np.arange(1 << n)
    want = np.exp(2j * np.pi * ((j * x) % (1 << n)) / (1 << n)) / np.sqrt(1 << n)
    assert np.abs(out.cpu().numpy() - want).max() <= 1e-5
    back = qft.inverse().forward(state=out).reshape(-1)
    assert (back - ket).abs().max().item() <= 1e-5


def test_conditional_defer_measure_on_the_card(card):
    cir = dqt.QubitCircuit(6)
    for w in range(3):
        cir.h(w)
        cir.x(w + 3, controls=w, condition=True)
    cir.ry(4, inputs=0.4)
    cir.forward()
    gen = torch.Generator(device='cuda').manual_seed(7)
    state, bits, prob = cir.defer_measure(with_prob=True, generator=gen)
    assert state.device.type == 'cuda' and state.shape == (8, 1)
    assert abs(torch.linalg.vector_norm(state).item() - 1) <= 1e-6
    assert abs(prob - cir.get_prob(bits, wires=[0, 1, 2]).item()) <= 1e-6
    assert torch.equal(cir.post_select(bits), state)


def test_mps_on_the_card(card):
    """A truncated MPS (n=10, chi=4) on the card: value and gradient against
    the same MPS on the CPU, 1e-5 / 1e-4."""
    def run(device):
        cir = dqt.QubitCircuit(10, device=device, mps=True, chi=4)
        for _ in range(2):
            for w in range(10):
                cir.rx(w)
                cir.rz(w)
            for w in range(9):
                cir.cnot(w, w + 1)
        cir.observable(0)
        cir.init_para(3)
        p = cir.params.requires_grad_()
        e = cir.expectation(params=p)[0]
        e.backward()
        return e.item(), p.grad.cpu()

    e, g = run(None)
    e_cpu, g_cpu = run('cpu')
    assert abs(e - e_cpu) <= 1e-5 and (g - g_cpu).abs().max().item() <= 1e-4


def test_mps_gradient_at_zero_angle_on_the_card(card):
    """|++> through an Rzz at angle 0, a product gate whose derivative is
    not: the MPS keeps the channel, d<YZ>/dtheta = 1 (1e-5) on the card."""
    cir = dqt.QubitCircuit(2, mps=True, chi=4)
    cir.h(0)
    cir.h(1)
    cir.rzz([0, 1])
    cir.observable([0, 1], basis='yz')
    p = torch.zeros_like(cir.params).requires_grad_()
    cir.expectation(params=p)[0].backward()
    assert p.grad.device.type == 'cuda' and abs(p.grad.item() - 1) <= 1e-5


def test_adjoint_expectation_on_the_card(card):
    from deepquantum_tpu_torch.adjoint import make_adjoint_expectation
    cir = _bench(14, 2)
    fn = make_adjoint_expectation(cir)
    p = cir.params.requires_grad_()
    fn(p).backward()
    loss, grad = _grad(cir)
    assert torch.allclose(p.grad, grad, atol=1e-6, rtol=0)
    dqt.set_dtype('complex128')
    ref = _bench(14, 2)
    q = ref.params.requires_grad_()
    make_adjoint_expectation(ref)(q).backward()
    assert (q.grad - grad.double()).abs().max().item() <= 1e-4


# ------------------------------------------- the continuous-variable engine
def _counts_of(dqt_fn):
    from deepquantum_tpu_torch.photonic import tor_kernel as tk
    tk.tor_dets_cuda.batched_launches = tk.tor_dets_quads_cuda.batched_launches = 0
    out = dqt_fn()
    return out, (tk.tor_dets_cuda.batched_launches, tk.tor_dets_quads_cuda.batched_launches)


def _by_pattern(out):
    return {tuple(k.state.tolist()): v.item() for k, v in out.items()}


def test_graph_gbs_on_the_card(card128):
    """GraphGBS with threshold detectors: the click table in one batched K8
    call per click count >= 3 and samples from it on the card; pnrd through
    hafnian_batch; both against the CPU."""
    rng = np.random.default_rng(31)
    adj = np.triu((rng.random((8, 8)) < 0.5).astype(float), 1)
    adj = adj + adj.T
    gbs = dqt.photonic.GraphGBS(adj, mean_photon_num=6, detector='threshold',
                                rng=np.random.default_rng(0))
    table, (k8, k9) = _counts_of(lambda: gbs(is_prob=True))
    assert (k8, k9) == (6, 0)
    ref = dqt.photonic.GraphGBS(adj, mean_photon_num=6, detector='threshold',
                                rng=np.random.default_rng(0), device='cpu')
    want = _by_pattern(ref(is_prob=True))
    got = _by_pattern(table)
    assert max(abs(got[k] - want[k]) for k in want) <= 1e-10
    counts = gbs.measure(shots=20000, generator=torch.Generator('cuda').manual_seed(0))
    assert sum(counts.values()) == 20000 and all(want[tuple(k.state.tolist())] > 0 for k in counts)
    six = gbs.postselect(counts, [4])[0]
    assert all(sum(k.state) == 4 for k in six)
    small = dqt.photonic.GraphGBS(adj[:6, :6], cutoff=2, mean_photon_num=4, detector='pnrd',
                                  rng=np.random.default_rng(0))
    ref = dqt.photonic.GraphGBS(adj[:6, :6], cutoff=2, mean_photon_num=4, detector='pnrd',
                                rng=np.random.default_rng(0), device='cpu')
    got, want = _by_pattern(small(is_prob=True)), _by_pattern(ref(is_prob=True))
    assert len(got) == 64 and max(abs(got[k] - want[k]) for k in want) <= 1e-12


def test_lossy_gbs_and_homodyne_on_the_card(card128):
    rng = np.random.default_rng(32)
    sq, u = rng.uniform(0.2, 0.6, 6), _haar(6, rng)

    def build(device=None):
        cir = dqt.photonic.GaussianBosonSampling(6, sq, u, detector='threshold', device=device)
        cir.d(2, 0.3, 0.4)
        for i in range(6):
            cir.loss_db(i, 3.0)
        return cir

    cir, ref = build(), build('cpu')
    table, (k8, k9) = _counts_of(lambda: cir(is_prob=True))
    assert (k8, k9) == (0, 4)
    want = _by_pattern(ref(is_prob=True))
    assert max(abs(v - want[k]) for k, v in _by_pattern(table).items()) <= 1e-10
    state, rstate = cir(), ref()
    for w in (1, 4):
        state = dqt.Homodyne(0.4, 6, w)(state, samples=[0.3, -0.2])
        rstate = dqt.Homodyne(0.4, 6, w)(rstate, samples=[0.3, -0.2])
    for a, b in zip(state, rstate):
        assert a.device.type == 'cuda' and (a.cpu() - b).abs().max().item() <= 1e-10


def test_tdm_on_the_card(card):
    """Borealis-like loops of 1, 2 and 3 bins, a batch of 4, 10 steps: the
    covariances on the card at complex64 against the CPU at complex128."""
    def build(device=None):
        cir = dqt.QumodeCircuitTDM(1, 'vac', device=device)
        cir.s(0, r=0.8)
        for ntau in (1, 2, 3):
            cir.delay(0, ntau=ntau, convention='bs', encode=True)
        cir.homodyne_x(0)
        return cir

    data = np.random.default_rng(33).uniform(0, 2 * np.pi, (4, 10, 6))
    cir = build()
    state = cir(data=data, generator=torch.Generator('cuda').manual_seed(0))
    assert state[0].shape == (4, 14, 14) and cir.samples.shape == (4, 10)
    dqt.set_dtype('complex128')
    ref = build('cpu')
    rstate = ref(data=data, generator=torch.Generator().manual_seed(0))
    err = (state[0].cpu().double() - rstate[0]).abs().max() / rstate[0].abs().max()
    assert err.item() <= 1e-5 and torch.isfinite(cir.samples).all()


def test_bosonic_on_the_card(card128):
    def build(device=None):
        cir = dqt.QumodeCircuit(2, backend='bosonic', device=device)
        cir.cat(0, r=1.2, theta=0.0, p=1)
        cir.gkp(1, theta=0.0, phi=0.0, amp_cutoff=0.2, epsilon=0.1)
        cir.bs([0, 1], [np.pi / 4, 0.0])
        cir.homodyne_x(1)
        return cir

    cir, ref = build(), build('cpu')
    for a, b in zip(cir(), ref()):
        assert a.device.type == 'cuda' and (a.cpu() - b).abs().max().item() <= 1e-10
    xs = cir.measure_homodyne(shots=200, generator=torch.Generator('cuda').manual_seed(0))
    assert xs.shape == (200,) and torch.isfinite(xs).all()
    weights = cir.state_measured[2].sum(-1)
    assert (weights - 1).abs().max().item() <= 1e-9
    w = cir.wigner(0, npoints=60, plot=False, normalize=False)
    wr = ref.wigner(0, npoints=60, plot=False, normalize=False)
    assert (w.cpu() - wr).abs().max().item() <= 1e-10
    assert abs(w.sum().item() * (20 / 59) ** 2 - 1) <= 1e-3


# ------------------------------------------------ the Fock-tensor engine
def _fock_qnn(device=None, den_mat=False, mps=False, chi=None, nmode=3, cutoff=6):
    """A CV-QNN-like layer on the vacuum, trainable, fixed values."""
    rng = np.random.default_rng(41)
    cir = dqt.QumodeCircuit(nmode, init_state='vac', cutoff=cutoff, basis=False,
                            den_mat=den_mat, mps=mps, chi=chi, device=device)
    for w in range(nmode):
        cir.add_op('Squeezing', w, [rng.uniform(0, 0.3), rng.uniform(0, 6)], requires_grad=True)
    for w in range(nmode - 1):
        cir.add_op('BeamSplitter', [w, w + 1], rng.uniform(0, 1.5, 2), requires_grad=True)
    for w in range(nmode):
        cir.add_op('Displacement', w, [rng.uniform(0, 0.4), rng.uniform(0, 6)],
                   requires_grad=True)
        cir.add_op('Kerr', w, [rng.uniform(-0.2, 0.2)], requires_grad=True)
    cir.ck([0, 1], [0.2])
    cir.cp(1, [0.1])
    return cir


def _fock_value_grad(cir):
    p = cir.params.requires_grad_()
    cir(params=p)
    value = cir.photon_number_mean_var()[0].sum()
    value.backward()
    return value.detach(), p.grad


def _rel(a, b):
    return ((a.cpu().to(b.dtype) - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize('name', ['PhaseShift', 'BeamSplitter', 'MZI', 'Squeezing', 'Squeezing2',
                                  'Displacement', 'DisplacementPosition', 'DisplacementMomentum',
                                  'QuadraticPhase', 'ControlledX', 'ControlledZ', 'CubicPhase',
                                  'Kerr', 'CrossKerr'])
def test_fock_gate_matrices_on_the_card(card, name):
    """complex64 on the card against complex128 on the CPU, a batch of 4."""
    from deepquantum_tpu_torch.photonic.gates import PHOTONIC_REGISTRY
    reg = PHOTONIC_REGISTRY[name]
    p = np.random.default_rng(42).uniform(-1, 1, (4, reg['npara']))
    got = reg['fock'](torch.as_tensor(p, dtype=torch.float32, device='cuda'), 7)
    dqt.set_dtype('complex128')
    want = reg['fock'](torch.as_tensor(p), 7)
    assert got.device.type == 'cuda' and got.dtype == torch.complex64
    assert _rel(got, want) <= 1e-5


def test_fock_tensor_forward_and_gradient_on_the_card(card):
    cir = _fock_qnn()
    state = cir()
    value, grad = _fock_value_grad(cir)
    assert state.device.type == 'cuda' and state.shape == (6, 6, 6)
    dqt.set_dtype('complex128')
    ref = _fock_qnn('cpu')
    rvalue, rgrad = _fock_value_grad(ref)
    assert _rel(state, ref()) <= 1e-5 and _rel(grad, rgrad) <= 1e-4
    assert abs(value.item() - rvalue.item()) <= 1e-5 * abs(rvalue.item())


def test_lossy_fock_rho_on_the_card(card):
    cir = _fock_qnn(den_mat=True)
    for w in range(3):
        cir.loss_db(w, 3.0)
    rho = cir()
    value, grad = _fock_value_grad(cir)
    cir()
    counts = cir.measure(shots=20000, generator=torch.Generator('cuda').manual_seed(0))
    wig = cir.wigner(0, npoints=40, plot=False)
    dqt.set_dtype('complex128')
    ref = _fock_qnn('cpu', den_mat=True)
    for w in range(3):
        ref.loss_db(w, 3.0)
    rvalue, rgrad = _fock_value_grad(ref)
    rrho = ref()
    assert rho.device.type == 'cuda' and _rel(rho, rrho) <= 1e-5 and _rel(grad, rgrad) <= 1e-4
    assert abs(value.item() - rvalue.item()) <= 1e-5 * abs(rvalue.item())
    assert _rel(wig, ref.wigner(0, npoints=40, plot=False)) <= 1e-5
    assert sum(counts.values()) == 20000
    diag = rrho.reshape(216, 216).diagonal().real
    for key in counts:
        assert diag[int(np.ravel_multi_index(tuple(key.state), (6, 6, 6)))] > 0


def test_fock_mps_on_the_card(card):
    from deepquantum_tpu_torch.mps import full_tensor
    mps = _fock_qnn(mps=True, chi=36, nmode=4, cutoff=4)
    dense = _fock_qnn(nmode=4, cutoff=4)
    psi = dense().reshape(-1)
    sites = mps()
    assert sites[0].device.type == 'cuda'
    assert _rel(full_tensor(sites), (psi / torch.linalg.vector_norm(psi)).cpu()) <= 1e-5
    counts = mps.measure(shots=500, generator=torch.Generator('cuda').manual_seed(1))
    assert sum(counts.values()) == 500


def test_fock_homodyne_sampling_on_the_card(card):
    cir = _fock_qnn(cutoff=8)
    cir.homodyne(0, phi=0.3)
    state = cir()
    xs = dqt.QumodeCircuit.measure_homodyne(cir, shots=50, generator=torch.Generator(
        'cuda').manual_seed(2))
    assert xs.shape == (50,) and xs.device.type == 'cuda' and torch.isfinite(xs).all()
    post = cir.measurements[0](state, samples=[0.4])
    cir.measurements.clear()
    ideal = cir.measure_homodyne(shots=2000, wires=0, generator=torch.Generator(
        'cuda').manual_seed(3))
    assert ideal.shape == (2000,) and abs(ideal.mean().item()
                                         - cir.quadrature_mean(0).item()) <= 0.2
    dqt.set_dtype('complex128')
    ref = _fock_qnn('cpu', cutoff=8)
    ref.homodyne(0, phi=0.3)
    rpost = ref.measurements[0](ref(), samples=[0.4])
    assert _rel(post, rpost) <= 1e-5


# -------------------------------------------- the qubit toolchain (no kernel)
def _cut_halves(m1, m2, layers=2, cut=True):
    """Two halves of the bench ansatz (m1 and m2 wires) joined by a cnot
    each way across the middle, the crossing wires cut (two fragments of
    m1 + 1 and m2 + 1 wires); Z on one wire of each half."""
    n = m1 + m2
    cir = dqt.QubitCircuit(n)
    rng = np.random.default_rng(n)
    cir.cnot(m1 - 1, m1)
    if cut:
        cir.cut(m1)
    for lo, hi in ((0, m1 - 1), (m1, n - 1)):
        for _ in range(layers):
            for i in range(lo, hi + 1):
                cir.rx(i, inputs=float(rng.random() * 6))
                cir.rz(i, inputs=float(rng.random() * 6))
            cir.cnot_ring(minmax=[lo, hi])
    if cut:
        cir.cut(m1 - 1)
    cir.cnot(m1, m1 - 1)
    cir.observable([0, m1 - 1, m1, n - 1], basis='zzxz')
    return cir


def test_cut_reconstruction_on_the_card(card):
    """A cut n=16 circuit: 64 terms, fragments of 11 wires (the planar
    kernels) and 7 (the einsum route), on the card, against the uncut
    circuit."""
    cut = _cut_halves(10, 6)
    sub, coeffs = cut.get_subexperiments()
    assert len(coeffs) == 64 and sorted(s[0].nqubit for s in sub.values()) == [7, 11]
    assert all(c.device.type == 'cuda' for s in sub.values() for c in s)
    total = 0.0
    for k, coeff in enumerate(coeffs):
        prod = 1.0
        for s in sub.values():
            if s[k].observables:
                prod *= s[k].expectation().prod().item()
        total += coeff * prod
    want = _cut_halves(10, 6, cut=False).expectation()[0].item()
    assert abs(total - want) <= 1e-5
    moved = cut.transform_cut2move()
    assert moved.device.type == 'cuda' and abs(moved.expectation()[0].item() - want) <= 1e-5


def test_standardized_pattern_on_the_card(card128):
    """A 4-qubit circuit of the random MBQC family: its standardised
    pattern's first measurement holds a 20-node graph state on the card;
    the output against the circuit's state, complex128."""
    rng = np.random.default_rng(8)
    cir = dqt.QubitCircuit(4)
    for i in range(4):
        cir.rx(i, inputs=float(rng.random() * 6))
    cir.cnot(0, 1)
    for i in range(4):
        cir.rz(i, inputs=float(rng.random() * 6))
    cir.cnot(1, 2)
    cir.h(0)
    target = cir().reshape(-1)
    pat = cir.pattern(generator=torch.Generator('cuda').manual_seed(0))
    pat.standardize()
    first = next(c for c in pat.commands if type(c).__name__ == 'Measurement')
    assert first.nodes == [0]
    seen = []
    orig = dqt.mbqc.SubGraphState.full_state.fget

    def spy(self):
        out = orig(self)
        seen.append(out.numel())
        return out

    dqt.mbqc.SubGraphState.full_state = property(spy)
    try:
        graph = pat()
    finally:
        dqt.mbqc.SubGraphState.full_state = property(orig)
    assert max(seen) == 1 << 20
    out = graph.full_state.reshape(-1)
    assert out.device.type == 'cuda' and out.dtype == torch.complex128
    assert all(b.device.type == 'cuda' for v in graph.measure_dict.values() for b in v)
    overlap = (out.conj() @ target).abs().item() / (out.norm() * target.norm()).item()
    assert overlap >= 1 - 1e-8


def test_class_api_and_qasm_on_the_card(card):
    from deepquantum_tpu_torch import api
    rx = api.Rx(inputs=0.3, wires=1)
    assert rx.matrix().device.type == 'cuda'
    assert rx(torch.ones(4, dtype=torch.complex64, device=card) / 2).device.type == 'cuda'
    cir = dqt.QubitCircuit(12)
    cir.add(api.RxLayer(12))
    cir.add(api.CnotRing(12))
    cir.add(api.RzLayer(12))
    back = dqt.qasm3_to_cir(cir.qasm3())
    assert back.device.type == 'cuda'
    torch.testing.assert_close(back(), cir(), atol=1e-5, rtol=0)


def _dist_bench(n, layers, mesh):
    cir = dqt.DistributedQubitCircuit(n, mesh=mesh)
    for _ in range(layers):
        for i in range(n):
            cir.rx(i)
            cir.rz(i)
            cir.rx(i)
        cir.cnot_ring()
    cir.observable(list(range(n)), basis='x' * n)
    cir.init_para(n)
    return cir


def test_shardmap_grad_step_on_four_shards_of_the_card(card):
    """The shardmap engine at n=20 on 4 shards of the one card (18 local
    qubits): loss and gradient against the local engine (1e-5, 1e-4 of
    max|g|); on every shard K1 and K6 launched (single gates and remaps)
    and the window runs as one window-chain launch each way; K5 with
    fused_bwd off."""
    mesh = dqt.parallel.make_mesh(devices=['cuda:0'] * 4)
    cir = _dist_bench(20, 2, mesh)
    assert cir.engine == 'shardmap' and cir._smap.use_kernels and cir.fused_bwd
    local = _bench(20, 2)
    for fn in (tpg.planar_apply, tpg.planar_bwd_fused, tpg.planar_grad, tck.window_chain_fwd,
               tck.window_chain_bwd):
        fn.launches = 0
    loss, grad = _grad(cir)
    assert tpg.planar_apply.launches > 0 and tck.window_chain_fwd.launches > 0
    assert tck.window_chain_bwd.launches > 0
    assert tpg.planar_bwd_fused.launches > 0 and tpg.planar_grad.launches == 0
    ref_loss, ref_grad = _grad(local)
    assert abs(loss.item() - ref_loss.item()) <= 1e-5
    torch.testing.assert_close(grad, ref_grad, atol=1e-4 * ref_grad.abs().max().item(), rtol=0)
    cir.fused_bwd = False
    _, grad5 = _grad(cir)
    assert tpg.planar_grad.launches > 0
    torch.testing.assert_close(grad5, grad, atol=1e-5 * grad.abs().max().item(), rtol=0)
    with torch.no_grad():
        torch.testing.assert_close(cir.forward(), local.forward()[:, 0], atol=1e-5, rtol=0)


def test_sharded_fock_forward_on_two_shards_of_the_card(card):
    """A 5-mode Fock circuit at cutoff 6 on 2 shards of the card (mode 0's
    range split): the forward against the local Fock tensor, complex64."""
    mesh = dqt.parallel.make_mesh(devices=['cuda:0'] * 2)
    dist = dqt.DistributedQumodeCircuit(5, 'vac', cutoff=6, mesh=mesh)
    local = dqt.QumodeCircuit(5, init_state='vac', cutoff=6, basis=False)
    for c in (dist, local):
        r = np.random.default_rng(4)
        for w in range(5):
            c.s(w, r=0.2 * r.random(), theta=r.random())
        for w in range(4):
            c.bs([w, w + 1], inputs=r.random(2).tolist())
        c.d(0, r=0.3, theta=0.2)
        c.k(0, inputs=[0.05])
    out = dist()
    assert out.device.type == 'cuda' and dist.dstate.shards[1].device.type == 'cuda'
    torch.testing.assert_close(out, local().reshape(-1), atol=1e-5, rtol=0)


def test_make_mesh_does_not_repeat_the_card(card):
    """make_mesh(k) takes k visible cards; on a one-card machine asking for
    two raises, and listing the card twice gives two shards on it."""
    count = torch.cuda.device_count()
    if count == 1:
        with pytest.raises(RuntimeError, match='visible'):
            dqt.parallel.make_mesh(2)
    else:
        assert dqt.parallel.make_mesh(2).size == 2
    assert dqt.parallel.make_mesh(devices=['cuda:0'] * 2).devices == (torch.device('cuda', 0),) * 2
    assert dqt.parallel.make_mesh().size == count
