#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--out FILE]   # where a grad step's time goes

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card (nvidia-smi name and power limit), torch and
   CUDA versions;
2. build the CUDA kernels from deepquantum_tpu_torch/csrc and print the
   build time;
3. hold each of the six kernels against its plain PyTorch twin on the card
   (float32, unnormalised randn states from a fixed seed; state error =
   max|d| / max|ref| of the state outputs, plane error the same for the
   reduced cotangent planes), with CUDA-event median times and the least
   time the card could take (bound_ms, from the bytes each call must move
   and the operations it does, against the published peaks):
   planar_apply, planar_grad, planar_bwd_fused at n=22 on eight wire sets
   (states <= 1e-6 / 1e-5, planes <= 1e-5), window_apply at n=24 with a
   random unitary (<= 1e-6; also timed against the one library call that
   computes the same function, a real 256 x 256 block matmul), window_chain_fwd
   and window_chain_bwd at n=18 on the bench ansatz's scheduled sequence
   (states <= 1e-5, dW <= 1e-5);
4. the serving slice at n=18, 5 layers: the bench ansatz (rx/rz/rx per
   wire plus a CNOT ring, X string on all wires) through the public
   QubitCircuit API on the default device (the card) at complex64 with
   params from init_para(seed): state and <X...X> against the port's
   complex128 einsum route on the card (<= 1e-5), window_chain_fwd launched
   exactly twice (forward + observable), and the median forward +
   expectation time on the kernel route and on the twin route;
5. the same at n=24 (window_apply route) and at n=22 with one extra
   cnot(0, 11) per layer (planar_apply >= 5 launches, window_apply > 0);
6. the training slice at n=18, 5 layers: one step = forward, expectation,
   backward, SGD update, with the parameters a leaf that requires grad.
   Loss and gradient against the complex128 route with plain autograd
   (<= 1e-5, <= 1e-4); per step window_chain_fwd launched exactly twice and
   window_chain_bwd once; three SGD steps on both routes from the same
   parameters give losses within 1e-5 after every step; the median step
   time on the kernel route and on the twin route;
7. the per-step backward at n=22 with cnot(0, 11) per layer, 2 layers: the
   default route launches planar_grad >= 2, planar_apply and window_apply;
   with fused_bwd it launches planar_bwd_fused >= 2 and planar_grad 0; both
   gradients against complex128 (<= 1e-4) and against each other (<= 1e-5);
8. print the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 1234
LAYERS = 5
REPS = 20
LR = 1e-3
# reduced cotangent planes (dRe, dIm, dW) against max|ref|: float32 sums of up
# to 2^21 products taken in another order than the twin's matmul; the card
# reads 1.6e-6 to 2.0e-6
PLANE_BAR = 1e-5

# published peaks of one H100 SXM at its full power limit
PEAK_BYTES_S = 3.35e12       # device memory
PEAK_FP32_S = 67e12          # float32 outside the tensor cores

KERNELS = {   # wrapper -> (source, TPU kernel it replaces)
    'planar_apply': ('deepquantum_tpu_torch/csrc/planar_apply.cu',
                     'deepquantum_tpu/ops/planar_gate.py:412'),
    'window_apply': ('deepquantum_tpu_torch/csrc/window_apply.cu',
                     'deepquantum_tpu/ops/window_gate.py:92'),
    'window_chain_fwd': ('deepquantum_tpu_torch/csrc/window_chain.cu',
                         'deepquantum_tpu/ops/chain_kernel.py:294'),
    'window_chain_bwd': ('deepquantum_tpu_torch/csrc/window_chain_bwd.cu',
                         'deepquantum_tpu/ops/chain_kernel.py:324'),
    'planar_grad': ('deepquantum_tpu_torch/csrc/planar_grad.cu',
                    'deepquantum_tpu/ops/planar_gate.py:560'),
    'planar_bwd_fused': ('deepquantum_tpu_torch/csrc/planar_bwd_fused.cu',
                         'deepquantum_tpu/ops/planar_gate.py:687'),
}
GATE_WIRE_SETS = [(0,), (21,), (10,), (0, 1), (3, 17), (20, 21), (0, 10, 21), (5, 6, 7)]


def _pkg():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import deepquantum_tpu_torch as dqt
    from deepquantum_tpu_torch.ops import chain_kernel, planar_gate, window_gate
    return dqt, planar_gate, window_gate, chain_kernel


def _wrappers():
    _, pg, wg, ck = _pkg()
    return {'planar_apply': pg.planar_apply, 'window_apply': wg.window_apply,
            'window_chain_fwd': ck.window_chain_fwd, 'window_chain_bwd': ck.window_chain_bwd,
            'planar_grad': pg.planar_grad, 'planar_bwd_fused': pg.planar_bwd_fused}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def time_ms(fn, reps: int = REPS, warmup: int = 2):
    """Median and all per-call times of fn() on the card, with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def rel_err(y, ref):
    d = (y - ref).abs().max().item()
    return d / ref.abs().max().item(), d


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FP32_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def mean_bound(bounds) -> dict:
    ms = float(np.mean([b['bound_ms'] for b in bounds]))
    kinds = {b['bound_by'] for b in bounds}
    if len(kinds) != 1:
        raise AssertionError(f'mixed bounds {kinds} in one mean')
    return dict(bound_ms=ms, bound_by=kinds.pop())


@contextlib.contextmanager
def twin_route():
    """Run the planar engine's steps, forward and backward, through the
    plain twins on the card (the same contracts as the kernel wrappers)."""
    _, pg, wg, ck = _pkg()

    def planar(x, mre, mim, n, wires):
        x.copy_(pg.planar_evolve_xla(x, mre, mim, n, wires))
        return x

    def window(x, mre, mim, n, w):
        x.copy_(wg.window_apply_plain(x, mre, mim, n, w))
        return x

    def bwd_fused(y, g, mre_t, mim_t, n, wires):
        x, g2, dre, dim = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
        y.copy_(x)
        g.copy_(g2)
        return y, g, dre, dim

    patches = [(pg, 'planar_apply', planar), (wg, 'window_apply', window),
               (ck, 'window_chain_fwd', ck.window_chain_plain),
               (ck, 'window_chain_bwd', ck.window_chain_bwd_plain),
               (pg, 'planar_grad', pg.planar_grad_xla), (pg, 'planar_bwd_fused', bwd_fused)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def bench_circuit(n: int, device=None, extra_cnot=None, layers: int = LAYERS):
    """The bench ansatz: layers x (rx, rz, rx on every wire; CNOT ring),
    optionally one more cnot per layer; X string on all wires. With no
    device it lands on the port's default device, the card."""
    dqt = _pkg()[0]
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
    cir.init_para(SEED)
    return cir


def _haar(k: int, rng) -> np.ndarray:
    z = rng.normal(size=(k, k)) + 1j * rng.normal(size=(k, k))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _planes(u, device):
    import torch
    return (torch.as_tensor(u.real, dtype=torch.float32, device=device),
            torch.as_tensor(u.imag, dtype=torch.float32, device=device))


def _randn_state(n: int, rng, device):
    import torch
    return torch.as_tensor(rng.standard_normal((2, 1 << n), dtype=np.float32), device=device)


def _hold(name: str, err: float, bar: float):
    if not err <= bar:
        raise AssertionError(f'{name}: rel err {err} > {bar}')


# ------------------------------------------------------------------ phases
def setup():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: torch.cuda.is_available() is false; this check needs a CUDA card')
    if not (ROOT / 'deepquantum_tpu_torch' / 'csrc').is_dir():
        raise SystemExit('FAIL: deepquantum_tpu_torch/ is not beside chip_smoke.py')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {smi}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}')
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    if dqt.default_device().type != 'cuda':
        raise AssertionError(f'the default device is {dqt.default_device()}, not the card')
    return smi


def build():
    from deepquantum_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    print(f'build: {time.perf_counter() - t0:.1f} s -> {path.relative_to(ROOT)}')
    for line in _cuda.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line.lower():
            print(f'  nvcc: {line.strip()}')


def check_gate_kernels(results: dict, rng, rng_g):
    """Phase 3, the per-gate kernels K1, K5, K6 at n=22 on eight wire sets.
    States and unitaries come from ``rng`` in a fixed order, cotangents from
    ``rng_g``, so that adding a kernel leaves the others' inputs as they were."""
    import torch
    pg = _pkg()[1]
    dev = torch.device('cuda')
    n = 22
    state_bytes = 2 * (1 << n) * 4          # one (2, 2^n) float32 state
    x = _randn_state(n, rng, dev)
    g = _randn_state(n, rng_g, dev)
    acc = {name: dict(errs=[], abs_errs=[], plane_errs=[], t_k=[], t_p=[], bounds=[])
           for name in ('planar_apply', 'planar_grad', 'planar_bwd_fused')}

    def note(name, wires, e, d, pe, tk, tp, bnd):
        a = acc[name]
        a['errs'].append(e)
        a['abs_errs'].append(d)
        a['plane_errs'].append(pe)
        a['t_k'].append(tk)
        a['t_p'].append(tp)
        a['bounds'].append(bnd)
        errs = ', '.join(f'{what} rel err {v:.2e}' for what, v in (('state', e), ('plane', pe))
                         if v is not None)
        print(f'{name} n={n} wires={wires}: {errs}, kernel {tk:.4f} ms, twin {tp:.4f} ms, '
              f'bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')

    for wires in GATE_WIRE_SETS:
        k = len(wires)
        apply_flops = (1 << (n - k)) * 8 * 4 ** k       # a complex (2^k)^2 product per group
        mre, mim = _planes(_haar(1 << k, rng), dev)
        mre_t, mim_t = mre.t().contiguous(), (-mim.t()).contiguous()

        # K1: y = U x
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), mre, mim, n, wires)
        torch.cuda.synchronize()
        e, d = rel_err(y, ref)
        _hold(f'planar_apply wires={wires}', e, 1e-6)
        work = x.clone()
        tk, _ = time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
        tp, _ = time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))
        note('planar_apply', wires, e, d, None, tk, tp, bound(2 * state_bytes, apply_flops))

        # K5: (dRe, dIm) from g and x, pure reads
        ref = pg.planar_grad_xla(g, x, n, wires)
        got = pg.planar_grad(g, x, n, wires)
        torch.cuda.synchronize()
        pe, pd = max(rel_err(a, b) for a, b in zip(got, ref))
        _hold(f'planar_grad wires={wires}', pe, PLANE_BAR)
        tk, _ = time_ms(lambda: pg.planar_grad(g, x, n, wires))
        tp, _ = time_ms(lambda: pg.planar_grad_xla(g, x, n, wires))
        note('planar_grad', wires, None, pd, pe, tk, tp,
             bound(2 * state_bytes + 2 * 4 ** k * 4, apply_flops))

        # K6: x = U^H y, g' = U^H g, planes from the raw g, in place on both
        ref = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
        wy, wg_ = y.clone(), g.clone()
        got = pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires)
        torch.cuda.synchronize()
        if got[0] is not wy or got[1] is not wg_:
            raise AssertionError('planar_bwd_fused must update y and g in place')
        (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
        e, d = max(e, e2), max(d, d2)
        _hold(f'planar_bwd_fused states wires={wires}', e, 1e-5)
        _hold(f'planar_bwd_fused recovers x wires={wires}', rel_err(got[0], x)[0], 1e-5)
        pe, pd = max(rel_err(a, b) for a, b in zip(got[2:], ref[2:]))
        _hold(f'planar_bwd_fused planes wires={wires}', pe, PLANE_BAR)
        tk, _ = time_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
        tp, _ = time_ms(lambda: pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires))
        note('planar_bwd_fused', wires, e, max(d, pd), pe, tk, tp,
             bound(4 * state_bytes + 2 * 4 ** k * 4, 3 * apply_flops))

    for name, a in acc.items():
        states = [v for v in a['errs'] if v is not None]
        planes = [v for v in a['plane_errs'] if v is not None]
        results[name] = dict(max_abs_err=max(a['abs_errs']),
                             rel_err=max(states) if states else None,
                             plane_rel_err=max(planes) if planes else None,
                             ms=float(np.mean(a['t_k'])), plain_ms=float(np.mean(a['t_p'])),
                             shape=f'n={n}, mean over {len(GATE_WIRE_SETS)} wire sets',
                             **mean_bound(a['bounds']))


def check_window_kernels(results: dict, rng, rng_g):
    """Phase 3, the window kernels K2 (n=24) and K3, K4 (n=18)."""
    import torch
    _, _, wg, ck = _pkg()
    dev = torch.device('cuda')

    n = 24
    x = _randn_state(n, rng, dev)
    mre, mim = _planes(_haar(128, rng), dev)
    ref = wg.window_apply_plain(x, mre, mim, n, 7)
    y = wg.window_apply(x.clone(), mre, mim, n, 7)
    torch.cuda.synchronize()
    e, d = rel_err(y, ref)
    work = x.clone()
    tk, _ = time_ms(lambda: wg.window_apply(work, mre, mim, n, 7))
    tp, _ = time_ms(lambda: wg.window_apply_plain(x, mre, mim, n, 7))
    cols = 1 << (n - 7)
    # the library yardstick, used nowhere in the port: W as the real block
    # matrix [[Wr, -Wi], [Wi, Wr]] against the planes stacked as (256, cols)
    # is ONE float32 matmul with the same operation count
    block = torch.cat([torch.cat([mre, -mim], 1), torch.cat([mim, mre], 1)], 0)
    e_lib = rel_err(torch.matmul(block, x.view(256, cols)).view(2, -1), ref)[0]
    _hold('window_apply library call', e_lib, 1e-5)
    tl, _ = time_ms(lambda: torch.matmul(block, x.view(256, cols)))
    win_flops = 8 * 128 * 128               # a complex 128 x 128 product per column
    bnd = bound(2 * 2 * (1 << n) * 4 + 2 * 128 * 128 * 4, cols * win_flops)
    print(f'window_apply n={n}: rel err {e:.2e}, kernel {tk:.4f} ms, twin {tp:.4f} ms, '
          f'one block matmul {tl:.4f} ms (rel err {e_lib:.2e}), '
          f'bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')
    _hold('window_apply', e, 1e-6)
    results['window_apply'] = dict(max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk,
                                   plain_ms=tp, library_ms=tl, shape=f'n={n}', **bnd)
    del x, y, ref, work, block

    n = 18
    cir = bench_circuit(n)
    mres, mims, wseq = cir._planar_seq(cir._full_params())
    if not ck.chain_fused_ok(wseq, n, mres):
        raise AssertionError('the n=18 bench sequence does not qualify for the window chain')
    n_win = sum(1 for s in wseq if s[0] == 'win')
    steps = f'{n_win} win + {len(wseq) - n_win} rot steps'
    cols = 1 << (n - 7)
    state_bytes = 2 * (1 << n) * 4
    stack_bytes = n_win * 2 * 128 * 128 * 4
    x = _randn_state(n, rng, dev)
    ref = ck.window_chain_plain(x, mres, mims, n, wseq)
    y = ck.window_chain_fwd(x, mres, mims, n, wseq)
    torch.cuda.synchronize()
    e, d = rel_err(y, ref)
    tk, _ = time_ms(lambda: ck.window_chain_fwd(x, mres, mims, n, wseq))
    tp, _ = time_ms(lambda: ck.window_chain_plain(x, mres, mims, n, wseq))
    bnd = bound(2 * state_bytes + stack_bytes, n_win * cols * win_flops)
    print(f'window_chain_fwd n={n} ({steps}): rel err {e:.2e}, kernel {tk:.4f} ms, '
          f'twin {tp:.4f} ms, bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')
    _hold('window_chain_fwd', e, 1e-5)
    results['window_chain_fwd'] = dict(max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk,
                                       plain_ms=tp, shape=f'n={n}, {len(wseq)} steps', **bnd)

    # K4: y is the forward's output, g a random cotangent
    g = _randn_state(n, rng_g, dev)
    y0, g0 = y.clone(), g.clone()
    ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
    got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    torch.cuda.synchronize()
    if not (torch.equal(y, y0) and torch.equal(g, g0)):
        raise AssertionError('window_chain_bwd wrote to its inputs')
    (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
    e, d = max(e, e2), max(d, d2)
    _hold('window_chain_bwd states', e, 1e-5)
    _hold('window_chain_bwd recovers x', rel_err(got[0], x)[0], 1e-5)
    pairs = [(a, b) for dk, dr in zip(got[2:], ref[2:]) for a, b in zip(dk, dr) if b is not None]
    if len(pairs) != 2 * n_win or any(a is None for a, _ in pairs):
        raise AssertionError('window_chain_bwd: dW slots do not match the window steps')
    pe, pd = max(rel_err(a, b) for a, b in pairs)
    _hold('window_chain_bwd dW', pe, PLANE_BAR)
    tk, _ = time_ms(lambda: ck.window_chain_bwd(y, g, mres, mims, n, wseq))
    tp, _ = time_ms(lambda: ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq))
    # per window: W^H y and W^H g, and four real (128 x cols)(cols x 128) products
    dw_flops = 4 * 2 * 128 * 128 * cols
    bnd = bound(4 * state_bytes + 2 * stack_bytes, n_win * (2 * cols * win_flops + dw_flops))
    print(f'window_chain_bwd n={n} ({steps}): state rel err {e:.2e}, dW rel err {pe:.2e}, '
          f'kernel {tk:.4f} ms, twin {tp:.4f} ms, bound {bnd["bound_ms"]:.4f} ms '
          f'({bnd["bound_by"]})')
    results['window_chain_bwd'] = dict(max_abs_err=max(d, pd), rel_err=e, plane_rel_err=pe, ms=tk,
                                       plain_ms=tp, shape=f'n={n}, {len(wseq)} steps', **bnd)


def check_slice(n: int, extra_cnot, expect):
    """Phases 4-5: forward + expectation through the public API on the card.
    ``expect(counts)`` checks the kernel launch counts of one run."""
    import torch
    dqt = _pkg()[0]
    label = f'n={n}' + (f' + cnot{extra_cnot}/layer' if extra_cnot else '')
    dqt.set_dtype('complex64')
    cir = bench_circuit(n, None, extra_cnot)
    if cir.device.type != 'cuda':
        raise AssertionError(f'{label}: the circuit landed on {cir.device}')
    with torch.inference_mode():
        reset_counts()
        state = cir.forward()
        e = cir.expectation()
        torch.cuda.synchronize()
        counts = read_counts()
        state = state.clone()
    print(f'slice {label}: launches {counts}')
    expect(counts)

    dqt.set_dtype('complex128')
    try:
        ref_cir = bench_circuit(n, 'cuda', extra_cnot)
        if ref_cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        with torch.inference_mode():
            ref_state = ref_cir.forward()
            ref_e = ref_cir.expectation()
    finally:
        dqt.set_dtype('complex64')
    if not (torch.isfinite(state.real).all() and torch.isfinite(state.imag).all()):
        raise AssertionError(f'{label}: non-finite state')
    if tuple(state.shape) != (1 << n, 1) or tuple(e.shape) != (1,):
        raise AssertionError(f'{label}: shapes {tuple(state.shape)}, {tuple(e.shape)}')
    d_state = (state.to(torch.complex128) - ref_state).abs().max().item()
    d_e = abs(e.item() - ref_e.item())
    print(f'slice {label}: <X..X> = {e.item():.8f} (complex128 {ref_e.item():.8f}), '
          f'|d exp| {d_e:.2e}, state max|d| {d_state:.2e}')
    if not (d_e <= 1e-5 and d_state <= 1e-5):
        raise AssertionError(f'{label}: differs from the complex128 route')

    def step():
        cir.forward()
        cir.expectation()

    with torch.inference_mode():
        t_kernel, _ = time_ms(step)
        reset_counts()
        with twin_route():
            t_twin, _ = time_ms(step)
            e_twin = cir.expectation().item()
        if sum(read_counts().values()) != 0:
            raise AssertionError('the twin route launched a kernel')
    if abs(e_twin - e.item()) > 1e-5:
        raise AssertionError(f'{label}: twin route gives {e_twin}, kernel route {e.item()}')
    print(f'slice {label}: forward + expectation median over {REPS} calls: kernel route '
          f'{t_kernel:.3f} ms, twin route {t_twin:.3f} ms')
    return counts, t_kernel, t_twin


def grad_step(cir, p, update: bool = True):
    """One training step: forward, expectation, backward and, with
    ``update``, the SGD update in place. Returns (loss, gradient)."""
    import torch
    loss = cir.expectation(params=p)[0]
    loss.backward()
    grad, p.grad = p.grad, None
    if update:
        with torch.no_grad():
            p -= LR * grad
    return loss.detach(), grad


def _reference_grad(n: int, extra_cnot, layers: int, sgd_steps: int = 0):
    """Loss and gradient on the port's complex128 einsum route with plain
    autograd on the card, then the losses of ``sgd_steps`` SGD steps (each
    step's loss, and the loss after the last update)."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        cir = bench_circuit(n, 'cuda', extra_cnot, layers)
        if cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        p = cir.params.requires_grad_()
        loss, grad = grad_step(cir, p, update=False)
        losses = []
        for _ in range(sgd_steps):
            losses.append(grad_step(cir, p)[0].item())
        if sgd_steps:
            with torch.no_grad():
                losses.append(cir.expectation(params=p)[0].item())
        torch.cuda.synchronize()
        return loss.item(), grad, losses
    finally:
        dqt.set_dtype('complex64')


def check_training(n: int = 18):
    """Phase 6: the VQE gradient step at n=18, 5 layers, full width."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = bench_circuit(n)
    if cir.device.type != 'cuda' or not cir._planar_ok():
        raise AssertionError(f'training n={n}: device {cir.device}, planar {cir._planar_ok()}')
    p0 = cir.params
    if p0.device.type != 'cuda':
        raise AssertionError(f'training n={n}: parameters on {p0.device}')

    p = p0.clone().requires_grad_()
    reset_counts()
    loss, grad = grad_step(cir, p, update=False)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f'training n={n}: launches per grad step {counts}')
    if counts['window_chain_fwd'] != 2 or counts['window_chain_bwd'] != 1:
        raise AssertionError(f'training n={n}: expected window_chain_fwd 2 and window_chain_bwd 1')
    if tuple(grad.shape) != tuple(p0.shape) or not torch.isfinite(grad).all():
        raise AssertionError(f'training n={n}: gradient shape {tuple(grad.shape)} or non-finite')

    ref_loss, ref_grad, ref_losses = _reference_grad(n, None, LAYERS, sgd_steps=3)
    d_loss = abs(loss.item() - ref_loss)
    d_grad = (grad.double() - ref_grad).abs().max().item()
    print(f'training n={n}: loss {loss.item():.8f} (complex128 {ref_loss:.8f}), |d loss| '
          f'{d_loss:.2e}, max|d grad| {d_grad:.2e} (max|grad| {ref_grad.abs().max().item():.3e})')
    if not (d_loss <= 1e-5 and d_grad <= 1e-4):
        raise AssertionError(f'training n={n}: differs from the complex128 route')

    p = p0.clone().requires_grad_()
    losses = [grad_step(cir, p)[0].item() for _ in range(3)]
    with torch.no_grad():
        losses.append(cir.expectation(params=p)[0].item())
    d_sgd = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f'training n={n}: 3 SGD steps, losses {[round(v, 8) for v in losses]}, '
          f'max |d| to complex128 {d_sgd:.2e}')
    if not d_sgd <= 1e-5:
        raise AssertionError(f'training n={n}: the SGD losses drift from the complex128 route')

    p = p0.clone().requires_grad_()
    t_kernel, _ = time_ms(lambda: grad_step(cir, p))
    p = p0.clone().requires_grad_()
    reset_counts()
    with twin_route():
        t_twin, _ = time_ms(lambda: grad_step(cir, p))
    if sum(read_counts().values()) != 0:
        raise AssertionError('the twin route launched a kernel')
    print(f'training n={n}: grad step (forward, expectation, backward, update) median over '
          f'{REPS} steps: kernel route {t_kernel:.3f} ms, twin route {t_twin:.3f} ms')
    return counts, t_kernel, t_twin


def check_step_backward(n: int = 22, extra_cnot=(0, 11), layers: int = 2, reps: int = 5):
    """Phase 7: the per-step backward walk, default and fused."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    label = f'n={n} + cnot{extra_cnot}/layer, {layers} layers'
    ref_loss, ref_grad, _ = _reference_grad(n, extra_cnot, layers)
    out = {}
    for fused in (False, True):
        cir = bench_circuit(n, None, extra_cnot, layers)
        cir.fused_bwd = fused
        p = cir.params.requires_grad_()
        reset_counts()
        loss, grad = grad_step(cir, p, update=False)
        torch.cuda.synchronize()
        counts = read_counts()
        d_loss = abs(loss.item() - ref_loss)
        d_grad = (grad.double() - ref_grad).abs().max().item()
        t, _ = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=1)
        print(f'backward {label}, fused_bwd={fused}: launches {counts}, |d loss| {d_loss:.2e}, '
              f'max|d grad| {d_grad:.2e}, grad step median over {reps}: {t:.3f} ms')
        if not (d_loss <= 1e-5 and d_grad <= 1e-4):
            raise AssertionError(f'{label}, fused_bwd={fused}: differs from the complex128 route')
        out[fused] = (counts, grad, t)
    c_def, c_fus = out[False][0], out[True][0]
    if c_def['planar_grad'] < 2 or c_def['planar_apply'] <= 0 or c_def['window_apply'] <= 0 \
            or c_def['planar_bwd_fused'] != 0:
        raise AssertionError(f'{label}: default backward launches {c_def}')
    if c_fus['planar_bwd_fused'] < 2 or c_fus['planar_grad'] != 0:
        raise AssertionError(f'{label}: fused backward launches {c_fus}')
    d = (out[False][1] - out[True][1]).abs().max().item()
    print(f'backward {label}: default vs fused max|d grad| {d:.2e}')
    if not d <= 1e-5:
        raise AssertionError(f'{label}: default and fused gradients differ by {d}')
    return c_def, c_fus


# ----------------------------------------------------------------- profile
PARTS = {   # label -> where the real step spends host time
    'sequence': 'QubitCircuit._planar_seq (gate matrices, window plan and products)',
    'chain_forward': 'planar_chain (K3 at n=18)',
    'pauli_expectation': 'planar_pauli_expectation (K3 at n=18)',
    'chain_backward': '_chain_backward, the adjoint walk inside loss.backward() (K4 at n=18)',
}


@contextlib.contextmanager
def labelled_parts(host_ms: dict):
    """Run the real entry points with the functions of PARTS wrapped: each
    adds its host time (no synchronise) to ``host_ms`` and shows as a
    ``dq:<label>`` range in a torch.profiler trace."""
    import torch
    dqt, pg, _, _ = _pkg()

    def wrap(label, fn):
        def inner(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f'dq:{label}'):
                out = fn(*args, **kwargs)
            host_ms[label] = host_ms.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return inner

    patches = [(dqt.QubitCircuit, '_planar_seq', 'sequence'), (pg, 'planar_chain', 'chain_forward'),
               (pg, 'planar_pauli_expectation', 'pauli_expectation'),
               (pg, '_chain_backward', 'chain_backward')]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, label in patches:
        setattr(mod, name, wrap(label, getattr(mod, name)))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_training(card: str, n: int = 18, reps: int = 10, steps: int = 5) -> dict:
    """Where one grad step (phase 6's ``grad_step`` on ``bench_circuit``)
    spends its time: the free-running median; the host time of each of
    PARTS inside the free-running step; a split of the real calls with a
    synchronise after expectation, backward and update (the parts then
    serialise host and device); and one torch.profiler window of ``steps``
    steps for the device time, the device operations and the top kernels."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = bench_circuit(n)
    p = cir.params.requires_grad_()
    t_step, all_steps = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=3)

    host_ms: dict = {}
    with labelled_parts(host_ms):
        t0 = time.perf_counter()
        for _ in range(reps):
            grad_step(cir, p)
        torch.cuda.synchronize()
        t_labelled = (time.perf_counter() - t0) * 1e3 / reps
    host_ms = {k: v / reps for k, v in host_ms.items()}

    def synced(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def update():
        with torch.no_grad():
            p.sub_(LR * p.grad)
        p.grad = None

    split = []
    torch.cuda.synchronize()
    for _ in range(reps):
        loss, t_fwd = synced(lambda: cir.expectation(params=p)[0])
        _, t_bwd = synced(loss.backward)
        _, t_upd = synced(update)
        split.append((t_fwd, t_bwd, t_upd))
    t_fwd, t_bwd, t_upd = (float(v) for v in np.median(np.array(split), axis=0))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with labelled_parts({}), torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            grad_step(cir, p)
        torch.cuda.synchronize()
    dev_us, dev_ops, by_name, launch_us, ranges = 0.0, 0, [], 0.0, {}
    for ev in prof.key_averages():
        if ev.key.startswith('dq:'):
            # a range shows twice: on the host, and as an annotation on the
            # device side that spans its kernels and is no device work itself
            if ev.device_type == torch.autograd.DeviceType.CPU:
                ranges[ev.key[3:]] = ev.cpu_time_total / 1e3 / steps
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            # the attribute was renamed across PyTorch versions
            t = getattr(ev, 'self_device_time_total', None)
            t = float(t if t is not None else getattr(ev, 'self_cuda_time_total', 0.0))
            dev_us += t
            dev_ops += ev.count
            by_name.append((t, ev.count, ev.key))
        elif ev.key == 'cudaLaunchKernel':
            launch_us = ev.self_cpu_time_total
    by_name.sort(reverse=True)
    return dict(
        card=card, device=torch.cuda.get_device_name(0), n=n, layers=LAYERS, parts=PARTS,
        step_ms_median=t_step, step_ms_all=all_steps, step_ms_with_labels=t_labelled,
        host_ms_per_step=host_ms,
        sync_split_ms=dict(forward_and_expectation=t_fwd, backward=t_bwd, update=t_upd,
                           total=t_fwd + t_bwd + t_upd),
        profiled_steps=steps, profiled_range_host_ms_per_step=ranges,
        device_ms_per_step=dev_us / 1e3 / steps, device_ops_per_step=dev_ops / steps,
        cuda_launch_cpu_ms_per_step=launch_us / 1e3 / steps,
        device_busy_share=dev_us / 1e3 / steps / t_step,
        top_kernels=[dict(name=k[:90], ms_per_step=t / 1e3 / steps, calls_per_step=c / steps)
                     for t, c, k in by_name[:12]])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--profile', action='store_true',
                    help='instead of the checks, print where one n=18 grad step spends its time')
    ap.add_argument('--out', default=None, help='with --profile: also write the JSON here')
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = setup()
    build()
    if args.profile:
        text = json.dumps(profile_training(smi))
        print(text)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text + '\n')
        return 0
    results: dict = {}
    rng, rng_g = np.random.default_rng(SEED), np.random.default_rng(SEED + 1)
    # no_grad, not inference_mode: a tensor made in inference mode and cached
    # would break the autograd-tracked phases below
    with torch.no_grad():
        check_gate_kernels(results, rng, rng_g)
        check_window_kernels(results, rng, rng_g)

    def n18(c):
        if c['window_chain_fwd'] != 2:
            raise AssertionError(f'n=18: window_chain_fwd launched {c["window_chain_fwd"]} times, not 2')

    def n24(c):
        if c['window_apply'] <= 0:
            raise AssertionError('n=24: window_apply was not launched')

    def n22(c):
        if c['planar_apply'] < 5 or c['window_apply'] <= 0:
            raise AssertionError(f'n=22 + cnot(0, 11): launches {c}')

    main_path = {name: 0 for name in KERNELS}

    def add(counts):
        for name, c in counts.items():
            main_path[name] += c

    for n, extra, expect in [(18, None, n18), (24, None, n24), (22, (0, 11), n22)]:
        add(check_slice(n, extra, expect)[0])
    add(check_training()[0])
    for counts in check_step_backward():
        add(counts)
    for name, c in main_path.items():
        if c <= 0:
            raise AssertionError(f'{name} was not launched on the main paths')

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        # library_ms: window_apply has one (a real block matmul, timed in
        # phase 3). The others have no single PyTorch call: a gate on
        # arbitrary wires needs a permute beside its matmul, the reduced
        # planes need two products combined, the chains are loops of steps
        kernels.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                            launches=main_path[name], max_abs_err=r['max_abs_err'],
                            rel_err=r['rel_err'], plane_rel_err=r['plane_rel_err'], ms=r['ms'],
                            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                            bound_by=r['bound_by'], library_ms=r.get('library_ms'),
                            shape=r['shape']))
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
