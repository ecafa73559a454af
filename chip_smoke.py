#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card (nvidia-smi name and power limit), torch and
   CUDA versions;
2. build the CUDA kernels from deepquantum_tpu_torch/csrc and print the
   build time;
3. hold each kernel against its plain PyTorch twin on the card (float32,
   unnormalised randn states from a fixed seed; error = max|d| / max|ref|):
   planar_apply at n=22 on eight wire sets (<= 1e-6), window_apply at n=24
   with a random unitary (<= 1e-6), window_chain_fwd at n=18 on the bench
   ansatz's scheduled sequence (<= 1e-5), with their times;
4. the serving slice at n=18, 5 layers: the bench ansatz (rx/rz/rx per
   wire plus a CNOT ring, X string on all wires) through the public
   QubitCircuit API on cuda at complex64 with params from init_para(seed):
   state and <X...X> against the port's complex128 einsum route on the card
   (<= 1e-5), window_chain_fwd launched exactly twice (forward + observable),
   and the median forward + expectation time on the kernel route and on the
   twin route;
5. the same at n=24 (window_apply route) and at n=22 with one extra
   cnot(0, 11) per layer (planar_apply >= 5 launches, window_apply > 0);
6. print the kernels' JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Nothing of JAX is imported.
"""

from __future__ import annotations

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

KERNELS = {   # wrapper -> (source, TPU kernel it replaces)
    'planar_apply': ('deepquantum_tpu_torch/csrc/planar_apply.cu',
                     'deepquantum_tpu/ops/planar_gate.py:412'),
    'window_apply': ('deepquantum_tpu_torch/csrc/window_apply.cu',
                     'deepquantum_tpu/ops/window_gate.py:92'),
    'window_chain_fwd': ('deepquantum_tpu_torch/csrc/window_chain.cu',
                         'deepquantum_tpu/ops/chain_kernel.py:294'),
}


def _pkg():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import deepquantum_tpu_torch as dqt
    from deepquantum_tpu_torch.ops import chain_kernel, planar_gate, window_gate
    return dqt, planar_gate, window_gate, chain_kernel


def _wrappers():
    _, pg, wg, ck = _pkg()
    return {'planar_apply': pg.planar_apply, 'window_apply': wg.window_apply,
            'window_chain_fwd': ck.window_chain_fwd}


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


@contextlib.contextmanager
def twin_route():
    """Run the planar engine's steps through the plain twins on the card
    (the same in-place contract as the kernel wrappers)."""
    _, pg, wg, ck = _pkg()

    def planar(x, mre, mim, n, wires):
        x.copy_(pg.planar_evolve_xla(x, mre, mim, n, wires))
        return x

    def window(x, mre, mim, n, w):
        x.copy_(wg.window_apply_plain(x, mre, mim, n, w))
        return x

    saved = pg.planar_apply, wg.window_apply, ck.window_chain_fwd
    pg.planar_apply, wg.window_apply, ck.window_chain_fwd = planar, window, ck.window_chain_plain
    try:
        yield
    finally:
        pg.planar_apply, wg.window_apply, ck.window_chain_fwd = saved


def bench_circuit(n: int, device, extra_cnot=None):
    """The bench ansatz: LAYERS x (rx, rz, rx on every wire; CNOT ring),
    optionally one more cnot per layer; X string on all wires."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(n, device=device)
    for _ in range(LAYERS):
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
    _pkg()[0].set_dtype('complex64')
    return smi


def build():
    from deepquantum_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    print(f'build: {time.perf_counter() - t0:.1f} s -> {path.relative_to(ROOT)}')
    for line in _cuda.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line.lower():
            print(f'  nvcc: {line.strip()}')


def check_kernels(results: dict):
    """Phase 3: every kernel against its twin on the card."""
    import torch
    _, pg, wg, ck = _pkg()
    dev = torch.device('cuda')
    rng = np.random.default_rng(SEED)

    n = 22
    x = _randn_state(n, rng, dev)
    errs, abs_errs, t_k, t_p = [], [], [], []
    for wires in [(0,), (21,), (10,), (0, 1), (3, 17), (20, 21), (0, 10, 21), (5, 6, 7)]:
        mre, mim = _planes(_haar(1 << len(wires), rng), dev)
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), mre, mim, n, wires)
        torch.cuda.synchronize()
        e, d = rel_err(y, ref)
        work = x.clone()
        tk, _ = time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
        tp, _ = time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))
        print(f'planar_apply n={n} wires={wires}: rel err {e:.2e}, kernel {tk:.4f} ms, '
              f'twin {tp:.4f} ms')
        if not e <= 1e-6:
            raise AssertionError(f'planar_apply wires={wires}: rel err {e} > 1e-6')
        errs.append(e)
        abs_errs.append(d)
        t_k.append(tk)
        t_p.append(tp)
    results['planar_apply'] = dict(max_abs_err=max(abs_errs), rel_err=max(errs),
                                   ms=float(np.mean(t_k)), plain_ms=float(np.mean(t_p)),
                                   shape=f'n={n}, mean over 8 wire sets')

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
    print(f'window_apply n={n}: rel err {e:.2e}, kernel {tk:.4f} ms, twin {tp:.4f} ms')
    if not e <= 1e-6:
        raise AssertionError(f'window_apply: rel err {e} > 1e-6')
    results['window_apply'] = dict(max_abs_err=d, rel_err=e, ms=tk, plain_ms=tp, shape=f'n={n}')

    n = 18
    cir = bench_circuit(n, dev)
    with torch.inference_mode():
        mres, mims, wseq = cir._planar_seq(cir._full_params())
    if not ck.chain_fused_ok(wseq, n, mres):
        raise AssertionError('the n=18 bench sequence does not qualify for window_chain_fwd')
    n_win = sum(1 for s in wseq if s[0] == 'win')
    x = _randn_state(n, rng, dev)
    ref = ck.window_chain_plain(x, mres, mims, n, wseq)
    y = ck.window_chain_fwd(x, mres, mims, n, wseq)
    torch.cuda.synchronize()
    e, d = rel_err(y, ref)
    tk, _ = time_ms(lambda: ck.window_chain_fwd(x, mres, mims, n, wseq))
    tp, _ = time_ms(lambda: ck.window_chain_plain(x, mres, mims, n, wseq))
    print(f'window_chain_fwd n={n} ({n_win} win + {len(wseq) - n_win} rot steps): rel err {e:.2e}, '
          f'kernel {tk:.4f} ms, twin {tp:.4f} ms')
    if not e <= 1e-5:
        raise AssertionError(f'window_chain_fwd: rel err {e} > 1e-5')
    results['window_chain_fwd'] = dict(max_abs_err=d, rel_err=e, ms=tk, plain_ms=tp,
                                       shape=f'n={n}, {len(wseq)} steps')


def check_slice(n: int, extra_cnot, expect):
    """Phases 4-5: forward + expectation through the public API on cuda.
    ``expect(counts)`` checks the kernel launch counts of one run."""
    import torch
    dqt = _pkg()[0]
    dev = torch.device('cuda')
    label = f'n={n}' + (f' + cnot{extra_cnot}/layer' if extra_cnot else '')
    dqt.set_dtype('complex64')
    cir = bench_circuit(n, dev, extra_cnot)
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
        ref_cir = bench_circuit(n, dev, extra_cnot)
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


def main() -> int:
    import torch
    smi = setup()
    build()
    results: dict = {}
    with torch.inference_mode():
        check_kernels(results)

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
    for n, extra, expect in [(18, None, n18), (24, None, n24), (22, (0, 11), n22)]:
        counts, _, _ = check_slice(n, extra, expect)
        for name, c in counts.items():
            main_path[name] += c
    for name, c in main_path.items():
        if c <= 0:
            raise AssertionError(f'{name} was not launched on the main path')

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                            launches=main_path[name], max_abs_err=r['max_abs_err'],
                            rel_err=r['rel_err'], ms=r['ms'], plain_ms=r['plain_ms'],
                            shape=r['shape']))
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
