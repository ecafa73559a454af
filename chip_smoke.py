#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --profile [--out FILE]   # where a grad step's, a batched
                                                   # QML step's and a photonic
                                                   # call's time goes

Phases (each raises on failure, so the run exits non-zero):

1. require CUDA; print the card (nvidia-smi name and power limit), torch and
   CUDA versions;
2. build the CUDA kernels from deepquantum_tpu_torch/csrc and print the
   build time;
3. hold each of the nine kernels against its plain PyTorch twin on the card
   (K1-K6: float32, unnormalised randn states from a fixed seed; state error =
   max|d| / max|ref| of the state outputs, plane error the same for the
   reduced cotangent planes), with CUDA-event median times and the least
   time the card could take (bound_ms, from the bytes each call must move
   and the operations it does, against the published peaks):
   planar_apply, planar_grad, planar_bwd_fused at n=22 on eight wire sets
   (states <= 1e-6 / 1e-5, planes <= 1e-5), window_apply at n=24 with a
   random unitary (<= 1e-6; also timed against the one library call that
   computes the same function, a real 256 x 256 block matmul) and at
   n = 12, 13, 16, 20, 24 with a random non-unitary W (<= 1e-6),
   window_chain_fwd and window_chain_bwd at n=18 on the bench ansatz's
   scheduled sequence (states <= 1e-5, dW <= 1e-5; window_chain_bwd also at
   n = 14 and 19, and at n=19 on a grid of 114 SMs where a block walks two
   column tiles; its dW bitwise equal over two launches, its device time
   alone from torch.profiler beside the time through the wrapper).
   window_apply and window_chain_bwd run 3xTF32 on the tensor cores: their
   bound_ms is that route's (495 TFLOP/s); the FP32 bound and K4's barrier
   count from its step table go on a line of their own, as derived
   numbers. K7-K9 compute in float64 and are bounded against the FP64
   rate: permanent_cuda_batch on Haar unitaries at (B, n) =
   (12376, 6), (3, 4), (2, 5), (1000, 14) (<= 1e-10 of the twin, and of a
   numpy Ryser of its own), (1, 20), (4, 20), (1, 22) (<= 1e-8: the terms
   cancel by 1e4 to 1e5; at n=20 also against a long-double numpy Ryser),
   and n=26 once for time and a finite value; tor_dets_cuda and tor_dets_quads_cuda at
   m = 8, 10, 12, 14 on O = I - (I + M M^T)^-1 and on O plus a non-symmetric
   perturbation (per-subset det and quad <= 1e-9 of the twin, the
   torontonian <= 1e-6, or 1e-15 times its cancellation where that is
   more), tor_dets_cuda also timed against torch.linalg.det
   on the pre-gathered stacks. The batched forms of K1, K5, K6 (rows
   planar_apply_batched, planar_grad_batched, planar_bwd_fused_batched) on
   (B, 2, 2^n) stacks with per-sample planes at (n, B) = (14, 100) and
   (20, 8), k = 1, 2, 3 (states <= 1e-6, K6 1e-5, planes <= 1e-5), K1 also
   with one set of planes for every sample. K4 under depth: n=18 with 10
   and 20 layers against the twin (bars 1e-5) and both against the twin in
   float64; the verdict is printed and recorded, not a stop (the main paths
   walk 5 layers, held at the bar above);
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
   the median grad step on the kernel route and on the twin route;
7b. the batched QML step (benchmarks/bench_suite.py::bench_batched_qml):
   QubitCircuit(14, reupload=True), 2 layers of ry(encode), rz, ry per
   wire and a CNOT ring, Z on wire 0; data (100, 14) from default_rng(0);
   a step = expectation(data=feats, params=p) (100, 1), its mean, backward,
   SGD. Plain (feats = data) and hybrid (feats = data @ W + b): loss and
   gradients (p; W, b) against the complex128 route (<= 1e-5, <= 1e-4);
   per step batched planar_apply and planar_grad launched, no window or
   chain kernel; with fused_bwd batched planar_bwd_fused instead of
   planar_grad, gradients <= 1e-5 from the default; three SGD steps on the
   kernel and twin routes (<= 1e-5 apart); medians on both routes and the
   device's busy share from a profiler window;
8. boson sampling at complex128: Clements(12 modes, 6 photons) with seeded
   angles gives 12376 probabilities from ONE permanent_cuda_batch launch
   (sum 1 within 1e-6, twin route within 1e-8), then get_amplitude of the
   all-ones outcome of a 20-mode, 20-photon mesh (one 20 x 20 permanent);
9. Gaussian boson sampling with click detectors at complex128:
   GaussianBosonSampling(10 modes, threshold) gives 1024 click-pattern
   probabilities, the 968 patterns of >= 3 clicks through tor_dets_cuda
   (sum 1 within 1e-6, twin route within 1e-8); with a displacement on two
   modes tor_dets_quads_cuda takes them instead; then get_prob of the
   all-click pattern at 14 modes (2m = 28, 16383 subsets that cancel by
   1e11: the routes agree to 1e-3), both ways;
9b. photonic gradients at complex128 (K7-K9 as autograd Functions whose
   backward is the twin's derivative): d P / d squeezing of GBS(10 modes,
   threshold) for three click patterns through tor_dets_cuda (three
   launches), displaced through tor_dets_quads_cuda, and d P / d angles of
   three Clements(12, 6 photons) probabilities through one
   permanent_cuda_batch launch, each <= 1e-8 of the twin route's autograd;
10. print the kernels' JSON line (twelve rows: the nine kernels and the
   three batched forms, each with its launches on the main paths), the
   card line, and last {"ok": true, "device": {...}}.

Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
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
PEAK_FP64_S = 34e12          # float64 outside the tensor cores
PEAK_TF32_S = 495e12         # TF32 on the tensor cores (dense)

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
    'permanent_cuda_batch': ('deepquantum_tpu_torch/csrc/permanent_ryser.cu',
                             'deepquantum_tpu/ops/pallas_kernels.py:228'),
    'tor_dets_cuda': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                      'deepquantum_tpu/photonic/tor_kernel.py:188'),
    'tor_dets_quads_cuda': ('deepquantum_tpu_torch/csrc/tor_lu.cu',
                            'deepquantum_tpu/photonic/tor_kernel.py:230'),
    # the batched forms of K1, K5, K6 ((B, 2, 2^n) stacks, the JAX kernels'
    # leading batch grid axis): the same sources, counted apart
    'planar_apply_batched': ('deepquantum_tpu_torch/csrc/planar_apply.cu',
                             'deepquantum_tpu/ops/planar_gate.py:412'),
    'planar_grad_batched': ('deepquantum_tpu_torch/csrc/planar_grad.cu',
                            'deepquantum_tpu/ops/planar_gate.py:560'),
    'planar_bwd_fused_batched': ('deepquantum_tpu_torch/csrc/planar_bwd_fused.cu',
                                 'deepquantum_tpu/ops/planar_gate.py:687'),
}
BATCHED = {'planar_apply_batched': 'planar_apply', 'planar_grad_batched': 'planar_grad',
           'planar_bwd_fused_batched': 'planar_bwd_fused'}
GATE_WIRE_SETS = [(0,), (21,), (10,), (0, 1), (3, 17), (20, 21), (0, 10, 21), (5, 6, 7)]


def _pkg():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import deepquantum_tpu_torch as dqt
    from deepquantum_tpu_torch.ops import chain_kernel, planar_gate, window_gate
    return dqt, planar_gate, window_gate, chain_kernel


def _photonic():
    _pkg()
    from deepquantum_tpu_torch.ops import permanent_kernel
    from deepquantum_tpu_torch.photonic import qmath, tor_kernel, torontonian_
    return permanent_kernel, qmath, tor_kernel, torontonian_


def _wrappers():
    """Row name -> (wrapper, the attribute its launches count in): a
    batched row reads the same wrapper's ``batched_launches``."""
    _, pg, wg, ck = _pkg()
    pk, _, tk, _ = _photonic()
    fns = {'planar_apply': pg.planar_apply, 'window_apply': wg.window_apply,
           'window_chain_fwd': ck.window_chain_fwd, 'window_chain_bwd': ck.window_chain_bwd,
           'planar_grad': pg.planar_grad, 'planar_bwd_fused': pg.planar_bwd_fused,
           'permanent_cuda_batch': pk.permanent_cuda_batch, 'tor_dets_cuda': tk.tor_dets_cuda,
           'tor_dets_quads_cuda': tk.tor_dets_quads_cuda}
    out = {name: (fn, 'launches') for name, fn in fns.items()}
    out.update({name: (fns[single], 'batched_launches') for name, single in BATCHED.items()})
    return out


def reset_counts():
    for fn, attr in _wrappers().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in _wrappers().items()}


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


def bound(nbytes: float, flops: float, peak: float = PEAK_FP32_S) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations')


def mean_bound(bounds) -> dict:
    ms = float(np.mean([b['bound_ms'] for b in bounds]))
    kinds = {b['bound_by'] for b in bounds}
    if len(kinds) != 1:
        raise AssertionError(f'mixed bounds {kinds} in one mean')
    return dict(bound_ms=ms, bound_by=kinds.pop())


@contextlib.contextmanager
def complex128():
    """The photonic phases run at the complex128 policy (K7-K9 compute in
    float64 either way; the policy sets the type of the circuit's matrices
    and of the values returned)."""
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        yield
    finally:
        dqt.set_dtype('complex64')


@contextlib.contextmanager
def twin_route():
    """Run the planar engine's steps, forward and backward, and the photonic
    sweeps through the plain twins on the card (the same contracts as the
    kernel wrappers)."""
    _, pg, wg, ck = _pkg()
    pk, pq, tk, pt = _photonic()

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
               (pg, 'planar_grad', pg.planar_grad_xla), (pg, 'planar_bwd_fused', bwd_fused),
               (pq, 'permanent_cuda_batch', pk.permanent_plain_batch),
               (pt, 'tor_dets_cuda', tk.tor_dets_plain),
               (pt, 'tor_dets_quads_cuda', tk.tor_dets_quads_plain)]
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


def tf32x3_bounds(nbytes: float, flops: float) -> dict:
    """K2 and K4 run their float32 products as three TF32 products on the
    tensor cores: bound_ms is that route's bound (3 x the operations at the
    TF32 peak, or the bytes), bound_fp32_ms the bound on the FP32 CUDA cores
    that the first designs were held to."""
    fp32 = bound(nbytes, flops)
    tc = bound(nbytes, 3 * flops, PEAK_TF32_S)
    return dict(tc, bound_fp32_ms=fp32['bound_ms'], bound_fp32_by=fp32['bound_by'])


def _shares(r: dict) -> str:
    return (f'bound {r["bound_ms"]:.4f} ms 3xTF32 ({r["bound_by"]}, {r["bound_ms"] / r["ms"]:.0%}), '
            f'{r["bound_fp32_ms"]:.4f} ms FP32 ({r["bound_fp32_by"]}, '
            f'{r["bound_fp32_ms"] / r["ms"]:.0%})')


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


def _kernel_name(mangled: str) -> str:
    """'_ZN..._15_planar_apply_cu_f1d3476e19planar_apply_kernelILi3ELb1EEEv...'
    -> 'planar_apply_kernel<3,1>': the length-prefixed identifier that ends
    in 'kernel', and the integer template arguments."""
    for m in re.finditer(r'(?=(\d+)([A-Za-z_]\w*))', mangled):
        ident = m.group(2)[:int(m.group(1))]
        if len(ident) == int(m.group(1)) and ident.endswith('kernel'):
            args = re.findall(r'L[ib](\d+)E', mangled)
            return ident + (f'<{",".join(args)}>' if args else '')
    return mangled


def build():
    from deepquantum_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    print(f'build: {time.perf_counter() - t0:.1f} s -> {path.relative_to(ROOT)}')
    name, spill = '?', ''
    for line in _cuda.build_log.splitlines():
        if 'Compiling entry function' in line:
            name = _kernel_name(line.split("'")[1])
        elif 'spill' in line:
            spill = line.strip()
        elif 'Used' in line and 'registers' in line:
            print(f'  nvcc: {name}: {line.split(":", 1)[1].strip()}; {spill}')
        elif 'error' in line.lower():
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


BATCH_SHAPES = [(14, 100), (20, 8)]       # (n, B): the QML step's stack, and a wide one
BATCH_WIRES = {14: [(5,), (0, 13), (1, 7, 12)], 20: [(0,), (3, 17), (0, 10, 19)]}


def check_batched_kernels(results: dict, rng):
    """Phase 3, the batched forms of K1, K5, K6 on (B, 2, 2^n) stacks with
    per-sample Haar planes at (n, B) = (14, 100) and (20, 8), k = 1, 2, 3,
    and K1 with one set of planes for every sample (stride 0): states
    <= 1e-6 of max|ref| (K6 1e-5, as the single form), planes <= 1e-5. Their
    own generator, so that the other kernels' inputs stay as they were."""
    import torch
    pg = _pkg()[1]
    dev = torch.device('cuda')
    rows = {name: [] for name in BATCHED}
    for n, b in BATCH_SHAPES:
        stack_bytes = b * 2 * (1 << n) * 4           # one (B, 2, 2^n) float32 stack
        acc = {name: dict(errs=[], abs_errs=[], plane_errs=[], t_k=[], t_p=[], bounds=[])
               for name in BATCHED}
        x = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        g = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)

        def note(name, wires, e, d, pe, tk, tp, bnd):
            a = acc[name]
            for key, v in (('errs', e), ('abs_errs', d), ('plane_errs', pe), ('t_k', tk),
                           ('t_p', tp), ('bounds', bnd)):
                a[key].append(v)
            errs = ', '.join(f'{what} rel err {v:.2e}' for what, v in (('state', e), ('plane', pe))
                             if v is not None)
            print(f'{name} n={n} B={b} wires={wires}: {errs}, kernel {tk:.4f} ms, twin '
                  f'{tp:.4f} ms, bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')

        for wires in BATCH_WIRES[n]:
            k = len(wires)
            flops = b * (1 << (n - k)) * 8 * 4 ** k
            us = np.stack([_haar(1 << k, rng) for _ in range(b)])
            mre = torch.as_tensor(us.real, dtype=torch.float32, device=dev)
            mim = torch.as_tensor(us.imag, dtype=torch.float32, device=dev)
            mre_t, mim_t = mre.transpose(1, 2).contiguous(), (-mim.transpose(1, 2)).contiguous()
            plane_bytes = 2 * b * 4 ** k * 4

            ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
            y = pg.planar_apply(x.clone(), mre, mim, n, wires)
            torch.cuda.synchronize()
            e, d = rel_err(y, ref)
            _hold(f'planar_apply_batched n={n} B={b} wires={wires}', e, 1e-6)
            work = x.clone()
            tk, _ = time_ms(lambda: pg.planar_apply(work, mre, mim, n, wires))
            tp, _ = time_ms(lambda: pg.planar_evolve_xla(x, mre, mim, n, wires))
            note('planar_apply_batched', wires, e, d, None, tk, tp,
                 bound(2 * stack_bytes + plane_bytes, flops))

            ref = pg.planar_grad_xla(g, x, n, wires)
            got = pg.planar_grad(g, x, n, wires)
            torch.cuda.synchronize()
            pe, pd = max(rel_err(a, r) for a, r in zip(got, ref))
            _hold(f'planar_grad_batched n={n} B={b} wires={wires}', pe, PLANE_BAR)
            tk, _ = time_ms(lambda: pg.planar_grad(g, x, n, wires))
            tp, _ = time_ms(lambda: pg.planar_grad_xla(g, x, n, wires))
            note('planar_grad_batched', wires, None, pd, pe, tk, tp,
                 bound(2 * stack_bytes + plane_bytes, flops))

            ref = pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires)
            wy, wg_ = y.clone(), g.clone()
            got = pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires)
            torch.cuda.synchronize()
            if got[0] is not wy or got[1] is not wg_:
                raise AssertionError('planar_bwd_fused must update y and g in place')
            (e, d), (e2, d2) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1])
            e, d = max(e, e2), max(d, d2)
            _hold(f'planar_bwd_fused_batched states n={n} B={b} wires={wires}', e, 1e-5)
            _hold(f'planar_bwd_fused_batched recovers x n={n} B={b} wires={wires}',
                  rel_err(got[0], x)[0], 1e-5)
            pe, pd = max(rel_err(a, r) for a, r in zip(got[2:], ref[2:]))
            _hold(f'planar_bwd_fused_batched planes n={n} B={b} wires={wires}', pe, PLANE_BAR)
            tk, _ = time_ms(lambda: pg.planar_bwd_fused(wy, wg_, mre_t, mim_t, n, wires))
            tp, _ = time_ms(lambda: pg.planar_bwd_fused_plain(y, g, mre_t, mim_t, n, wires))
            note('planar_bwd_fused_batched', wires, e, max(d, pd), pe, tk, tp,
                 bound(4 * stack_bytes + 2 * plane_bytes, 3 * flops))

        # K1 with one set of planes read by every sample (an observable's)
        wires = BATCH_WIRES[n][1]
        u = _haar(4, rng)
        mre, mim = _planes(u, dev)
        shared = (mre.expand(b, 4, 4), mim.expand(b, 4, 4))
        ref = pg.planar_evolve_xla(x, mre, mim, n, wires)
        y = pg.planar_apply(x.clone(), *shared, n, wires)
        torch.cuda.synchronize()
        e_sh, d_sh = rel_err(y, ref)
        _hold(f'planar_apply_batched shared planes n={n} B={b}', e_sh, 1e-6)
        work = x.clone()
        t_sh, _ = time_ms(lambda: pg.planar_apply(work, *shared, n, wires))
        print(f'planar_apply_batched n={n} B={b} wires={wires}, one set of planes for every '
              f'sample: rel err {e_sh:.2e}, kernel {t_sh:.4f} ms')

        for name, a in acc.items():
            states = [v for v in a['errs'] if v is not None]
            planes = [v for v in a['plane_errs'] if v is not None]
            row = dict(max_abs_err=max(a['abs_errs']), rel_err=max(states) if states else None,
                       plane_rel_err=max(planes) if planes else None,
                       ms=float(np.mean(a['t_k'])), plain_ms=float(np.mean(a['t_p'])),
                       shape=f'n={n}, B={b}, mean over k = 1, 2, 3',
                       **mean_bound(a['bounds']))
            if name == 'planar_apply_batched':
                row.update(shared_planes_ms=t_sh, shared_planes_rel_err=e_sh)
                row['max_abs_err'] = max(row['max_abs_err'], d_sh)
            rows[name].append(row)
        del x, g, y, work
    for name, r in rows.items():
        results[name] = dict(r[0], other_shapes=r[1:])


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
    bnd = tf32x3_bounds(2 * 2 * (1 << n) * 4 + 2 * 128 * 128 * 4, cols * win_flops)
    results['window_apply'] = dict(max_abs_err=d, rel_err=e, plane_rel_err=None, ms=tk,
                                   plain_ms=tp, library_ms=tl, shape=f'n={n}', **bnd)
    print(f'window_apply n={n}: rel err {e:.2e}, kernel {tk:.4f} ms, twin {tp:.4f} ms, '
          f'one block matmul {tl:.4f} ms (rel err {e_lib:.2e}, kernel/matmul {tk / tl:.2f}), '
          f'{_shares(results["window_apply"])}')
    _hold('window_apply', e, 1e-6)
    del x, y, ref, work, block
    check_window_apply_sizes(results['window_apply'])

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
    bnd = tf32x3_bounds(4 * state_bytes + 2 * stack_bytes,
                        n_win * (2 * cols * win_flops + dw_flops))
    again = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for dk, dr in zip(got[2:], again[2:]) for a, b in zip(dk, dr)
               if a is not None):
        raise AssertionError('window_chain_bwd: two launches give different dW')
    rows = ck._bwd_rows(ck._step_table(wseq, n, backward=True)[0], n)
    barriers = len(rows) - (rows[-1][0] == 0)
    t_dev = _device_ms(lambda: ck.window_chain_bwd(y, g, mres, mims, n, wseq), 'window_chain_bwd')
    results['window_chain_bwd'] = dict(max_abs_err=max(d, pd), rel_err=e, plane_rel_err=pe, ms=tk,
                                       plain_ms=tp, device_ms=t_dev, table_barriers=barriers,
                                       shape=f'n={n}, {len(wseq)} steps', **bnd)
    print(f'window_chain_bwd n={n} ({steps}; {len(rows)} table rows, so {barriers} grid barriers): '
          f'state rel err {e:.2e}, dW rel err {pe:.2e}, dW bitwise equal over two launches, '
          f'kernel {tk:.4f} ms through the wrapper ({t_dev:.4f} ms device time alone, profiler), '
          f'twin {tp:.4f} ms, {_shares(results["window_chain_bwd"])}')
    for n_other, sms in ((14, None), (19, None), (19, 114)):
        check_chain_bwd_size(n_other, sms)
    results['window_chain_bwd']['depth'] = check_chain_bwd_depth()


def check_window_apply_sizes(row: dict):
    """Phase 3, K2 at n = 12, 13, 16, 20, 24 with a random non-unitary W
    (its own generator, so that the other kernels' inputs stay as they
    were): in place, returns x, one launch each, <= 1e-6 of the twin."""
    import torch
    wg = _pkg()[2]
    dev = torch.device('cuda')
    rng = np.random.default_rng(SEED + 3)
    errs = {}
    for n in (12, 13, 16, 20, 24):
        w = (rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))) / 16
        mre, mim = _planes(w, dev)
        x = _randn_state(n, rng, dev)
        ref = wg.window_apply_plain(x, mre, mim, n, 7)
        before = wg.window_apply.launches
        out = wg.window_apply(x, mre, mim, n, 7)
        torch.cuda.synchronize()
        if out is not x or wg.window_apply.launches != before + 1:
            raise AssertionError(f'window_apply n={n}: not in place, or not one launch')
        errs[n] = rel_err(x, ref)[0]
        print(f'window_apply n={n}, non-unitary W: rel err {errs[n]:.2e}')
    row['non_unitary_rel_err'] = errs
    for n, e in errs.items():
        _hold(f'window_apply n={n}, non-unitary W', e, 1e-6)


def check_chain_bwd_size(n: int, sms=None):
    """Phase 3, K4 at another n on the bench sequence (2 layers; its windows
    and relabels): states and dW <= 1e-5 of the twin. With ``sms`` the grid
    fills that many SMs only (114, an H100 PCIe's count, gives n=19's 128
    column tiles to 114 blocks, so some blocks walk two tiles), and two
    launches must give bitwise-equal results."""
    import torch
    ck = _pkg()[3]
    dev = torch.device('cuda')
    cir = bench_circuit(n, layers=2)
    mres, mims, wseq = cir._planar_seq(cir._full_params())
    keep = [i for i, st in enumerate(wseq) if st[0] in ('win', 'rot')]
    mres, mims, wseq = [mres[i] for i in keep], [mims[i] for i in keep], tuple(wseq[i] for i in keep)
    if not ck.chain_fused_ok(wseq, n, mres):
        raise AssertionError(f'window_chain_bwd n={n}: the sequence does not qualify')
    rng = np.random.default_rng(SEED + 4 + n)
    y = ck.window_chain_plain(_randn_state(n, rng, dev), mres, mims, n, wseq)
    g = _randn_state(n, rng, dev)
    ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
    if sms is None:
        got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
    else:
        if ck._bwd_slots(n, sms) <= sms:
            raise AssertionError(f'window_chain_bwd n={n} on {sms} SMs: no block walks two tiles')
        got = ck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        again = ck._window_chain_bwd_cuda(y, g, mres, mims, n, wseq, sms=sms)
        if not all(torch.equal(a, b) for a, b in zip(got[:2] + tuple(got[2] + got[3]),
                                                      again[:2] + tuple(again[2] + again[3]))
                   if a is not None):
            raise AssertionError(f'window_chain_bwd n={n} on {sms} SMs: two launches differ')
    torch.cuda.synchronize()
    e = max(rel_err(got[0], ref[0])[0], rel_err(got[1], ref[1])[0])
    pe = max(rel_err(a, b)[0] for dk, dr in zip(got[2:], ref[2:]) for a, b in zip(dk, dr)
             if b is not None)
    where = '' if sms is None else (f' on {sms} SMs, {ck._bwd_slots(n, sms)} column tiles, '
                                    'bitwise equal over two launches')
    _hold(f'window_chain_bwd n={n}{where} states', e, 1e-5)
    _hold(f'window_chain_bwd n={n}{where} dW', pe, PLANE_BAR)
    print(f'window_chain_bwd n={n} ({len(wseq)} steps{where}): state rel err {e:.2e}, '
          f'dW rel err {pe:.2e}')


def check_chain_bwd_depth(n: int = 18, layer_counts=(10, 20)):
    """Phase 3, K4 under depth: the bench ansatz's window sequence at n=18
    with 10 and 20 layers, its states and dW against the twin (bars 1e-5),
    and both against the twin in float64, which tells the kernel's share of
    the difference from the twin's. The verdict against the bar is printed
    and recorded in the kernels' JSON line; it does not stop the run, since
    the main paths never walk this deep (5 layers, held above at the bar).
    Non-finite output stops it."""
    import torch
    ck = _pkg()[3]
    dev = torch.device('cuda')
    rows = []
    for layers in layer_counts:
        cir = bench_circuit(n, layers=layers)
        mres, mims, wseq = cir._planar_seq(cir._full_params())
        keep = [i for i, st in enumerate(wseq) if st[0] in ('win', 'rot')]
        mres, mims = [mres[i] for i in keep], [mims[i] for i in keep]
        wseq = tuple(wseq[i] for i in keep)
        if not ck.chain_fused_ok(wseq, n, mres):
            raise AssertionError(f'window_chain_bwd n={n}, {layers} layers: does not qualify')
        n_win = sum(1 for st in wseq if st[0] == 'win')
        rng = np.random.default_rng(SEED + 40 + layers)
        y = ck.window_chain_plain(_randn_state(n, rng, dev), mres, mims, n, wseq)
        g = _randn_state(n, rng, dev)
        got = ck.window_chain_bwd(y, g, mres, mims, n, wseq)
        ref = ck.window_chain_bwd_plain(y, g, mres, mims, n, wseq)
        d64 = [[None if m is None else m.double() for m in ms] for ms in (mres, mims)]
        exact = ck.window_chain_bwd_plain(y.double(), g.double(), *d64, n, wseq)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in got[:2]):
            raise AssertionError(f'window_chain_bwd n={n}, {layers} layers: non-finite output')

        def errs(a, b):
            st = max(rel_err(a[0].double(), b[0].double())[0],
                     rel_err(a[1].double(), b[1].double())[0])
            dw = max(rel_err(p.double(), q.double())[0] for dk, dr in zip(a[2:], b[2:])
                     for p, q in zip(dk, dr) if q is not None)
            return st, dw

        (e, pe), (ke, kpe), (te, tpe) = errs(got, ref), errs(got, exact), errs(ref, exact)
        holds = e <= 1e-5 and pe <= PLANE_BAR
        print(f'window_chain_bwd n={n}, {layers} layers ({len(wseq)} steps, {n_win} windows): '
              f'against the twin states {e:.2e}, dW {pe:.2e} (bars 1e-5, {PLANE_BAR:.0e}: '
              f'{"holds" if holds else "FAILS"}); against the float64 twin: kernel {ke:.2e} / '
              f'{kpe:.2e}, float32 twin {te:.2e} / {tpe:.2e}')
        rows.append(dict(layers=layers, windows=n_win, state_rel_err=e, dw_rel_err=pe,
                         holds_bar=holds, kernel_vs_float64=[ke, kpe],
                         twin_vs_float64=[te, tpe]))
    return rows


def _device_ms(fn, name: str, calls: int = 5) -> float:
    """Device time per call of the kernels whose name holds ``name``, from
    one torch.profiler window of ``calls`` calls after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = sum(k['ms_per_step'] for k in _device_profile(fn, calls)['top_kernels']
             if name in k['name'])
    if ms <= 0:
        raise AssertionError(f'the profiler saw no device time of {name}')
    return ms


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
    cir = bench_circuit(n, None, extra_cnot, layers)
    p = cir.params.requires_grad_()
    reset_counts()
    with twin_route():
        t_twin, _ = time_ms(lambda: grad_step(cir, p), reps=reps, warmup=1)
    if sum(read_counts().values()) != 0:
        raise AssertionError('the twin route launched a kernel')
    print(f'backward {label}: grad step median over {reps}: kernel route {out[False][2]:.3f} ms, '
          f'twin route {t_twin:.3f} ms')
    return c_def, c_fus


# ------------------------------------------------------------ batched QML
QML_N, QML_LAYERS, QML_B = 14, 2, 100     # bench_suite.py::bench_batched_qml


def qml_circuit(device=None):
    """bench_batched_qml's circuit (benchmarks/bench_suite.py:693-755):
    QML_LAYERS x (ry(encode) on every wire; rz, ry on every wire; CNOT
    ring), observable Z on wire 0, reupload: the 14 features of a sample
    wrap around the 28 encoders. With no device it lands on the card."""
    dqt = _pkg()[0]
    cir = dqt.QubitCircuit(QML_N, device=device, reupload=True)
    for _ in range(QML_LAYERS):
        for i in range(QML_N):
            cir.ry(i, encode=True)
        for i in range(QML_N):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0)
    cir.init_para(SEED)
    return cir


def qml_inputs(device):
    """The benchmark's data, (100, 14) float32 from default_rng(0), and the
    hybrid variant's linear layer W (14 x 14) and b from default_rng(SEED)."""
    import torch
    data = np.random.default_rng(0).random((QML_B, QML_N)).astype(np.float32)
    rng = np.random.default_rng(SEED)
    w = rng.normal(0, 0.5, (QML_N, QML_N)).astype(np.float32)
    b = rng.normal(0, 0.1, QML_N).astype(np.float32)
    return [torch.as_tensor(a, device=device) for a in (data, w, b)]


def qml_step(cir, leaves, hybrid: bool, update: bool = True):
    """One data-encoded training step: expectation(data=feats, params=p) of
    shape (B, 1), the mean as the loss, backward, and with ``update`` the SGD
    update of every leaf in place. leaves = [p, data, W, b]; the hybrid
    variant feeds feats = data @ W + b, so the gradient also reaches W and b.
    Returns (loss, gradients of the leaves that train)."""
    import torch
    p, data, w, b = leaves
    feats = data @ w + b if hybrid else data
    out = cir.expectation(data=feats, params=p)
    if tuple(out.shape) != (data.shape[0], 1):
        raise AssertionError(f'batched expectation of shape {tuple(out.shape)}')
    loss = out.mean()
    loss.backward()
    train = [p, w, b] if hybrid else [p]
    grads = []
    for t in train:
        grads.append(t.grad)
        t.grad = None
    if update:
        with torch.no_grad():
            for t, gr in zip(train, grads):
                t -= LR * gr
    return loss.detach(), grads


def _qml_leaves(cir, device, hybrid: bool):
    dqt = _pkg()[0]
    data, w, b = qml_inputs(device)
    p = cir.params.to(dqt.rdtype()).requires_grad_()
    if hybrid:
        w, b = w.to(dqt.rdtype()).requires_grad_(), b.to(dqt.rdtype()).requires_grad_()
    return [p, data.to(dqt.rdtype()), w.to(dqt.rdtype()), b.to(dqt.rdtype())]


def _qml_reference(hybrid: bool, sgd_steps: int = 3):
    """Loss and gradients on the port's complex128 einsum route on the
    card, then the losses of ``sgd_steps`` SGD steps."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex128')
    try:
        cir = qml_circuit('cuda')
        if cir._planar_ok():
            raise AssertionError('the complex128 reference must take the einsum route')
        leaves = _qml_leaves(cir, 'cuda', hybrid)
        loss, grads = qml_step(cir, leaves, hybrid, update=False)
        losses = [qml_step(cir, leaves, hybrid)[0].item() for _ in range(sgd_steps)]
        with torch.no_grad():
            losses.append(qml_step_loss(cir, leaves, hybrid))
        torch.cuda.synchronize()
        return loss.item(), grads, losses
    finally:
        dqt.set_dtype('complex64')


def qml_step_loss(cir, leaves, hybrid: bool) -> float:
    p, data, w, b = leaves
    return cir.expectation(data=data @ w + b if hybrid else data, params=p).mean().item()


def check_batched_qml(card: str, reps: int = 10):
    """The batched QML slice: bench_batched_qml's circuit at n=14, 2 layers,
    B=100 through the public API on the card, plain and hybrid. Per step
    batched planar_apply and planar_grad launched (planar_bwd_fused with
    fused_bwd, and then no planar_grad), no window or chain kernel; loss and
    gradients against the complex128 route (<= 1e-5, <= 1e-4), fused against
    default (<= 1e-5), three SGD steps on the kernel and twin routes (losses
    <= 1e-5 apart after each); the median step on both routes and the
    device's busy share in a profiler window."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    no_window = ('window_apply', 'window_chain_fwd', 'window_chain_bwd')
    main_counts, out = {name: 0 for name in KERNELS}, {}
    for hybrid in (False, True):
        label = f'batched QML n={QML_N}, {QML_LAYERS} layers, B={QML_B}' + \
            (', hybrid' if hybrid else '')
        ref_loss, ref_grads, ref_losses = _qml_reference(hybrid)
        grads_by_route = {}
        for fused in (False, True):
            cir = qml_circuit()
            cir.fused_bwd = fused
            if cir.device.type != 'cuda' or not cir._planar_ok():
                raise AssertionError(f'{label}: device {cir.device}, planar {cir._planar_ok()}')
            leaves = _qml_leaves(cir, cir.device, hybrid)
            reset_counts()
            loss, grads = qml_step(cir, leaves, hybrid, update=False)
            torch.cuda.synchronize()
            counts = read_counts()
            d_loss = abs(loss.item() - ref_loss)
            d_grad = max((a.double() - r).abs().max().item() for a, r in zip(grads, ref_grads))
            print(f'{label}, fused_bwd={fused}: launches {counts}, loss {loss.item():.8f} '
                  f'(complex128 {ref_loss:.8f}), |d loss| {d_loss:.2e}, max|d grad| {d_grad:.2e} '
                  f'over {"p, W, b" if hybrid else "p"}')
            if any(counts[k] for k in no_window):
                raise AssertionError(f'{label}: a window or chain kernel was launched')
            if counts['planar_apply_batched'] < 1:
                raise AssertionError(f'{label}: batched planar_apply was not launched')
            if fused and (counts['planar_bwd_fused_batched'] < 1
                          or counts['planar_grad_batched'] != 0):
                raise AssertionError(f'{label}, fused_bwd: launches {counts}')
            if not fused and (counts['planar_grad_batched'] < 1
                              or counts['planar_bwd_fused_batched'] != 0):
                raise AssertionError(f'{label}: launches {counts}')
            if not (d_loss <= 1e-5 and d_grad <= 1e-4):
                raise AssertionError(f'{label}, fused_bwd={fused}: differs from complex128')
            grads_by_route[fused] = grads
            for name, c in counts.items():
                main_counts[name] += c
        d = max((a - b).abs().max().item() for a, b in zip(*grads_by_route.values()))
        print(f'{label}: default vs fused_bwd max|d grad| {d:.2e}')
        if not d <= 1e-5:
            raise AssertionError(f'{label}: default and fused gradients differ by {d}')

        cir = qml_circuit()
        leaves = _qml_leaves(cir, cir.device, hybrid)
        losses = [qml_step(cir, leaves, hybrid)[0].item() for _ in range(3)]
        with torch.no_grad():
            losses.append(qml_step_loss(cir, leaves, hybrid))
        reset_counts()
        with twin_route():
            twin_leaves = _qml_leaves(cir, cir.device, hybrid)
            twin = [qml_step(cir, twin_leaves, hybrid)[0].item() for _ in range(3)]
            with torch.no_grad():
                twin.append(qml_step_loss(cir, twin_leaves, hybrid))
        if sum(read_counts().values()) != 0:
            raise AssertionError('the twin route launched a kernel')
        d_twin = max(abs(a - b) for a, b in zip(losses, twin))
        d_ref = max(abs(a - b) for a, b in zip(losses, ref_losses))
        print(f'{label}: 3 SGD steps, losses {[round(v, 8) for v in losses]}, max |d| to the twin '
              f'route {d_twin:.2e}, to complex128 {d_ref:.2e}')
        if not (d_twin <= 1e-5 and d_ref <= 1e-5):
            raise AssertionError(f'{label}: the SGD losses drift between routes')

        leaves = _qml_leaves(cir, cir.device, hybrid)
        t_kernel, _ = time_ms(lambda: qml_step(cir, leaves, hybrid), reps=reps, warmup=2)
        dev = _device_profile(lambda: qml_step(cir, leaves, hybrid), 3)
        with twin_route():
            leaves = _qml_leaves(cir, cir.device, hybrid)
            t_twin, _ = time_ms(lambda: qml_step(cir, leaves, hybrid), reps=reps, warmup=2)
        busy = dev['device_ms_per_step'] / t_kernel
        print(f'{label}: step median over {reps}: kernel route {t_kernel:.3f} ms, twin route '
              f'{t_twin:.3f} ms; device {dev["device_ms_per_step"]:.3f} ms per step '
              f'({dev["device_ops_per_step"]:.0f} device ops, busy {busy:.1%}), top '
              f'{[(k["name"][:40], round(k["ms_per_step"], 4)) for k in dev["top_kernels"][:4]]} '
              f'[{card}]')
        out['hybrid' if hybrid else 'plain'] = dict(step_ms=t_kernel, twin_step_ms=t_twin,
                                                   device_busy_share=busy)
    return main_counts, out


# ------------------------------------------------------ photonic gradients
def _rel_close(name: str, got, ref, bar: float) -> float:
    e = ((got - ref).abs().max() / ref.abs().max()).item()
    if not e <= bar:
        raise AssertionError(f'{name}: kernel and twin route gradients differ by {e} > {bar}')
    return e


def check_photonic_gradients(card: str, rng):
    """d P / d squeezing of GBS(10 modes, threshold) for a few click
    patterns through K8 (K9 with a displacement), and d P / d angles of
    Clements(12 modes, 6 photons) probabilities through K7, each against the
    twin route's autograd (relative error <= 1e-8), at complex128."""
    import torch
    dqt = _pkg()[0]
    counts = {name: 0 for name in KERNELS}
    patterns = [[1, 1, 0, 1, 0, 0, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                [0, 1, 0, 1, 0, 1, 0, 1, 0, 1]]
    with complex128():
        sq, u = rng.uniform(0.2, 0.6, GBS_MODES), _haar(GBS_MODES, rng)
        for displaced, hot in ((False, 'tor_dets_cuda'), (True, 'tor_dets_quads_cuda')):
            cir = dqt.photonic.GaussianBosonSampling(GBS_MODES, sq, u, detector='threshold')
            if displaced:
                cir.d(0, 0.3, 0.4)
                cir.d(GBS_MODES // 2, 0.2, 1.0)
            # the squeezing magnitudes as the trainable parameters
            cir._train_mask = [False] * len(cir._pvals)
            for op in cir.operators[:GBS_MODES]:
                cir._train_mask[op.pidx[0]] = True

            def grad():
                p = cir.params.requires_grad_()
                cir(params=p)
                loss = sum(cir.get_prob(pat) for pat in patterns)
                loss.backward()
                return loss.item(), p.grad

            reset_counts()
            loss, g = grad()
            torch.cuda.synchronize()
            c = read_counts()
            with twin_route():
                ref_loss, ref = grad()
            e = _rel_close(f'GBS d P / d squeezing{", displaced" if displaced else ""}', g, ref,
                           1e-8)
            print(f'GBS {GBS_MODES} modes, threshold{", displaced" if displaced else ""}: '
                  f'd P / d squeezing of {len(patterns)} patterns (P {loss:.6e}), launches '
                  f'{ {k: v for k, v in c.items() if v} }, rel err to the twin route {e:.2e}')
            if c[hot] != len(patterns) or abs(loss - ref_loss) > 1e-8 * abs(ref_loss):
                raise AssertionError(f'GBS gradient: expected {len(patterns)} launches of {hot}')
            for name, v in c.items():
                counts[name] += v

        nmode, nphoton = BS_MODES, BS_PHOTONS
        cir = dqt.photonic.Clements(nmode, init_state=[1] * nphoton + [0] * (nmode - nphoton),
                                    cutoff=nphoton + 1)
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        keys = [dqt.photonic.FockState([1] * nphoton + [0] * (nmode - nphoton)),
                dqt.photonic.FockState([0, 1] * nphoton),
                dqt.photonic.FockState([2, 0, 0, 1, 1, 0, 0, 1, 0, 1, 0, 0])]

        def grad():
            d = torch.tensor(angles, device='cuda', requires_grad=True)
            probs = cir(data=d, is_prob=True)
            sum(probs[k] for k in keys).backward()
            return d.grad

        reset_counts()
        g = grad()
        torch.cuda.synchronize()
        c = read_counts()
        with twin_route():
            ref = grad()
        e = _rel_close('Clements d P / d angles', g, ref, 1e-8)
        print(f'boson sampling {nmode} modes, {nphoton} photons: d P / d angles ({cir.ndata} '
              f'angles, {len(keys)} outcomes), launches {c["permanent_cuda_batch"]} of '
              f'permanent_cuda_batch, rel err to the twin route {e:.2e} [{card}]')
        if c['permanent_cuda_batch'] != 1:
            raise AssertionError('Clements gradient: expected one permanent launch')
        for name, v in c.items():
            counts[name] += v
    return counts


# ---------------------------------------------------------------- photonic
def _ryser_numpy(a: np.ndarray, dtype=np.complex128) -> complex:
    """Ryser permanent of one matrix in numpy, by doubling: the column sums
    of the subsets of the first i + 1 rows are those of the first i rows,
    and those plus row i. With ``np.clongdouble`` (64-bit mantissa on x86)
    it is the yardstick for the float64 sweeps at n = 20."""
    n = a.shape[0]
    a = a.astype(dtype)
    sums = np.zeros((1, n), dtype)
    signs = np.ones(1, dtype)
    for i in range(n):
        sums = np.concatenate([sums, sums + a[i]])
        signs = np.concatenate([signs, -signs])
    return complex((-1) ** n * np.sum(signs * np.prod(sums, axis=1)))


def _perm_bar(n: int) -> float:
    """Kernel against twin, both float64 sweeps in different orders. A term
    (a product of n column sums) carries about n * 2^-53 of its own size, and
    the 2^n terms cancel down to a permanent some 1e4 (n = 20) to 1e5
    (n = 22) times smaller than their typical size: the card reads 1e-12 at
    n = 14, 6e-11 at n = 20 and 4e-10 at n = 22."""
    return 1e-10 if n <= 14 else 1e-8


BS_MODES, BS_PHOTONS = 12, 6      # path (a): C(17, 6) = 12376 outcomes
BS_BIG = 20                       # get_amplitude: one 20 x 20 permanent
GBS_MODES, GBS_BIG = 10, 14       # path (b): 1024 patterns; the kernel's limit 2m = 28
TOR_MODES = (14, 8, 10, 12)       # m = 14 first: the shape get_prob gives at 14 modes
PERM_SHAPES = [   # (B, n, input type); the first two are what path (a) gives the kernel
    (12376, 6, 'complex128'), (1, 20, 'complex128'), (3, 4, 'complex128'), (2, 5, 'complex64'),
    (1000, 14, 'complex64'), (4, 20, 'complex64'), (1, 22, 'complex128'),
    (1, 26, 'complex128')]        # n = 26: too slow for the twin, time and a finite value only


def check_permanent_kernel(results: dict, rng):
    """Phase 3, K7 on Haar unitaries, against its twin and a numpy Ryser."""
    import torch
    pk = _photonic()[0]
    dev = torch.device('cuda')
    rows = []
    for b, n, dtype in PERM_SHAPES:
        mats = torch.as_tensor(np.stack([_haar(n, rng) for _ in range(b)]), device=dev).to(
            getattr(torch, dtype))
        got = pk.permanent_cuda_batch(mats)
        torch.cuda.synchronize()
        if got.dtype != torch.complex128 or tuple(got.shape) != (b,):
            raise AssertionError(f'permanent (B={b}, n={n}): {got.dtype} {tuple(got.shape)}')
        tk_ms, _ = time_ms(lambda: pk.permanent_cuda_batch(mats), reps=10 if n >= 22 else REPS)
        # n complex adds and n complex multiplies per subset (Gray-code Ryser)
        bnd = bound(mats.numel() * mats.element_size() + b * 16, b * (1 << n) * 8 * n, PEAK_FP64_S)
        if n > 22:
            if not torch.isfinite(torch.view_as_real(got)).all():
                raise AssertionError(f'permanent n={n}: non-finite')
            print(f'permanent_cuda_batch B={b} n={n} {dtype}: value {complex(got[0]):.6e}, '
                  f'kernel {tk_ms:.4f} ms, bound {bnd["bound_ms"]:.4f} ms ({bnd["bound_by"]})')
            rows.append(dict(shape=f'B={b}, n={n}, {dtype}', ms=tk_ms, **bnd))
            continue
        ref = pk.permanent_plain_batch(mats)
        e, d = rel_err(got, ref)
        _hold(f'permanent_cuda_batch B={b} n={n}', e, _perm_bar(n))
        e_np = None
        if n <= 14 or (b, n) == (1, 20):
            host = mats[:8].cpu().numpy().astype(np.complex128)
            oracle = np.array([_ryser_numpy(m, np.complex128 if n <= 14 else np.clongdouble)
                               for m in host])
            e_np = float(np.abs(got[:8].cpu().numpy() - oracle).max() / np.abs(oracle).max())
            _hold(f'permanent_cuda_batch B={b} n={n} against numpy', e_np, _perm_bar(n))
            if n == 20:
                e_twin = float(np.abs(ref.cpu().numpy() - oracle).max() / np.abs(oracle).max())
                print(f'permanent n=20 against a long-double numpy Ryser: kernel {e_np:.2e}, '
                      f'twin {e_twin:.2e}')
        tp_ms, _ = time_ms(lambda: pk.permanent_plain_batch(mats), reps=5, warmup=1)
        print(f'permanent_cuda_batch B={b} n={n} {dtype}: rel err {e:.2e}'
              + (f' (numpy Ryser {e_np:.2e})' if e_np is not None else '')
              + f', kernel {tk_ms:.4f} ms, twin {tp_ms:.4f} ms, bound {bnd["bound_ms"]:.5f} ms '
              f'({bnd["bound_by"]})')
        rows.append(dict(shape=f'B={b}, n={n}, {dtype}', ms=tk_ms, plain_ms=tp_ms, rel_err=e,
                         max_abs_err=d, **bnd))
    # no single PyTorch call computes a permanent: library_ms stays null
    results['permanent_cuda_batch'] = dict(rows[0], plane_rel_err=None, other_shapes=rows[1:])


def _tor_inputs(m: int, rng, perturb: bool):
    """O = I - (I + M M^T)^-1 (symmetric), optionally plus a small
    non-symmetric complex perturbation, and gamma with gamma[m:] =
    conj(gamma[:m])."""
    mm = rng.standard_normal((2 * m, 2 * m)) * 0.1
    o = (np.eye(2 * m) - np.linalg.inv(np.eye(2 * m) + mm @ mm.T)).astype(np.complex128)
    if perturb:
        o = o + 0.01 * (rng.standard_normal((2 * m, 2 * m))
                        + 1j * rng.standard_normal((2 * m, 2 * m)))
    gam = rng.standard_normal(2 * m) * 0.1 + 0.05j * rng.standard_normal(2 * m)
    gam[m:] = np.conj(gam[:m])
    return o, gam


def check_tor_kernels(results: dict, rng):
    """Phase 3, K8 and K9 against their twins; K8 also against the library's
    batched determinant on stacks gathered beforehand."""
    import torch
    from math import comb
    _, _, tk, pt = _photonic()
    dev = torch.device('cuda')
    rows8, rows9 = [], []
    for m in TOR_MODES:
        idx, valid, sign = pt._padded_tor_indices(m, dev)
        nsub = idx.shape[0]
        lu_flops = sum(comb(m, r) * 8 * (2 * r) ** 3 / 3 for r in range(1, m + 1))
        solve_flops = sum(comb(m, r) * 8 * (2 * r) ** 2 for r in range(1, m + 1))
        scaffold_bytes = idx.numel() * 8 + valid.numel() * 4
        for perturb in (False, True):
            o_np, g_np = _tor_inputs(m, rng, perturb)
            o, g = torch.as_tensor(o_np, device=dev), torch.as_tensor(g_np, device=dev)
            label = f'm={m}, {"non-symmetric" if perturb else "symmetric"} O'
            det, _ = tk.tor_dets_cuda(o, idx, valid, sign)
            det9, quad, _ = tk.tor_dets_quads_cuda(o, g, idx, valid, sign)
            torch.cuda.synchronize()
            ref, _ = tk.tor_dets_plain(o, idx, valid, sign)
            ref9, refq, _ = tk.tor_dets_quads_plain(o, g, idx, valid, sign)
            e8 = ((det - ref).abs() / ref.abs()).max().item()
            e9 = max(((det9 - ref9).abs() / ref9.abs()).max().item(),
                     ((quad - refq).abs() / refq.abs()).max().item())
            _hold(f'tor_dets_cuda {label}', e8, 1e-9)
            _hold(f'tor_dets_quads_cuda {label}', e9, 1e-9)
            t8, t8r = pt._tor_epilogue(det, sign, m), pt._tor_epilogue(ref, sign, m)
            t9, t9r = pt._tor_epilogue(det9, sign, m, quad), pt._tor_epilogue(ref9, sign, m, refq)
            et8 = (abs(t8 - t8r) / abs(t8r)).item()
            et9 = (abs(t9 - t9r) / abs(t9r)).item()
            # the signed sum cancels: two float64 sums of terms that agree to
            # 1e-15 can differ by that times the cancellation (sum |term| over
            # |torontonian|: 1e8 at m = 8, 1e11 at m = 14), so the bar is 1e-6
            # where the cancellation allows it and 1e-15 times it beyond
            amp8 = ((1 / ref.sqrt()).abs().sum() / abs(t8r)).item()
            amp9 = ((refq / 2).exp() / ref9.sqrt()).abs().sum().item() / abs(t9r).item()
            _hold(f'torontonian from tor_dets_cuda {label}', et8, max(1e-6, 1e-15 * amp8))
            _hold(f'torontonian from tor_dets_quads_cuda {label}', et9, max(1e-6, 1e-15 * amp9))
            k8, _ = time_ms(lambda: tk.tor_dets_cuda(o, idx, valid, sign))
            k9, _ = time_ms(lambda: tk.tor_dets_quads_cuda(o, g, idx, valid, sign))
            p8, _ = time_ms(lambda: tk.tor_dets_plain(o, idx, valid, sign), reps=5, warmup=1)
            p9, _ = time_ms(lambda: tk.tor_dets_quads_plain(o, g, idx, valid, sign), reps=5,
                            warmup=1)
            # the library yardstick, used nowhere in the port: one batched det per
            # size group on stacks gathered outside the timed region
            stacks = [tk._gathered(o, idx, p, a, b)[0] for p, a, b in tk._group_slices(m)]
            lib, _ = time_ms(lambda: [torch.linalg.det(st) for st in stacks], reps=5, warmup=1)
            b8 = bound(o.numel() * 16 + scaffold_bytes + nsub * 16, lu_flops, PEAK_FP64_S)
            b9 = bound((o.numel() + g.numel()) * 16 + scaffold_bytes + nsub * 32,
                       lu_flops + solve_flops, PEAK_FP64_S)
            print(f'tor_dets_cuda {label} ({nsub} subsets): det rel err {e8:.2e}, torontonian '
                  f'{t8.real.item():.6e} rel err {et8:.2e} (terms cancel by {amp8:.1e}), '
                  f'kernel {k8:.4f} ms, twin {p8:.4f} ms, '
                  f'linalg.det on gathered stacks {lib:.4f} ms, bound {b8["bound_ms"]:.5f} ms '
                  f'({b8["bound_by"]})')
            print(f'tor_dets_quads_cuda {label}: det / quad rel err {e9:.2e}, torontonian '
                  f'{t9.real.item():.6e} rel err {et9:.2e}, kernel {k9:.4f} ms, twin {p9:.4f} ms, '
                  f'bound {b9["bound_ms"]:.5f} ms ({b9["bound_by"]})')
            rows8.append(dict(shape=label, ms=k8, plain_ms=p8, library_ms=lib, rel_err=e8,
                              max_abs_err=(det - ref).abs().max().item(),
                              torontonian_rel_err=et8, **b8))
            rows9.append(dict(shape=label, ms=k9, plain_ms=p9, rel_err=e9,
                              max_abs_err=max((det9 - ref9).abs().max().item(),
                                              (quad - refq).abs().max().item()),
                              torontonian_rel_err=et9, **b9))
    # K9 has no single library call: det and solve are two, and the form a third
    results['tor_dets_cuda'] = dict(rows8[0], plane_rel_err=None, other_shapes=rows8[1:])
    results['tor_dets_quads_cuda'] = dict(rows9[0], plane_rel_err=None, other_shapes=rows9[1:])


def _by_state(out: dict) -> dict:
    return {tuple(k.state.tolist()): v for k, v in out.items()}


def _probs_close(name: str, got: dict, ref: dict, bar: float):
    got, ref = _by_state(got), _by_state(ref)
    if got.keys() != ref.keys():
        raise AssertionError(f'{name}: the routes give different outcomes')
    import torch
    keys = list(ref)
    d = (torch.stack([got[k] for k in keys]) - torch.stack([ref[k] for k in keys])).abs().max()
    if not d.item() <= bar:
        raise AssertionError(f'{name}: kernel and twin route differ by {d.item()} > {bar}')
    return d.item()


def check_boson_sampling(card: str, rng):
    """Phase 8, path (a): the Fock backend in basis mode, at complex128."""
    import torch
    from math import comb
    dqt = _pkg()[0]
    with complex128():
        nmode, nphoton = BS_MODES, BS_PHOTONS
        cir = dqt.photonic.Clements(nmode, init_state=[1] * nphoton + [0] * (nmode - nphoton),
                                    cutoff=nphoton + 1)
        if cir.device.type != 'cuda':
            raise AssertionError(f'boson sampling: the circuit landed on {cir.device}')
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        with torch.no_grad():
            reset_counts()
            probs = cir(data=angles, is_prob=True)
            torch.cuda.synchronize()
            counts = read_counts()
            total = torch.stack(list(probs.values())).sum().item()
            print(f'boson sampling {nmode} modes, {nphoton} photons: {len(probs)} outcomes, '
                  f'sum {total:.10f}, launches {counts}')
            nout = comb(nmode + nphoton - 1, nphoton)
            if len(probs) != nout or counts['permanent_cuda_batch'] != 1:
                raise AssertionError(f'boson sampling: expected {nout} outcomes from one launch')
            if not abs(total - 1) <= 1e-6:
                raise AssertionError(f'boson sampling: probabilities sum to {total}')
            t_kernel, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
            reset_counts()
            with twin_route():
                ref = cir(data=angles, is_prob=True)
                t_twin, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
            if sum(read_counts().values()) != 0:
                raise AssertionError('the twin route launched a kernel')
            d = _probs_close('boson sampling', probs, ref, 1e-8)
            print(f'boson sampling: max |d prob| to the twin route {d:.2e}; median over 5 calls: '
                  f'kernel route {t_kernel:.3f} ms, twin route {t_twin:.3f} ms [{card}]')

            n20 = BS_BIG
            big = dqt.photonic.Clements(n20, init_state=[1] * n20, cutoff=n20 + 1)
            big.encode(rng.uniform(0, 2 * np.pi, big.ndata))
            reset_counts()
            amp = big.get_amplitude([1] * n20)
            torch.cuda.synchronize()
            c20 = read_counts()
            with twin_route():
                amp_ref = big.get_amplitude([1] * n20)
            e = (abs(amp - amp_ref) / abs(amp_ref)).item()
            t_amp, _ = time_ms(lambda: big.get_amplitude([1] * n20), reps=5, warmup=1)
            print(f'get_amplitude {n20} modes, {n20} photons: {complex(amp):.6e}, rel err to the '
                  f'twin route {e:.2e}, launches {c20}, median {t_amp:.3f} ms [{card}]')
            if c20['permanent_cuda_batch'] != 1 or not e <= 1e-8:
                raise AssertionError('get_amplitude: expected one launch and the twin value')
    for name, c in c20.items():
        counts[name] += c
    return counts


def check_gbs(card: str, rng):
    """Phase 9, path (b): Gaussian boson sampling with click detectors, at
    complex128."""
    import torch
    from math import comb
    dqt = _pkg()[0]
    total_counts = {name: 0 for name in KERNELS}

    def gbs(nmode, displaced):
        cir = dqt.photonic.GaussianBosonSampling(
            nmode, rng.uniform(0.2, 0.6, nmode), _haar(nmode, rng), detector='threshold')
        if displaced:
            cir.d(0, 0.3, 0.4)
            cir.d(nmode // 2, 0.2, 1.0)
        return cir

    with complex128():
        nmode = GBS_MODES
        expected = (1 << nmode) - sum(comb(nmode, c) for c in range(3))    # >= 3 clicks: 968
        with torch.no_grad():
            for displaced, hot, cold in ((False, 'tor_dets_cuda', 'tor_dets_quads_cuda'),
                                         (True, 'tor_dets_quads_cuda', 'tor_dets_cuda')):
                cir = gbs(nmode, displaced)
                label = f'GBS {nmode} modes, threshold' + (', displaced' if displaced else '')
                reset_counts()
                probs = cir(is_prob=True)
                torch.cuda.synchronize()
                counts = read_counts()
                total = torch.stack(list(probs.values())).sum().item()
                print(f'{label}: {len(probs)} patterns, sum {total:.10f}, launches {counts}')
                if len(probs) != 1 << nmode or counts[hot] != expected or counts[cold] != 0:
                    raise AssertionError(f'{label}: expected {expected} launches of {hot}')
                if not abs(total - 1) <= 1e-6:
                    raise AssertionError(f'{label}: probabilities sum to {total}')
                t_kernel, _ = time_ms(lambda: cir(is_prob=True), reps=3, warmup=1)
                reset_counts()
                with twin_route():
                    ref = cir(is_prob=True)
                    t_twin, _ = time_ms(lambda: cir(is_prob=True), reps=3, warmup=0)
                if sum(read_counts().values()) != 0:
                    raise AssertionError('the twin route launched a kernel')
                d = _probs_close(label, probs, ref, 1e-8)
                print(f'{label}: max |d prob| to the twin route {d:.2e}; median over 3 calls: '
                      f'kernel route {t_kernel:.3f} ms, twin route {t_twin:.3f} ms [{card}]')
                for name, c in counts.items():
                    total_counts[name] += c

                big = gbs(GBS_BIG, displaced)
                big()                                   # the Gaussian state of the circuit
                clicks = [1] * GBS_BIG
                reset_counts()
                p = big.get_prob(clicks)
                torch.cuda.synchronize()
                counts = read_counts()
                with twin_route():
                    p_ref = big.get_prob(clicks)
                e = (abs(p - p_ref) / abs(p_ref)).item()
                t_p, _ = time_ms(lambda: big.get_prob(clicks), reps=5, warmup=1)
                print(f'get_prob all-click at {GBS_BIG} modes{", displaced" if displaced else ""}: '
                      f'{p.item():.6e}, rel err to the twin route {e:.2e}, launches {counts}, '
                      f'median {t_p:.3f} ms [{card}]')
                # 1e-3: the 16383 terms of this torontonian cancel by 1e11 to 1e12, so
                # two float64 routes agree to 1e-5 to 1e-4 of the probability at best
                # (phase 3 holds the per-subset values themselves at 1e-9)
                if counts[hot] != 1 or counts[cold] != 0 or not e <= 1e-3 \
                        or not 0 < p.item() < 1:
                    raise AssertionError('get_prob of all clicks: expected one launch of '
                                         f'{hot} and the twin value')
                for name, c in counts.items():
                    total_counts[name] += c
    return total_counts


# ----------------------------------------------------------------- profile
PARTS = {   # label -> where the real step spends host time
    'sequence': 'QubitCircuit._planar_seq (gate matrices, window plan and products)',
    'sequence_batched': 'QubitCircuit._planar_seq_batched (every group\'s (B, K, K) matrices)',
    'chain_forward': 'planar_chain (K3 at n=18; batched K1 per gate step in the QML step)',
    'pauli_expectation': 'planar_pauli_expectation (K3 at n=18; batched K1 in the QML step)',
    'chain_backward': '_chain_backward, the adjoint walk inside loss.backward() (K4 at n=18; '
                      'batched K1 + K5 + K1 per gate step in the QML step)',
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

    patches = [(dqt.QubitCircuit, '_planar_seq', 'sequence'),
               (dqt.QubitCircuit, '_planar_seq_batched', 'sequence_batched'),
               (pg, 'planar_chain', 'chain_forward'),
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


def _synced(fn):
    """(fn(), host ms until the device has finished it)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


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

    def update():
        with torch.no_grad():
            p.sub_(LR * p.grad)
        p.grad = None

    split = []
    torch.cuda.synchronize()
    for _ in range(reps):
        loss, t_fwd = _synced(lambda: cir.expectation(params=p)[0])
        _, t_bwd = _synced(loss.backward)
        _, t_upd = _synced(update)
        split.append((t_fwd, t_bwd, t_upd))
    t_fwd, t_bwd, t_upd = (float(v) for v in np.median(np.array(split), axis=0))

    with labelled_parts({}):
        dev = _device_profile(lambda: grad_step(cir, p), steps)
    return dict(
        card=card, device=torch.cuda.get_device_name(0), n=n, layers=LAYERS, parts=PARTS,
        step_ms_median=t_step, step_ms_all=all_steps, step_ms_with_labels=t_labelled,
        host_ms_per_step=host_ms,
        sync_split_ms=dict(forward_and_expectation=t_fwd, backward=t_bwd, update=t_upd,
                           total=t_fwd + t_bwd + t_upd),
        profiled_steps=steps, device_busy_share=dev['device_ms_per_step'] / t_step, **dev)


def profile_batched_qml(card: str, reps: int = 10, steps: int = 3) -> dict:
    """Where one batched QML step (``qml_step`` on ``qml_circuit``, plain
    variant, B=100) spends its time, as ``profile_training`` splits the VQE
    step: the free-running median, the host time of PARTS inside it, a
    synchronised split, and the profiler's device time and top kernels."""
    import torch
    dqt = _pkg()[0]
    dqt.set_dtype('complex64')
    cir = qml_circuit()
    leaves = _qml_leaves(cir, cir.device, False)
    t_step, all_steps = time_ms(lambda: qml_step(cir, leaves, False), reps=reps, warmup=3)
    host_ms: dict = {}
    with labelled_parts(host_ms):
        for _ in range(reps):
            qml_step(cir, leaves, False)
        torch.cuda.synchronize()
    host_ms = {k: v / reps for k, v in host_ms.items()}
    p, data = leaves[0], leaves[1]

    def update():
        with torch.no_grad():
            p.sub_(LR * p.grad)
        p.grad = None

    split = []
    for _ in range(reps):
        loss, t_fwd = _synced(lambda: cir.expectation(data=data, params=p).mean())
        _, t_bwd = _synced(loss.backward)
        _, t_upd = _synced(update)
        split.append((t_fwd, t_bwd, t_upd))
    t_fwd, t_bwd, t_upd = (float(v) for v in np.median(np.array(split), axis=0))
    with labelled_parts({}):
        dev = _device_profile(lambda: qml_step(cir, leaves, False), steps)
    return dict(
        card=card, device=torch.cuda.get_device_name(0), n=QML_N, layers=QML_LAYERS, batch=QML_B,
        parts=PARTS, step_ms_median=t_step, step_ms_all=all_steps, host_ms_per_step=host_ms,
        sync_split_ms=dict(forward_and_expectation=t_fwd, backward=t_bwd, update=t_upd,
                           total=t_fwd + t_bwd + t_upd),
        profiled_steps=steps, device_busy_share=dev['device_ms_per_step'] / t_step, **dev)


def _device_profile(step, steps: int) -> dict:
    """One torch.profiler window of ``steps`` calls of ``step``: device time,
    device operations, CPU time in cudaLaunchKernel, the host time of the
    ``dq:`` ranges and the top kernels, per call."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
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
        profiled_range_host_ms_per_step=ranges,
        device_ms_per_step=dev_us / 1e3 / steps, device_ops_per_step=dev_ops / steps,
        cuda_launch_cpu_ms_per_step=launch_us / 1e3 / steps,
        top_kernels=[dict(name=k[:90], ms_per_step=t / 1e3 / steps, calls_per_step=c / steps)
                     for t, c, k in by_name[:12]])


def profile_photonic(card: str) -> dict:
    """Where one call of each photonic path spends its time, at complex128:
    the free-running median, a split with a synchronise after each part
    (medians of 3), and one torch.profiler window for the device time."""
    import torch
    dqt = _pkg()[0]
    from deepquantum_tpu_torch.photonic import gaussian_prob
    rng = np.random.default_rng(SEED + 2)

    def split(parts):
        rows = [[_synced(fn)[1] for _, fn in parts] for _ in range(3)]
        return {name: float(v) for (name, _), v in zip(parts, np.median(np.array(rows), axis=0))}

    out = dict(card=card, device=torch.cuda.get_device_name(0))
    with complex128(), torch.no_grad():
        cir = dqt.photonic.Clements(BS_MODES, [1] * BS_PHOTONS + [0] * (BS_MODES - BS_PHOTONS),
                                    cutoff=BS_PHOTONS + 1)
        angles = rng.uniform(0, 2 * np.pi, cir.ndata)
        in_state = cir._basis_input(None)
        basis = cir._output_basis(in_state)
        full = cir._full_params(None, angles, cir._data_indices(len(angles)))
        amps = cir._fock_basis_amps(angles, in_state, basis)
        t_a, _ = time_ms(lambda: cir(data=angles, is_prob=True), reps=5, warmup=1)
        out['boson_sampling'] = dict(
            modes=BS_MODES, photons=BS_PHOTONS, outcomes=len(basis), call_ms_median=t_a,
            sync_split_ms=split([
                ('unitary (gate matrices and their product)', lambda: cir._unitary_of(full)),
                ('amplitudes (unitary, sub-matrix gather, K7, norms)',
                 lambda: cir._fock_basis_amps(angles, in_state, basis)),
                ('dict of FockState keys, sorted',
                 lambda: cir._state_dict(basis, amps.abs() ** 2, True))]),
            **_device_profile(lambda: cir(data=angles, is_prob=True), 3))

        gbs = dqt.photonic.GaussianBosonSampling(
            GBS_MODES, rng.uniform(0.2, 0.6, GBS_MODES), _haar(GBS_MODES, rng),
            detector='threshold')
        cov, mean = gbs()
        t_b, _ = time_ms(lambda: gbs(is_prob=True), reps=3, warmup=1)
        out['gaussian_boson_sampling'] = dict(
            modes=GBS_MODES, patterns=1 << GBS_MODES, call_ms_median=t_b,
            sync_split_ms=split([
                ('Gaussian state (symplectic folds over the gates)', lambda: gbs()),
                ('Q-function matrices', lambda: gaussian_prob._q_mats(cov[0], mean[0])),
                ('all patterns (Q matrices, then gather + torontonian each)',
                 lambda: gaussian_prob.fock_probs_gaussian(cov, mean, gbs.cutoff,
                                                           'threshold'))]),
            **_device_profile(lambda: gbs(is_prob=True), 1))
    for v in (out['boson_sampling'], out['gaussian_boson_sampling']):
        v['device_busy_share'] = v['device_ms_per_step'] / v['call_ms_median']
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--profile', action='store_true',
                    help='instead of the checks, print where one n=18 grad step, one batched '
                         'QML step and one call of each photonic path spend their time')
    ap.add_argument('--out', default=None, help='with --profile: also write the JSON here')
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = setup()
    build()
    if args.profile:
        text = json.dumps(dict(training=profile_training(smi), batched_qml=profile_batched_qml(smi),
                               photonic=profile_photonic(smi)))
        print(text)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text + '\n')
        return 0
    results: dict = {}
    rng, rng_g = np.random.default_rng(SEED), np.random.default_rng(SEED + 1)
    # no_grad, not inference_mode: a tensor made in inference mode and cached
    # would break the autograd-tracked phases below
    # the photonic phases draw from a generator of their own, so that K1-K6
    # see the inputs they always saw
    rng_p = np.random.default_rng(SEED + 2)
    with torch.no_grad():
        check_gate_kernels(results, rng, rng_g)
        check_batched_kernels(results, np.random.default_rng(SEED + 5))
        check_window_kernels(results, rng, rng_g)
        with complex128():
            check_permanent_kernel(results, rng_p)
            check_tor_kernels(results, rng_p)

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
    add(check_batched_qml(smi)[0])
    add(check_boson_sampling(smi, rng_p))
    add(check_gbs(smi, rng_p))
    add(check_photonic_gradients(smi, np.random.default_rng(SEED + 6)))
    for name, c in main_path.items():
        if c <= 0:
            raise AssertionError(f'{name} was not launched on the main paths')

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        # library_ms: window_apply has one (a real block matmul, timed in
        # phase 3) and tor_dets_cuda has one (a batched det per size group).
        # The others have no single PyTorch call: a gate on arbitrary wires
        # needs a permute beside its matmul (per sample: a permute and a
        # batched matmul), the reduced planes need two products combined,
        # the chains are loops of steps, nothing computes a permanent, and
        # the quadratic form is a det, a solve and a dot
        kernels.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                            launches=main_path[name], max_abs_err=r['max_abs_err'],
                            rel_err=r['rel_err'], plane_rel_err=r['plane_rel_err'], ms=r['ms'],
                            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                            bound_by=r['bound_by'], library_ms=r.get('library_ms'),
                            shape=r['shape'], other_shapes=r.get('other_shapes'),
                            **{k: r[k] for k in ('device_ms', 'non_unitary_rel_err', 'depth',
                                                 'shared_planes_ms', 'shared_planes_rel_err')
                               if k in r}))
    # computed, not measured: the FP32 bounds from the inputs as bound_ms is,
    # and K4's barriers from its step table (one per row, less a final relabel)
    derived = {name: {k: results[name][k] for k in ('bound_fp32_ms', 'bound_fp32_by',
                                                    'table_barriers') if k in results[name]}
               for name in ('window_apply', 'window_chain_bwd')}
    print(f'derived from the inputs and the step table, not measured: {json.dumps(derived)}')
    print(f'total: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
