#!/usr/bin/env python3
"""Time the per-gate kernels K1 / K5 and the two paths that launch them, for
one tree of the PyTorch port, so that two trees can be compared in turns.

    python3 tools/gate_turns.py [--root DIR] [--label NAME] [--out FILE]

Imports ``deepquantum_tpu_torch`` from DIR (default: this checkout), builds
its kernels there, and measures on one CUDA card, with this checkout's
``chip_smoke.py`` helpers:

- K1 ``planar_apply`` and K5 ``planar_grad`` at n=22 on chip_smoke's eight
  wire sets: time through the wrapper (CUDA events around one call from an
  idle card, ``time_ms``), device time (events behind a queued sleep,
  ``_queued_ms``) and device time with the L2 flushed (``_cold_ms``);
- K1b / K5b on (B, 2, 2^n) stacks at (n, B) = (14, 100), (18, 8), (20, 8)
  on chip_smoke's wire sets: wrapper and device time;
- the n=22 + cnot(0, 11) grad step, 2 layers (chip_smoke's
  ``check_step_backward`` circuit, default backward) and the batched QML
  step at n=18, B=8 (``check_batched_qml_wide``'s): the median step, the
  launches per step and one profiler window's device time per step and
  that of the port's kernels.

Prints the card line and one JSON line; ``--out`` also writes the JSON. To
compare two trees, run both in one call on one card in turns (A, B, B, A):
two cards, or two calls, differ by more than the change. Nothing of JAX is
imported.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _load(root: Path):
    """The port from ``root`` first, then this checkout's chip_smoke.py
    (whose helpers import the already-loaded package)."""
    sys.path.insert(0, str(root))
    import deepquantum_tpu_torch as dqt
    if not Path(dqt.__file__).resolve().is_relative_to(root):
        raise SystemExit(f'deepquantum_tpu_torch came from {dqt.__file__}, not {root}')
    spec = importlib.util.spec_from_file_location('chip_smoke', HERE / 'chip_smoke.py')
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return dqt, chip_smoke


def _gate_rows(cs, pg, rng):
    import torch
    dev = torch.device('cuda')
    out = {}
    n = 22
    x = torch.as_tensor(rng.standard_normal((2, 1 << n), dtype=np.float32), device=dev)
    g = torch.as_tensor(rng.standard_normal((2, 1 << n), dtype=np.float32), device=dev)
    for wires in cs.GATE_WIRE_SETS:
        u = cs._haar(1 << len(wires), rng)
        mre, mim = cs._planes(u, dev)
        work = x.clone()
        for name, fn in (('planar_apply', lambda: pg.planar_apply(work, mre, mim, n, wires)),
                         ('planar_grad', lambda: pg.planar_grad(g, x, n, wires))):
            out.setdefault(name, []).append(dict(
                wires=list(wires), ms=cs.time_ms(fn)[0], device_ms=cs._queued_ms(fn),
                cold_ms=cs._cold_ms(fn)))
    for shape in ((14, 100), (18, 8), (20, 8)):
        n, b = shape
        xb = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        gb = torch.as_tensor(rng.standard_normal((b, 2, 1 << n), dtype=np.float32), device=dev)
        for wires in cs.BATCH_WIRES[n]:
            k = 1 << len(wires)
            us = np.stack([cs._haar(k, rng) for _ in range(b)])
            mre = torch.as_tensor(us.real, dtype=torch.float32, device=dev)
            mim = torch.as_tensor(us.imag, dtype=torch.float32, device=dev)
            work = xb.clone()
            for name, fn in (('planar_apply_batched',
                              lambda: pg.planar_apply(work, mre, mim, n, wires)),
                             ('planar_grad_batched', lambda: pg.planar_grad(gb, xb, n, wires))):
                out.setdefault(f'{name} ({n}, {b})', []).append(dict(
                    wires=list(wires), ms=cs.time_ms(fn)[0], device_ms=cs._queued_ms(fn)))
        del xb, gb, work
    return out


def _step(cs, fn, reps: int):
    """Median step, launches of one step, and device time per step."""
    import torch
    cs.reset_counts()
    fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in cs.read_counts().items() if v}
    t, _ = cs.time_ms(fn, reps=reps, warmup=1)
    prof = cs._device_profile(fn, 2)
    return dict(step_ms=t, launches=counts, device_ms_per_step=prof['device_ms_per_step'],
                port_kernels=prof['port_kernels'])


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=str(HERE), help='the tree whose port is measured')
    ap.add_argument('--label', default='tree')
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: this tool needs a CUDA card')
    root = Path(args.root).resolve()
    dqt, cs = _load(root)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    from deepquantum_tpu_torch.ops import _cuda
    from deepquantum_tpu_torch.ops import planar_gate as pg
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    dqt.set_dtype('complex64')
    rng = np.random.default_rng(cs.SEED + 9)
    with torch.no_grad():
        rows = _gate_rows(cs, pg, rng)

    cir = cs.bench_circuit(22, None, (0, 11), 2)
    p = cir.params.requires_grad_()
    grad22 = _step(cs, lambda: cs.grad_step(cir, p), reps=5)
    del cir, p
    cir = cs.qml_circuit(None, 18)
    leaves = cs._qml_leaves(cir, cir.device, False, 8)
    qml18 = _step(cs, lambda: cs.qml_step(cir, leaves, False), reps=10)

    out = dict(label=args.label, root=str(root), card=smi, build_s=build_s,
               mean={name: {key: float(np.mean([r[key] for r in rs]))
                            for key in rs[0] if key.endswith('ms')}
                     for name, rs in rows.items()},
               rows=rows, grad_step_n22=grad22, qml_step_n18_b8=qml18)
    for name, m in out['mean'].items():
        print(f'{args.label} {name}: ' + ', '.join(f'{k} {v:.4f}' for k, v in m.items()))
    for key in ('grad_step_n22', 'qml_step_n18_b8'):
        r = out[key]
        print(f'{args.label} {key}: step {r["step_ms"]:.3f} ms, device '
              f'{r["device_ms_per_step"]:.3f} ms a step, launches {r["launches"]}')
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    print(smi)
    print(text)
    return 0


if __name__ == '__main__':
    sys.exit(main())
