#!/usr/bin/env python3
"""Time the permanent kernel K7 over the launch plans it can take, at the
shapes ``chip_smoke.py`` gives it, on one CUDA card.

    python3 tools/perm_sweep.py [--out FILE]

For each row of chip_smoke's PERM_SHAPES (Haar unitaries from its
photonic seed) and each level L that the kernel instance takes (a run of
2^L subsets; ways runs a thread, so 2^(n - L) / ways threads a matrix;
runs of at most 2^14 steps and at most 2^20 threads),
launches the kernel directly through its C entry, holds the result to the
plan's own (1e-10, or 1e-8 where the terms cancel, as chip_smoke's bars)
and times it on the card (CUDA events behind a queued sleep,
``chip_smoke._queued_ms``). Marks the level ``permanent_kernel.plan``
picks. Prints the card line and one JSON line; ``--out`` also writes it.
Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: this tool needs a CUDA card')
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location('chip_smoke', HERE / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import deepquantum_tpu_torch as dqt
    from deepquantum_tpu_torch.ops import _cuda
    from deepquantum_tpu_torch.ops import permanent_kernel as pk
    from deepquantum_tpu_torch.ops.planar_gate import workspace
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dqt.set_dtype('complex128')
    dev = torch.device('cuda')
    rng = np.random.default_rng(cs.SEED + 2)
    index, stream = _cuda.stream_of(dev)
    rows = []
    with torch.no_grad():
        for b, n, dtype in cs.PERM_SHAPES:
            mats = torch.as_tensor(np.stack([cs._haar(n, rng) for _ in range(b)]),
                                   device=dev).to(getattr(torch, dtype))
            ways = pk.ways_of(n)
            chosen = pk.plan(b, n, pk._resident_threads(dev, n))[0]
            ref = pk.permanent_cuda_batch(mats)
            bar = cs._perm_bar(n)
            # runs of at most 2^14 steps, at most 2^20 threads
            for level in range(min(n - (ways.bit_length() - 1), 14), 1, -1):
                tpm = (1 << (n - level)) // ways
                mpb = min(b, pk.THREADS // tpm) if tpm <= pk.THREADS else 1
                if mpb * pk.smem_stride(n) * 16 > pk._SMEM_BYTES or b * tpm > 1 << 20:
                    continue
                out = torch.empty(b, dtype=torch.complex128, device=dev)
                parts, count = workspace(dev, index, stream, 4 * b * max(1, tpm // pk.THREADS), b)

                def fn():
                    _cuda.launch_on('dq_permanent_ryser', index, stream, mats,
                                    int(mats.dtype == torch.complex64), out, 0, parts, count, b,
                                    n, level, ways)
                fn()
                torch.cuda.synchronize()
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                if not err <= bar:
                    raise AssertionError(f'(B={b}, n={n}) at L={level}: rel err {err} > {bar}')
                reps = 5 if n >= 22 else cs.REPS
                ms = cs._queued_ms(fn, reps=reps)
                rows.append(dict(b=b, n=n, dtype=dtype, level=level, ways=ways, tpm=tpm,
                                 device_ms=ms, rel_err=err, plan=level == chosen))
                print(f'(B={b}, n={n}, {dtype}) L={level} tpm={tpm}: device {ms:.4f} ms, rel err '
                      f'{err:.1e}{"  <- plan" if level == chosen else ""}', flush=True)
    text = json.dumps(dict(card=smi, rows=rows))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    print(smi)
    print(text)
    return 0


if __name__ == '__main__':
    sys.exit(main())
