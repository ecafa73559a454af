#!/usr/bin/env python3
"""Where one CV-QNN value-and-gradient step on Fock tensors spends its time.

    python3 tools/fock_step_profile.py [--out FILE]

Builds chip_smoke.py's phase-9l circuit (2 CV-QNN layers on 7 modes at
cutoff 10, complex64, on the CUDA card), runs two warm-up steps, then one
step under torch.profiler (host and CUDA activity) and prints the step's
wall time, the device time, the number of device launches and the ten
operators with the most device time and the most host time. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke as cs
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    print(cs.setup())
    cir = cs.cvqnn_circuit(cs.QNN_MODES, cs.QNN_CUTOFF, cs.QNN_LAYERS, cs.SEED)
    p = cir.params
    for _ in range(2):
        cs.fock_step(cir, p)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cs.fock_step(cir, p)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()

    def dev(e):
        t = getattr(e, 'self_device_time_total', None)
        return float(t if t is not None else getattr(e, 'self_cuda_time_total', 0.0)) / 1e3

    cuda = [e for e in evs if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in evs if e.device_type != torch.autograd.DeviceType.CUDA]
    out = dict(wall_ms=wall, device_ms=sum(dev(e) for e in cuda),
               launches=sum(e.count for e in cuda),
               top_device=[(e.key[:60], round(dev(e), 3), e.count)
                           for e in sorted(cuda, key=dev, reverse=True)[:10]],
               top_host=[(e.key[:60], round(e.self_cpu_time_total / 1e3, 3), e.count)
                         for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                                         reverse=True)[:10]])
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
