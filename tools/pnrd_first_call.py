#!/usr/bin/env python3
"""Trace the first complex64 call of the 10-node pnrd GraphGBS table.

    python3 tools/pnrd_first_call.py [--out FILE]

Runs, on one CUDA card, ``chip_smoke.py``'s phase 9h pnrd circuit (the
10-node subgraph of its planted G(14, 1/2) graph, cutoff 2, all 1024
outcomes) as the phase does: one table at complex128, then the first and
the second table at complex64. The first complex64 call runs inside a
torch.profiler window that records the host's ops and the card's; the
ops are printed by host time, the largest first, with the call's time
between CUDA events. The second call is timed alone.

Prints the card line, the table of ops and one JSON line; ``--out`` also
writes the JSON. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None, help='also write the JSON here')
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('FAIL: this needs a CUDA card')
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f'card: {card}')
    import deepquantum_tpu_torch as dqt
    adj, _ = cs._planted_graph(cs.GRAPH_NODES, cs.GRAPH_CLIQUE, np.random.default_rng(cs.SEED + 10))
    small = adj[:cs.GRAPH_SMALL, :cs.GRAPH_SMALL]

    def table(dtype):
        dqt.set_dtype(dtype)
        gbs = dqt.photonic.GraphGBS(small, cutoff=2, mean_photon_num=cs.GRAPH_SMALL,
                                    detector='pnrd', rng=np.random.default_rng(cs.SEED))
        return lambda: gbs(is_prob=True)

    out = {}
    with torch.no_grad():
        _, out['complex128_first_ms'] = cs._one_call_ms(table('complex128'))
        first = table('complex64')
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, out['complex64_first_ms'] = cs._one_call_ms(first)
        _, out['complex64_second_ms'] = cs._one_call_ms(first)
    dqt.set_dtype('complex64')
    rows = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)
    print(f"{'op':48s} {'calls':>6s} {'host ms':>10s} {'self host ms':>13s} {'device ms':>10s}")
    top = []
    for ev in rows[:25]:
        dev = getattr(ev, 'device_time_total', getattr(ev, 'cuda_time_total', 0.0)) / 1e3
        print(f'{ev.key[:48]:48s} {ev.count:6d} {ev.cpu_time_total / 1e3:10.2f} '
              f'{ev.self_cpu_time_total / 1e3:13.2f} {dev:10.3f}')
        top.append(dict(op=ev.key, calls=ev.count, host_ms=ev.cpu_time_total / 1e3,
                        self_host_ms=ev.self_cpu_time_total / 1e3, device_ms=dev))
    out['top_ops'] = top
    out['card'] = card
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
