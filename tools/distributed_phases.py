#!/usr/bin/env python3
"""Run chip_smoke.py's distributed phases (9t-9v) alone on one CUDA card.

    python3 tools/distributed_phases.py

Builds the kernels (9t launches K1, K2, K5 and K6 on every shard), then
calls chip_smoke.check_shardmap, check_gspmd and check_sharded_fock,
prints each phase's lines and wall seconds, then one JSON line of their
results. Exits non-zero without CUDA or when a phase misses a bar.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import chip_smoke as cs
    smi = cs.setup()
    cs.build()
    out, seconds = {}, {}
    for key, label, check in (('shardmap', '9t', cs.check_shardmap), ('gspmd', '9u', cs.check_gspmd),
                              ('sharded_fock', '9v', cs.check_sharded_fock)):
        t = time.perf_counter()
        _, out[key] = check(smi)
        seconds[label] = round(time.perf_counter() - t, 1)
    print(f'wall seconds: {json.dumps(seconds)}')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
