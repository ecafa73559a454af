#!/usr/bin/env python3
"""Run chip_smoke.py's example phases (E1-E10) alone on one CUDA card.

    python3 tools/examples_phases.py

Builds the kernels, then calls chip_smoke.run_examples: each module of
deepquantum_tpu_torch/examples/ at the card's size, held against the twin
route (the n=28 mesh against the local engine); prints each phase's lines
and wall seconds, then one JSON line of their results. Exits non-zero
without CUDA or when a phase misses a bar.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import chip_smoke as cs
    smi = cs.setup()
    cs.build()
    seconds = {}

    @contextlib.contextmanager
    def phase(label: str):
        t = time.perf_counter()
        yield
        seconds[label] = round(time.perf_counter() - t, 1)

    counts, out = cs.run_examples(smi, phase)
    print(f'launches over the example phases: {json.dumps({k: v for k, v in counts.items() if v})}')
    print(f'wall seconds: {json.dumps(seconds)}')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
