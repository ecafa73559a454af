#!/usr/bin/env python3
"""Run chip_smoke.py's Fock-tensor phases (9l-9o) alone on one CUDA card.

    python3 tools/fock_phases.py

Calls chip_smoke.check_fock_qnn, check_fock_dm, check_fock_mps and
check_fock_homodyne in that order (9o reads 9l's state), prints each
phase's lines and wall seconds, then one JSON line of their results. These
phases launch none of the port's kernels, so nothing is built. Exits
non-zero without CUDA or when a phase misses a bar.
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
    out, seconds = {}, {}
    t = time.perf_counter()
    _, out['qnn'], qnn = cs.check_fock_qnn(smi)
    seconds['9l'] = time.perf_counter() - t
    for key, label, check in (('dm', '9m', lambda: cs.check_fock_dm(smi)),
                              ('mps', '9n', lambda: cs.check_fock_mps(smi)),
                              ('homodyne', '9o', lambda: cs.check_fock_homodyne(smi, qnn))):
        t = time.perf_counter()
        _, out[key] = check()
        seconds[label] = time.perf_counter() - t
    print(f'wall seconds: {json.dumps(seconds)}')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
