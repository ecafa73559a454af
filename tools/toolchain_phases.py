#!/usr/bin/env python3
"""Run chip_smoke.py's qubit-toolchain phases (9p-9s) alone on one CUDA card.

    python3 tools/toolchain_phases.py

Builds the kernels (9p and 9q launch K1-K3), then calls
chip_smoke.check_class_api_qasm, check_cutting, check_mbqc and
check_optimizers, prints each phase's lines and wall seconds, then one
JSON line of their results. Exits non-zero without CUDA or when a phase
misses a bar.
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
    for key, label, check in (('class_api_qasm', '9p', cs.check_class_api_qasm),
                              ('cutting', '9q', cs.check_cutting), ('mbqc', '9r', cs.check_mbqc),
                              ('optimizers', '9s', cs.check_optimizers)):
        t = time.perf_counter()
        _, out[key] = check(smi)
        seconds[label] = round(time.perf_counter() - t, 1)
    print(f'wall seconds: {json.dumps(seconds)}')
    print(json.dumps(out))
    return 0


if __name__ == '__main__':
    sys.exit(main())
