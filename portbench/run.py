"""Run one cell of the port's benchmark on the CUDA card.

    python3 portbench/run.py --workload hea26.train --seed 7 --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its limit;
the same numbers end standard error. Without a CUDA card, or with fewer
cards than the cell asks for, it exits with code 3 and prints no result.
It measures the port, ``deepquantum_tpu_torch``, and never imports JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error('--seed is a whole number >= 0')
    # every cache that a kernel build could write, at a fixed place in the
    # checkout (the port's own library builds into deepquantum_tpu_torch/_build)
    cache = ROOT / 'portbench' / '_out' / 'cache'
    os.environ.setdefault('TRITON_CACHE_DIR', str(cache / 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR', str(cache / 'torch_extensions'))
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness

    try:
        cell = harness.resolve(args.workload)
    except harness.CellError as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'portbench: {cell.name} needs {cell.chips} CUDA card(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0} found',
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    try:
        result, lines, _ = harness.run(cell, args.seed, args.seconds, bool(args.trace), 'cuda:0',
                                    T_START)
        harness.check_modules()
    except harness.CellError as e:
        print(f'portbench: {e}', file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
