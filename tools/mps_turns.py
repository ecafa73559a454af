#!/usr/bin/env python3
"""Time the MPS path of one tree of the PyTorch port, so that two trees can
be compared in turns.

    python3 tools/mps_turns.py [--root DIR] [--label NAME] [--out FILE]

Imports ``deepquantum_tpu_torch`` from DIR (default: this checkout) and
runs, on one CUDA card, ``chip_smoke.py``'s MPS circuit (n=100, chi=64, 8
layers of rx, rz, rx and a CNOT chain, Z on wire 0, complex64): one
forward to warm up, then one timed forward (inference mode) and one timed
value and gradient, each with the count of ``torch.linalg.svd`` /
``torch.linalg.qr`` calls it made. Times are CUDA events around one call,
the host's work included (``chip_smoke._one_call_ms``).

Prints the card line and one JSON line; ``--out`` also writes the JSON. To
compare two trees, run both in one call on one card in turns (A, B, B, A),
each in its own process. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

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
    return chip_smoke


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', type=Path, default=HERE)
    ap.add_argument('--label', default='tree')
    ap.add_argument('--out', type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('no CUDA device', file=sys.stderr)
        return 1
    cs = _load(args.root.resolve())
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip()
    cir = cs.mps_circuit(cs.MPS_N, cs.MPS_CHI, cs.MPS_LAYERS)
    with torch.inference_mode():
        cir.forward()
        with cs.count_factorisations({}) as fwd_calls:
            _, fwd_ms = cs._one_call_ms(cir.forward)
    with cs.count_factorisations({}) as step_calls:
        (e, g), step_ms = cs._one_call_ms(lambda: cs._mps_step(cir))
    out = dict(label=args.label, root=str(args.root), card=card, forward_ms=fwd_ms,
               forward_calls=fwd_calls, step_ms=step_ms, step_calls=step_calls,
               value=e.item(), grad_max=g.abs().max().item())
    print(card)
    print(json.dumps(out))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
