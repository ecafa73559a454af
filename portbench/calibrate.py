"""Readings that each cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload hea26.train --seeds 11,12,13 \\
        --control-seeds 11,12,13 --seconds 2

For each of ``--seeds`` a whole run of the cell (a short window) prints the
program's compared numbers. For each of ``--control-seeds`` the control
stands in the program's place: the plain reference computed in TF32 (the
precision below the configuration's float32 with TF32 off); and, for a
training cell, the witness: the plain reference in complex64, which shows
what float32 rounding alone does to each number. A state left unchanged
reads 1 on ``median_step_gap`` by the measure itself and needs no run. One JSON
line a reading, also appended to ``portbench/_out/calibrate.jsonl``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _emit(row: dict) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    out = ROOT / 'portbench' / '_out'
    out.mkdir(parents=True, exist_ok=True)
    with open(out / 'calibrate.jsonl', 'a') as f:
        f.write(line + '\n')


def control(cell, seed: int, device) -> list:
    """The control's (and the witness's) numbers on one seed."""
    import torch
    from portbench import harness
    ctx = harness.Ctx(cell=cell, seed=seed, seconds=0, trace=False, device=torch.device(device),
                      t_start=time.perf_counter())
    ctx.inputs = cell.config.inputs(cell.cfg, cell.traffic, seed, ctx.device)
    ref_mod, rows = cell.reference, []
    if cell.traffic['loop'] == 'train':
        def rec(**kw):
            return cell.loop.by_leaf(cell.config.leaves, ref_mod.train(
                cell.cfg, cell.traffic, ctx.inputs, cell.traffic['checked_steps'], **kw))

        ref = rec()
        rows.append(('control_tf32', cell.loop.numbers(rec(precision='tf32'), ref)))
        rows.append(('witness_complex64', cell.loop.numbers(rec(precision='float32'), ref)))
    else:
        record = {'outputs': [None] * cell.traffic['check_evals']}
        nums = cell.loop.check(ctx, record, ref_mod, answer=lambda d: ref_mod.evaluate(
            cell.cfg, ctx.inputs, d, 'tf32'))[0]
        rows.append(('control_tf32', nums))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print('portbench: no CUDA card', file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = harness.resolve(args.workload)
    seeds = [int(s) for s in args.seeds.split(',') if s]
    for seed in seeds:
        t0 = time.perf_counter()
        result, lines, numbers = harness.run(cell, seed, args.seconds, False, 'cuda:0', t0)
        _emit({'cell': cell.name, 'seed': seed, 'mode': 'program', 'correct': result['correct'],
               'attempted': result['attempted'], 'numbers': numbers, 'notes': lines,
               'metrics': {k: m['value'] for k, m in result['metrics'].items()},
               'seconds': time.perf_counter() - t0})
    for seed in (int(s) for s in args.control_seeds.split(',') if s):
        t0 = time.perf_counter()
        for mode, nums in control(cell, seed, 'cuda:0'):
            _emit({'cell': cell.name, 'seed': seed, 'mode': mode, 'numbers': nums,
                   'seconds': time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
