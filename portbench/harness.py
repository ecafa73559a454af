"""Resolve a cell of ``BENCHMARK.json`` to its files by name, and run it.

A cell names a configuration and a traffic mix. The harness finds:

- the configuration's sizes in the file ``BENCHMARK.json`` gives, its
  program builder in ``configs/<config>.py``, its plain reference in
  ``reference/<config>.py`` and its counts in ``counts/<config>.py``;
- the traffic's parameters in ``traffic/<traffic>.json``, whose ``loop``
  names the general loop ``loops/<loop>.py`` that runs them;
- the cell's limits in ``limits/<cell>.json``;
- each per-layer metric's reader in ``metrics/<metric>.py``, or else in
  ``metrics/<the part of its name before the first dot>.py``.

So a cell, a configuration, a traffic mix or a metric is added as new
files and entries, without editing a file that is there.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = HERE / '_out'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'deepquantum_tpu')


class CellError(Exception):
    """A run that may print no result."""


def load(path: Path, name: str):
    if not path.is_file():
        raise CellError(f'{path} is missing')
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f'{path} is missing')
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    config: object
    reference: object
    counts: object
    loop: object
    readers: dict


def _for_cell(metrics: list, name: str) -> list:
    return [m for m in metrics if name in m.get('workloads', [name])]


def resolve(name: str, bench: dict | None = None) -> Cell:
    bench = bench or _json(ROOT / 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise CellError(f'no workload {name!r} in BENCHMARK.json: {sorted(cells)}')
    w = cells[name]
    conf = {c['name']: c for c in bench['configs']}[w['config']]
    traffic = _json(HERE / 'traffic' / f"{w['traffic']}.json")
    per_layer = _for_cell(bench['per_layer'], name)
    readers, loaded = {}, {}
    for m in per_layer:
        path = HERE / 'metrics' / f"{m['name']}.py"
        if not path.is_file():
            path = HERE / 'metrics' / f"{m['name'].split('.')[0]}.py"
        if path not in loaded:
            loaded[path] = load(path, f"portbench_metric_{path.stem}")
        readers[m['name']] = loaded[path]
    cfg_name = w['config']
    return Cell(
        name=name, chips=w['chips'], cfg=_json(ROOT / conf['file']), traffic=traffic,
        limits=_json(HERE / 'limits' / f'{name}.json')['limits'],
        end_to_end=_for_cell(bench['end_to_end'], name), per_layer=per_layer,
        config=load(HERE / 'configs' / f'{cfg_name}.py', f'portbench_config_{cfg_name}'),
        reference=load(HERE / 'reference' / f'{cfg_name}.py', f'portbench_reference_{cfg_name}'),
        counts=load(HERE / 'counts' / f'{cfg_name}.py', f'portbench_counts_{cfg_name}'),
        loop=load(HERE / 'loops' / f"{traffic['loop']}.py", f"portbench_loop_{traffic['loop']}"),
        readers=readers)


@dataclass
class Ctx:
    """What a loop sees of the run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    inputs: dict = field(default_factory=dict)
    program: object = None
    setup_s: float | None = None
    peak_setup: int = 0

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def draw(self, k: int) -> dict:
        return self.cell.config.draw(self.cfg, self.traffic, self.seed, k, self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def window_start(self) -> None:
        if self.device.type == 'cuda':
            self.peak_setup = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def traced(self, call, ncalls: int):
        from portbench import trace
        return trace.window(call, ncalls, self.sync, self.device.type == 'cuda',
                            OUT / f'trace_{self.cell.name}.json')


def check_modules() -> None:
    """Raise where ``sys.modules`` holds JAX or the JAX package (top-level
    names compared whole): such a run may print no result."""
    bad = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))
    if bad:
        raise CellError(f'modules loaded that the port may not use: {bad}')


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    """One run of the cell: (the result line's object, the lines that end
    standard error, every number the check read). Raises CellError where no
    result may be printed."""
    device = torch.device(device)
    ctx = Ctx(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
              t_start=t_start)
    ctx.inputs = cell.config.inputs(cell.cfg, cell.traffic, seed, device)
    ctx.program = cell.config.Program(cell.cfg, cell.traffic, ctx.inputs, device)
    out = cell.loop.run(ctx)
    ctx.sync()
    cuda = device.type == 'cuda'
    peak = max(ctx.peak_setup, torch.cuda.max_memory_allocated(device)) if cuda else 0
    values = out['values']
    attempted = len(values)
    failed = sum(not bool(torch.isfinite(torch.as_tensor(v)).all()) for v in values)
    metrics, notes = {}, []
    if trace:
        tr = out['trace']
        if tr.incomplete:
            raise CellError(f'the trace is incomplete: {tr.incomplete}')
        if cuda and tr.busy_s <= 0:
            raise CellError('the trace shows no device operation')
        tr.least_s, tr.left_out = cell.counts.least_s(tr.port, tr.calls, cell.cfg, cell.traffic)
        tr.ops_per_call = cell.counts.ops_per_call(cell.cfg, cell.traffic)
        if tr.left_out:
            notes.append(f'left out of the roofline: {sorted(set(tr.left_out))}')
        for m in cell.per_layer:
            v = cell.readers[m['name']].read(tr, m['name'])
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        tr = None
        e2e = dict(out['metrics'], setup_s=ctx.setup_s, peak_mem_gib=peak / 2 ** 30)
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
    # the program's state goes before the reference runs, so that the
    # reference neither meets it nor sets the peak read above
    record = out['record']
    del out, values
    ctx.program = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, why = cell.loop.check(ctx, record, cell.reference)
    notes += why + [f'the reference check took {time.perf_counter() - t0:.1f} s']
    notes += [f'reading {k}: {v!r}' for k, v in numbers.items() if k not in cell.limits]
    checks = {k: {'value': numbers[k], 'limit': lim} for k, lim in cell.limits.items()}
    correct = all(math.isfinite(c['value']) and c['value'] <= c['limit'] for c in checks.values())
    check_modules()
    result = {'correct': correct, 'attempted': attempted, 'failed': failed, 'metrics': metrics,
              'device': device_info(device, peak)}
    if tr is not None:
        result['breakdown'] = tr.breakdown
        result['device'].update(busy_s=tr.busy_s, window_s=tr.window_s)
    result['checks'] = checks
    lines = notes + [f"check {k}: {c['value']!r} limit {c['limit']!r} "
                     f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}" for k, c in checks.items()]
    return result, lines, numbers


def device_info(device, peak: int) -> dict:
    if device.type == 'cuda':
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device), 'count': 1,
                'memory_peak_bytes': peak}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': 1, 'memory_peak_bytes': peak}
