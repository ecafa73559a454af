"""The traced window of a ``--trace 1`` run.

A few calls run under one torch.profiler window that records the card's
activity only (recording every host operation as well made a hea26 step
half as long again on the H100). Before each call into the port the run
synchronises, and a host span of the benchmark's own clock covers that
call: so the span is the call's host work with an empty queue. The trace
gives every device operation's interval, on the host's wall clock
(``baseTimeNanoseconds`` + ``ts``), so that each idle gap is labelled by
the span the host was in and the runtime call it was making. The port's
kernels are counted against the launch counters of its wrappers over the
same window, and a window in which the profiler kept fewer kernel records
than the program launched is refused.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import program, yardstick

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cuda_runtime', 'cuda_driver')
LABELLED_GAPS = 400          # the longest idle gaps are labelled by the host's work


def no_span(name: str):
    """The untraced loops' span: nothing."""
    return contextlib.nullcontext()


class Spans:
    """Host seconds in the calls into the port, summed per call, and each
    span's wall-clock interval (ns since the epoch)."""

    def __init__(self, sync) -> None:
        self.sync = sync
        self.per_call: list[float] = []
        self.walls: list[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.sync()
        w0, t0 = time.time_ns(), time.perf_counter()
        yield
        self.per_call[-1] += time.perf_counter() - t0
        self.walls.append((w0, time.time_ns(), name))


@dataclass
class Trace:
    """What the per-layer readers read."""
    calls: int
    window_s: float
    busy_s: float
    host_s: list
    device: list = field(default_factory=list)      # (name, seconds) of every device op
    port: list = field(default_factory=list)        # (kernel, template args, seconds)
    breakdown: dict = field(default_factory=dict)
    incomplete: str = ''
    least_s: float | None = None                    # of the port launches (counts)
    left_out: list = field(default_factory=list)
    ops_per_call: float = 0.0


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _short(name: str) -> str:
    pk = yardstick.port_kernel(name)
    if pk:
        return f'{pk[0]}_kernel<{",".join(map(str, pk[1]))}>'
    return name[:80]


def window(call, ncalls: int, sync, cuda: bool, out_path: Path):
    """Run ``call(i, spans)`` for i < ncalls under the profiler; returns
    (the calls' results, the Trace)."""
    before = program.launch_counts() if cuda else None
    spans = Spans(sync)
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    results = []
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        w0, t0 = time.time_ns(), time.perf_counter()
        for i in range(ncalls):
            spans.per_call.append(0.0)
            results.append(call(i, spans))
        sync()
        window_s = time.perf_counter() - t0
        w1 = time.time_ns()
    after = program.launch_counts() if cuda else None
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    with open(out_path) as f:
        doc = json.load(f)
    out_path.unlink()
    tr = Trace(calls=ncalls, window_s=window_s, busy_s=0.0, host_s=spans.per_call)
    _read_events(tr, doc, (w0, w1), spans.walls)
    if cuda:
        expected = sum(after[0][k] - before[0][k] for k in after[0])
        other = sum(after[1][k] - before[1][k] for k in after[1])
        if other:
            tr.incomplete = f'{other} calls of wrappers that launch many kernels each'
        elif expected != len(tr.port):
            tr.incomplete = (f'the profiler kept {len(tr.port)} port-kernel records of the '
                             f'{expected} launches the wrappers counted')
    return results, tr


def _read_events(tr: Trace, doc: dict, window: tuple, walls: list) -> None:
    """Device intervals, the port's kernel records and the breakdown, all on
    the wall clock in microseconds."""
    base = float(doc.get('baseTimeNanoseconds', 0)) / 1e3
    events = [e for e in doc['traceEvents'] if e.get('ph') == 'X' and 'dur' in e]
    w0, w1 = window[0] / 1e3, window[1] / 1e3
    dev = [(e['name'], base + float(e['ts']), float(e['dur'])) for e in events
           if e.get('cat') in DEVICE_CATS]
    for name, _, dur in dev:
        tr.device.append((name, dur * 1e-6))
        pk = yardstick.port_kernel(name)
        if pk:
            tr.port.append((pk[0], pk[1], dur * 1e-6))
    merged = _union((max(w0, ts), min(w1, ts + dur)) for _, ts, dur in dev)
    merged = [m for m in merged if m[1] > m[0]]
    tr.busy_s = sum(e - s for s, e in merged) * 1e-6
    by_op: dict[str, float] = {}
    for name, sec in tr.device:
        key = _short(name)
        by_op[key] = by_op.get(key, 0.0) + sec
    gaps, cur = [], w0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(base + float(e['ts']), base + float(e['ts']) + float(e['dur']), e['name'])
            for e in events if e.get('cat') in HOST_CATS]
    spans = [(a / 1e3, b / 1e3, name) for a, b, name in walls]
    tr.breakdown = {'device_ops': sorted(([k, v] for k, v in by_op.items()),
                                         key=lambda kv: -kv[1])[:10],
                    'idle_gaps': _label_gaps(gaps[:LABELLED_GAPS], spans, host)}


def _label_gaps(gaps: list, spans: list, host: list) -> list:
    """Idle seconds by what the host was doing at each gap's middle: the
    benchmark's span ('between calls' outside them: the optimizer's update,
    the loss or values read, the next inputs drawn) and the runtime call in
    progress ('python' where none was)."""
    def table(rows):
        if not rows:
            return np.zeros(0), np.zeros(0), []
        return (np.array([r[0] for r in rows]), np.array([r[1] for r in rows]),
                [r[2] for r in rows])

    tabs = table(spans), table(host)

    def innermost(tab, t):
        s, e, names = tab
        hit = np.nonzero((s <= t) & (e >= t))[0]
        if not len(hit):
            return None
        return names[hit[np.argmin((e - s)[hit])]]

    by_label: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = (f'{innermost(tabs[0], mid) or "between calls"}: '
                 f'{innermost(tabs[1], mid) or "python"}')
        by_label[label] = by_label.get(label, 0.0) + (g1 - g0) * 1e-6
    return sorted(([k, v] for k, v in by_label.items()), key=lambda kv: -kv[1])[:10]
