"""Evaluation traffic: a closed loop of calls, one caller. Each call takes
fresh inputs drawn from the seed (call k from its own stream), runs the
program without gradients and reads its values on the host before the
next call. The window reports ``eval_ms``, its wall time over the calls
completed in it, ``eval_p90_ms``, the 90th percentile of the calls' times
(each from the draw of its inputs to its values on the host), and
``peak_mem_gib``.
"""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from portbench.seeds import mix
from portbench.trace import no_span

NUMBERS = ('value_gap',)


def run(ctx) -> dict:
    prog, traffic = ctx.program, ctx.traffic

    def call(k, span=no_span) -> torch.Tensor:
        drawn = ctx.draw(k)
        with span('call'):
            out = prog.evaluate(drawn)
        return out.detach().float().cpu()

    for k in range(traffic['warmup_calls']):
        call(-1 - k)
    ctx.setup_done()
    if ctx.trace:
        outputs, trace = ctx.traced(call, traffic['trace_calls'])
        return dict(values=outputs, trace=trace, record=dict(outputs=outputs))
    ctx.window_start()
    t0 = time.perf_counter()
    outputs, times = [], []
    while True:
        c0 = time.perf_counter()
        outputs.append(call(len(outputs)))
        times.append(time.perf_counter() - c0)
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    p90 = statistics.quantiles(times, n=10)[-1] if len(times) > 1 else times[0]
    metrics = {'eval_ms': elapsed / len(outputs) * 1e3, 'eval_p90_ms': p90 * 1e3}
    return dict(values=outputs, metrics=metrics, record=dict(outputs=outputs))


def check(ctx, record: dict, reference, answer=None):
    """``value_gap``: the largest |value - reference value| over a sample,
    drawn from the seed, of ``check_evals`` of the window's calls (and of
    ``check_rows`` rows of each, where the traffic names it); a value that
    is not finite reads inf. ``answer(drawn)``, where given, stands in for
    the program's answers (the control). Returns the numbers and no line."""
    traffic, outputs = ctx.traffic, record['outputs']
    rng = np.random.default_rng(mix(ctx.seed, -1))
    ks = sorted(rng.choice(len(outputs), size=min(traffic['check_evals'], len(outputs)),
                           replace=False).tolist())
    gap = 0.0
    for k in ks:
        drawn, rows = ctx.draw(k), None
        if 'check_rows' in traffic:
            rows = torch.as_tensor(rng.choice(traffic['batch'], replace=False,
                                              size=min(traffic['check_rows'], traffic['batch'])))
            drawn = {key: v[rows.to(v.device)] for key, v in drawn.items()}
        if answer is not None:
            out = answer(drawn).cpu()
        else:
            out = outputs[k] if rows is None else outputs[k][rows]
        ref = reference.evaluate(ctx.cfg, ctx.inputs, drawn)
        d = float((out.double() - ref.double().cpu()).abs().max())
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return {'value_gap': gap}, []
