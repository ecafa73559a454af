"""Training traffic: a closed loop of Adam steps, one caller, as the port's
``examples.adam_steps`` runs them (copied here, where a change to the
program cannot reach it): zero the gradients, the loss, its backward, the
update, and the loss read on the host.

Set-up drives the cell's own optimizer through its first
``checked_steps`` steps; those are what the reference follows, and the
window goes on from the same object. The window reports ``step_ms``, its
wall time over the steps completed in it, and ``peak_mem_gib``.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from portbench.trace import no_span

NUMBERS = ('loss_gap', 'grad_gap', 'median_step_gap', 'step_gap', 'moved_leaves',
           'left_out_step_gap')
ADAM_EPS = 1e-8     # torch.optim.Adam's default, and the reference's


def run(ctx) -> dict:
    prog, traffic = ctx.program, ctx.traffic
    leaves = prog.leaves
    opt = torch.optim.Adam(list(leaves.values()), lr=traffic['lr'])
    beta1 = opt.defaults['betas'][0]

    def step(i, span=no_span) -> float:
        opt.zero_grad()
        with span('forward'):
            loss = prog.loss()
        with span('backward'):
            loss.backward()
        opt.step()
        return loss.item()

    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses, grads = [], None
    for i in range(traffic['checked_steps']):
        losses.append(step(i))
        if grads is None:
            # the first gradient as the optimizer got it: m_1 = (1 - beta1) g
            # (an optimizer that kept no state got none)
            grads = {k: opt.state[v]['exp_avg'] / (1 - beta1) if 'exp_avg' in opt.state[v]
                     else torch.zeros_like(v) for k, v in leaves.items()}
    record = dict(losses=losses, grads=grads,
                  deltas={k: v.detach() - start[k] for k, v in leaves.items()})
    ctx.setup_done()
    if ctx.trace:
        values, trace = ctx.traced(step, traffic['trace_calls'])
        return dict(values=values, trace=trace, record=record)
    ctx.window_start()
    t0 = time.perf_counter()
    values = []
    while True:
        values.append(step(len(values)))
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    metrics = {'step_ms': elapsed / len(values) * 1e3}
    return dict(values=values, metrics=metrics, record=record)


def check(ctx, record: dict, reference):
    """The reference's own ``checked_steps`` steps from the same inputs,
    against the program's: each step's loss, the first gradient and the
    change of the parameters, by leaf. The leaves are the configuration's
    (``configs/<config>.py::leaves``): one per gate angle, as DeepQuantum
    holds its gates' parameters, and each layer's tensor. Returns the
    numbers and a line on the leaf that reads the largest change gap."""
    ref = reference.train(ctx.cfg, ctx.traffic, ctx.inputs, ctx.traffic['checked_steps'])
    prog, ref = (by_leaf(ctx.cell.config.leaves, r) for r in (record, ref))
    return numbers(prog, ref), [_worst_leaf(prog, ref)]


def by_leaf(split, record: dict) -> dict:
    """A record of the checked steps with its tensors split into leaves."""
    return {k: v if k == 'losses' else split(v) for k, v in record.items()}


def _gaps(prog: dict, ref: dict, keys: list) -> dict:
    norms = {k: float(r.double().norm()) for k, r in ref.items()}
    med = statistics.median(norms.values())
    gaps = {k: abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med) for k in keys}
    return {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}


def _moved(ref: dict) -> list:
    """The leaves that Adam moves by their gradient and not by round-off:
    the reference's gradient, at every checked step, at least a thousandth
    of the median leaf's first gradient and at least 100 times Adam's eps.
    Below that, eps and the gradient's float32 rounding set the step."""
    med = statistics.median(float(g.double().norm()) for g in ref['grads'].values())
    floor = max(1e-3 * med, 100 * ADAM_EPS)
    return [k for k, g in ref['least'].items() if float(g.double().norm()) >= floor]


def numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest |loss - reference loss| over the steps.
    ``grad_gap``: over the leaves, the largest gap between the program's
    norm and the reference's of the first gradient, over the larger of
    that leaf's reference norm and the median leaf's. ``median_step_gap``:
    the same gap of each leaf's change after the steps, its median over
    the leaves that ``_moved`` keeps (a run where it keeps none reads inf).
    Readings only: ``step_gap``, the largest of those; ``moved_leaves``,
    how many ``_moved`` keeps; ``left_out_step_gap``, the largest change
    gap over the others. A kept leaf's later steps follow the left-out
    leaves, whose changes part by round-off, so the largest gap swings
    from seed to seed and the median does not."""
    moved = _moved(ref)
    out = set(ref['deltas']) - set(moved)
    steps = _gaps(prog['deltas'], ref['deltas'], list(ref['deltas']))
    kept = [steps[k] for k in moved]
    return {'loss_gap': max(abs(a - b) for a, b in zip(prog['losses'], ref['losses'])),
            'grad_gap': max(_gaps(prog['grads'], ref['grads'], list(ref['grads'])).values()),
            'median_step_gap': statistics.median(kept) if kept else math.inf,
            'step_gap': max(kept, default=math.inf),
            'moved_leaves': len(moved),
            'left_out_step_gap': max((steps[k] for k in out), default=0.0)}


def _worst_leaf(prog: dict, ref: dict) -> str:
    moved = _moved(ref)
    if not moved:
        return 'no leaf moved by more than round-off'
    steps = _gaps(prog['deltas'], ref['deltas'], moved)
    k = max(steps, key=steps.get)
    med = statistics.median(float(g.double().norm()) for g in ref['grads'].values())
    return (f'largest change gap: leaf {k}, gradient {float(ref["grads"][k].double().norm()):.3e} '
            f'(reference) {float(prog["grads"][k].double().norm()):.3e} (program), least over '
            f'the steps {float(ref["least"][k].double().norm()):.3e}, median leaf '
            f'{med:.3e}; change {float(ref["deltas"][k].double().norm()):.4f} (reference) '
            f'{float(prog["deltas"][k].double().norm()):.4f} (program)')
