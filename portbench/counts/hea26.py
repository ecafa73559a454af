"""Operations and bytes of ``hea26``: the ansatz as written, and each
per-gate kernel launch on the one 2^n state."""

from __future__ import annotations

from portbench import yardstick as ys


def gates(cfg: dict) -> list:
    n = cfg['nqubit']
    layer = [g for _ in range(n) for g in cfg['rotations']] + ['cnot'] * n
    return layer * cfg['layers']


def forward_ops(cfg: dict) -> float:
    """Forward and <X...X>: every gate, the X string (a permutation) and
    the inner product, on 2^n amplitudes."""
    n = cfg['nqubit']
    return ys.circuit_ops(gates(cfg), 1 << n, ['x'] * n)


def ops_per_call(cfg: dict, traffic: dict) -> float:
    """A training step counts three forwards; an evaluation one."""
    return (3 if traffic['loop'] == 'train' else 1) * forward_ops(cfg)


def least_s(port: list, calls: int, cfg: dict, traffic: dict):
    """(the least seconds of the port-kernel launches ``port``, a list of
    (kernel, template arguments, seconds); the kernels left out)."""
    total, left = 0.0, []
    for kernel, targs, _ in port:
        cost = ys.gate_kernel_cost(kernel, targs, 1 << cfg['nqubit'])
        if cost is None:
            left.append(kernel)
        else:
            total += ys.least_s(*cost)
    return total, left
