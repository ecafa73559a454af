"""What the benchmark reads of the program besides its entry points: the
launch counters on the port's kernel wrappers. Each counted call of these
wrappers issues exactly one device launch of a kernel that
``yardstick.PORT_KERNEL`` names; the torontonian wrappers issue one launch
per subset size, so their counters cannot be matched to the trace."""

from __future__ import annotations

import importlib

ONE_LAUNCH = (
    ('ops.planar_gate', 'planar_apply', ('launches', 'batched_launches')),
    ('ops.planar_gate', 'planar_grad', ('launches', 'batched_launches')),
    ('ops.planar_gate', 'planar_bwd_fused', ('launches', 'batched_launches')),
    ('ops.window_gate', 'window_apply', ('launches',)),
    ('ops.chain_kernel', 'window_chain_fwd', ('launches',)),
    ('ops.chain_kernel', 'window_chain_bwd', ('launches',)),
    ('ops.planar_chain_batched', 'planar_chain_batched', ('launches',)),
    ('ops.planar_chain_batched', 'planar_chain_batched_bwd', ('launches',)),
    ('ops.permanent_kernel', 'permanent_cuda_batch', ('launches',)),
)
MANY_LAUNCHES = (
    ('photonic.tor_kernel', 'tor_dets_cuda', ('launches', 'batched_launches')),
    ('photonic.tor_kernel', 'tor_dets_quads_cuda', ('launches', 'batched_launches')),
)


def _read(table) -> dict:
    out = {}
    for mod, fn, attrs in table:
        f = getattr(importlib.import_module(f'deepquantum_tpu_torch.{mod}'), fn)
        for a in attrs:
            out[f'{fn}.{a}'] = getattr(f, a, 0)
    return out


def launch_counts() -> tuple[dict, dict]:
    """(counters of one-launch wrappers, counters of the others)."""
    return _read(ONE_LAUNCH), _read(MANY_LAUNCHES)
