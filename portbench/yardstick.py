"""The benchmark's yardstick: the card's published peaks, the least time of
a piece of work, the operations of a circuit as written, and the least
bytes and operations of each port kernel's launch.

Frozen here so that a later change to the program cannot move it. The
peaks and ``bound`` are copied from ``chip_smoke.py``; the kernel rule is
``PERF.md``'s "Bound" column: each input byte read once, each output byte
written once, the operations of the function the kernel is given, and the
larger of bytes over the memory rate and operations over the peak of their
type.
"""

from __future__ import annotations

import re

# published peaks of one H100 SXM at its full power limit (NVIDIA's data
# sheet, dense rates)
PEAK_BYTES_S = 3.35e12       # device memory
PEAK_FP32_S = 67e12          # float32 outside the tensor cores
PEAK_FP64_TC_S = 67e12       # FP64 on the tensor cores (DMMA, dense)

AMP_BYTES = 8                # one complex64 amplitude as two float32 planes

# operations per amplitude of one gate as written: a dense k-qubit gate
# 8 * 2^k (2^k complex multiply-adds), a diagonal one 6, a permutation 0
GATE_OPS = {'rx': 16, 'ry': 16, 'rz': 6, 'cnot': 0, 'x': 0, 'z': 6}
INNER_PRODUCT_OPS = 8        # Re<x|y> per amplitude

# the kernel functions of the port's csrc/, as the profiler names them
# (demangled), with the template arguments that follow the name
PORT_KERNEL = re.compile(
    r'\(anonymous namespace\)::(planar_apply|planar_grad|planar_bwd_fused|window_apply|'
    r'window_chain_fwd|window_chain_bwd|ryser|tor_lu|chain_fwd|chain_bwd)_kernel\b(<[^>]*>)?')


def least_s(nbytes: float, ops: float, peak: float = PEAK_FP32_S) -> float:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    return max(nbytes / PEAK_BYTES_S, ops / peak)


def port_kernel(name: str):
    """(kernel, template arguments) of a profiler record that is one of the
    port's kernels, else None: 'void (anonymous namespace)::planar_apply_kernel
    <3, 1>(float*, ...)' -> ('planar_apply', (3, 1))."""
    m = PORT_KERNEL.search(name)
    if m is None:
        return None
    args = tuple(int(a) for a in re.findall(r'-?\d+', m.group(2) or ''))
    return m.group(1), args


def gate_kernel_cost(kernel: str, targs: tuple, amplitudes: int):
    """(bytes, operations, peak) of one launch of a per-gate kernel on
    ``amplitudes`` complex amplitudes (the batch times 2^n), from its
    template arguments (K, the gate's qubits, comes first); None for a
    kernel whose work the trace cannot give."""
    s = float(amplitudes)
    if kernel == 'planar_apply':                 # K1: y = U x in place
        return 2 * AMP_BYTES * s, 8 * (1 << targs[0]) * s, PEAK_FP32_S
    if kernel == 'planar_grad':                  # K5: dU = g x^H, reads g and x
        return 2 * AMP_BYTES * s, 8 * (1 << targs[0]) * s, PEAK_FP32_S
    if kernel == 'planar_bwd_fused':             # K6: x = U^H y, g' = U^H g, dU
        return 4 * AMP_BYTES * s, 3 * 8 * (1 << targs[0]) * s, PEAK_FP32_S
    if kernel == 'window_apply':                 # K2: a dense 128 x 128 window
        return 2 * AMP_BYTES * s, 8 * 128 * s, PEAK_FP64_TC_S
    return None


def circuit_ops(gates, amplitudes: int, observable, inner_product: bool = True) -> float:
    """Operations of a circuit as written: each gate's ``GATE_OPS`` per
    amplitude, then the observable's Pauli gates and, with
    ``inner_product``, the inner product, over ``amplitudes``."""
    per_amp = sum(GATE_OPS[g] for g in gates) + sum(GATE_OPS[g] for g in observable)
    return float(per_amp + (INNER_PRODUCT_OPS if inner_product else 0)) * amplitudes
