"""State evolution: apply a k-qudit matrix to an n-qudit state tensor.

PyTorch counterpart of ``deepquantum_tpu/ops/apply.py``. A gate on k wires
reshapes the flat state into the 2k+1 segments around its (sorted) target
axes and contracts with one einsum. This complex route is the port's engine
for complex128, for n < 10 and for anything the planar engine does not take.
A batch of states is a (B, 2, ..., 2) tensor with (B, d^k, d^k) matrices
(or one matrix for every sample): the batch axes lead, the einsum carries
them as its ellipsis.
A density matrix of n qudits is a (d,)*2n tensor, the row qudits first:
U rho U^dagger is U on the row wires and conj(U) on the column wires.
The JAX package's tail expansion (``_expand_tail``) exists only to dodge TPU
tile padding and is not carried over.
"""

from __future__ import annotations

import string

import torch

__all__ = ['evolve_state', 'evolve_state_controlled', 'evolve_den_mat', 'evolve_den_mat_controlled',
           'controlled_matrix', 'permute_matrix_wires']

_LETTERS = string.ascii_lowercase + string.ascii_uppercase


def permute_matrix_wires(matrix: torch.Tensor, order, qudit: int = 2) -> torch.Tensor:
    """Reorder the qudit axes of a (d^k, d^k) matrix, or of each matrix of a
    (..., d^k, d^k) stack.

    ``order[j]`` gives, for the j-th output qudit, its position in the
    matrix's original qudit ordering.
    """
    k = len(order)
    if list(order) == list(range(k)):
        return matrix
    lead = tuple(matrix.shape[:-2])
    nl = len(lead)
    t = matrix.reshape(lead + (qudit,) * (2 * k))
    axes = list(range(nl)) + [nl + p for p in order] + [nl + p + k for p in order]
    return t.permute(axes).reshape(lead + (qudit ** k, qudit ** k))


def _apply_sorted(state, matrix, nqudit: int, wires_sorted, qudit: int):
    """Apply a (..., d^k, d^k) matrix to strictly increasing wires of a
    (..., d, ..., d) tensor whose last nqudit axes are the qudits."""
    k = len(wires_sorted)
    d = qudit
    lead = tuple(state.shape[:state.dim() - nqudit])
    shape = []
    prev = -1
    for w in wires_sorted:
        shape.append(d ** (w - prev - 1))
        shape.append(d)
        prev = w
    shape.append(d ** (nqudit - 1 - prev))
    x = state.reshape(lead + tuple(shape))
    m = matrix.reshape(tuple(matrix.shape[:-2]) + (d,) * (2 * k))
    outs = _LETTERS[:k]
    ins = _LETTERS[k:2 * k]
    gaps = _LETTERS[2 * k:3 * k + 1]
    x_sub = gaps[0] + ''.join(i + g for i, g in zip(ins, gaps[1:]))
    y_sub = gaps[0] + ''.join(o + g for o, g in zip(outs, gaps[1:]))
    y = torch.einsum(f'...{outs}{ins},...{x_sub}->...{y_sub}', m, x)
    return y.reshape(tuple(y.shape[:y.dim() - len(shape)]) + (d,) * nqudit)


def evolve_state(state: torch.Tensor, matrix: torch.Tensor, nqudit: int, wires,
                 qudit: int = 2) -> torch.Tensor:
    """Apply ``matrix`` (d^k x d^k) to ``wires`` of a (d,)*n state tensor;
    with leading batch axes on the state, the matrix may carry the same
    axes (one matrix per sample).

    Wire 0 is the leftmost (most significant) tensor axis; the matrix's
    row/column order follows the ``wires`` list order.
    """
    wires = list(wires)
    order = sorted(range(len(wires)), key=lambda i: wires[i])
    if order != list(range(len(wires))):
        # move the axis permutation into the small matrix, not the big state
        matrix = permute_matrix_wires(matrix, order, qudit)
        wires = sorted(wires)
    return _apply_sorted(state, matrix.to(state.dtype), nqudit, wires, qudit)


def controlled_matrix(matrix: torch.Tensor, n_controls: int, qudit: int = 2) -> torch.Tensor:
    """Block-diagonal embedding: identity except the all-ones control block.
    The result acts on (controls..., wires...) in that qubit order; a
    (B, d^k, d^k) stack gives one embedding per sample."""
    if n_controls == 0:
        return matrix
    blk = matrix.shape[-1]
    dim = qudit ** n_controls * blk
    u = torch.eye(dim, dtype=matrix.dtype, device=matrix.device)
    u = u.expand(tuple(matrix.shape[:-2]) + (dim, dim)).clone()
    u[..., dim - blk:, dim - blk:] = matrix
    return u


def evolve_state_controlled(state: torch.Tensor, matrix: torch.Tensor, nqudit: int, wires,
                            controls, qudit: int = 2) -> torch.Tensor:
    """Apply ``matrix`` to ``wires`` on the slice where all ``controls`` are 1."""
    controls = list(controls)
    if not controls:
        return evolve_state(state, matrix, nqudit, list(wires), qudit)
    u = controlled_matrix(matrix, len(controls), qudit)
    return evolve_state(state, u, nqudit, controls + list(wires), qudit)


def evolve_den_mat(state: torch.Tensor, matrix: torch.Tensor, nqudit: int, wires,
                   qudit: int = 2) -> torch.Tensor:
    """rho -> U rho U^dagger on a (d,)*2n density-matrix tensor (leading
    batch axes as ``evolve_state``)."""
    wires = list(wires)
    state = evolve_state(state, matrix, 2 * nqudit, wires, qudit)
    return evolve_state(state, matrix.conj(), 2 * nqudit, [w + nqudit for w in wires], qudit)


def evolve_den_mat_controlled(state: torch.Tensor, matrix: torch.Tensor, nqudit: int, wires,
                              controls, qudit: int = 2) -> torch.Tensor:
    """A controlled gate on a density matrix."""
    controls = list(controls)
    if not controls:
        return evolve_den_mat(state, matrix, nqudit, wires, qudit)
    u = controlled_matrix(matrix, len(controls), qudit)
    return evolve_den_mat(state, u, nqudit, controls + list(wires), qudit)
