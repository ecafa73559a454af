"""Adjoint differentiation: gradients in O(1) state memory in the depth.

PyTorch counterpart of ``deepquantum_tpu/adjoint.py``
(``make_adjoint_expectation``, arXiv:2009.02823): the forward keeps only the
final state; the backward un-applies each gate from both the state and
the observable-weighted state and reads each parameter's gradient off
2 Re <lambda| dU |psi>.

On the planar engine (complex64, n >= 10, every fused group on <= 3
wires) that is what ``planar_chain``'s backward already does over the
port's kernels (K3 / K4, or K1 / K5 / K2 step by step), so the callable is
the circuit's own expectation. Elsewhere (complex128, or a group on more
than 3 wires) it is one autograd Function over the op list on the einsum
route: dU comes from the gate's own matrix function through
``torch.autograd.functional.jacobian``, one gate at a time, so nothing
grows with the depth. The JAX package's gather table with dynamic wires
(a scan-compile device) is not carried over.
"""

from __future__ import annotations

import torch

from .config import cdtype, rdtype
from .ops.apply import controlled_matrix, evolve_state

__all__ = ['make_adjoint_expectation']


def _op_matrix(op, full: torch.Tensor) -> torch.Tensor:
    """The op's matrix with its controls embedded."""
    return controlled_matrix(op.matrix(full).to(cdtype()), len(op.controls))


def _op_derivs(op, full: torch.Tensor) -> torch.Tensor:
    """d(matrix)/d(theta_j) for each of the op's parameters: (npara, D, D)."""
    idx = torch.as_tensor(op.pidx, device=full.device)

    def mat(v):
        return torch.view_as_real(_op_matrix(op, full.index_put((idx,), v)).resolve_conj())

    jac = torch.autograd.functional.jacobian(mat, full[idx])        # (D, D, 2, npara)
    return torch.complex(jac[..., 0, :], jac[..., 1, :]).permute(2, 0, 1).to(cdtype())


class _AdjointExpectation(torch.autograd.Function):
    """<psi|O|psi> of the circuit's gates on its initial state; the backward
    walks the gates in reverse."""

    @staticmethod
    def forward(ctx, params, cir, obs, ops):
        n = cir.nqubit
        full = cir._full_params(params.detach())
        psi = cir.init_state.state.to(device=cir.device, dtype=cdtype()).reshape([2] * n)
        for op in ops:
            psi = evolve_state(psi, _op_matrix(op, full), n, list(op.all_wires))
        lam = obs.apply(psi)
        ctx.cir, ctx.ops, ctx.full = cir, ops, full
        ctx.save_for_backward(psi, lam)
        return (psi.conj() * lam).sum().real.to(rdtype())

    @staticmethod
    def backward(ctx, g):
        psi, lam = ctx.saved_tensors
        cir, ops, full = ctx.cir, ctx.ops, ctx.full
        n = cir.nqubit
        grad = torch.zeros(full.shape[0], dtype=rdtype(), device=full.device)
        for op in reversed(ops):
            wires = list(op.all_wires)
            uh = _op_matrix(op, full).conj().transpose(-1, -2)
            psi = evolve_state(psi, uh, n, wires)
            if op.npara and op.requires_grad:
                for j, dmat in enumerate(_op_derivs(op, full)):
                    mu = evolve_state(psi, dmat, n, wires)
                    grad[op.pidx[j]] += 2 * (lam.conj() * mu).sum().real.to(rdtype())
            lam = evolve_state(lam, uh, n, wires)
        idx = torch.as_tensor(cir._train_idx, dtype=torch.long, device=grad.device)
        return g * grad[idx], None, None, None


def make_adjoint_expectation(cir, observable_idx: int = 0):
    """A callable ``params -> <O>`` (the circuit's trainable parameters, O
    its observable ``observable_idx``) whose gradient comes from the
    adjoint method. Data encoders are not fed here (their stored values
    are used), as in the JAX package."""
    if cir.den_mat or cir.mps:
        raise ValueError('the adjoint expectation takes state-vector circuits')
    if cir._planar_ok():
        return lambda params: cir.expectation(params=params)[observable_idx]
    ops = [op for op in cir.operators if op.kind not in ('barrier', 'cut')]
    for op in ops:
        if op.kind != 'gate':
            raise ValueError(f'the adjoint expectation takes unitary gates only, not {op.name}')
    obs = cir.observables[observable_idx]

    def expectation(params):
        params = torch.as_tensor(params, device=cir.device).to(rdtype()).reshape(-1)
        return _AdjointExpectation.apply(params, cir, obs, ops)

    return expectation
