"""A plain statevector simulator in PyTorch: the benchmark's reference.

It imports nothing of the program under test and nothing of JAX. A batch
of states is a (B, 2^n) complex tensor; wire 0 is the most significant bit
of the flat index (the state tensor's first axis). A circuit is a list of
ops ``(gate, wires, angle)``: ``rx`` / ``ry`` / ``rz`` take an angle that is
a 0-dim tensor (shared by the batch) or a (B,) tensor (one per sample),
``cnot`` takes ``(control, target)`` and no angle.

``precision='float64'`` computes in complex128. ``precision='tf32'`` is
the control: complex64 with every operand of a product rounded to TF32 (10
mantissa bits, round to nearest) and the products and sums in float32, as
the tensor cores compute with TF32 on. ``precision='float32'`` is plain
complex64: a witness of what float32 rounding alone does.

The gradient is the adjoint method: one forward pass, then a walk back
that un-applies each gate from the state and from the weighted
observable's image, reading each rotation's derivative as
Im <lambda| G psi> for its generator G. Memory stays at a few states
whatever the depth.
"""

from __future__ import annotations

import torch

PAULI = {'rx': 'x', 'ry': 'y', 'rz': 'z'}


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32 or complex64) with each float rounded to TF32."""
    r = torch.view_as_real(t) if t.is_complex() else t
    bits = r.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.view_as_complex(out) if t.is_complex() else out


class Sim:
    """The arithmetic of one precision."""

    def __init__(self, precision: str = 'float64') -> None:
        if precision not in ('float64', 'float32', 'tf32'):
            raise ValueError(f'precision {precision!r}')
        self.control = precision == 'tf32'
        wide = precision == 'float64'
        self.real = torch.float64 if wide else torch.float32
        self.cplx = torch.complex128 if wide else torch.complex64

    def r(self, t: torch.Tensor) -> torch.Tensor:
        """An operand of a product, in this precision."""
        return tf32(t) if self.control else t

    def matrix(self, gate: str, angle: torch.Tensor, inverse: bool = False):
        """(m00, m01, m10, m11) of a rotation, each of the angle's shape."""
        th = angle.to(self.real) * (-0.5 if inverse else 0.5)
        c = torch.cos(th).to(self.cplx)
        s = torch.sin(th).to(self.cplx)
        if gate == 'rx':
            return c, -1j * s, -1j * s, c
        if gate == 'ry':
            return c, -s, s, c
        if gate == 'rz':
            z = torch.zeros_like(c)
            return c - 1j * s, z, z, c + 1j * s
        raise ValueError(gate)

    def apply(self, psi: torch.Tensor, n: int, op, inverse: bool = False) -> torch.Tensor:
        """The op (or its inverse) applied to each state of psi (B, 2^n)."""
        gate, wires, angle = op
        b = psi.shape[0]
        if gate == 'cnot':
            c, t = wires
            lo, hi = min(c, t), max(c, t)
            v = psi.reshape(b, 1 << lo, 2, 1 << (hi - lo - 1), 2, 1 << (n - hi - 1))
            out = psi.clone()
            ov = out.view(v.shape)
            # control axis 2 (lo) or 4 (hi); the target's axis flips: 3 or 2
            # once the control's axis is taken
            if c == lo:
                ov[:, :, 1].copy_(v[:, :, 1].flip(3))
            else:
                ov[:, :, :, :, 1].copy_(v[:, :, :, :, 1].flip(2))
            return out
        q = wires[0]
        v = psi.reshape(b, 1 << q, 2, 1 << (n - q - 1))
        x0, x1 = self.r(v[:, :, 0]), self.r(v[:, :, 1])
        m = [self.r(e).reshape(-1, 1, 1) if e.dim() else self.r(e)
             for e in self.matrix(gate, angle, inverse)]
        y0 = m[0] * x0 + m[1] * x1
        y1 = m[2] * x0 + m[3] * x1
        return torch.stack((y0, y1), dim=2).reshape(b, -1)

    def pauli_inner(self, lam: torch.Tensor, psi: torch.Tensor, n: int, pauli: str,
                    q: int) -> torch.Tensor:
        """<lam_b| P_q psi_b> for each state b, (B,)."""
        b = psi.shape[0]
        lv = self.r(lam.reshape(b, 1 << q, 2, 1 << (n - q - 1)))
        pv = self.r(psi.reshape(b, 1 << q, 2, 1 << (n - q - 1)))
        l0, l1, p0, p1 = lv[:, :, 0].conj(), lv[:, :, 1].conj(), pv[:, :, 0], pv[:, :, 1]
        if pauli == 'x':
            t = l0 * p1 + l1 * p0
        elif pauli == 'y':
            t = -1j * (l0 * p1) + 1j * (l1 * p0)
        else:
            t = l0 * p0 - l1 * p1
        return t.sum(dim=(1, 2))

    def zero_state(self, b: int, n: int, device) -> torch.Tensor:
        psi = torch.zeros((b, 1 << n), dtype=self.cplx, device=device)
        psi[:, 0] = 1
        return psi

    def forward(self, ops, n: int, b: int, device) -> torch.Tensor:
        psi = self.zero_state(b, n, device)
        for op in ops:
            psi = self.apply(psi, n, op)
        return psi

    def expectation(self, psi: torch.Tensor, n: int, observable):
        """(values (B,), O psi): ``observable`` is 'x_string' (X on every
        wire: the flat index reversed) or ('z', q)."""
        b = psi.shape[0]
        if observable == 'x_string':
            opsi = psi.flip(-1)
        else:
            q = observable[1]
            v = psi.reshape(b, 1 << q, 2, 1 << (n - q - 1))
            opsi = torch.stack((v[:, :, 0], -v[:, :, 1]), dim=2).reshape(b, -1)
        vals = (self.r(psi).conj() * self.r(opsi)).real.sum(-1)
        return vals, opsi

    def value_and_grad(self, ops, n: int, b: int, observable, weight_fn, device):
        """Values E_b of the batch, and the adjoint gradient of
        L = sum_b w_b E_b with w = ``weight_fn(E)`` (B,): one entry per op,
        the op's angle's shape for a rotation (None for a CNOT)."""
        psi = self.forward(ops, n, b, device)
        vals, opsi = self.expectation(psi, n, observable)
        lam = opsi * weight_fn(vals).to(self.cplx).reshape(-1, 1)
        del opsi
        grads = [None] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            gate, wires, angle = ops[i]
            if gate in PAULI:
                g = self.pauli_inner(lam, psi, n, PAULI[gate], wires[0]).imag
                grads[i] = g if angle.dim() else g.sum()
            psi = self.apply(psi, n, ops[i], inverse=True)
            lam = self.apply(lam, n, ops[i], inverse=True)
        return vals, grads


def adam(params: list, grads: list, state: dict, lr: float, betas=(0.9, 0.999),
         eps: float = 1e-8) -> None:
    """One Adam update in place (PyTorch's and optax's rule:
    p -= lr * m_hat / (sqrt(v_hat) + eps))."""
    state['t'] = state.get('t', 0) + 1
    t = state['t']
    for i, (p, g) in enumerate(zip(params, grads)):
        m = state.setdefault(('m', i), torch.zeros_like(p))
        v = state.setdefault(('v', i), torch.zeros_like(p))
        m.mul_(betas[0]).add_(g, alpha=1 - betas[0])
        v.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
        denom = (v / (1 - betas[1] ** t)).sqrt_().add_(eps)
        p.sub_(lr / (1 - betas[0] ** t) * m / denom)
