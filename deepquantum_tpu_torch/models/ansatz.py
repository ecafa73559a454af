"""Algorithm circuits (the port's ``deepquantum_tpu/models/ansatz.py``).

All circuits are built on the port's QubitCircuit IR: sub-circuits compose
by ``add`` (parameters copied), and gate sharing re-adds one descriptor
(``make_gate``). The gate sequences (QFT, QPE, HHL, the Beauregard Shor
arithmetic, QCNN, the random {CNOT, H, T} circuit) are the JAX package's,
op for op and parameter for parameter; every class also takes the
``device`` its circuits live on.
"""

from __future__ import annotations

import random
from typing import Any

import numpy as np

from ..circuit import QubitCircuit
from ..gate import GATE_REGISTRY, GateOp
from ..ops.qmath import int_to_bitstring, is_unitary

__all__ = [
    'Ansatz', 'ControlledMultiplier', 'ControlledUa', 'HHL', 'NumberEncoder', 'PhiAdder',
    'PhiModularAdder', 'QuantumConvolutionalNeuralNetwork', 'QuantumFourierTransform',
    'QuantumPhaseEstimation', 'QuantumPhaseEstimationSingleQubit', 'RandomCircuitG3',
    'ShorCircuit', 'ShorCircuitFor15', 'make_gate',
]


def _aslist(v) -> list:
    """None -> [], int -> [int], iterable -> list."""
    if v is None:
        return []
    if isinstance(v, int):
        return [v]
    return list(v)


def make_gate(name: str, inputs=None, requires_grad: bool = True) -> GateOp:
    """A standalone descriptor of a registry gate; adding it to one circuit
    again shares its parameters."""
    reg = GATE_REGISTRY[name]
    return GateOp(name=name, wires=(0,), matrix_fn=reg['fn'], npara=reg['npara'],
                  requires_grad=requires_grad, extra={'inputs': inputs})


class Ansatz(QubitCircuit):
    """Base class for algorithm circuits (reference ansatz.py:14)."""

    def __init__(self, nqubit: int, wires=None, minmax=None, ancilla=None, controls=None,
                 init_state: Any = 'zeros', name: str | None = None, den_mat: bool = False,
                 reupload: bool = False, mps: bool = False, chi: int | None = None,
                 device=None) -> None:
        super().__init__(nqubit=nqubit, init_state=init_state, name=name, den_mat=den_mat,
                         reupload=reupload, mps=mps, chi=chi, device=device)
        if wires is None:
            lo, hi = (0, nqubit - 1) if minmax is None else minmax
            wires = list(range(lo, hi + 1))
        self.wires = sorted(_aslist(wires))
        self.ancilla = _aslist(ancilla)
        self.controls = _aslist(controls)
        self.minmax = [self.wires[0], self.wires[-1]]
        reserved = set(self.ancilla) | set(self.controls)
        overlap = reserved.intersection(self.wires)
        assert not overlap, f'ancilla/control wires {sorted(overlap)} collide with data wires'


class QuantumFourierTransform(Ansatz):
    """QFT (reference ansatz.py:565)."""

    def __init__(self, nqubit: int, minmax=None, reverse: bool = False, init_state='zeros',
                 den_mat=False, mps=False, chi=None, device=None,
                 show_barrier: bool = False) -> None:
        super().__init__(nqubit=nqubit, minmax=minmax, init_state=init_state,
                         name='QuantumFourierTransform', den_mat=den_mat, mps=mps, chi=chi,
                         device=device)
        self.reverse = reverse
        for w in self.wires:
            self.qft_block(w)
            if show_barrier:
                self.barrier(self.wires)
        if not reverse:
            half = self.wires[:len(self.wires) // 2]
            for a, b in zip(half, reversed(self.wires)):
                self.swap([a, b])

    def qft_block(self, n: int) -> None:
        """H on wire n, then controlled phases pi/2, pi/4, ... from the
        wires below it."""
        self.h(n)
        for dist in range(1, self.minmax[1] - n + 1):
            self.cp(n + dist, n, np.pi / 2 ** dist)


class QuantumPhaseEstimation(Ansatz):
    """QPE for an arbitrary unitary (reference ansatz.py:621)."""

    def __init__(self, nqubit: int, ncount: int, unitary, minmax=None, den_mat=False,
                 mps=False, chi=None, device=None, show_barrier: bool = False) -> None:
        unitary = np.asarray(unitary, dtype=np.complex128)
        assert is_unitary(unitary)
        n_target = int(np.log2(len(unitary)))
        if minmax is None:
            minmax = [0, ncount + n_target - 1]
        assert minmax[1] - minmax[0] == ncount + n_target - 1
        self.unitary = unitary
        super().__init__(nqubit=nqubit, minmax=minmax, name='QuantumPhaseEstimation',
                         den_mat=den_mat, mps=mps, chi=chi, device=device)
        count_wires = self.wires[:ncount]
        target_wires = self.wires[ncount:]
        self.hlayer(count_wires)
        if show_barrier:
            self.barrier()
        # walk LSB -> MSB so each controlled power is one squaring away
        power = unitary
        for wire in reversed(count_wires):
            self.any(unitary=power, wires=target_wires, controls=wire)
            power = power @ power
        if show_barrier:
            self.barrier()
        iqft = QuantumFourierTransform(nqubit=nqubit, minmax=[count_wires[0], count_wires[-1]],
                                       den_mat=den_mat, mps=mps, chi=chi, device=device).inverse()
        self.add(iqft)


class QuantumPhaseEstimationSingleQubit(Ansatz):
    """QPE for a single-qubit phase gate (reference ansatz.py:687)."""

    def __init__(self, t: int, phase, den_mat=False, mps=False, chi=None, device=None) -> None:
        nqubit = t + 1
        self.phase = phase
        super().__init__(nqubit=nqubit, name='QuantumPhaseEstimationSingleQubit',
                         den_mat=den_mat, mps=mps, chi=chi, device=device)
        self.hlayer(list(range(t)))
        self.x(t)
        for i in range(t):
            self.cp(i, t, np.pi * phase * (2 ** (t - i)))
        iqft = QuantumFourierTransform(nqubit=nqubit, minmax=[0, t - 1],
                                       den_mat=den_mat, mps=mps, chi=chi, device=device).inverse()
        self.add(iqft)


class HHL(Ansatz):
    """HHL linear-system circuit (reference ansatz.py:236)."""

    def __init__(self, ncount: int, mat, t0: float = 1, den_mat=False, mps=False,
                 chi=None, device=None, show_barrier: bool = False) -> None:
        mat = np.asarray(mat, dtype=np.complex128)
        from scipy.linalg import expm
        unitary = expm(1j * mat * (t0 * 2 * np.pi) / 2 ** ncount)
        assert is_unitary(unitary)
        n_target = int(np.log2(len(unitary)))
        nqubit = 1 + ncount + n_target
        self.unitary = unitary
        super().__init__(nqubit=nqubit, name='HHL', den_mat=den_mat, mps=mps, chi=chi,
                         device=device)
        creg = list(range(1, ncount + 1))          # counting register
        qpe = QuantumPhaseEstimation(nqubit=nqubit, ncount=ncount, unitary=unitary,
                                     minmax=[1, nqubit - 1], den_mat=den_mat, mps=mps,
                                     chi=chi, device=device, show_barrier=show_barrier)
        self.add(qpe)
        if show_barrier:
            self.barrier()
        # eigenvalue-inversion rotation on the ancilla, one multi-controlled
        # RY per counting-register value: X-sandwich the zero bits so the
        # all-ones control fires exactly on |i>. Bit j of i (LSB first)
        # corresponds to counting wire 1 + j.
        for i in range(2 ** ncount):
            zero_bits = [creg[j] for j in range(ncount) if not (i >> j) & 1]
            for w in zero_bits:
                self.x(w)
            self.ry(0, inputs=2 * np.pi * i / 2 ** ncount, controls=creg)
            for w in zero_bits:
                self.x(w)
            if show_barrier:
                self.barrier()
        self.add(qpe.inverse())
        if show_barrier:
            self.barrier()


class NumberEncoder(Ansatz):
    """Basis-state encoder for an integer (reference ansatz.py:311)."""

    def __init__(self, nqubit: int, number: int, minmax=None, den_mat=False,
                 mps=False, chi=None, device=None) -> None:
        super().__init__(nqubit=nqubit, minmax=minmax, name='NumberEncoder',
                         den_mat=den_mat, mps=mps, chi=chi, device=device)
        pattern = int_to_bitstring(number, len(self.wires))
        for wire, bit in zip(self.wires, pattern):
            if bit == '1':
                self.x(wire)


class PhiAdder(Ansatz):
    """Fourier-space adder (reference ansatz.py:350, arXiv:quant-ph/0205095 Fig.2-3)."""

    def __init__(self, nqubit: int, number: int, minmax=None, controls=None,
                 den_mat=False, mps=False, chi=None, device=None, debug: bool = False) -> None:
        super().__init__(nqubit=nqubit, minmax=minmax, controls=controls, name='PhiAdder',
                         den_mat=den_mat, mps=mps, chi=chi, device=device)
        bits = int_to_bitstring(number, len(self.wires), debug=debug)
        ctrl = self.controls or None
        for i, wire in enumerate(self.wires):
            # accumulated Fourier-basis phase from bit i downward
            phi = sum(np.pi / 2 ** k
                      for k, bit in enumerate(bits[i:]) if bit == '1')
            if phi:
                self.p(wires=wire, inputs=phi, controls=ctrl)


class PhiModularAdder(Ansatz):
    """Fourier-space modular adder (reference ansatz.py:399, Fig.5)."""

    def __init__(self, nqubit: int, number: int, mod: int, minmax=None, ancilla=None,
                 controls=None, den_mat=False, mps=False, chi=None, device=None,
                 debug: bool = False) -> None:
        if minmax is None:
            minmax = [0, nqubit - 2]
        if ancilla is None:
            ancilla = [minmax[1] + 1]
        super().__init__(nqubit=nqubit, minmax=minmax, ancilla=ancilla, controls=controls,
                         name='PhiModularAdder', den_mat=den_mat, mps=mps, chi=chi, device=device)
        if debug and number >= 2 * mod:
            print(f'The number {number} in {self.name} is too large.')
        kw = dict(den_mat=den_mat, mps=mps, chi=chi, device=device, debug=debug)

        def adder(value, ctrl):
            return PhiAdder(nqubit, value, self.minmax, ctrl, **kw)

        add_n = adder(number, self.controls)
        qft = QuantumFourierTransform(nqubit=nqubit, minmax=self.minmax, reverse=True,
                                      den_mat=den_mat, mps=mps, chi=chi, device=device)
        iqft = qft.inverse()
        sign_wire, flag = self.minmax[0], self.ancilla[0]
        # Beauregard Fig.5: add a, subtract N, detect the sign on the flag
        # ancilla, conditionally re-add N, then uncompute the flag.
        self.add(add_n)
        self.add(adder(mod, None).inverse())
        self.add(iqft)
        self.cnot(sign_wire, flag)
        self.add(qft)
        self.add(adder(mod, self.ancilla))
        self.add(add_n.inverse())
        self.add(iqft)
        self.x(sign_wire)
        self.cnot(sign_wire, flag)
        self.x(sign_wire)
        self.add(qft)
        self.add(add_n)


class ControlledMultiplier(Ansatz):
    """Controlled multiplier (reference ansatz.py:69, Fig.6)."""

    def __init__(self, nqubit: int, a: int, mod: int, minmax=None, nqubitx=None,
                 ancilla=None, controls=None, den_mat=False, mps=False, chi=None, device=None,
                 debug: bool = False) -> None:
        assert isinstance(a, int) and isinstance(mod, int)
        if minmax is None:
            minmax = [0, nqubit - 2]
        if nqubitx is None:
            nqubitx = mod.bit_length()
        if ancilla is None:
            ancilla = [minmax[1] + 1]
        super().__init__(nqubit=nqubit, minmax=minmax, ancilla=ancilla, controls=controls,
                         name='ControlledMultiplier', den_mat=den_mat, mps=mps, chi=chi,
                         device=device)
        assert len(self.wires) >= nqubitx + mod.bit_length() + 1, \
            'quantum register too small for x and the b accumulator'
        x_span = [self.minmax[0], self.minmax[0] + nqubitx - 1]
        b_span = [x_span[1] + 1, minmax[1]]
        qft = QuantumFourierTransform(nqubit=nqubit, minmax=b_span, reverse=True,
                                      den_mat=den_mat, mps=mps, chi=chi, device=device)
        self.add(qft)
        # b += (2^k a) x_bit for each bit of x, LSB = bottom wire of x_span
        for k, xw in enumerate(range(x_span[1], x_span[0] - 1, -1)):
            if debug and 2 ** k * a >= 2 * mod:
                print(f'The number 2^{k}*{a} in {self.name} may be too large, '
                      f'unless the control qubit {xw} is 0.')
            self.add(PhiModularAdder(nqubit=nqubit, number=2 ** k * a, mod=mod,
                                     minmax=b_span, ancilla=self.ancilla,
                                     controls=self.controls + [xw],
                                     den_mat=den_mat, mps=mps, chi=chi, device=device, debug=debug))
        self.add(qft.inverse())


class ControlledUa(Ansatz):
    """Controlled a*x mod N (reference ansatz.py:150, Fig.7)."""

    def __init__(self, nqubit: int, a: int, mod: int, minmax=None, ancilla=None,
                 controls=None, den_mat=False, mps=False, chi=None, device=None,
                 debug: bool = False) -> None:
        nregister = mod.bit_length()
        nancilla = nregister + 2
        if minmax is None:
            minmax = [0, nregister - 1]
        if ancilla is None:
            ancilla = list(range(minmax[1] + 1, minmax[1] + 1 + nancilla))
        super().__init__(nqubit=nqubit, minmax=minmax, ancilla=ancilla, controls=controls,
                         name='ControlledUa', den_mat=den_mat, mps=mps, chi=chi, device=device)
        assert len(self.wires) == nregister and len(self.ancilla) == nancilla

        def multiplier(mult_by):
            return ControlledMultiplier(nqubit=nqubit, a=mult_by, mod=mod,
                                        minmax=[self.minmax[0], self.ancilla[-2]],
                                        nqubitx=nregister, ancilla=self.ancilla[-1],
                                        controls=self.controls, den_mat=den_mat,
                                        mps=mps, chi=chi, device=device, debug=debug)

        # |x, 0> -> |x, ax mod N> -> (swap) |ax mod N, x> -> uncompute x
        self.add(multiplier(a))
        ctrl = self.controls or None
        for data, anc in zip(self.wires, self.ancilla[1:]):
            self.swap([data, anc], controls=ctrl)
        self.add(multiplier(pow(a, -1, mod)).inverse())


class QuantumConvolutionalNeuralNetwork(Ansatz):
    """QCNN ansatz with shared conv/pool parameters (reference ansatz.py:491)."""

    def __init__(self, nqubit: int, nlayer: int, minmax=None, init_state='zeros',
                 den_mat=False, requires_grad: bool = True, mps=False, chi=None,
                 device=None) -> None:
        super().__init__(nqubit=nqubit, minmax=minmax, init_state=init_state,
                         name='QuantumConvolutionalNeuralNetwork', den_mat=den_mat,
                         mps=mps, chi=chi, device=device)
        wires = self.wires
        self.requires_grad = requires_grad
        u_top = make_gate('U3Gate', requires_grad=requires_grad)
        u_bot = make_gate('U3Gate', requires_grad=requires_grad)
        for top, bot in zip(wires[::2], wires[1::2]):
            self.add(u_top, wires=top)
            self.add(u_bot, wires=bot)
        for _ in range(nlayer):
            self.conv(wires)
            self.pool(wires)
            wires = wires[::2]
        self.latent(wires=wires)

    def conv(self, wires):
        two_q = [make_gate(g, requires_grad=self.requires_grad)
                 for g in ('Rxx', 'Ryy', 'Rzz')]
        u_top = make_gate('U3Gate', requires_grad=self.requires_grad)
        u_bot = make_gate('U3Gate', requires_grad=self.requires_grad)
        for offset in (0, 1):           # even pairs, then odd (brick pattern)
            for top, bot in zip(wires[offset::2], wires[offset + 1::2]):
                for g in two_q:
                    self.add(g, wires=[top, bot])
                self.add(u_top, wires=top)
                self.add(u_bot, wires=bot)

    def pool(self, wires):
        cu = make_gate('U3Gate', requires_grad=self.requires_grad)
        for kept, measured in zip(wires[::2], wires[1::2]):
            self.add(cu, wires=kept, controls=measured)


class RandomCircuitG3(Ansatz):
    """Random {CNOT, H, T} circuit (reference ansatz.py:723)."""

    def __init__(self, nqubit: int, ngate: int, wires=None, minmax=None,
                 init_state='zeros', den_mat=False, mps=False, chi=None, device=None) -> None:
        super().__init__(nqubit=nqubit, wires=wires, minmax=minmax, init_state=init_state,
                         name='RandomCircuitG3', den_mat=den_mat, mps=mps, chi=chi, device=device)
        self.ngate = ngate
        self.gate_set = ['CNOT', 'H', 'T']
        emit = {
            'CNOT': lambda: self.cnot(*random.sample(self.wires, 2)),
            'H': lambda: self.h(random.choice(self.wires)),
            'T': lambda: self.t(random.choice(self.wires)),
        }
        for _ in range(ngate):
            emit[random.choice(self.gate_set)]()


class ShorCircuit(Ansatz):
    """Shor's algorithm circuit (reference ansatz.py:774)."""

    def __init__(self, mod: int, ncount: int, a: int, den_mat=False, mps=False,
                 chi=None, device=None, debug: bool = False) -> None:
        nreg = mod.bit_length()
        nqubit = ncount + 2 * nreg + 2
        super().__init__(nqubit=nqubit, name='ShorCircuit', den_mat=den_mat, mps=mps, chi=chi,
                         device=device)
        count_span = [0, ncount - 1]
        work_span = [ncount, ncount + nreg - 1]
        ancilla = list(range(ncount + nreg, nqubit))
        self.hlayer(list(range(ncount)))
        self.x(work_span[1])                       # work register = |1>
        # LSB counting wire applies U_a once; each wire above squares a
        an = a % mod
        for wire in range(ncount - 1, -1, -1):
            self.add(ControlledUa(nqubit=nqubit, a=an, mod=mod, minmax=work_span,
                                  ancilla=ancilla, controls=[wire], den_mat=den_mat,
                                  mps=mps, chi=chi, device=device, debug=debug))
            an = an * an % mod
        self.add(QuantumFourierTransform(nqubit=nqubit, minmax=count_span, den_mat=den_mat,
                                         mps=mps, chi=chi, device=device).inverse())


class ShorCircuitFor15(Ansatz):
    """Compiled Shor circuit for N=15 (reference ansatz.py:840)."""

    def __init__(self, ncount: int, a: int, den_mat=False, mps=False, chi=None,
                 device=None) -> None:
        mod = 15
        nreg = mod.bit_length()
        self.ncount = ncount
        super().__init__(nqubit=ncount + nreg, name='ShorCircuitFor15', den_mat=den_mat,
                         mps=mps, chi=chi, device=device)
        self.hlayer(list(range(ncount)))
        self.x(ncount + nreg - 1)                   # work register = |1>
        power = 1
        for wire in reversed(range(ncount)):
            self.cua(a, power, wire)
            power *= 2
        self.add(QuantumFourierTransform(nqubit=self.nqubit, minmax=[0, ncount - 1],
                                         den_mat=den_mat, mps=mps, chi=chi,
                                         device=device).inverse())

    # mod-15 multiplication compiled to work-register wire permutations
    # (x -> ax mod 15 permutes the 4 dual bits) + X-conjugation for a > 7
    _PERM_SWAPS = {
        2: ((2, 3), (1, 2), (0, 1)), 13: ((2, 3), (1, 2), (0, 1)),
        7: ((0, 1), (1, 2), (2, 3)), 8: ((0, 1), (1, 2), (2, 3)),
        4: ((1, 3), (0, 2)), 11: ((1, 3), (0, 2)),
    }

    def cua(self, a: int, power: int, controls) -> None:
        assert a in self._PERM_SWAPS, f'a={a} is not coprime-compiled for N=15'
        for _ in range(power):
            for lo, hi in self._PERM_SWAPS[a]:
                self.swap([self.ncount + lo, self.ncount + hi], controls)
            if a in (7, 11, 13):
                for q in range(4):
                    self.x(self.ncount + q, controls)
