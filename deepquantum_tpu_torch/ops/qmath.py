"""Quantum math helpers (the slice of ``deepquantum_tpu/ops/qmath.py`` the
port needs so far): amplitude encoding, Pauli expectations, and
measurement by sampling. Samples are drawn on the state's device with
``torch.multinomial`` from an explicit ``torch.Generator`` (on that device)
when one is given, so that a seed fixes the counts."""

from __future__ import annotations

from typing import Any

import torch

from ..config import cdtype

__all__ = ['amplitude_encoding', 'expectation_pauli', 'marginal_probs', 'sample_probs', 'measure',
           'sample2expval']


def amplitude_encoding(data: Any, nqubit: int) -> torch.Tensor:
    """Normalise data into state amplitudes, shape (batch, 2^n, 1), or
    (2^n, 1) for one vector: zero-pad or truncate to 2^n, then L2-normalise
    along the last axis (a zero vector stays zero)."""
    data = torch.as_tensor(data)
    single = data.dim() == 1 or (data.dim() == 2 and data.shape[-1] == 1)
    data = data.reshape(1 if single else data.shape[0], -1).to(cdtype())
    n = 2 ** nqubit
    data = data[:, :n]
    norm = torch.linalg.vector_norm(data, dim=-1, keepdim=True)
    data = data / torch.where(norm == 0, torch.ones_like(norm), norm)
    state = torch.nn.functional.pad(data, (0, n - data.shape[1]))[..., None]
    return state[0] if single else state


def expectation_pauli(state: torch.Tensor, obs_state: torch.Tensor,
                      nqubit: int | None = None) -> torch.Tensor:
    """Re<psi|O|psi> given the state and O|psi>; with ``nqubit``, one value
    per state of a batch whose last nqubit axes are the qubits."""
    if nqubit is None:
        return torch.sum(torch.conj(state.reshape(-1)) * obs_state.reshape(-1)).real
    axes = tuple(range(state.dim() - nqubit, state.dim()))
    return torch.sum(torch.conj(state) * obs_state, dim=axes).real


def marginal_probs(probs: torch.Tensor, nqubit: int, wires) -> torch.Tensor:
    """Marginalise a 2^n probability vector onto the sorted ``wires``."""
    wires = sorted(wires)
    if wires == list(range(nqubit)):
        return probs
    perm = wires + [i for i in range(nqubit) if i not in wires]
    p = probs.reshape([2] * nqubit).permute(perm)
    return p.reshape(2 ** len(wires), -1).sum(-1)


def sample_probs(probs: torch.Tensor, shots: int, generator: torch.Generator | None = None):
    """``shots`` outcome indices drawn from a probability vector (need not
    sum to 1), on its device."""
    return torch.multinomial(probs, shots, replacement=True, generator=generator)


def measure(state: torch.Tensor, shots: int = 1024, with_prob: bool = False, wires=None,
            den_mat: bool = False, generator: torch.Generator | None = None):
    """Sample computational-basis outcomes of a state (2^n, 1), a batch
    (B, 2^n, 1), or with ``den_mat`` a density matrix (2^n, 2^n) or a batch
    of them (its diagonal); returns {bitstring: count}, or a list of such
    dicts for a batch. ``wires`` (sorted) are measured, the others summed
    out; ``with_prob`` gives {bitstring: (count, probability)}."""
    if den_mat:
        state = torch.diagonal(state, dim1=-2, dim2=-1)
    single = state.dim() == 1 or (state.dim() == 2 and state.shape[-1] == 1)
    state = state.reshape(1 if single else state.shape[0], -1)
    n = state.shape[-1].bit_length() - 1
    if isinstance(wires, int):
        wires = [wires]
    wires = sorted(wires) if wires is not None else list(range(n))
    out = []
    for s in state:
        probs = s.abs() if den_mat else s.abs() ** 2
        probs = marginal_probs(probs, n, wires)
        counts = torch.bincount(sample_probs(probs, shots, generator), minlength=probs.numel())
        hit = torch.nonzero(counts).reshape(-1)
        keys = [format(int(k), f'0{len(wires)}b') for k in hit.tolist()]
        vals = counts[hit].tolist()
        if with_prob:
            vals = list(zip(vals, probs[hit].tolist()))
        out.append(dict(zip(keys, vals)))
    return out[0] if single else out


def sample2expval(sample: dict) -> float:
    """Measurement counts -> the parity expectation value of the measured
    bits."""
    total = exp = 0
    for bits, count in sample.items():
        exp += count * (-1) ** (bits.count('1') % 2)
        total += count
    return exp / total
