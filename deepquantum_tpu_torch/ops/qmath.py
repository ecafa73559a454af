"""Quantum math helpers: the PyTorch counterpart of
``deepquantum_tpu/ops/qmath.py``: amplitude encoding, Pauli expectations,
measurement by sampling, partial traces, state slicing for deferred
measurement, the Meyer-Wallach measure and the MPS inner product. Samples
are drawn on the state's device with ``torch.multinomial`` from an explicit
``torch.Generator`` (on that device) when one is given, so that a seed fixes
the counts."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..config import cdtype, rdtype

__all__ = ['amplitude_encoding', 'expectation_pauli', 'marginal_probs', 'sample_probs', 'measure',
           'sample2expval', 'inverse_permutation', 'multi_kron', 'partial_trace',
           'slice_state_vector', 'meyer_wallach_measure', 'inner_product_mps', 'is_unitary',
           'is_density_matrix', 'int_to_bitstring', 'sample_sc_mcmc']


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


def inverse_permutation(perm) -> list:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return inv


def multi_kron(lst) -> torch.Tensor:
    """Kronecker product of a list of matrices."""
    if len(lst) == 1:
        return lst[0]
    mid = len(lst) // 2
    return torch.kron(multi_kron(lst[:mid]), multi_kron(lst[mid:]))


def partial_trace(rho: torch.Tensor, nqudit: int, trace_lst, qudit: int = 2) -> torch.Tensor:
    """Trace out the qudits ``trace_lst`` of a density matrix (d^n, d^n), or
    of each of a batch (B, d^n, d^n)."""
    single = rho.dim() == 2
    if single:
        rho = rho[None]
    b = rho.shape[0]
    trace_lst = list(trace_lst)
    k = len(trace_lst)
    keep = [i for i in range(nqudit) if i not in trace_lst]
    perm = [0] + [i + 1 for i in keep] + [i + 1 + nqudit for i in keep] \
        + [i + 1 for i in trace_lst] + [i + 1 + nqudit for i in trace_lst]
    rho = rho.reshape([b] + [qudit] * (2 * nqudit)).permute(perm)
    rho = rho.reshape(b, qudit ** (nqudit - k), qudit ** (nqudit - k), qudit ** k, qudit ** k)
    rho = rho.diagonal(dim1=-2, dim2=-1).sum(-1)
    return rho[0] if single else rho


def slice_state_vector(state: torch.Tensor, nqubit: int, wires, bits: str,
                       normalize: bool = True) -> torch.Tensor:
    """Project a state, or each of a batch, onto the computational-basis
    values ``bits`` of ``wires`` and drop those wires: (batch, 2^(n - k)),
    renormalised unless ``normalize`` is False (a zero projection stays
    zero)."""
    wires = list(wires)
    if len(bits) == 1:
        bits = bits * len(wires)
    if len(wires) != len(bits):
        raise ValueError(f'{len(bits)} bits for {len(wires)} wires')
    state = state.reshape([-1] + [2] * nqubit)
    batch = state.shape[0]
    perm = [w + 1 for w in wires] + [0] + [i + 1 for i in range(nqubit) if i not in wires]
    state = state.permute(perm)
    for b in bits:
        state = state[int(b)]
    state = state.reshape(batch, -1)
    if normalize:
        norm = torch.linalg.vector_norm(state, dim=-1, keepdim=True)
        state = state / torch.where(norm == 0, torch.ones_like(norm), norm)
    return state


def meyer_wallach_measure(state_tsr: torch.Tensor) -> torch.Tensor:
    """Meyer-Wallach entanglement of each state of a (batch, 2, ..., 2)
    tensor."""
    nqubit = state_tsr.dim() - 1
    batch = state_tsr.shape[0]
    rst = torch.zeros(batch, dtype=rdtype(), device=state_tsr.device)
    for i in range(nqubit):
        perm = [0, i + 1] + [j + 1 for j in range(nqubit) if j != i]
        x = state_tsr.permute(perm).reshape(batch, 2, -1)
        s1, s2 = x[:, 0], x[:, 1]
        d = ((s1.abs() ** 2).sum(-1) * (s2.abs() ** 2).sum(-1)
             - (torch.conj(s1) * s2).sum(-1).abs() ** 2)
        rst = rst + d.real.to(rst.dtype)
    return rst * 4 / nqubit


def inner_product_mps(tensors0, tensors1) -> torch.Tensor:
    """<mps0|mps1>, contracted from the left; each site (chi_l, d, chi_r)."""
    env = torch.ones((1, 1), dtype=tensors1[0].dtype, device=tensors1[0].device)
    for a, b in zip(tensors0, tensors1):
        tmp = torch.tensordot(env, b, dims=([1], [0]))                   # (chi0_l, d, chi1_r)
        env = torch.tensordot(torch.conj(a), tmp, dims=([0, 1], [0, 1]))  # (chi0_r, chi1_r)
    return env.reshape(())


def is_unitary(u, atol: float = 1e-4) -> bool:
    u = u.detach().cpu().numpy() if torch.is_tensor(u) else np.asarray(u)
    return bool(np.allclose(u @ u.conj().T, np.eye(u.shape[-1]), atol=atol))


def is_density_matrix(rho, atol: float = 1e-5) -> bool:
    """Hermitian, unit trace and positive semidefinite (each of a batch)."""
    rho = rho.detach().cpu().numpy() if torch.is_tensor(rho) else np.asarray(rho)
    if rho.ndim == 2:
        rho = rho[None]
    herm = np.allclose(rho, np.conj(np.swapaxes(rho, -1, -2)), atol=atol)
    tr = np.allclose(np.trace(rho, axis1=-2, axis2=-1), 1, atol=atol)
    psd = all(np.linalg.eigvalsh(r).min() > -atol for r in rho)
    return bool(herm and tr and psd)


def int_to_bitstring(number: int, nbit: int, debug: bool = False) -> str:
    """An integer as a bit string of length ``nbit`` (its low bits when it
    needs more)."""
    if not isinstance(number, int):
        raise TypeError('number must be an int')
    bits = format(number, 'b')
    if len(bits) <= nbit:
        return bits.zfill(nbit)
    if debug:
        print(f'The number {number} exceeds {nbit} bits and is truncated.')
    return bits[-nbit:]


def sample_sc_mcmc(prob_func=None, proposal_sampler=None, shots: int = 1024,
                   num_chain: int = 5, state=None, generator: torch.Generator | None = None):
    """The reference's MCMC sampler of an MPS: exact ancestral sampling
    replaces it (``mps.measure_mps``), so given an MPS ``state`` this
    samples that; without one it raises."""
    if state is not None:
        from ..mps import measure_mps
        return measure_mps(state, shots=shots, generator=generator)
    raise NotImplementedError('exact sampling replaces MCMC: use QubitCircuit.measure')
