"""Photonic mid-circuit measurements on Gaussian and Bosonic states.

PyTorch counterpart of ``deepquantum_tpu/photonic/measurement.py``, the
continuous-variable half. ``Generaldyne`` conditions a state on the outcome
of a Gaussian measurement of covariance ``cov_m`` on some modes, by the
Schur complement (Serafini Eq. 5.143-5.144); a Bosonic state also reweights
its components (arXiv:2103.05530 Eq. 35-37). ``Homodyne`` is its
eps-squeezed limit after a rotation by -phi. ``GeneralBosonic`` conditions
on a POVM element that is itself a weighted sum of Gaussians, and
``PhotonNumberResolvingBosonic`` on a Fock-state POVM element.

Every measurement takes ``samples=`` for a given outcome, and otherwise
draws it from ``generator`` (a ``torch.Generator`` on the state's device;
torch's default one when None). A Gaussian outcome is a multivariate
normal draw. A Bosonic outcome is drawn from the true marginal
p(x) = Re sum_k w_k N(x; mu_k, Sigma_k) (complex means by analytic
continuation; the same expression the reweighting and ``cv_to_wigner``
evaluate) by rejection from the proposal sum_k |w_k| e^(Im mu_k^T
Sigma_k^-1 Im mu_k / 2) N(x; Re mu_k, Sigma_k), which bounds it. (The JAX
package draws a component by |Re w| and samples its Gaussian, which is
not p(x) where weights are negative, as in cat and GKP states.)

Homodyne on Fock tensors (``op_fock``) waits for the Fock slice.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..config import cdtype

__all__ = ['Generaldyne', 'Homodyne', 'GeneralBosonic', 'PhotonNumberResolvingBosonic',
           'sample_bosonic']

# largest (rows x candidates x components) evaluated at once by the sampler
_SAMPLER_CHUNK = 1 << 22
# rounds of candidates after which the sampler gives up on a row
_MAX_ROUNDS = 10000


def _normal(shape, device, dtype, generator):
    """Standard normals drawn in float64 and cast, so that one seed gives
    the same draws whatever the precision of the state."""
    return torch.randn(shape, generator=generator, dtype=torch.float64, device=device).to(dtype)


def _mvn_sample(mean, cov, generator=None):
    """One multivariate normal draw per row: mean (..., d), cov (..., d, d)
    (broadcast against the mean's rows)."""
    chol = torch.linalg.cholesky(cov)
    z = _normal(mean.shape, mean.device, mean.dtype, generator)
    return mean + (chol @ z[..., None])[..., 0]


def _split(nmode: int, wires):
    """The measured rows (x of each wire, then p) and the rest, ascending."""
    wires = np.asarray(wires)
    idx = np.concatenate([wires, wires + nmode])
    rest = np.setdiff1d(np.arange(2 * nmode), idx)
    return idx, rest


def _mixture_parts(cov, mean, weight):
    """Per row and component of a Bosonic marginal cov (R, K, d, d), mean
    (R, K, d, 1) complex, weight (R, K): Re mu, Cholesky factor, inverse,
    log det(2 pi Sigma), Sigma^-1 Im mu, log |w| + Im mu^T Sigma^-1 Im mu / 2
    (the log of each component's bound) and arg w."""
    d = cov.shape[-1]
    m_re, m_im = mean.real[..., 0], mean.imag[..., 0]
    chol = torch.linalg.cholesky(cov)
    inv = torch.cholesky_inverse(chol)
    logdet = 2 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1) + d * math.log(2 * math.pi)
    inv_im = (inv @ m_im[..., None])[..., 0]
    log_bound = torch.log(weight.abs()) + (m_im * inv_im).sum(-1) / 2
    return m_re, chol, inv, logdet, inv_im, log_bound, torch.angle(weight)


def _accept_ratio(x, m_re, inv, logdet, inv_im, log_bound, arg):
    """p(x) / bound(x) in [-1, 1] for candidates x (P, M, d) of P rows,
    the row parts (P, K, ...)."""
    diff = x[:, :, None, :] - m_re[:, None]                          # (P, M, K, d)
    quad = torch.einsum('pmki,pkij,pmkj->pmk', diff, inv, diff)
    phase = torch.einsum('pmki,pki->pmk', diff, inv_im)
    logmag = log_bound[:, None] - quad / 2 - logdet[:, None] / 2
    top = logmag.max(-1, keepdim=True).values
    mag = torch.exp(logmag - top)
    return (mag * torch.cos(arg[:, None] + phase)).sum(-1) / mag.sum(-1)


def sample_bosonic(cov, mean, weight, generator=None):
    """One draw per row from p(x) = Re sum_k w_k N(x; mu_k, Sigma_k): cov
    (R or 1, K, d, d) real, mean (R, K, d, 1) complex, weight (R or 1, K);
    returns (R, d). Rejection sampling: a candidate comes from the bound's
    mixture (component k with probability proportional to |w_k|
    e^(Im mu_k^T Sigma_k^-1 Im mu_k / 2), then N(Re mu_k, Sigma_k)) and is
    kept with probability p(x) / bound(x)."""
    rows = mean.shape[0]
    kdim, d = mean.shape[-3], mean.shape[-2]
    # per-component parts at their own batch, then views over the rows
    parts = _mixture_parts(cov, mean, weight)
    m_re, chol, inv, logdet, inv_im, log_bound, arg = (
        t.expand((rows,) + t.shape[1:]) for t in parts)
    # the bound's integral over its mass 1: draws per accepted sample, on average
    expected = torch.exp(torch.logsumexp(log_bound, -1)).max().item()
    per_row = max(2, min(int(2 * expected) + 1, 64))
    out = torch.empty(rows, d, dtype=m_re.dtype, device=m_re.device)
    pending = torch.arange(rows, device=m_re.device)
    for _ in range(_MAX_ROUNDS):
        if pending.numel() == 0:
            return out
        step = max(1, _SAMPLER_CHUNK // (per_row * kdim))
        left = []
        for part in pending.split(step):
            q = torch.exp(log_bound[part] - log_bound[part].max(-1, keepdim=True).values)
            comps = torch.multinomial(q, per_row, replacement=True, generator=generator)
            pick = part[:, None]
            z = _normal((len(part), per_row, d), m_re.device, m_re.dtype, generator)
            x = m_re[pick, comps] + (chol[pick, comps] @ z[..., None])[..., 0]
            ratio = _accept_ratio(x, m_re[part], inv[part], logdet[part], inv_im[part],
                                  log_bound[part], arg[part])
            u = torch.rand(ratio.shape, generator=generator, dtype=torch.float64,
                           device=m_re.device).to(ratio.dtype)
            hit = u < ratio
            got = hit.any(1)
            first = hit.to(torch.int8).argmax(1)
            out[part[got]] = x[got, first[got]]
            left.append(part[~got])
        pending = torch.cat(left)
    raise RuntimeError(f'sample_bosonic: {pending.numel()} rows without a sample after '
                       f'{_MAX_ROUNDS} rounds (is the state physical?)')


def _rotate(cov, mean, nmode: int, wire: int, phi: float):
    """Rotate one mode's (x, p) by the phase shift phi."""
    c, s = math.cos(phi), math.sin(phi)
    rot = torch.tensor([[c, -s], [s, c]], dtype=cov.dtype, device=cov.device)
    idx = torch.tensor([wire, wire + nmode], device=cov.device)
    cov = cov.index_copy(-2, idx, rot @ cov[..., idx, :])
    cov = cov.index_copy(-1, idx, cov[..., :, idx] @ rot.mT)
    mean = mean.index_copy(-2, idx, rot.to(mean.dtype) @ mean[..., idx, :])
    return cov, mean


class Generaldyne:
    """General-dyne measurement of covariance ``cov_m`` on ``wires`` of a
    Gaussian state [cov, mean] or a Bosonic state [cov, mean, weight]."""

    def __init__(self, cov_m: Any, nmode: int = 1, wires=None, cutoff: int | None = None,
                 den_mat: bool = False, name: str = 'Generaldyne', noise: bool = False,
                 mu: float = 0, sigma: float = 0.1) -> None:
        if noise:
            raise NotImplementedError(f'{name}: noise=True is not ported to '
                                      'deepquantum_tpu_torch yet')
        self.nmode = nmode
        if wires is None:
            wires = list(range(nmode))
        self.wires = [wires] if isinstance(wires, int) else list(wires)
        self.cutoff = 2 if cutoff is None else cutoff
        self.den_mat = den_mat
        self.name = name
        nwire = len(self.wires)
        self.cov_m = np.asarray(cov_m, dtype=np.float64).reshape(2 * nwire, 2 * nwire)
        self.samples = None
        self.npara = 0

    def forward(self, x: list, samples=None, generator=None) -> list:
        """The post-measurement state; the outcome goes to ``self.samples``."""
        cov, mean = x[0], x[1]
        weight = x[2] if len(x) > 2 else None
        cov_out, mean_out, weight_out, self.samples = self._conditioned(
            cov, mean, weight, samples, generator)
        return [cov_out, mean_out] if weight is None else [cov_out, mean_out, weight_out]

    __call__ = forward

    def _given(self, samples, like, shape):
        return torch.as_tensor(np.asarray(samples.detach().cpu() if torch.is_tensor(samples)
                                          else samples, np.float64),
                               device=like.device).to(like.dtype).reshape(shape)

    def _conditioned(self, cov, mean, weight, samples, generator):
        n = self.nmode
        nw = 2 * len(self.wires)
        idx, rest = _split(n, self.wires)
        cov_a = cov[..., rest[:, None], rest]
        cov_ab = cov[..., rest[:, None], idx]
        mean_a, mean_b = mean[..., rest, :], mean[..., idx, :]
        cov_t = cov[..., idx[:, None], idx] + torch.as_tensor(self.cov_m, device=cov.device).to(cov.dtype)
        cov_a = cov_a - cov_ab @ torch.linalg.solve(cov_t, cov_ab.mT)
        # the conditioned covariance keeps the input's batch: it does not
        # depend on the outcome
        cov_out = torch.eye(2 * n, dtype=cov.dtype, device=cov.device).repeat(cov.shape[:-2] + (1, 1))
        cov_out[..., rest[:, None], rest] = cov_a
        if weight is None:                                        # Gaussian
            if samples is None:
                mean_m = _mvn_sample(mean_b[..., 0], cov_t, generator)
            else:
                mean_m = self._given(samples, cov, mean_b.shape[:-2] + (nw,))
            mean_a = mean_a + cov_ab @ torch.linalg.solve(cov_t, mean_m[..., None] - mean_b)
            mean_out = torch.zeros_like(mean)
            mean_out[..., rest, :] = mean_a
            return cov_out, mean_out, None, mean_m
        # Bosonic: reweight the components (arXiv:2103.05530 Eq. 35-37)
        if samples is None:
            mean_m = sample_bosonic(cov_t.reshape((-1,) + cov_t.shape[-3:]),
                                    mean_b.reshape((-1,) + mean_b.shape[-3:]),
                                    weight.reshape(-1, weight.shape[-1]), generator)
        else:
            mean_m = self._given(samples, cov, (1, nw))
        weight, mean_a = _reweight(cov_t, cov_ab, mean_a, mean_b, weight, mean_m)
        mean_out = torch.zeros(mean_a.shape[:-2] + mean.shape[-2:], dtype=mean.dtype,
                               device=mean.device)
        mean_out[..., rest, :] = mean_a
        return cov_out, mean_out, weight, mean_m


def _reweight(cov_t, cov_ab, mean_a, mean_b, weight, mean_m):
    """A Bosonic state's weights and unmeasured means after the outcome
    mean_m (R, d): w_k N(m; mu_k, Sigma_k) normalised, and mu_a + Sigma_ab
    Sigma_t^-1 (m - mu_b) per component."""
    ctype = mean_b.dtype
    rm = mean_m.reshape(-1, 1, mean_m.shape[-1], 1)               # (R, 1, d, 1)
    mb_re, mb_im = mean_b.real, mean_b.imag
    sol_im = torch.linalg.solve(cov_t, mb_im)
    exp_real = torch.exp((mb_im.mT @ sol_im)[..., 0, 0] / 2)
    diff = rm.to(cov_t.dtype) - mb_re
    quad = (diff.mT @ torch.linalg.solve(cov_t, diff))[..., 0, 0]
    prob_g = torch.exp(-quad / 2) / torch.sqrt(torch.linalg.det(2 * math.pi * cov_t))
    exp_imag = torch.exp(1j * (diff.mT @ sol_im)[..., 0, 0].to(ctype))
    weight = weight * exp_real * prob_g * exp_imag
    weight = weight / weight.sum(-1, keepdim=True)
    mean_a = mean_a + cov_ab.to(ctype) @ torch.linalg.solve(cov_t.to(ctype), rm.to(ctype) - mean_b)
    return weight, mean_a


class Homodyne(Generaldyne):
    """Homodyne measurement of the quadrature at angle phi of one mode: the
    state rotated by -phi, then an x-quadrature general-dyne of covariance
    diag(eps^2, 1 / eps^2)."""

    def __init__(self, phi: Any = None, nmode: int = 1, wires=None, cutoff: int | None = None,
                 den_mat: bool = False, eps: float = 2e-4, requires_grad: bool = False,
                 noise: bool = False, mu: float = 0, sigma: float = 0.1,
                 name: str = 'Homodyne') -> None:
        if wires is None:
            wires = [0]
        wires = [wires] if isinstance(wires, int) else list(wires)
        cov_m = np.diag(np.array([eps ** 2] * len(wires) + [1 / eps ** 2] * len(wires)))
        super().__init__(cov_m=cov_m, nmode=nmode, wires=wires, cutoff=cutoff,
                         den_mat=den_mat, name=name, noise=noise, mu=mu, sigma=sigma)
        if len(self.wires) != 1:
            raise ValueError(f'{self.name} must act on one mode')
        if phi is None:
            phi = float(np.random.rand() * 2 * np.pi)
        self.phi = float(np.asarray(phi).reshape(-1)[0])
        self.eps = eps
        self.npara = 1

    def op_cv(self, x: list, samples=None, generator=None) -> list:
        """Rotate by -phi, then the x-quadrature general-dyne."""
        cov, mean = _rotate(x[0], x[1], self.nmode, self.wires[0], -self.phi)
        return super().forward([cov, mean] + list(x[2:]), samples, generator)

    def op_fock(self, x, samples=None, generator=None):
        raise NotImplementedError('Homodyne on Fock tensors (op_fock) is not ported to '
                                  'deepquantum_tpu_torch yet (the Fock slice)')

    def forward(self, x, samples=None, generator=None):
        if isinstance(x, (list, tuple)):
            return self.op_cv(list(x), samples, generator)
        return self.op_fock(x, samples, generator)

    __call__ = forward


class GeneralBosonic(Generaldyne):
    """Conditioning on a Bosonic POVM element, a weighted sum of Gaussians
    (cov_j, weight_j) (arXiv:2103.05530 Eq. 30-31 / 35-37): the state's
    components times the element's."""

    def __init__(self, cov, weight, nmode: int = 1, wires=None, cutoff: int | None = None,
                 name: str = 'GeneralBosonic') -> None:
        wires = list(range(nmode)) if wires is None else (
            [wires] if isinstance(wires, int) else list(wires))
        nwire = len(wires)
        cov = np.asarray(cov, np.float64).reshape(-1, 2 * nwire, 2 * nwire)
        super().__init__(cov_m=cov[0], nmode=nmode, wires=wires, cutoff=cutoff, name=name)
        self.cov_j = cov
        self.weight_j = np.asarray(weight, complex).reshape(-1)

    def forward(self, x: list, samples=None, generator=None) -> list:
        cov, mean = x[0], x[1]
        if cov.ndim == 3:
            cov = cov[:, None]
        if mean.ndim == 3:
            mean = mean[:, None]
        weight = x[2] if len(x) > 2 else torch.ones(cov.shape[:2], dtype=cdtype(),
                                                    device=cov.device)
        cov_out, mean_out, weight_out, self.samples = self._gb_conditioned(
            cov, mean.to(cdtype()), weight.to(cdtype()), samples, generator)
        return [cov_out, mean_out, weight_out]

    __call__ = forward

    def _gb_conditioned(self, cov, mean, weight, samples, generator):
        n = self.nmode
        idx, rest = _split(n, self.wires)
        nj = len(self.weight_j)
        cov_e, mean_e = cov[:, :, None], mean[:, :, None]         # (B, K, 1, ...)
        cov_a = cov_e[..., rest[:, None], rest]
        cov_ab = cov_e[..., rest[:, None], idx]
        mean_a, mean_b = mean_e[..., rest, :], mean_e[..., idx, :]
        cov_t = cov_e[..., idx[:, None], idx] + torch.as_tensor(self.cov_j, device=cov.device).to(cov.dtype)
        cov_a = cov_a - cov_ab @ torch.linalg.solve(cov_t, cov_ab.mT)
        bsz, kdim = cov.shape[0], cov.shape[1]

        def flat(z):
            return z.reshape((z.shape[0], kdim * nj) + z.shape[3:])

        weight_j = torch.as_tensor(self.weight_j, device=cov.device).to(cdtype())
        weight_new = flat(weight[:, :, None] * weight_j)
        cov_new = flat(cov_t.expand(bsz, kdim, nj, *cov_t.shape[-2:]))
        mean_new = flat(mean_b.expand(mean_b.shape[0], kdim, nj, *mean_b.shape[-2:]))
        if samples is None:
            mean_m = sample_bosonic(cov_new, mean_new, weight_new, generator)
        else:
            mean_m = self._given(samples, cov, (1, 2 * len(self.wires)))
        weight_out, mean_a = _reweight(
            cov_new, flat(cov_ab.expand(bsz, kdim, nj, *cov_ab.shape[-2:])),
            flat(mean_a.expand(mean_a.shape[0], kdim, nj, *mean_a.shape[-2:])), mean_new,
            weight_new, mean_m)
        cov_a = flat(cov_a.expand(bsz, kdim, nj, *cov_a.shape[-2:]))
        nt = 2 * n
        cov_out = torch.eye(nt, dtype=cov.dtype, device=cov.device).repeat(cov_a.shape[:2] + (1, 1))
        cov_out[..., rest[:, None], rest] = cov_a
        mean_out = torch.zeros(mean_a.shape[:2] + (nt, 1), dtype=cdtype(), device=cov.device)
        mean_out[..., rest, :] = mean_a
        return cov_out, mean_out, weight_out, mean_m


class PhotonNumberResolvingBosonic(GeneralBosonic):
    """Photon-number-resolving measurement of outcome n on one mode of a
    Bosonic state, through the Fock-state POVM element as Gaussians."""

    def __init__(self, n: int, r: float = 0.05, nmode: int = 1, wires=None,
                 cutoff: int | None = None, name: str = 'PhotonNumberResolvingBosonic') -> None:
        from .state import FockStateBosonic
        wires = [0] if wires is None else ([wires] if isinstance(wires, int) else list(wires))
        state = FockStateBosonic(n, r, cutoff)
        super().__init__(cov=state.cov[0], weight=state.weight[0], nmode=nmode, wires=wires,
                         cutoff=cutoff or state.cutoff, name=name)
        if len(self.wires) != 1:
            raise ValueError(f'{self.name} must act on one mode')

    def forward(self, x: list, samples=None, generator=None) -> list:
        return super().forward(x, samples=np.zeros(2), generator=generator)

    __call__ = forward
