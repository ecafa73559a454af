"""Time-domain multiplexing.

PyTorch counterpart of ``deepquantum_tpu/photonic/tdm.py``.
``QumodeCircuitTDM`` evolves a circuit with delay loops over time steps with
homodyne feedback: each step runs the unrolled concurrent-mode circuit (one
row of data per sample), shifts the loops, measures every spatial mode, and
feeds the post-measurement state into the next step.
"""

from __future__ import annotations

from typing import Any

import torch

from .circuit import QumodeCircuit

__all__ = ['QumodeCircuitTDM']


class QumodeCircuitTDM(QumodeCircuit):
    """A time-domain-multiplexed photonic circuit (Gaussian or Bosonic)."""

    def __init__(self, nmode: int, init_state: Any, cutoff: int | None = None,
                 backend: str = 'gaussian', name: str | None = None, noise: bool = False,
                 mu: float = 0, sigma: float = 0.1, device=None) -> None:
        if backend not in ('gaussian', 'bosonic'):
            raise ValueError(f"QumodeCircuitTDM: backend {backend!r}, not 'gaussian' or 'bosonic'")
        super().__init__(nmode=nmode, init_state=init_state, cutoff=cutoff, backend=backend,
                         basis=False, detector='pnrd', name=name, noise=noise, mu=mu,
                         sigma=sigma, device=device)
        self.samples = None
        self._samples = None           # (batch, nwire, nstep), in wires_homodyne order

    def __call__(self, data=None, state: Any = None, nstep: int | None = None,
                 generator: torch.Generator | None = None):
        return self.forward(data, state, nstep, generator)

    def forward(self, data=None, state: Any = None, nstep: int | None = None,
                generator: torch.Generator | None = None):
        """Evolve nstep time steps with homodyne feedback; data (batch,
        ntimes, nfeat), (ntimes, nfeat) or None, step i reading time bin
        i % ntimes. Returns the last post-measurement state; the samples,
        (batch, nwire, nstep) squeezed, go to ``self.samples``."""
        if not self._with_delay:
            raise ValueError('QumodeCircuitTDM: no delay loop')
        missing = [i for i in range(self.nmode) if i not in self.wires_homodyne]
        if missing:
            raise ValueError(f'QumodeCircuitTDM: homodyne must measure every spatial mode, not '
                             f'{missing}')
        if data is None:
            nstep = nstep or 1
        else:
            data = self._real(data)
            if data.ndim == 2:
                data = data[None]
            if data.ndim != 3:
                raise ValueError(f'QumodeCircuitTDM: data of shape {tuple(data.shape)}, '
                                 'not (batch, ntimes, nfeat)')
            if nstep is None:
                nstep = data.shape[1]
        self.state = state
        samples = []
        for i in range(nstep):
            if data is None:
                self.state = super().forward(state=self.state)
            else:
                self.state = super().forward(data[:, i % data.shape[1], :], self.state)
            samples.append(self.measure_homodyne(shots=1, generator=generator))
            self.state = list(self.state_measured)
        self.samples = torch.stack([torch.atleast_1d(s) for s in samples], -1)
        self._samples = torch.stack([s.reshape(self.state[1].shape[0], -1) for s in samples], -1)
        return self.state

    def get_samples(self, wires=None):
        """The measured samples of the given spatial modes, (batch, nwire,
        nstep) with no axis squeezed (the JAX package indexes its squeezed
        ``samples``, so with one spatial mode it picks batch rows)."""
        if wires is None:
            wires = list(range(self.nmode))
        wires = sorted([wires] if isinstance(wires, int) else list(wires))
        order = [self.wires_homodyne.index(w) for w in wires]
        return self._samples[:, order, :]
