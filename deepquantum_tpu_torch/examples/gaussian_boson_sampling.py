"""Gaussian boson sampling: photon-number (hafnian) and click-pattern
(torontonian) probabilities of a squeezed state through an interferometer,
samples from the photon-number table, and the photon-number means.

On the card every click count's patterns go through one call of the
batched torontonian kernel.

    python -m deepquantum_tpu_torch.examples.gaussian_boson_sampling
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..photonic.ansatz import GaussianBosonSampling

SQUEEZING_4 = [0.5, 0.4, 0.3, 0.2]


def main(nmode: int = 4, cutoff: int = 3, shots: int = 1000, seed: int = 0,
         generator: torch.Generator | None = None, device=None) -> dict:
    """GBS on ``nmode`` modes through scipy's ``unitary_group.rvs(nmode,
    random_state=seed)``, the squeezing the script's at 4 modes, else
    uniform in [0.2, 0.6) from ``numpy.random.default_rng(seed)``. Returns
    the photon-number table at ``cutoff`` (``probs``), ``shots`` samples of
    it drawn from ``generator`` (default: one on the device seeded with
    ``seed``), the photon-number means and variances, the click-pattern
    table and its sum, which must be 1 within 1e-4, and the circuit."""
    from scipy.stats import unitary_group
    dev = resolve_device(device)
    unitary = unitary_group.rvs(nmode, random_state=seed)
    squeezing = SQUEEZING_4 if nmode == 4 else np.random.default_rng(seed).uniform(0.2, 0.6, nmode)
    gbs = GaussianBosonSampling(nmode=nmode, squeezing=squeezing, unitary=unitary, cutoff=cutoff,
                                backend='gaussian', device=dev)
    probs = gbs(is_prob=True)
    print('top outcomes:')
    for fs, p in list(probs.items())[:6]:
        print(f'  {fs}: {float(p):.5f}')
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    samples = gbs.measure(shots=shots, generator=generator)
    print('samples:', {str(k): v for k, v in list(samples.items())[:6]})
    mean, var = gbs.photon_number_mean_var()
    print('photon number mean:', np.round(mean.detach().cpu().numpy(), 4))
    probs_click = gbs(is_prob=True, detector='threshold')
    total = float(torch.stack(list(probs_click.values())).sum())
    print('threshold click-pattern probabilities (top 4):')
    for fs, p in list(probs_click.items())[:4]:
        print(f'  {fs}: {float(p):.5f}')
    print(f'sum over all click patterns = {total:.6f}')
    assert abs(total - 1) < 1e-4, total
    print('PASS')
    return dict(probs=probs, samples=samples, mean=mean, var=var, probs_click=probs_click,
                click_total=total, circuit=gbs)


if __name__ == '__main__':
    main()
