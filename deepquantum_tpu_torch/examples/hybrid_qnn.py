"""Hybrid classical-quantum classifier as an ``nn.Module``.

A linear layer feeds a data re-uploading circuit (ry encoders, trainable
rz / ry, a CNOT ring per layer); <Z_0> is the logit. The linear layer and
the circuit's parameters train end to end by Adam through one batched
forward: on the card the batch rides the batched gate-chain kernel, and
the gradient reaches the data through the linear layer.

    python -m deepquantum_tpu_torch.examples.hybrid_qnn
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import QubitCircuit
from ..config import rdtype, resolve_device
from . import adam_steps

N = 4          # qubits
LAYERS = 2     # re-uploading blocks
B = 64         # batch
LR = 0.05


def rings(rng: np.random.Generator, batch: int = B):
    """2 * batch points on two noisy concentric rings (radius 0.5 or 1.5)
    and their labels (outer ring 1), drawn as the JAX script draws them."""
    r = np.where(rng.random(2 * batch) < 0.5, 0.5, 1.5) + rng.normal(0, 0.1, 2 * batch)
    phi = rng.random(2 * batch) * 2 * np.pi
    x = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=1).astype(np.float32)
    return x, (r > 1.0).astype(np.float32)


def build(nqubit: int = N, layers: int = LAYERS, device=None) -> QubitCircuit:
    cir = QubitCircuit(nqubit, device=device)
    for _ in range(layers):
        for i in range(nqubit):
            cir.ry(i, encode=True)
        for i in range(nqubit):
            cir.rz(i)
            cir.ry(i)
        cir.cnot_ring()
    cir.observable(0, basis='z')
    return cir


class HybridQNN(nn.Module):
    """x (B, 2) -> Linear(2, nqubit * layers) -> the circuit's encoders ->
    <Z_0>, (B,). The circuit's trainable angles are the parameter ``q``,
    drawn from ``seed``."""

    def __init__(self, nqubit: int = N, layers: int = LAYERS, device=None,
                 seed: int | None = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.cir = build(nqubit, layers, dev)
        self.cir.init_para(seed)
        self.linear = nn.Linear(2, nqubit * layers, device=dev, dtype=rdtype())
        self.q = nn.Parameter(self.cir.params)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cir.expectation(data=self.linear(x), params=self.q)[..., 0]

    def load_numpy(self, w, b, q) -> None:
        """Take the JAX example's arrays: ``w`` (2, nqubit * layers), the
        weight of ``x @ w + b`` (the linear layer holds its transpose),
        ``b`` and the circuit's parameters ``q``."""
        with torch.no_grad():
            for dst, src in ((self.linear.weight, np.array(w).T), (self.linear.bias, b),
                             (self.q, q)):
                src = src if torch.is_tensor(src) else torch.from_numpy(np.array(src))
                dst.copy_(src.to(dst.dtype))


def loss_fn(model: HybridQNN, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(2.0 * model(x), t)


def train(model: HybridQNN, x: torch.Tensor, t: torch.Tensor, epochs: int) -> list[float]:
    """Full-batch Adam over every parameter of ``model``; each epoch's loss."""
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    return adam_steps(lambda: loss_fn(model, x, t), opt, epochs)


def setup(nqubit: int = N, layers: int = LAYERS, batch: int = B, seed: int = 0, device=None):
    """The model and the data of ``main``: rings and the linear weight
    from ``numpy.random.default_rng(seed)`` (data first, as in the JAX
    script), the circuit's angles from ``seed``. Returns the model and the
    training and test points and labels, on the device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x, y = rings(rng, batch)
    model = HybridQNN(nqubit, layers, dev, seed)
    w = rng.normal(0, 0.5, (2, nqubit * layers)).astype(np.float32)
    model.load_numpy(w, np.zeros(nqubit * layers, np.float32), model.q.detach().cpu())
    x, y = (torch.as_tensor(a, dtype=rdtype(), device=dev) for a in (x, y))
    return model, x[:batch], y[:batch], x[batch:], y[batch:]


def main(nqubit: int = N, layers: int = LAYERS, batch: int = B, epochs: int = 60,
         seed: int = 0, device=None, bar: float | None = 0.85) -> dict:
    """Train on ``batch`` points, test on ``batch`` more (``setup``).
    Returns each epoch's loss, the test accuracy and the model; asserts the
    accuracy > ``bar`` (None: no assertion)."""
    model, x, y, x_test, y_test = setup(nqubit, layers, batch, seed, device)
    losses = train(model, x, y, epochs)
    for epoch in range(0, epochs, 15):
        print(f'epoch {epoch}: loss = {losses[epoch]:.4f}')
    with torch.no_grad():
        pred = model(x_test) > 0
    acc = float((pred == (y_test > 0.5)).float().mean())
    print(f'test accuracy = {acc:.3f}')
    if bar is not None:
        assert acc > bar, acc
        print('PASS')
    return dict(losses=losses, acc=acc, model=model)


if __name__ == '__main__':
    main()
