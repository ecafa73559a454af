"""``hea26``: DeepQuantum's gradient-benchmark ansatz through the port's
``QubitCircuit``. Per layer rx, rz, rx on every wire and a CNOT ring; the
observable is X on every wire. The entry is
``QubitCircuit.expectation(params=...)``; the parameters are the cell's
inputs, drawn from the seed on the device."""

from __future__ import annotations

import math

import torch

from portbench.seeds import generator


def nparams(cfg: dict) -> int:
    return cfg['nqubit'] * cfg['layers'] * len(cfg['rotations'])


def _angles(cfg: dict, g: torch.Generator, device) -> torch.Tensor:
    return torch.rand(nparams(cfg), generator=g, device=device) * (2 * math.pi)


def inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The set-up's inputs: the starting parameters."""
    return {'params': _angles(cfg, generator(seed, 0, device), device)}


def draw(cfg: dict, traffic: dict, seed: int, k: int, device) -> dict:
    """Evaluation k's inputs: fresh parameters."""
    return {'params': _angles(cfg, generator(seed, k + 1, device), device)}


def leaves(params: dict) -> dict:
    """The compared leaves: each gate's angle (a DeepQuantum gate holds its
    own parameter)."""
    return {f'params[{i}]': v for i, v in enumerate(params['params'])}


class Program:
    """The circuit, built once in set-up, and its trainable leaf."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device) -> None:
        import deepquantum_tpu_torch as dqt
        dqt.set_dtype(cfg['precision'])
        n = cfg['nqubit']
        cir = dqt.QubitCircuit(n, device=device)
        for _ in range(cfg['layers']):
            for q in range(n):
                for gate in cfg['rotations']:
                    getattr(cir, gate)(q)
            cir.cnot_ring()
        cir.observable(list(range(n)), basis='x' * n)
        self.cir = cir
        self.leaves = {'params': inputs['params'].clone().requires_grad_()}

    def loss(self) -> torch.Tensor:
        return self.cir.expectation(params=self.leaves['params'])[0]

    def evaluate(self, drawn: dict) -> torch.Tensor:
        with torch.no_grad():
            return self.cir.expectation(params=drawn['params'])
