"""Inputs from ``--seed``: one torch.Generator per stream of draws, on the
device that uses them. Any whole number from 0 up to 2^63 is a seed."""

from __future__ import annotations

import torch

_MASK = (1 << 63) - 1


def mix(seed: int, stream: int) -> int:
    """A generator seed for one stream of the run's seed: the set-up's
    inputs are stream 0, evaluation k's are stream k + 1 (warm-up calls
    take negative k)."""
    return (seed * 0x9E3779B97F4A7C15 + (stream + 2) * 0xBF58476D1CE4E5B9) & _MASK


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, stream))
    return g
