"""Bit twiddling for amplitude indexing.

PyTorch counterpart of ``deepquantum_tpu/bitmath.py``: the same helpers on
Python ints and on integer tensors (bit 0 is the least significant).
"""

from __future__ import annotations

import torch

__all__ = ['power_of_2', 'is_power_of_2', 'log_base2', 'get_bit', 'flip_bit', 'insert_bit',
           'get_bit_mask']


def power_of_2(n):
    return 1 << n


def is_power_of_2(n) -> bool:
    n = int(n)
    return n > 0 and (n & (n - 1)) == 0


def log_base2(n) -> int:
    return int(n).bit_length() - 1


def get_bit(number, bit_index):
    """Bit at ``bit_index`` (0 = LSB)."""
    return (number >> bit_index) & 1


def flip_bit(number, bit_index):
    """Flip one bit."""
    if torch.is_tensor(number):
        return torch.bitwise_xor(number, 1 << bit_index)
    return number ^ (1 << bit_index)


def insert_bit(number, bit_index, bit_value=0):
    """Insert a bit, shifting the higher bits up."""
    high = (number >> bit_index) << (bit_index + 1)
    low = number & ((1 << bit_index) - 1)
    return high | low | (bit_value << bit_index)


def get_bit_mask(number, nbit):
    """The lowest ``nbit`` bits of ``number``."""
    return number & ((1 << nbit) - 1)
