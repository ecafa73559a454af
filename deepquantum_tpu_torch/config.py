"""Global configuration for deepquantum_tpu_torch: dtype policy and device.

PyTorch counterpart of ``deepquantum_tpu/config.py``. The default device is
the CUDA card: circuits, states and parameters built without a ``device``
land there, and raise on a machine that has none. ``set_device('cpu')`` (or
``device='cpu'`` at the call) asks for the CPU. complex64 is the
default (two float32 planes on the planar engine); complex128 runs the
complex einsum engine. Quantum amplitudes need full-precision float32
products everywhere: TF32 keeps about three decimal digits and drifts
unitarity over tens of gates, so both TF32 switches are turned off here
(the JAX package pins ``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ['set_dtype', 'cdtype', 'rdtype', 'set_device', 'default_device', 'resolve_device',
           'set_hbar', 'set_kappa']

_COMPLEX = torch.complex64
_REAL = torch.float32
_DEVICE = None           # None: the CUDA card, resolved at first use (not at import)

# photonic conventions: x = kappa sqrt(hbar) (a + a^dagger)
HBAR = 2.0
KAPPA = 2 ** (-0.5)

_DTYPES = {
    'complex64': (torch.complex64, torch.float32),
    'complex128': (torch.complex128, torch.float64),
    torch.complex64: (torch.complex64, torch.float32),
    torch.complex128: (torch.complex128, torch.float64),
}


def set_dtype(dtype) -> None:
    """Set the global complex dtype ('complex64' or 'complex128')."""
    global _COMPLEX, _REAL
    key = dtype if isinstance(dtype, torch.dtype) else str(dtype)
    if key not in _DTYPES:
        raise ValueError(f'Unsupported complex dtype: {dtype}')
    _COMPLEX, _REAL = _DTYPES[key]


def cdtype() -> torch.dtype:
    """Current complex dtype."""
    return _COMPLEX


def rdtype() -> torch.dtype:
    """Current real dtype."""
    return _REAL


def default_device() -> torch.device:
    """Current default device (the CUDA card unless ``set_device`` chose
    another)."""
    return torch.device('cuda') if _DEVICE is None else _DEVICE


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (the default device when None). Asking
    for a CUDA device, explicitly or by default, on a machine without one
    raises."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available; call "
                           "set_device('cpu') or pass device='cpu' to run on the CPU")
    return dev


def set_device(device) -> None:
    """Set the default device for new circuits and states; ``None`` restores
    the default (the CUDA card)."""
    global _DEVICE
    _DEVICE = None if device is None else resolve_device(device)


def set_hbar(hbar: float) -> None:
    """Set the reduced Planck constant of the photonic quadratures."""
    global HBAR
    HBAR = hbar


def set_kappa(kappa: float) -> None:
    """Set the kappa convention of the photonic quadratures."""
    global KAPPA
    KAPPA = kappa
