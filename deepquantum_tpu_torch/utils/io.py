"""Parameter files and training-state checkpoints.

PyTorch counterpart of ``deepquantum_tpu/utils/io.py``.

- ``save_params`` / ``load_params``: a circuit's flat parameter state as
  an ``.npz`` of ``pvals`` (float64), ``train_mask`` (bool) and
  ``enc_pidx`` (int64), the JAX package's layout: a file written by either
  package loads into the other's circuit of the same structure.
- ``save_train_state`` / ``load_train_state``: a training state (a dict of
  tensors, numbers, and objects with a ``state_dict``, such as a
  ``torch.optim`` optimizer) through ``torch.save`` / ``torch.load``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['save_params', 'load_params', 'save_train_state', 'load_train_state']


def save_params(cir, filename: str) -> None:
    """Save a circuit's full parameter state."""
    np.savez(filename,
             pvals=np.asarray(cir._pvals, np.float64),
             train_mask=np.asarray(cir._train_mask, bool),
             enc_pidx=np.asarray(cir._enc_pidx, np.int64))


def load_params(cir, filename: str) -> None:
    """Restore a circuit's parameter state (the structure must match)."""
    data = np.load(filename)
    if len(data['pvals']) != len(cir._pvals):
        raise ValueError(f'{filename} holds {len(data["pvals"])} parameters, the circuit '
                         f'{len(cir._pvals)}')
    cir._pvals = [float(v) for v in data['pvals']]
    cir._train_mask = [bool(v) for v in data['train_mask']]
    cir._touch()


def save_train_state(path: str, state: dict) -> None:
    """Write a training state: each value a tensor, a number, or an object
    with ``state_dict()`` (an optimizer, a module), saved as that dict."""
    torch.save({k: v.state_dict() if hasattr(v, 'state_dict') else v for k, v in state.items()},
               str(path))


def load_train_state(path: str, like: dict | None = None) -> dict:
    """Read a state written by ``save_train_state``. Without ``like`` the
    saved dict comes back with its tensors on the CPU. With ``like`` (the
    live state, keyed as saved) an object with ``load_state_dict`` is
    loaded in place, and a tensor comes back on the device and in the dtype
    of ``like``'s, requiring grad where that one does."""
    data = torch.load(str(path), map_location='cpu', weights_only=True)
    if like is None:
        return data
    out = {}
    for key, ref in like.items():
        value = data[key]
        if hasattr(ref, 'load_state_dict'):
            ref.load_state_dict(value)
            out[key] = ref
        elif torch.is_tensor(ref):
            value = value.to(device=ref.device, dtype=ref.dtype)
            out[key] = value.requires_grad_(ref.requires_grad)
        else:
            out[key] = value
    return out
