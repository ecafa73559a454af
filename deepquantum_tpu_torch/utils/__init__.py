"""Parameter files, training-state checkpoints and timing helpers."""

from .io import load_params, load_train_state, save_params, save_train_state
from .timing import Time, record_time

__all__ = ['save_params', 'load_params', 'save_train_state', 'load_train_state', 'Time',
           'record_time']
