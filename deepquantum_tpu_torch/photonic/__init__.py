"""Photonic stack of deepquantum_tpu_torch: Fock basis mode and Gaussian
states, through the permanent and torontonian kernels on the card."""

from . import gates, qmath
from .ansatz import Clements, GaussianBosonSampling
from .circuit import PhotonicOp, QumodeCircuit
from .decompose import UnitaryDecomposer
from .gaussian_prob import fock_probs_gaussian, probs_gaussian_helper
from .hafnian_ import hafnian
from .qmath import permanent, permanent_batch
from .state import FockState, GaussianState
from .torontonian_ import torontonian, torontonian_batch

__all__ = ['QumodeCircuit', 'PhotonicOp', 'Clements', 'GaussianBosonSampling', 'FockState',
           'GaussianState', 'UnitaryDecomposer', 'permanent', 'permanent_batch', 'hafnian',
           'torontonian', 'torontonian_batch', 'fock_probs_gaussian',
           'probs_gaussian_helper', 'gates', 'qmath']
