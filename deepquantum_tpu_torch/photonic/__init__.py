"""Photonic stack of deepquantum_tpu_torch: Fock basis mode, Gaussian and
Bosonic states, loss, homodyne and general-dyne measurement, time-domain
multiplexing, through the permanent and torontonian kernels on the card."""

from . import gates, qmath
from .ansatz import Clements, GaussianBosonSampling, GraphGBS
from .circuit import PhotonicOp, QumodeCircuit
from .decompose import UnitaryDecomposer
from .gaussian_prob import fock_probs_gaussian, probs_gaussian_helper
from .hafnian_ import hafnian, hafnian_batch
from .measurement import GeneralBosonic, Generaldyne, Homodyne, PhotonNumberResolvingBosonic
from .qmath import permanent, permanent_batch, schur_anti_symm_even, sqrtm_herm, takagi, williamson
from .state import (BosonicState, CatState, FockState, FockStateBosonic, GaussianState, GKPState,
                    combine_bosonic_states)
from .tdm import QumodeCircuitTDM
from .torontonian_ import torontonian, torontonian_batch
from .wigner import cv_to_wigner

__all__ = ['QumodeCircuit', 'QumodeCircuitTDM', 'PhotonicOp', 'Clements',
           'GaussianBosonSampling', 'GraphGBS', 'FockState', 'GaussianState', 'BosonicState',
           'CatState', 'GKPState', 'FockStateBosonic', 'combine_bosonic_states', 'Homodyne',
           'Generaldyne', 'GeneralBosonic', 'PhotonNumberResolvingBosonic',
           'UnitaryDecomposer', 'permanent', 'permanent_batch', 'hafnian', 'hafnian_batch',
           'torontonian', 'torontonian_batch', 'fock_probs_gaussian', 'probs_gaussian_helper',
           'takagi', 'williamson', 'sqrtm_herm', 'schur_anti_symm_even', 'cv_to_wigner',
           'gates', 'qmath']
