"""Photonic stack of deepquantum_tpu_torch: Fock basis mode, Fock tensors
(dense, density matrices, MPS), Gaussian and Bosonic states, loss, homodyne
and general-dyne measurement, time-domain multiplexing, through the
permanent and torontonian kernels on the card; a Fock tensor sharded over a
mesh (``distributed``), drawing, the unitary mapper and sample files."""

from .. import config
from ..config import set_hbar, set_kappa
from . import gates, qmath
from .ansatz import Clements, GaussianBosonSampling, GraphGBS
from .circuit import PhotonicOp, QumodeCircuit
from .decompose import UnitaryDecomposer
from .gaussian_prob import fock_probs_gaussian, probs_gaussian_helper
from .hafnian_ import hafnian, hafnian_batch
from .measurement import GeneralBosonic, Generaldyne, Homodyne, PhotonNumberResolvingBosonic
from .qmath import (ladder_ops, ladder_to_quadrature, perm_chunksize_dict, permanent,
                    permanent_batch, quadrature_to_ladder, schur_anti_symm_even,
                    set_perm_chunksize, sqrtm_herm, takagi, williamson, xpxp_to_xxpp,
                    xxpp_to_xpxp)
from .state import (BosonicState, CatState, FockState, FockStateBosonic, GaussianState, GKPState,
                    combine_bosonic_states)
from .tdm import QumodeCircuitTDM
from .torontonian_ import torontonian, torontonian_batch
from .wigner import cv_to_wigner, fock_to_wigner

__all__ = ['QumodeCircuit', 'QumodeCircuitTDM', 'PhotonicOp', 'Clements',
           'GaussianBosonSampling', 'GraphGBS', 'FockState', 'GaussianState', 'BosonicState',
           'CatState', 'GKPState', 'FockStateBosonic', 'combine_bosonic_states', 'Homodyne',
           'Generaldyne', 'GeneralBosonic', 'PhotonNumberResolvingBosonic',
           'UnitaryDecomposer', 'permanent', 'permanent_batch', 'hafnian', 'hafnian_batch',
           'torontonian', 'torontonian_batch', 'fock_probs_gaussian', 'probs_gaussian_helper',
           'takagi', 'williamson', 'sqrtm_herm', 'schur_anti_symm_even', 'cv_to_wigner',
           'fock_to_wigner', 'ladder_ops', 'gates', 'qmath', 'perm_chunksize_dict',
           'set_perm_chunksize', 'xxpp_to_xpxp', 'xpxp_to_xxpp', 'quadrature_to_ladder',
           'ladder_to_quadrature', 'hbar', 'kappa', 'set_hbar', 'set_kappa']

# the class-style API (api.py), loaded on first use
_API_NAMES = (
    'PhaseShift', 'BeamSplitter', 'MZI', 'BeamSplitterTheta', 'BeamSplitterPhi',
    'BeamSplitterSingle', 'UAnyGate', 'Squeezing', 'Squeezing2', 'Displacement',
    'DisplacementPosition', 'DisplacementMomentum', 'QuadraticPhase',
    'ControlledX', 'ControlledZ', 'CubicPhase', 'Kerr', 'CrossKerr',
    'PhotonLoss', 'Delay', 'DelayBS', 'DelayMZI', 'Barrier',
)


# the distributed Fock tensor and the periphery, loaded on first use
_LAZY_SUBMODULES = ('api', 'distributed', 'draw', 'mapper', 'utils')
_LAZY_ATTRS = {
    'DistributedFockState': ('.distributed', 'DistributedFockState'),
    'DistributedQumodeCircuit': ('.distributed', 'DistributedQumodeCircuit'),
    'UnitaryMapper': ('.mapper', 'UnitaryMapper'),
    'DrawCircuit': ('.draw', 'DrawCircuit'),
    'DrawClements': ('.draw', 'DrawClements'),
    'quadrature_ladder_transform': ('.qmath', 'quadrature_to_ladder'),
}
# the quadrature conventions, read when asked (set_hbar / set_kappa change them)
_CONVENTIONS = {'hbar': 'HBAR', 'kappa': 'KAPPA'}


def __getattr__(name):
    import importlib
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f'.{name}', __name__)
    if name in _API_NAMES:
        return getattr(importlib.import_module('.api', __name__), name)
    if name in _LAZY_ATTRS:
        mod, attr = _LAZY_ATTRS[name]
        return getattr(importlib.import_module(mod, __name__), attr)
    if name in _CONVENTIONS:
        return getattr(config, _CONVENTIONS[name])
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_API_NAMES) | set(_LAZY_SUBMODULES) | set(_LAZY_ATTRS)
                  | set(_CONVENTIONS))
