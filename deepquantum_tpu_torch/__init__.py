"""deepquantum_tpu_torch: the PyTorch/CUDA port of deepquantum_tpu.

The JAX package ``deepquantum_tpu`` stays the reference; this package runs
the same circuits under the same public names with PyTorch, on the CPU
through plain torch and on an NVIDIA H100 through hand-written CUDA kernels
(``csrc/``). It never imports JAX.

The default device is the CUDA card; ``set_device('cpu')`` or
``device='cpu'`` asks for the CPU.

    import deepquantum_tpu_torch as dqt
    cir = dqt.QubitCircuit(18)                  # on the card
    ...
    with torch.inference_mode():                # serving
        cir.expectation()
    p = cir.params.requires_grad_()             # training
    cir.expectation(params=p)[0].backward()     # fills p.grad

    h = cir.hessian()                           # (P, P), reverse over reverse
    counts = cir.measure(shots=1000, generator=torch.Generator('cuda').manual_seed(0))

    noisy = dqt.QubitCircuit(12, den_mat=True)  # rho (2^n, 2^n), the Kraus channels
    noisy.rxlayer(); noisy.cnot_ring(); noisy.depolarizing(0, inputs=0.01)

    qml = dqt.QubitCircuit(14, reupload=True)   # data-encoded QML, a batch at once
    qml.rylayer(encode=True)
    ...
    out = qml.expectation(data=feats, params=p) # feats (B, ndata): out (B, n_obs)

    qft = dqt.QuantumFourierTransform(24)       # the algorithm circuits (dqt.models)
    back = qft.inverse().forward(state=qft.forward(state=ket))
    cir.x(3, controls=0, condition=True)        # mid-circuit measurement, deferred
    state, bits, prob = cir.defer_measure(with_prob=True, generator=gen)
    mps = dqt.QubitCircuit(100, mps=True, chi=64)   # an MPS (mps.py, safe SVD / QR)
    fn = dqt.make_adjoint_expectation(cir)      # params -> <O>, adjoint gradient

    bs = dqt.photonic.Clements(12, init_state=[1] * 6 + [0] * 6, cutoff=7)
    probs = bs(data=angles, is_prob=True)       # boson sampling: one permanent per outcome
    gbs = dqt.photonic.GaussianBosonSampling(10, squeezing, unitary, detector='threshold')
    probs = gbs(is_prob=True)                   # click patterns: a kernel call per click count
    counts = gbs.measure(shots=10**5, generator=gen)   # GBS samples from that table
    cv = dqt.QumodeCircuit(4, backend='bosonic')        # Gaussian / Bosonic: loss, homodyne
    cv.cat(0, r=1.5, p=1); cv.bs([0, 1]); cv.loss_db(1, 3.0); cv.homodyne_x(1)
    cv(); xs = cv.measure_homodyne(shots=1000, generator=gen)
    tdm = dqt.QumodeCircuitTDM(1, 'vac')        # time-domain multiplexing with feedback

    cir = dqt.QubitCircuit(3); cir.add(dqt.RxLayer(3)); cir.add(dqt.CnotRing(3))   # class-style API
    back = dqt.qasm3_to_cir(cir.qasm3()); print(cir.draw())       # QASM 2 / 3, text drawing
    out = cir.pattern(generator=gen)().full_state                  # MBQC (dqt.mbqc)
    dqt.utils.save_params(cir, 'p.npz')                             # parameter files
    dqt.optimizer.OptimizerSPSA(loss, x0).run(100)                  # gradient-free optimizers
    cir.cut(1); cir.rx(1); subs, coeffs = cir.get_subexperiments()  # circuit cutting

    mesh = dqt.parallel.make_mesh(devices=['cuda:0'] * 4)   # four shards on one card
    dist = dqt.DistributedQubitCircuit(28, mesh=mesh)        # the pair-exchange engine
    two = dqt.parallel.make_mesh(devices=['cuda:0'] * 2)
    fock = dqt.DistributedQumodeCircuit(7, 'vac', cutoff=10, mesh=two)   # a sharded Fock tensor
"""

import torch

from . import bitmath, photonic
from .circuit import Observable, QubitCircuit
from .config import (cdtype, default_device, rdtype, set_device, set_dtype, set_hbar,
                     set_kappa)
from .gate import GateOp
from .interop import from_jax, params_from_numpy, pattern_from_jax, qumode_from_jax
from .ops import qmath
from .ops.qmath import (amplitude_encoding, expectation_pauli, inner_product_mps, measure,
                        meyer_wallach_measure, multi_kron, partial_trace, slice_state_vector)
from .photonic import (BosonicState, CatState, FockState, FockStateBosonic, GaussianState,
                       GKPState, QumodeCircuit, QumodeCircuitTDM, cv_to_wigner, hafnian_batch,
                       permanent, takagi, torontonian, williamson)
from .state import QubitState

__all__ = ['QubitCircuit', 'Observable', 'QubitState', 'GateOp', 'set_dtype', 'set_device',
           'cdtype', 'rdtype', 'default_device', 'from_jax', 'params_from_numpy',
           'pattern_from_jax', 'photonic',
           'QumodeCircuit', 'QumodeCircuitTDM', 'FockState', 'GaussianState', 'BosonicState',
           'CatState', 'GKPState', 'FockStateBosonic', 'permanent', 'torontonian', 'takagi',
           'williamson', 'hafnian_batch', 'cv_to_wigner',
           'qumode_from_jax', 'set_hbar', 'set_kappa', 'amplitude_encoding',
           'expectation_pauli', 'inner_product_mps', 'measure', 'meyer_wallach_measure',
           'multi_kron', 'partial_trace', 'slice_state_vector', 'qmath', 'bitmath', 'dtype_map']

# a real dtype -> the complex dtype of the same precision
dtype_map = {torch.float32: torch.complex64, torch.float64: torch.complex128}

# the JAX package's lazy names, loaded on first use
_LAZY_SUBMODULES = ('mps', 'models', 'adjoint', 'channel', 'api', 'cutting', 'qasm', 'optimizer',
                    'draw', 'utils', 'mbqc', 'parallel')
_ANSATZ_NAMES = (
    'Ansatz', 'HHL', 'QuantumFourierTransform', 'QuantumPhaseEstimation',
    'QuantumPhaseEstimationSingleQubit', 'QuantumConvolutionalNeuralNetwork',
    'RandomCircuitG3', 'ShorCircuit', 'ShorCircuitFor15', 'NumberEncoder',
    'PhiAdder', 'PhiModularAdder', 'ControlledMultiplier', 'ControlledUa',
)
_LAZY_ATTRS = {
    'MatrixProductState': ('.mps', 'MatrixProductState'),
    'make_adjoint_expectation': ('.adjoint', 'make_adjoint_expectation'),
    'make_layered_vqe': ('.models.layered', 'make_layered_vqe'),
    'Clements': ('.photonic.ansatz', 'Clements'),
    'GaussianBosonSampling': ('.photonic.ansatz', 'GaussianBosonSampling'),
    'UnitaryDecomposer': ('.photonic.decompose', 'UnitaryDecomposer'),
    'hafnian': ('.photonic.hafnian_', 'hafnian'),
    'GraphGBS': ('.photonic.ansatz', 'GraphGBS'),
    'combine_bosonic_states': ('.photonic.state', 'combine_bosonic_states'),
    'Homodyne': ('.photonic.measurement', 'Homodyne'),
    'Generaldyne': ('.photonic.measurement', 'Generaldyne'),
    'GeneralBosonic': ('.photonic.measurement', 'GeneralBosonic'),
    'PhotonNumberResolvingBosonic': ('.photonic.measurement', 'PhotonNumberResolvingBosonic'),
    'Pattern': ('.mbqc.pattern', 'Pattern'),
    'SubGraphState': ('.mbqc.state', 'SubGraphState'),
    'GraphState': ('.mbqc.state', 'GraphState'),
    'cir_to_qasm3': ('.qasm', 'cir_to_qasm3'),
    'qasm3_to_cir': ('.qasm', 'qasm3_to_cir'),
    'DistributedQubitCircuit': ('.parallel.circuit', 'DistributedQubitCircuit'),
    'DistributedQubitState': ('.parallel.sharded', 'DistributedQubitState'),
    'setup_distributed': ('.parallel.sharded', 'setup_distributed'),
    'cleanup_distributed': ('.parallel.sharded', 'cleanup_distributed'),
    'DistributedFockState': ('.photonic.distributed', 'DistributedFockState'),
    'DistributedQumodeCircuit': ('.photonic.distributed', 'DistributedQumodeCircuit'),
    'UnitaryMapper': ('.photonic.mapper', 'UnitaryMapper'),
    'DrawClements': ('.photonic.draw', 'DrawClements'),
}
# the class-style gate, layer and channel API (api.py)
_API_NAMES = (
    'U3Gate', 'PhaseShift', 'Identity', 'PauliX', 'PauliY', 'PauliZ', 'Hadamard',
    'SGate', 'SDaggerGate', 'TGate', 'TDaggerGate', 'Rx', 'Ry', 'Rz', 'CNOT',
    'Swap', 'ImaginarySwap', 'Rxx', 'Ryy', 'Rzz', 'Rxy',
    'ReconfigurableBeamSplitter', 'Toffoli', 'Fredkin', 'ProjectionJ',
    'UAnyGate', 'LatentGate', 'HamiltonianGate', 'CombinedSingleGate', 'Barrier',
    'BitFlip', 'PhaseFlip', 'Depolarizing', 'Pauli', 'AmplitudeDamping',
    'PhaseDamping', 'GeneralizedAmplitudeDamping',
    'XLayer', 'YLayer', 'ZLayer', 'HLayer', 'RxLayer', 'RyLayer', 'RzLayer',
    'U3Layer', 'CnotLayer', 'CnotRing', 'expectation',
)


def __getattr__(name):
    import importlib
    if name in _LAZY_SUBMODULES:
        return importlib.import_module(f'.{name}', __name__)
    if name in _ANSATZ_NAMES:
        from .models import ansatz
        return getattr(ansatz, name)
    if name in _API_NAMES:
        return getattr(importlib.import_module('.api', __name__), name)
    if name in _LAZY_ATTRS:
        mod, attr = _LAZY_ATTRS[name]
        return getattr(importlib.import_module(mod, __name__), attr)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES) | set(_ANSATZ_NAMES)
                  | set(_API_NAMES) | set(_LAZY_ATTRS))
