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

    bs = dqt.photonic.Clements(12, init_state=[1] * 6 + [0] * 6, cutoff=7)
    probs = bs(data=angles, is_prob=True)       # boson sampling: one permanent per outcome
    gbs = dqt.photonic.GaussianBosonSampling(10, squeezing, unitary, detector='threshold')
    probs = gbs(is_prob=True)                   # click patterns: a kernel call per click count
"""

from . import photonic
from .circuit import Observable, QubitCircuit
from .config import (cdtype, default_device, rdtype, set_device, set_dtype, set_hbar,
                     set_kappa)
from .interop import from_jax, params_from_numpy, qumode_from_jax
from .ops.qmath import amplitude_encoding, expectation_pauli
from .photonic import FockState, GaussianState, QumodeCircuit, permanent, torontonian
from .state import QubitState

__all__ = ['QubitCircuit', 'Observable', 'QubitState', 'set_dtype', 'set_device', 'cdtype',
           'rdtype', 'default_device', 'from_jax', 'params_from_numpy', 'photonic',
           'QumodeCircuit', 'FockState', 'GaussianState', 'permanent', 'torontonian',
           'qumode_from_jax', 'set_hbar', 'set_kappa', 'amplitude_encoding',
           'expectation_pauli']
