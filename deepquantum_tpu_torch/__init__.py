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
"""

from .circuit import Observable, QubitCircuit
from .config import cdtype, default_device, rdtype, set_device, set_dtype
from .interop import from_jax, params_from_numpy
from .state import QubitState

__all__ = ['QubitCircuit', 'Observable', 'QubitState', 'set_dtype', 'set_device', 'cdtype',
           'rdtype', 'default_device', 'from_jax', 'params_from_numpy']
