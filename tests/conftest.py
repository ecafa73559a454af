"""Test harness: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-chip sharding is validated on virtual CPU devices (the driver dry-runs
the same path); TPU runs happen in bench.py. x64 gives us 1e-6-level parity
with the float64 torch reference oracle.
"""

import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = flags + ' --xla_force_host_platform_device_count=8'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_num_cpu_devices', 8)
jax.config.update('jax_enable_x64', True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepquantum_tpu  # noqa: E402

deepquantum_tpu.set_dtype('complex128')

# The mounted PyTorch reference acts as the tier-2 numerical oracle.
# Stub its draw/optimizer-only deps (qiskit/svgwrite/bayes_opt) that are not
# in this image — they are never exercised numerically.
REFERENCE_SRC = '/root/reference/src'
if os.path.isdir(REFERENCE_SRC) and REFERENCE_SRC not in sys.path:
    sys.path.insert(0, REFERENCE_SRC)
    import types

    for _name, _attrs in {
        'qiskit': ['QuantumCircuit'],
        'svgwrite': ['Drawing'],
        'bayes_opt': ['BayesianOptimization', 'UtilityFunction'],
    }.items():
        if _name not in sys.modules:
            try:
                __import__(_name)
            except ImportError:
                _mod = types.ModuleType(_name)
                for _a in _attrs:
                    setattr(_mod, _a, type(_a, (), {}))
                sys.modules[_name] = _mod


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU (CUDA kernels of deepquantum_tpu_torch); '
        'skipped without one; on the card run `pytest --noconftest -m cuda tests/test_torch_cuda.py`')
