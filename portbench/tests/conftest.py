"""The benchmark's own tests: CPU dry runs of its cells at tiny sizes.

    python -m pytest portbench/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes that the port's CPU twins run in seconds; the widths of the
# circuits stay (5 layers keep the ansatz's median gradient away from 0)
TINY_CFG = {'hea26': {'nqubit': 10}}
TINY_BATCH = {'train': 32, 'eval': 64}


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs an NVIDIA GPU; skipped without one')


def tiny(name: str):
    """The cell ``name`` resolved from BENCHMARK.json, cut to a CPU size."""
    from portbench import harness
    cell = harness.resolve(name)
    cell.cfg.update(TINY_CFG[cell.cfg['name']])
    if 'batch' in cell.traffic:
        cell.traffic['batch'] = TINY_BATCH[cell.traffic['loop']]
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    import deepquantum_tpu_torch as dqt
    dqt.set_device('cpu')
    yield
    dqt.set_device(None)
