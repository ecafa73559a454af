"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""

import subprocess
import sys
import time
import types

import pytest

from conftest import ROOT

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'deepquantum_tpu')

RUN_ALL = f'''
import sys, time
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'portbench' / 'tests')!r})
import deepquantum_tpu_torch as dqt
dqt.set_device('cpu')
from conftest import tiny
from portbench import harness, calibrate
for name in ('hea26.eval', 'hea26.train'):
    harness.run(tiny(name), 5, 0.2, True, 'cpu', time.perf_counter())
print(sorted({{m.split('.')[0] for m in sys.modules}}))
'''

REFERENCE_ONLY = f'''
import sys, pathlib, importlib.util
sys.path.insert(0, {str(ROOT)!r})
for p in sorted(pathlib.Path({str(ROOT / 'portbench' / 'reference')!r}).glob('*.py')):
    spec = importlib.util.spec_from_file_location('ref_' + p.stem, p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted({{m.split('.')[0] for m in sys.modules}}))
'''


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True,
                         timeout=600, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level(RUN_ALL)
    assert 'deepquantum_tpu_torch' in mods and not mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = _top_level(REFERENCE_ONLY)
    assert 'torch' in mods and not mods & set(FORBIDDEN + ('deepquantum_tpu_torch',))


def test_a_run_that_loads_jax_late_prints_no_result(tiny_cell, monkeypatch):
    """JAX loaded after the window, in the reference check, still stops the
    result: the harness looks at ``sys.modules`` last, before the result."""
    from portbench import harness
    cell = tiny_cell('hea26.eval')
    check = cell.loop.check

    def late(*args, **kw):
        monkeypatch.setitem(sys.modules, 'jax', types.ModuleType('jax'))
        return check(*args, **kw)

    monkeypatch.setattr(cell.loop, 'check', late)
    with pytest.raises(harness.CellError, match='jax'):
        harness.run(cell, 7, 0.2, False, 'cpu', time.perf_counter())


def test_the_jax_package_is_told_from_the_port(monkeypatch):
    from portbench import harness
    harness.check_modules()
    monkeypatch.setitem(sys.modules, 'deepquantum_tpu.ops', types.ModuleType('deepquantum_tpu.ops'))
    with pytest.raises(harness.CellError, match='deepquantum_tpu'):
        harness.check_modules()
