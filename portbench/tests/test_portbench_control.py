"""The comparison that decides ``correct`` fails where it must: the control
(the reference computed in TF32 in the program's place) and the planted
faults that a cell can have, each driven through the rest of a run at a
tiny size on the CPU. No cell runs on several chips or takes a batch, so
the faults of an exchange left out and of half a batch left out have no
cell."""

import time

import pytest
import torch

from test_portbench_layout import CELLS

TRAIN = [c for c in CELLS if c.endswith('.train')]
EVAL = [c for c in CELLS if not c.endswith('.train')]


def _run(cell):
    from portbench import harness
    return harness.run(cell, 2 ** 32 + 99, 0.3, False, 'cpu', time.perf_counter())[0]


@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_the_limits(tiny_cell, name):
    from portbench import calibrate
    cell = tiny_cell(name)
    nums = dict(calibrate.control(cell, 2 ** 32 + 99, 'cpu'))['control_tf32']
    assert any(nums[k] > lim for k, lim in cell.limits.items()), nums


@pytest.mark.parametrize('name', TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny_cell, name, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, 'step', lambda self, closure=None: None)
    result = _run(tiny_cell(name))
    assert result['correct'] is False
    assert all(result['checks'][k]['value'] == 1.0 for k in result['checks'] if 'step' in k)


@pytest.mark.parametrize('name', EVAL)
def test_an_altered_answer_is_not_correct(tiny_cell, name, monkeypatch):
    cell = tiny_cell(name)
    real = cell.config.Program.evaluate
    monkeypatch.setattr(cell.config.Program, 'evaluate',
                        lambda self, drawn: real(self, drawn) + 1e-3)
    assert _run(cell)['correct'] is False


@pytest.mark.parametrize('name', CELLS)
def test_the_sound_run_is_correct(tiny_cell, name):
    assert _run(tiny_cell(name))['correct'] is True
