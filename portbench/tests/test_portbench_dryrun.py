"""Each cell's loop, run on the port's CPU twins at a tiny size, ends in a
result with exactly the contract's keys; without a card the command prints
no result and fails."""

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from test_portbench_layout import CELLS

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('name', CELLS)
def test_dry_run_prints_the_contract_keys(tiny_cell, name, trace):
    from portbench import harness
    cell = tiny_cell(name)
    result, lines, _ = harness.run(cell, 2 ** 33 + 12345, 0.5, bool(trace), 'cpu',
                                time.perf_counter())
    json.dumps(result)
    assert list(result) == KEYS + (['breakdown'] if trace else []) + ['checks']
    assert result['correct'] is True and result['failed'] == 0 and result['attempted'] >= 1
    assert set(result['checks']) == set(cell.limits)
    assert lines[-len(cell.limits):] == [
        f"check {k}: {c['value']!r} limit {c['limit']!r} ok" for k, c in result['checks'].items()]
    if trace:
        assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
        assert {'busy_s', 'window_s'} <= set(result['device'])
        # host spans exist on any device; the device's numbers need the card
        assert set(result['metrics']) == {m['name'] for m in cell.per_layer
                                          if m['name'].startswith('host_ms')}
    else:
        assert set(result['metrics']) == {m['name'] for m in cell.end_to_end}
        assert all(m['value'] > 0 for k, m in result['metrics'].items() if k != 'peak_mem_gib')


def test_without_a_card_no_result():
    proc = subprocess.run([sys.executable, 'portbench/run.py', '--workload', CELLS[0],
                           '--seed', '1', '--seconds', '1', '--trace', '0'],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={'CUDA_VISIBLE_DEVICES': '', 'PATH': '/usr/bin:/bin'})
    assert proc.returncode == 3 and proc.stdout == ''
