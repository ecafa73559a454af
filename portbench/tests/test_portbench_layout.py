"""Every cell of BENCHMARK.json resolves by name to its pieces, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


@pytest.mark.parametrize('name', CELLS)
def test_cell_resolves_to_its_files(name):
    from portbench import harness
    cell = harness.resolve(name)
    assert callable(cell.config.inputs) and callable(cell.config.draw)
    assert callable(cell.config.leaves) and isinstance(cell.config.Program, type)
    assert callable(cell.reference.evaluate) and callable(cell.reference.train)
    assert callable(cell.counts.least_s) and callable(cell.counts.ops_per_call)
    assert callable(cell.loop.run) and callable(cell.loop.check)
    assert cell.limits and set(cell.limits) <= set(cell.loop.NUMBERS)
    assert set(cell.readers) == {m['name'] for m in cell.per_layer}
    assert all(callable(r.read) for r in cell.readers.values())
    reported = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in reported and len(reported) >= 2 and cell.per_layer
    assert all(m['moves'] in reported for m in cell.per_layer)


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['portbench'] and 1 <= BENCH['run_seconds'] <= 51
    assert not any(w.startswith('/') or '..' in w for w in BENCH['command'])
    names = [c['name'] for c in BENCH['configs']] + CELLS + \
        [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/') and (ROOT / c['file']).is_file()
    assert len({c['file'] for c in BENCH['configs']}) == len(BENCH['configs'])
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    assert len({(w['config'], w['traffic']) for w in BENCH['workloads']}) == len(CELLS)
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound', 'source'}
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source', 'layer', 'moves'}
        assert UNIT.match(m['unit']) and m['moves'] in e2e
        for w in m['workloads']:
            assert w in e2e[m['moves']].get('workloads', CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024
