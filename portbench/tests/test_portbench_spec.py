"""BENCHMARK.json against the contract, and every name in it resolved to
its files: a cell, configuration, traffic mix or per-layer metric is
added by adding files and entries."""
import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = run.Spec()
DATA = SPEC.data


def test_top_level_keys_and_command():
    assert set(DATA) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert DATA['command'] == ['python3', '-m', 'portbench.run']
    assert DATA['paths'] == ['portbench']
    assert 1 <= DATA['run_seconds'] <= 51
    assert len(json.dumps(DATA).encode()) <= 64 * 1024


@pytest.mark.parametrize('conf', DATA['configs'], ids=lambda c: c['name'])
def test_config_resolves(conf):
    assert set(conf) == {'name', 'source', 'file', 'reduced', 'why'}
    assert NAME.match(conf['name'])
    assert conf['file'] == 'portbench/configs/%s.json' % conf['name']
    body = run.load_json(os.path.join(ROOT, conf['file']))
    assert body['name'] == conf['name']
    assert body['source'] == conf['source']
    assert body['reduced'] == conf['reduced']
    for key in ('width', 'depth', 'length', 'batch', 'dropout', 'dtype'):
        assert key in body
    assert any(w['config'] == conf['name'] for w in DATA['workloads'])


@pytest.mark.parametrize('cell', DATA['workloads'], ids=lambda w: w['name'])
def test_cell_resolves(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert NAME.match(cell['name']) and NAME.match(cell['traffic'])
    assert cell['chips'] == 1
    assert 1 <= len(cell['why']) <= 200 and '\n' not in cell['why']
    resolved = run.Cell(SPEC, cell['name'])
    for fn in ('setup', 'window', 'release', 'end_to_end', 'check',
               'control'):
        assert callable(getattr(resolved.kind, fn))
    e2e = [m['name'] for m in SPEC.metrics_of(cell['name'], 'end_to_end')]
    assert 'setup_s' in e2e and len(e2e) >= 2
    layer = SPEC.metrics_of(cell['name'], 'per_layer')
    assert layer
    assert {m['moves'] for m in layer} <= set(e2e)


@pytest.mark.parametrize('metric', DATA['end_to_end'] + DATA['per_layer'],
                         ids=lambda m: m['name'])
def test_metric_resolves(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    cells = {w['name'] for w in DATA['workloads']}
    assert set(metric.get('workloads', cells)) <= cells
    if metric in DATA['end_to_end']:
        assert set(metric) - {'workloads'} == {
            'name', 'unit', 'better', 'bound', 'source'}
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
        return
    assert set(metric) - {'workloads'} == {
        'name', 'unit', 'better', 'source', 'layer', 'moves'}
    assert metric['source'] in ('device_trace', 'program_span',
                                'program_counter', 'host_clock')
    assert metric['moves'] in {m['name'] for m in DATA['end_to_end']}
    reader = run.load_module(SPEC.metric_path(metric['name']), 'm')
    assert callable(reader.read)
    # each cell that reports it reports the metric it moves
    for cell in metric.get('workloads', cells):
        moved = [m for m in SPEC.metrics_of(cell, 'end_to_end')
                 if m['name'] == metric['moves']]
        assert moved, (metric['name'], cell)


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell added by a traffic file and an entry resolves without an
    edit of any file the benchmark has."""
    root = tmp_path / 'checkout'
    (root / 'portbench').mkdir(parents=True)
    for sub in ('configs', 'traffic', 'kinds', 'metrics'):
        os.symlink(os.path.join(ROOT, 'portbench', sub),
                   root / 'portbench' / sub)
    data = json.loads(json.dumps(DATA))
    data['workloads'].append(dict(data['workloads'][0],
                                  name='german.decode.b10.copy'))
    (root / 'BENCHMARK.json').write_text(json.dumps(data))
    cell = run.Cell(run.Spec(str(root)), 'german.decode.b10.copy')
    assert cell.traffic['kind'] == 'decode'
