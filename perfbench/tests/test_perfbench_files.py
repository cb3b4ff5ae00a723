"""BENCHMARK.json and every file it names load, keep to the benchmark's
contract (names, units, lengths, the run budget) and agree with each other:
each cell's configuration, traffic and cell file, each traffic's driver,
each configuration's generator, and each per-layer metric's reader, whose
unit, layer and end-to-end metric are those BENCHMARK.json gives."""

import importlib
import importlib.util
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(f'reader_{name.replace(".", "_")}',
                                                  HERE / 'metrics' / f'{name}.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_top_level_keys_and_command():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert 1 <= len(BENCH['command']) <= 32 and all(_line(w) for w in BENCH['command'])
    assert 1 <= len(BENCH['paths']) <= 16
    for path in BENCH['paths']:
        assert PATH.match(path) and not path.startswith('/') and '..' not in path.split('/')
    for word in BENCH['command'][1:]:
        if '/' in word:
            assert any(word.startswith(path + '/') for path in BENCH['paths'])
    assert isinstance(BENCH['run_seconds'], int) and 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_run_budget_holds_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH['run_seconds'] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        names = [entry['name'] for entry in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(name) for name in names), group
    metrics = [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize('config', BENCH['configs'], ids=lambda c: c['name'])
def test_config_file(config):
    assert set(config) == {'name', 'source', 'file', 'reduced', 'why'}
    assert _line(config['source']) and _line(config['why'])
    assert len(config['reduced']) <= 16 and all(NAME.match(k) for k in config['reduced'])
    body = json.loads((ROOT / config['file']).read_text())
    assert config['file'].startswith('perfbench/configs/')
    assert body['name'] == config['name'] and body['source'] == config['source']
    assert body['reduced'] == config['reduced']
    importlib.import_module(f'perfbench.problems.{body["problem"]}')
    assert any(w['config'] == config['name'] for w in BENCH['workloads'])


@pytest.mark.parametrize('cell', BENCH['workloads'], ids=lambda w: w['name'])
def test_cell_files(cell):
    assert set(cell) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert cell['chips'] in (1, 4) and _line(cell['why'])
    assert NAME.match(cell['config']) and NAME.match(cell['traffic'])
    assert any(c['name'] == cell['config'] for c in BENCH['configs'])
    traffic = json.loads((HERE / 'traffic' / f'{cell["traffic"]}.json').read_text())
    driver = importlib.import_module(f'perfbench.drivers.{traffic["driver"]}')
    for function in ('setup', 'window', 'trace', 'close', 'check', 'counts'):
        assert callable(getattr(driver, function))
    limits = json.loads((HERE / 'cells' / f'{cell["name"]}.json').read_text())['limits']
    assert limits and all(isinstance(v, float) and v > 0 for v in limits.values())


def test_pairs_appear_once_and_four_chip_cells_are_few():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    assert sum(w['chips'] == 4 for w in BENCH['workloads']) <= max(1, len(pairs) // 4)


def test_end_to_end_metrics():
    names = {w['name'] for w in BENCH['workloads']}
    assert any(m['name'] == 'setup_s' and m['bound'] <= 0.25 for m in BENCH['end_to_end'])
    for metric in BENCH['end_to_end']:
        assert set(metric) <= {'name', 'unit', 'better', 'bound', 'source', 'workloads'}
        assert UNIT.match(metric['unit']) and metric['better'] in ('lower', 'higher')
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25
        assert set(metric.get('workloads', names)) <= names
    for cell in names:
        reported = [m['name'] for m in BENCH['end_to_end']
                    if cell in m.get('workloads', [cell])]
        assert 'setup_s' in reported and len(reported) >= 2, cell


@pytest.mark.parametrize('metric', BENCH['per_layer'], ids=lambda m: m['name'])
def test_per_layer_metric_and_reader(metric):
    assert set(metric) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
    assert UNIT.match(metric['unit']) and metric['better'] in ('lower', 'higher')
    assert metric['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
    assert _line(metric['layer'])
    ends = {m['name']: m for m in BENCH['end_to_end']}
    assert metric['moves'] in ends
    for cell in metric['workloads']:
        assert cell in ends[metric['moves']].get('workloads', [cell])
    reader = _reader(metric['name'])
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (metric['unit'], metric['layer'],
                                                         metric['moves'])
    assert reader.read({}) is None
    if metric['name'].endswith('_roofline') or 'mfu' in metric['name']:
        assert metric['unit'] == '%'


def test_every_cell_reports_a_per_layer_metric():
    for cell in BENCH['workloads']:
        assert any(cell['name'] in m['workloads'] for m in BENCH['per_layer'])
