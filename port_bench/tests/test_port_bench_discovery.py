"""Cells, configurations and metrics are found by their names."""

import json
import os
import shutil

import pytest

from port_bench import cells
from port_bench import run


def test_every_cell_of_the_benchmark_loads():
  bench = cells.benchmark()
  for entry in bench['workloads']:
    cell = cells.load(entry['name'], bench)
    assert cell['workload']['chips'] == entry['chips']
    config = {c['name']: c for c in bench['configs']}[entry['config']]
    assert os.path.exists(os.path.join(cells.ROOT, config['file']))


def test_every_metric_has_a_reader():
  bench = cells.benchmark()
  for metric in bench['per_layer']:
    assert callable(run.metric_reader(metric['name']))
    assert run.metric_reader(metric['name'])({}) is None


def test_each_cell_reports_what_its_layer_metrics_move():
  bench = cells.benchmark()
  for entry in bench['workloads']:
    e2e, layer = run.cell_metrics(bench, entry['name'])
    names = {m['name'] for m in e2e}
    assert 'setup_s' in names and len(names) >= 2 and layer
    assert all(m['moves'] in names for m in layer)


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
  copy = tmp_path / 'port_bench'
  shutil.copytree(cells.BENCH_DIR, copy,
                  ignore=shutil.ignore_patterns('__pycache__', '_cache'))
  shutil.copy(os.path.join(cells.ROOT, 'BENCHMARK.json'), tmp_path)
  monkeypatch.setattr(cells, 'BENCH_DIR', str(copy))
  monkeypatch.setattr(cells, 'ROOT', str(tmp_path))
  return copy


def test_a_new_cell_file_is_found_by_name(bench_copy):
  workload = json.loads((bench_copy / 'workloads' /
                         'deep.anakin.b32.json').read_text())
  traffic = json.loads((bench_copy / 'traffic' / 'anakin.b32.json')
                       .read_text())
  traffic['fields']['batch_size'] = 64
  (bench_copy / 'traffic' / 'anakin.b64.json').write_text(
      json.dumps(traffic))
  workload['traffic'] = 'anakin.b64'
  (bench_copy / 'workloads' / 'deep.anakin.b64.json').write_text(
      json.dumps(workload))
  cell = cells.load('deep.anakin.b64')
  assert cell['fields']['batch_size'] == 64
  assert cell['model']['torso'] == 'deep'


def test_a_new_metric_file_is_found_by_name(bench_copy):
  (bench_copy / 'metrics' / 'anakin.steps.py').write_text(
      'def read(record):\n  return record.get("steps")\n')
  assert run.metric_reader('anakin.steps')({'steps': 3}) == 3


def test_a_cell_that_disagrees_with_the_benchmark_is_refused(bench_copy):
  bench = cells.benchmark()
  bench['workloads'][0]['chips'] = 4
  with pytest.raises(ValueError, match='chips'):
    cells.load(bench['workloads'][0]['name'], bench)


def test_a_learner_setting_the_reference_lacks_is_refused(bench_copy):
  path = bench_copy / 'configs' / 'impala_deep.json'
  config = json.loads(path.read_text())
  config['fields']['reward_clipping'] = 'soft_asymmetric'
  path.write_text(json.dumps(config))
  with pytest.raises(ValueError, match='reward_clipping'):
    cells.load('deep.anakin.b32')
