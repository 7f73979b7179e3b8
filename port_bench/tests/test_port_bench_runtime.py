"""A tiny run of each runtime on the CPU prints a well-formed result,
and the faults planted under its timed path make `correct` false."""

import json

import pytest
import torch

from port_bench import cells
from port_bench import faults
from port_bench import run
from port_bench.tests import tiny


@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('name', [w['name'] for w in
                                  cells.benchmark()['workloads']])
def test_a_tiny_run_is_well_formed(name, trace):
  bench = cells.benchmark()
  result = run.execute(tiny.cell(name), bench, 2**31 + 17, 0.3, trace, 'cpu')
  json.dumps(result)
  assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                              'device']
  assert list(result)[-1] == 'checks'
  assert result['correct'] is True and result['failed'] == 0
  assert result['attempted'] >= 1
  e2e, layer = run.cell_metrics(bench, name)
  if trace:
    # On the CPU only the host's clock reads: no device metric.
    assert set(result['metrics']) == {m['name'] for m in layer
                                      if m['source'] == 'host_clock'}
    assert 'breakdown' in result
  else:
    assert set(result['metrics']) == {m['name'] for m in e2e}
  for value in result['metrics'].values():
    assert value['value'] > 0 or value['unit'] == 'GiB'
  assert result['device']['platform'] == 'cpu'


def test_the_same_seed_gives_the_same_inputs():
  cell = tiny.cell('shallow.anakin.b32')
  seen = []
  for _ in range(2):
    from port_bench.runtimes import anakin
    prog = anakin.AnakinRun(cell, 99, 'cpu', '/nonexistent')
    prog.record(1)
    seen.append(prog.recorded['batches'][0])
  for key in ('frames', 'reward', 'done', 'action'):
    assert torch.equal(seen[0][key], seen[1][key])


# The draws need enough acting steps for the greedy fault to stand out.
FAULT_SIZE = dict(batch_size=16, unroll_length=20, episode_length=7)


@pytest.mark.parametrize('fault', sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
  cell = tiny.cell('shallow.anakin.b32', **FAULT_SIZE)
  bench = cells.benchmark()
  with faults.FAULTS[fault]():
    result = run.execute(cell, bench, 12345, 0.2, 0, 'cpu')
  assert result['correct'] is False, result['checks']
  sound = run.execute(cell, bench, 12345, 0.2, 0, 'cpu')
  assert sound['correct'] is True, sound['checks']


def test_without_a_card_the_run_exits_with_no_result(capsys):
  if torch.cuda.is_available():
    pytest.skip('this machine has a card')
  code = run.main(['--workload', 'deep.anakin.b32', '--seed', '1',
                   '--seconds', '1', '--trace', '0'])
  out, err = capsys.readouterr()
  assert code != 0 and out == '' and 'CUDA' in err
