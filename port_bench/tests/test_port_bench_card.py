"""On the card: each cell's short run is correct, and its control (the
reference in TF32 in the program's place, at the cell's own size) fails
the cell's limits. Skips without a card; run on the card with

  python -m pytest -m requires_cuda port_bench/tests
"""

import pytest
import torch

from port_bench import cells
from port_bench import check
from port_bench import run

CELLS = [w['name'] for w in cells.benchmark()['workloads']]


def _card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA card')


@pytest.mark.requires_cuda
@pytest.mark.parametrize('name', CELLS)
def test_a_short_run_is_correct(name):
  _card()
  bench = cells.benchmark()
  result = run.execute(cells.load(name, bench), bench, 2**31 + 101, 2.0, 0,
                       'cuda')
  assert result['correct'], result['checks']
  assert result['device']['platform'] == 'gpu'


@pytest.mark.requires_cuda
@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct(name):
  _card()
  import tempfile
  from port_bench.runtimes import anakin
  cell = cells.load(name)
  with tempfile.TemporaryDirectory() as logdir:
    prog = anakin.AnakinRun(cell, 2**31 + 202, 'cuda', logdir)
    prog.record(cell['traffic']['recorded_steps'])
  prog.free()
  sound, control = prog.numbers(control=True)
  assert check.judge(sound, cell['limits'])[0]
  limits = {k: cell['limits'][k] for k in control}
  assert not check.judge(control, limits)[0], control
