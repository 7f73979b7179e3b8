"""The port's deep against deep_fast harness (scalable_agent_tpu_torch/
scripts/compare_torsos.py) against the JAX package's
scripts/compare_torsos.py.

`_return_curve` gives equal curves and tail means through both on
summaries.jsonl files made from numpy seeds: no episode at all, every
episode in one bucket, steps that do not divide by 10, and random runs.
The port's SMOKE run on the CPU (`main(['--device=cpu'])`, 8 learner
steps per torso) writes JAX's artifact keys and 8 steps and 128 frames
per torso; without `--device` it raises here (no CUDA). Slow: both
packages' SMOKE runs of one torso give the same steps, frames and keys.
"""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest

from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.scripts import compare_torsos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = ('task', 'note', 'runs')
JAX_RUN_KEYS = ('torso', 'steps', 'frames', 'return_curve_deciles',
                'tail_mean_return')


def _jax_compare_torsos():
  # The root script puts the repo root on sys.path itself; loaded by path
  # so its module-level code runs as it does under `python scripts/...`.
  spec = importlib.util.spec_from_file_location(
      'jax_compare_torsos', os.path.join(REPO, 'scripts',
                                         'compare_torsos.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


jax_compare_torsos = _jax_compare_torsos()


def _write_episodes(logdir, steps, seed):
  """A summaries.jsonl of one episode return per step in `steps`, among
  other scalars."""
  rng = np.random.RandomState(seed)
  writer = observability.SummaryWriter(str(logdir))
  for step in steps:
    writer.scalar('loss/total', float(rng.randn()), step)
    writer.scalar('cue_memory/episode_return', float(rng.uniform(0, 3)),
                  step)
  writer.close()
  return str(logdir)


CASES = {
    'no_episode': [],
    'one_bucket': [0, 0, 0],
    'step_zero_and_one': [0, 1],
    'steps_not_divisible_by_10': list(range(0, 38, 1)),
    'sparse': [3, 17, 17, 41, 96, 97],
    'random': sorted(np.random.RandomState(9).randint(0, 400, 120).tolist()),
}


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('buckets', [10, 3])
def test_return_curve_equals_jax_s(tmp_path, case, buckets):
  logdir = _write_episodes(tmp_path, CASES[case], seed=len(case))
  port = compare_torsos._return_curve(logdir, buckets=buckets)
  jax = jax_compare_torsos._return_curve(logdir, buckets=buckets)
  assert port == jax
  if case == 'no_episode':
    assert port == ([], 0.0)
  else:
    assert len(port[0]) == buckets


def test_the_smoke_run_on_the_cpu_writes_jax_s_keys(tmp_path, monkeypatch,
                                                    capsys):
  out = tmp_path / 'TORSO_COMPARE.json'
  monkeypatch.setenv('SMOKE', '1')
  monkeypatch.setenv('TORSO_COMPARE_OUT', str(out))
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))  # the run dirs
  assert compare_torsos.main(['--device=cpu']) == 0
  result = json.loads(out.read_text())
  assert all(k in result for k in JAX_KEYS)
  assert result['task'] == 'cue_memory'
  assert [r['torso'] for r in result['runs']] == ['deep', 'deep_fast']
  for run in result['runs']:
    assert all(k in run for k in JAX_RUN_KEYS)
    assert run['steps'] == 8 and run['frames'] == 8 * 2 * 8
    assert run['device'] == 'cpu'
    assert np.isfinite(run['tail_mean_return'])
  assert f'compare_torsos OK -> {out}' in capsys.readouterr().out


def test_without_cuda_the_default_device_raises(monkeypatch):
  import torch
  monkeypatch.setenv('SMOKE', '1')
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='cuda'):
    compare_torsos.main([])


@pytest.mark.slow
def test_both_packages_smoke_runs_agree(tmp_path, monkeypatch):
  """One torso's SMOKE run through both packages' `run_one` (JAX's on
  the CPU): the same steps and frames, and the same keys."""
  monkeypatch.chdir(tmp_path)
  monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))  # the run dirs
  jax = jax_compare_torsos.run_one('deep', smoke=True)
  port = compare_torsos.run_one('deep', smoke=True, device='cpu',
                                root=str(tmp_path))
  assert set(JAX_RUN_KEYS) == set(jax) <= set(port)
  assert (port['steps'], port['frames']) == (jax['steps'], jax['frames'])
  assert len(port['return_curve_deciles']) == len(
      jax['return_curve_deciles'])
