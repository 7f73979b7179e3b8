"""The port's soak (scalable_agent_tpu_torch/scripts/soak.py) on the CPU,
and its leak gate against the JAX package's (the root scripts/soak.py).

- `SOAK_SMOKE=1` with a short SOAK_SECONDS, as a process on the CPU: the
  record is ok (finite losses, PopArt sigma inside its bounds, the SLO
  verdict passing, zero integrity violations, the trace stream alive),
  and the steady-state run reports its ambient RSS growth per step.
- `_flatness_problems` of both packages on seeded sample series (flat,
  a thread leak, an fd leak, a block leak, an RSS leak, too few
  samples): the same problems, the port's ambient in place of JAX's
  where the RSS allowance is 2x the ambient (the smoke's 0.5 MB/step is
  the same in both). With no ambient measured, the port leaves the full
  run's RSS ungated and reports the rest as JAX's.
- Slow: the churn smoke (SIGKILLed env processes respawned, the leak
  gate at 0.5 MB/step).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from scalable_agent_tpu_torch.scripts import soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOAK_TIMEOUT_SECS = 300


def _jax_soak():
  spec = importlib.util.spec_from_file_location(
      'jax_soak_script', os.path.join(REPO, 'scripts', 'soak.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _run_soak(tmp_path, seconds, churn=False):
  env = dict(os.environ, SOAK_SMOKE='1', SOAK_SECONDS=str(seconds),
             TMPDIR=str(tmp_path))
  if churn:
    env['SOAK_CHURN'] = '1'
  proc = subprocess.run(
      [sys.executable, '-m', 'scalable_agent_tpu_torch.scripts.soak',
       '--device=cpu'], cwd=REPO, env=env, capture_output=True, text=True,
      timeout=SOAK_TIMEOUT_SECS)
  lines = proc.stdout.strip().splitlines()
  assert lines, proc.stderr[-3000:]
  return json.loads(lines[-1]), proc


def test_the_steady_state_smoke_passes(tmp_path):
  record, proc = _run_soak(tmp_path, 12)
  assert record['problems'] == [], proc.stderr[-3000:]
  assert proc.returncode == 0 and record['ok']
  assert record['device'] == 'cpu' and record['smoke']
  assert record['steps'] >= 2
  assert record['loss_first'] is not None
  assert np.all(np.isfinite([record['loss_first'], record['loss_last']]))
  lo, hi = record['popart_sigma_range']
  assert 1e-4 < lo <= hi < 1e6
  assert record['slo']['pass'] and record['churn'] is None
  assert record['telemetry']['trace_batches'] > 0
  assert set(record['integrity'].values()) == {0}
  assert record['out'].endswith('SOAK_smoke.json')
  assert os.path.exists(record['out'])
  assert record['resource_curve']  # the no-churn control's samples


def _series(seed, n=24, leak=None):
  """Seeded (t, rss_mb, threads, fds, py_blocks) samples every 2 s."""
  rng = np.random.RandomState(seed)
  samples = []
  for i in range(n):
    t = 2.0 * i
    rss = 900.0 + rng.randn() * 2.0 + (6.0 * i if leak == 'rss' else 0.0)
    threads = 20 + int(rng.randint(0, 2)) + (i if leak == 'threads' else 0)
    fds = 60 + int(rng.randint(0, 3)) + (3 * i if leak == 'fds' else 0)
    blocks = int(200000 + rng.randint(0, 500) +
                 (4000 * i if leak == 'blocks' else 0))
    samples.append((round(t, 1), round(rss, 1), threads, fds, blocks))
  return samples


_CASES = [(seed, leak, n) for seed in (0, 1, 2)
          for leak in (None, 'threads', 'fds', 'blocks', 'rss')
          for n in (24,)] + [(3, None, 5)]


@pytest.mark.parametrize('smoke', [True, False])
@pytest.mark.parametrize('seed,leak,n', _CASES)
def test_the_leak_gate_finds_jax_s_problems(monkeypatch, seed, leak, n,
                                            smoke):
  jax_soak = _jax_soak()
  samples = _series(seed, n=n, leak=leak)
  steps = 60
  # The port's measured ambient, and one large enough to pass a flat RSS.
  for ambient in (soak._AMBIENT_RSS_MB_PER_STEP, 0.25 + seed):
    monkeypatch.setattr(jax_soak, '_AMBIENT_RSS_MB_PER_STEP', ambient)
    monkeypatch.setattr(soak, '_AMBIENT_RSS_MB_PER_STEP', ambient)
    want = jax_soak._flatness_problems(samples, steps, smoke)
    got = soak._flatness_problems(samples, steps, smoke)
    assert got == want, ambient
    if leak is not None and n >= 8 and (smoke or leak != 'rss'):
      assert want  # the series exercises the gate
  # No measured ambient: the full run's RSS goes ungated, the rest is
  # JAX's.
  monkeypatch.setattr(soak, '_AMBIENT_RSS_MB_PER_STEP', None)
  got = soak._flatness_problems(samples, steps, smoke)
  if smoke:
    assert got == want
  else:
    assert got == [p for p in want if not p.startswith('rss grew')]


def test_rss_mb_per_step_is_the_gate_s_measure(monkeypatch):
  samples = _series(0, leak='rss')
  growth = soak.rss_mb_per_step(samples, 60)
  assert growth > 0.5
  monkeypatch.setattr(soak, '_AMBIENT_RSS_MB_PER_STEP', growth)
  problems = soak._flatness_problems(samples, 60, False)
  assert not any(p.startswith('rss grew') for p in problems)
  monkeypatch.setattr(soak, '_AMBIENT_RSS_MB_PER_STEP', growth / 2.01)
  problems = soak._flatness_problems(samples, 60, False)
  assert any(p.startswith('rss grew') for p in problems)
  assert soak.rss_mb_per_step(samples[:7], 60) is None


@pytest.mark.slow
def test_the_churn_smoke_passes(tmp_path):
  record, proc = _run_soak(tmp_path, 30, churn=True)
  assert record['problems'] == [], proc.stderr[-3000:]
  assert proc.returncode == 0
  churn = record['churn']
  assert churn['env_kills'] >= 1 and churn['fleet_respawns'] >= 1
  assert churn['rss_gate'] == 'CPU smoke: 0.5 MB/step'
