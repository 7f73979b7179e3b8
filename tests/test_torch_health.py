"""The port's training health (scalable_agent_tpu_torch/health.py) held to
the JAX package's (scalable_agent_tpu/health.py): both monitors on the same
value streams — the streams of tests/test_health.py and hypothesis-drawn
ones of finite, NaN and exploding losses, step_ok flags and windows — give
the same verdict for every step and the same counters; the sentinel read;
the halt bundle; and the driver-level ladder of tests/test_health.py
through the port's `driver.train(device='cpu')`: a NaN burst rolls back to
LAST_GOOD and recovers, and a rollback with nothing to restore halts with a
bundle and saves nothing.

Verdicts, counters and reasons are compared exactly.
"""

import json
import os

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from scalable_agent_tpu import health as jax_health
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import health
from scalable_agent_tpu_torch.checkpoint import Checkpointer
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.runtime import faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
  yield
  faults.clear()


def _vals(step_ok=1.0, loss=1.0, grad=1.0, sigma=None, sigma_min=None,
          sdc=None):
  values = {'step_ok': step_ok, 'total_loss': loss, 'grad_norm': grad,
            'popart_sigma_min': sigma_min, 'popart_sigma_max': sigma}
  if sdc is not None:
    values['sdc_replica_mismatch'] = sdc
  return values


def _run_both(stream, **kw):
  """Both monitors over `stream`; asserts equal verdicts, counters and
  reasons step by step, and returns the port's verdicts and monitor."""
  ref, port = jax_health.HealthMonitor(**kw), health.HealthMonitor(**kw)
  verdicts = []
  for step, values in enumerate(stream):
    want = ref.observe_values(step, dict(values))
    got = port.observe_values(step, dict(values))
    assert got == want, (step, values, got, want)
    assert port.stats() == ref.stats(), step
    assert port.last_reason == ref.last_reason, step
    assert port.consecutive_bad == ref.consecutive_bad
    verdicts.append(got)
  return verdicts, port


# The streams of tests/test_health.py's TestMonitor and SDC tests.
_STREAMS = {
    'finite': ([_vals()] * 20, {}),
    'device_skip_escalates': (
        [_vals(step_ok=0.0, loss=float('nan'))] * 7,
        dict(rollback_after=3, max_rollbacks=1)),
    'recovery_resets': (
        [_vals(step_ok=0.0), _vals(step_ok=0.0), _vals(), _vals(step_ok=0.0)],
        dict(rollback_after=3)),
    'loss_explosion': (
        [_vals(loss=1.0 + 0.01 * s) for s in range(10)] + [_vals(loss=1e5)],
        dict(min_window=8, loss_explosion_factor=100.0)),
    'sigma_divergence': (
        [_vals(sigma=2.0)] * 10 + [_vals(sigma=50.0)],
        dict(min_window=8, sigma_divergence_factor=10.0)),
    'sigma_collapse': (
        [_vals(sigma=2.0, sigma_min=1.0)] * 10 +
        [_vals(sigma=2.0, sigma_min=0.01)],
        dict(min_window=8, sigma_divergence_factor=10.0)),
    'missing_popart_keys': ([_vals(sigma=None)] * 20, dict(min_window=2)),
    'sdc': ([_vals(loss=0.5)] + [_vals(loss=0.5, sdc=1.0)] * 3 +
            [_vals(loss=0.5, sdc=0.0)], dict(rollback_after=3,
                                              max_rollbacks=2)),
    'sdc_absent': ([{'step_ok': 1.0, 'total_loss': 0.1, 'grad_norm': 0.5}],
                   {}),
}


@pytest.mark.parametrize('name', sorted(_STREAMS))
def test_monitor_matches_jax_on_the_jax_tests_streams(name):
  stream, kw = _STREAMS[name]
  verdicts, monitor = _run_both(stream, **kw)
  if name == 'device_skip_escalates':
    assert verdicts[:3] == [health.BAD, health.BAD, health.ROLLBACK]
    assert health.HALT in verdicts[3:]
    assert monitor.rollbacks == 1 and monitor.halts == 1
  elif name in ('loss_explosion', 'sigma_divergence', 'sigma_collapse'):
    assert verdicts[-1] == health.BAD
  elif name == 'sdc':
    assert verdicts[1:] == [health.BAD, health.BAD, health.ROLLBACK,
                            health.OK]
    assert monitor.sdc_mismatches == 3 and monitor.skipped_steps == 0
  elif name in ('finite', 'missing_popart_keys', 'sdc_absent'):
    assert set(verdicts) == {health.OK}
    assert monitor.sdc_mismatches == 0


_LOSS = st.one_of(
    st.floats(-50.0, 50.0, allow_nan=False),
    st.just(float('nan')), st.just(float('inf')),
    st.floats(1e3, 1e9),                          # explosions
    st.none())
_STEP = st.builds(
    lambda ok, loss, grad, sigma: _vals(step_ok=ok, loss=loss, grad=grad,
                                        sigma=sigma),
    st.sampled_from([1.0, 1.0, 1.0, 0.0, None]), _LOSS,
    st.one_of(st.floats(0.0, 10.0), st.just(float('nan')), st.none()),
    st.one_of(st.none(), st.floats(0.1, 100.0)))


@hypothesis.settings(max_examples=60, deadline=None, derandomize=True)
@hypothesis.given(
    stream=st.lists(_STEP, min_size=1, max_size=60),
    window=st.integers(1, 20), min_window=st.integers(0, 12),
    rollback_after=st.integers(1, 6), max_rollbacks=st.integers(0, 3),
    loss_factor=st.sampled_from([2.0, 10.0, 100.0]))
def test_monitor_matches_jax_on_drawn_streams(stream, window, min_window,
                                              rollback_after, max_rollbacks,
                                              loss_factor):
  _run_both(stream, window=window, min_window=min_window,
            rollback_after=rollback_after, max_rollbacks=max_rollbacks,
            loss_explosion_factor=loss_factor)


def test_monitor_from_config_reads_the_jax_fields():
  from scalable_agent_tpu.config import Config as JaxConfig
  kw = dict(health_window=9, health_min_window=3, health_rollback_after=2,
            health_max_rollbacks=1, health_loss_explosion_factor=7.0,
            health_sigma_divergence_factor=4.0)
  stream = ([_vals(loss=1.0)] * 4 + [_vals(loss=9.0)] +
            [_vals(step_ok=0.0)] * 5)
  ref = jax_health.monitor_from_config(JaxConfig(**kw))
  port = health.monitor_from_config(Config(**kw))
  for step, values in enumerate(stream):
    assert port.observe_values(step, values) == ref.observe_values(
        step, values)
  assert port.stats() == ref.stats()
  assert port.drain_report() == ref.drain_report()


def test_sentinels_are_read_one_step_late_as_values():
  metrics = {'step_ok': torch.tensor(0.0), 'total_loss': torch.tensor(
      float('nan')), 'grad_norm': torch.tensor(2.5), 'learning_rate':
      torch.tensor(1e-3)}
  handle = health.stack_sentinels(metrics)
  assert handle.keys == ('step_ok', 'total_loss', 'grad_norm')
  assert handle.ready is None  # CPU: nothing to wait for
  values = health.read_handle(handle)
  assert values['step_ok'] == 0.0 and np.isnan(values['total_loss'])
  assert values['grad_norm'] == 2.5
  assert values['popart_sigma_max'] is None  # not produced: detector off
  monitor = health.HealthMonitor()
  assert monitor.observe(1, metrics) == health.BAD
  assert monitor.skipped_steps == 1


def test_halt_bundle_contents(tmp_path):
  cfg = Config(logdir=str(tmp_path))
  monitor = health.HealthMonitor()
  monitor.observe_values(7, _vals(step_ok=0.0, loss=float('nan')))
  monitor.note_external('wedged_ingest', 2)
  path = monitor.write_halt_bundle(str(tmp_path), cfg, 7, reason='test')
  assert path == os.path.join(str(tmp_path), 'diagnostics',
                              'health_halt_step7.json')
  with open(path) as f:
    bundle = json.load(f)
  assert bundle['reason'] == 'test' and bundle['step'] == 7
  assert bundle['config']['logdir'] == str(tmp_path)
  assert bundle['versions']['torch'] == torch.__version__
  assert bundle['versions']['numpy'] == np.__version__
  assert {'cuda', 'device'} <= set(bundle['versions'])
  assert bundle['window'][-1]['step'] == 7
  assert bundle['counters']['skipped_steps'] == 1
  assert monitor.drain_report()['external_incidents'] == {
      'wedged_ingest': 2}


# --- the ladder in driver.train (tests/test_health.py:190-250) ---------------


def _config(tmp_path, **kw):
  base = dict(
      logdir=str(tmp_path), env_backend='bandit', num_actors=2,
      batch_size=2, unroll_length=5, num_action_repeats=1,
      episode_length=4, height=24, width=32, torso='shallow',
      use_py_process=False, use_instruction=False,
      total_environment_frames=10 ** 6, inference_timeout_ms=5,
      checkpoint_secs=0, summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


def _jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_nan_burst_skips_rolls_back_and_recovers(tmp_path):
  """A NaN burst crossing K rolls the params back to the last good
  checkpoint once; the run finishes with a monotone step counter, and the
  counters reach the summaries and incidents."""
  cfg = _config(tmp_path, health_rollback_after=3)
  faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=5,
                                        nan_burst_len=4))
  steps, after_rollback = [], {}

  def on_step(run, steps_done, metrics):
    steps.append(run.state.update_steps)
    if run.health.rollbacks and not after_rollback:
      after_rollback['step'] = steps_done
      after_rollback['params'] = {k: v.clone()
                                  for k, v in run.state.params.items()}
      after_rollback['version'] = run.server.stats()['live_version']

  run = driver.train(cfg, max_steps=12, device='cpu', stall_timeout_secs=60,
                     on_step=on_step)
  assert run.state.update_steps == 12
  assert steps == list(range(1, 13))  # monotone through the rollback
  stats = run.health.stats()
  assert stats['skipped_steps'] == 4 and stats['rollbacks'] == 1
  # Rolled back at step 9 (its read of step 8, the third bad step) to
  # LAST_GOOD, step 6: the last save before the burst showed.
  assert after_rollback['step'] == 9 and after_rollback['version'] == 9
  payload = torch.load(tmp_path / 'checkpoints' / '6' / 'default' /
                       'state.pt', weights_only=True)
  for k, v in after_rollback['params'].items():
    assert torch.equal(v, payload['params'][k]), k
  tags = {e['tag'] for e in _jsonl(tmp_path / 'summaries.jsonl')}
  assert {'skipped_steps', 'flagged_steps', 'rollbacks', 'halts',
          'checkpoint_save_errors', 'ckpt_digest_fallbacks',
          'fleet_healthy_fraction'} <= tags
  incidents = _jsonl(tmp_path / 'incidents.jsonl')
  kinds = [e['kind'] for e in incidents]
  assert kinds.count('fault_nan_burst') == 4
  assert 'health_bad_burst_start' in kinds and 'health_recovered' in kinds
  rollback = [e for e in incidents if e['kind'] == 'rollback']
  assert [e['restored_checkpoint_step'] for e in rollback] == [6]
  for p in run.state.params.values():
    assert torch.isfinite(p).all()
  # The run ended healthy, so its final save landed at step 12.
  assert Checkpointer(str(tmp_path / 'checkpoints')).latest_step() == 12


def test_halt_without_checkpoint_writes_bundle(tmp_path):
  """A rollback requested with nothing restorable halts with a bundle
  instead of training through divergence, and saves nothing."""
  cfg = _config(tmp_path, health_rollback_after=2, checkpoint_secs=10**6)
  faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=2,
                                        nan_burst_len=6))
  with pytest.raises(health.TrainingDivergence) as exc_info:
    driver.train(cfg, max_steps=12, device='cpu', stall_timeout_secs=60)
  bundle_path = exc_info.value.bundle_path
  assert bundle_path and os.path.exists(bundle_path)
  with open(bundle_path) as f:
    bundle = json.load(f)
  assert 'no restorable checkpoint' in bundle['reason']
  assert bundle['config']['health_rollback_after'] == 2
  # The unwind did not save the diverged state as a final checkpoint.
  assert Checkpointer(str(tmp_path / 'checkpoints')).latest_step() is None
  kinds = [e['kind'] for e in _jsonl(tmp_path / 'incidents.jsonl')]
  assert 'health_halt' in kinds and 'rollback' not in kinds


def test_anakin_runtime_rolls_back_and_halts_like_the_fleet(tmp_path):
  """driver.train_anakin runs the same ladder on the fused step."""
  cfg = _config(tmp_path / 'roll', runtime='anakin', batch_size=4,
                health_rollback_after=2)
  faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=3,
                                        nan_burst_len=3))
  run = driver.train(cfg, max_steps=8, device='cpu')
  faults.clear()
  assert run.state.update_steps == 8
  assert run.health.stats()['rollbacks'] == 1
  kinds = [e['kind'] for e in _jsonl(tmp_path / 'roll' / 'incidents.jsonl')]
  assert 'rollback' in kinds and 'health_recovered' in kinds
  cfg = _config(tmp_path / 'halt', runtime='anakin', batch_size=4,
                health_rollback_after=2, checkpoint_secs=10**6)
  faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=1,
                                        nan_burst_len=6))
  with pytest.raises(health.TrainingDivergence):
    driver.train(cfg, max_steps=8, device='cpu')
  assert Checkpointer(str(tmp_path / 'halt' / 'checkpoints')).latest_step(
      ) is None
