"""The two fault sites that need no transport, fired by the port as the
JAX package fires them (scalable_agent_tpu/runtime/faults.py FaultyEnv
and maybe_wrap_env; driver.train's slow_learner), on the CPU:
`install` accepts them, an `env_step` 'raise' in a tiny fleet crashes
one actor, which the fleet respawns (an `actors_respawned` incident
naming the injected error), and a `slow_learner` 'hang' stalls the
learner for its seconds, so the buffer fills and the actors' puts block
(`buffer/put_waits` rises in the registry)."""

import json
import os
import time

import pytest
import torch

from scalable_agent_tpu.runtime import faults as jax_faults
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.runtime import faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
  yield
  faults.clear()


def _config(tmp_path, **kw):
  """tests/test_torch_fleet.py's small config."""
  base = dict(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
              batch_size=2, unroll_length=5, num_action_repeats=1,
              episode_length=4, height=24, width=32, torso='shallow',
              use_py_process=False, use_instruction=False,
              total_environment_frames=10**6, inference_timeout_ms=5,
              summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


def _incidents(logdir):
  path = os.path.join(str(logdir), 'incidents.jsonl')
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f]


@pytest.mark.parametrize('kw', [
    dict(env_raise_at=3), dict(env_hang_at=1, env_hang_secs=0.25),
    dict(slow_learner_at=0, slow_learner_len=2, slow_learner_secs=0.5)],
    ids=['env_raise', 'env_hang', 'slow_learner'])
def test_install_accepts_the_sites_and_their_schedule_is_jax(kw):
  ref = jax_faults.FaultPlan.storm(seed=0, **kw)
  plan = faults.FaultPlan.storm(seed=0, **kw)
  assert plan.to_json() == ref.to_json()
  faults.install(plan)
  assert faults.active() is plan
  site = 'slow_learner' if 'slow_learner_at' in kw else 'env_step'
  assert plan.covers(site) and site in faults.PORTED_SITES
  assert len(faults.PORTED_SITES) == 14


class _CountingEnv:
  def __init__(self):
    self.steps = 0
    self.closed = False

  def initial(self):
    return 'first'

  def step(self, action):
    self.steps += 1
    return action

  def close(self):
    self.closed = True


def test_faulty_env_raises_hangs_and_passes_through():
  env = _CountingEnv()
  assert faults.maybe_wrap_env(env) is env  # no plan: untouched
  faults.install(faults.FaultPlan.storm(seed=0, env_raise_at=1,
                                        env_hang_at=2, env_hang_secs=0.2))
  wrapped = faults.maybe_wrap_env(env)
  assert isinstance(wrapped, faults.FaultyEnv)
  assert wrapped.initial() == 'first' and wrapped.steps == 0
  assert wrapped.step(7) == 7
  with pytest.raises(faults.InjectedFault, match='env_step'):
    wrapped.step(8)
  t0 = time.monotonic()
  assert wrapped.step(9) == 9
  assert time.monotonic() - t0 >= 0.2
  assert env.steps == 2  # the raised step never reached the env
  wrapped.close()
  assert env.closed


def test_an_env_step_raise_respawns_one_actor(tmp_path):
  faults.install(faults.FaultPlan.storm(seed=0, env_raise_at=12))
  run = driver.train(_config(tmp_path), max_steps=5, device='cpu',
                     stall_timeout_secs=60)
  assert run.state.update_steps == 5
  assert faults.active().stats()['env_step']['fired'] == 1
  assert run.stats['fleet']['respawns'] == 1
  respawned = [e for e in _incidents(tmp_path)
               if e['kind'] == 'actors_respawned']
  assert len(respawned) == 1 and len(respawned[0]['slots']) == 1
  assert any('InjectedFault' in err for err in respawned[0]['errors'])


def test_slow_learner_blocks_the_learner_and_fills_the_buffer(tmp_path):
  faults.install(faults.FaultPlan.storm(seed=0, slow_learner_at=1,
                                        slow_learner_len=2,
                                        slow_learner_secs=0.6))
  seen = []

  def on_step(run, step, metrics):
    seen.append((time.monotonic(),
                 telemetry.registry().snapshot()['buffer/put_waits']))

  run = driver.train(_config(tmp_path, queue_capacity_batches=1),
                     max_steps=4, device='cpu', stall_timeout_secs=60,
                     on_step=on_step)
  assert run.state.update_steps == 4
  slow = [e for e in _incidents(tmp_path)
          if e['kind'] == 'fault_slow_learner']
  assert [(e['step'], e['secs']) for e in slow] == [(2, 0.6), (3, 0.6)]
  # Steps 2 and 3 each took at least the sleep.
  assert seen[1][0] - seen[0][0] >= 0.6 and seen[2][0] - seen[1][0] >= 0.6
  # The actors' puts blocked on the full buffer while the learner slept.
  assert seen[2][1] > seen[0][1]
