"""The elastic fleet of the port (runtime/fleet.py `target_size`,
`set_target_size`, probation), mirroring the JAX package's
tests/test_fleet.py: parking and unparking with the quorum's denominator,
rehabilitation on probation cleared by one unroll, re-quarantine on a
repeat failure, parked slots' errors kept out of errors(); the same
resize sequence gives JAX's reports; and through driver.train with the
state arena, a shrink releases the parked actors' slots and a grow
re-acquires them while the learner steps."""

import json
import random
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu.runtime.fleet import ActorFleet as JaxActorFleet
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import Actor
from scalable_agent_tpu_torch.runtime.fleet import ActorFleet
from scalable_agent_tpu_torch.structs import AgentOutput

torch.set_num_threads(1)

H, W, A = 24, 32, 3


def _dummy_policy(prev_action, env_output, core_state):
  return (AgentOutput(action=np.int32(0),
                      policy_logits=np.zeros(A, np.float32),
                      baseline=np.float32(0.0)), core_state)


def _actor(i):
  env = FakeEnv(height=H, width=W, num_actions=A, seed=i)
  return env, None, Actor(env, _dummy_policy,
                          (np.zeros((1, 4), np.float32),) * 2,
                          unroll_length=4)


def _wait(predicate, timeout=15.0):
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    if predicate():
      return True
    time.sleep(0.02)
  return predicate()


def _pumped(fleet, cond, buffer=None):
  """check_health (the learner's duty) and a drained buffer, then
  `cond`."""
  def p():
    fleet.check_health()
    if buffer is not None:
      try:
        while True:
          buffer.get(timeout=0)
      except (TimeoutError, ring_buffer.Closed):
        pass
    return cond()
  return p


class _ZeroJitter(random.Random):

  def uniform(self, a, b):
    return 0.0


def test_set_target_size_parks_unparks_and_quorum_denominator():
  buffer = ring_buffer.TrajectoryBuffer(64)
  fleet = ActorFleet(_actor, buffer, num_actors=4)
  try:
    fleet.start()
    assert _wait(lambda: fleet.stats()['healthy'] == 4)
    report = fleet.set_target_size(2)
    assert sorted(report['parked']) == [2, 3]
    assert fleet.target_size() == 2
    assert _wait(lambda: fleet.stats()['healthy'] == 2)
    stats = fleet.stats()
    assert stats['parked'] == 2 and stats['healthy_fraction'] == 1.0
    fleet.check_health()
    assert fleet.stats()['parked'] == 2
    report = fleet.set_target_size(4)
    assert sorted(report['unparked']) == [2, 3]
    assert report['rehabilitated'] == []
    assert _wait(_pumped(fleet, lambda: fleet.stats()['healthy'] == 4,
                         buffer))
    # Never past the constructed size.
    assert fleet.set_target_size(9) == {'parked': [], 'unparked': [],
                                        'rehabilitated': []}
  finally:
    fleet.stop()


def test_rehabilitation_probation_success_counts():
  buffer = ring_buffer.TrajectoryBuffer(64)
  fails = {1: 1}

  def make_actor(i):
    if fails.get(i, 0) > 0:
      fails[i] -= 1
      raise RuntimeError(f'flaky env on slot {i}')
    return _actor(i)

  fleet = ActorFleet(make_actor, buffer, num_actors=2, quarantine_after=1,
                     probation_secs=0.05)
  for slot in fleet._slots:
    slot.backoff._rng = _ZeroJitter()
  try:
    fleet._slots[1].error = RuntimeError('seed: never spawned')
    fleet._spawn(fleet._slots[0])
    assert _wait(_pumped(fleet,
                         lambda: fleet.stats()['slots_quarantined'] == 1))
    assert fleet.target_size() == 1
    fleet._slots[1].quarantined_at = time.monotonic()
    assert fleet.set_target_size(2)['rehabilitated'] == []
    time.sleep(0.08)
    report = fleet.set_target_size(2)
    assert report['rehabilitated'] == [1]
    assert fleet.stats()['rehabilitations'] == 1
    assert fleet.errors() == []
    assert _wait(_pumped(fleet,
                         lambda: fleet.stats()['slots_rehabilitated'] == 1,
                         buffer=buffer))
    stats = fleet.stats()
    assert stats['slots_quarantined'] == 0
    assert stats['slots_rehabilitated'] == 1
  finally:
    fleet.stop()


def test_probation_requarantines_on_repeat_failure():
  buffer = ring_buffer.TrajectoryBuffer(64)

  def make_actor(i):
    raise RuntimeError(f'permanently broken env on slot {i}')

  fleet = ActorFleet(make_actor, buffer, num_actors=1, quarantine_after=1,
                     probation_secs=0.0)
  for slot in fleet._slots:
    slot.backoff._rng = _ZeroJitter()
  try:
    fleet._slots[0].error = RuntimeError('seed: never spawned')
    assert _wait(_pumped(fleet,
                         lambda: fleet.stats()['slots_quarantined'] == 1))
    respawns_before = fleet.stats()['respawns']
    assert fleet.set_target_size(1)['rehabilitated'] == [0]
    assert _wait(_pumped(fleet,
                         lambda: fleet.stats()['slots_quarantined'] == 1))
    stats = fleet.stats()
    assert stats['slots_rehabilitated'] == 0
    assert stats['respawns'] - respawns_before <= 2
    # A fleet whose every active slot is quarantined surfaces the error.
    assert fleet.errors()
  finally:
    fleet.stop()


def test_parked_slot_errors_do_not_surface():
  buffer = ring_buffer.TrajectoryBuffer(64)
  fleet = ActorFleet(_actor, buffer, num_actors=2)
  try:
    fleet.start()
    assert _wait(lambda: fleet.stats()['healthy'] == 2)
    fleet.set_target_size(1)
    fleet._slots[1].error = RuntimeError('stale, before the park')
    assert fleet.errors() == []
    fleet.set_target_size(2)
    assert fleet._slots[1].error is None  # a closed incident
  finally:
    fleet.stop()


def test_a_resize_sequence_reports_what_jax_s_fleet_reports():
  """Slots that never spawned: the same set_target_size sequence gives
  the same reports and target sizes in both packages."""
  def never(i):
    raise AssertionError('not spawned')

  fleets = [JaxActorFleet(never, None, num_actors=6),
            ActorFleet(never, None, num_actors=6)]
  for n in (4, 1, 5, 0, 6, 3, 8):
    reports = [f.set_target_size(n) for f in fleets]
    assert reports[0] == reports[1], n
    assert fleets[0].target_size() == fleets[1].target_size()
    assert (fleets[0].stats()['parked'] == fleets[1].stats()['parked'])


def test_train_releases_and_reacquires_slots_across_a_resize(tmp_path):
  """driver.train with the state arena: a shrink to 1 parks 2 actors
  (their slots come back), a grow to 3 spawns them again (fresh slots)
  and the learner keeps stepping."""
  config = Config(env_backend='bandit', torso='shallow', height=H, width=W,
                  batch_size=2, num_actors=3, unroll_length=4,
                  num_action_repeats=1, use_instruction=False,
                  use_py_process=False, summary_secs=0,
                  total_environment_frames=10**6,
                  inference_state_cache=True, logdir=str(tmp_path))
  seen = {}

  def on_step(run, step, metrics):
    if step == 2:
      seen['shrink'] = run.fleet.set_target_size(1)
    elif step == 5:
      # The parked actors end after their current unroll (the
      # prefetcher's thread drains the buffer meanwhile) and release
      # their slots.
      _wait(lambda: run.server.slots_free() == 7, timeout=20)
      seen['free_parked'] = run.server.slots_free()
      seen['grow'] = run.fleet.set_target_size(3)

  run = driver.train(config, max_steps=8, device='cpu', on_step=on_step)
  assert run.state.update_steps == 8
  assert sorted(seen['shrink']['parked']) == [1, 2]
  assert sorted(seen['grow']['unparked']) == [1, 2]
  server = run.stats['server']
  assert server['num_slots'] == 8 and seen['free_parked'] == 7
  assert server['acquires'] >= 5   # 3 at start, 2 after the grow
  assert run.stats['fleet']['target_size'] == 3
  assert run.stats['fleet']['parked'] == 0
  assert all(torch.isfinite(p).all() for p in run.state.params.values())


def _recorded_plan(make_fleet_fn, module, monkeypatch, config, levels,
                   jax_side):
  """Each slot's (level id, level, backend, seed) from `make_fleet_fn`
  with env construction and the Actor stubbed out."""
  built, ids = [], []

  class Env:

    def close(self):
      pass

  def build_environment(spec, use_py_process=False):
    built.append((spec.constructor_kwargs.get('level_name'),
                  spec.env_class.__name__, spec.constructor_kwargs['seed']))
    return Env(), None

  def actor(env, policy, state, unroll_length, num_action_repeats=1,
            level_name_id=0):
    ids.append(int(level_name_id))

  monkeypatch.setattr(module.factory, 'build_environment', build_environment)
  monkeypatch.setattr(module, 'Actor', actor)
  state_fn = lambda priority=None: None  # noqa: E731
  if jax_side:
    fleet = make_fleet_fn(config, None, None, None, levels,
                          initial_state_fn=state_fn)
  else:
    fleet = make_fleet_fn(config, None, None, levels, state_fn,
                          tasks=module.population_lib.parse_fleet_tasks(
                              config.fleet_tasks))
  for i in range(config.num_actors):
    fleet._make_actor(i)
  return list(zip(ids, built))


def test_a_mixed_fleet_plans_and_stamps_as_jax_s(monkeypatch):
  """fleet_tasks='gridworld:2,procgen' over 32 actors: the same
  per-slot task, backend, seed and level id as JAX's make_fleet (21/11
  by largest remainder)."""
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig
  kw = dict(fleet_tasks='gridworld:2,procgen', num_actions=4, num_actors=32,
            use_popart=True, height=H, width=W, use_instruction=False)
  levels = ['gridworld', 'procgen']
  got = _recorded_plan(driver.make_fleet, driver, monkeypatch, Config(**kw),
                       levels, jax_side=False)
  want = _recorded_plan(jax_driver.make_fleet, jax_driver, monkeypatch,
                        JaxConfig(**kw), levels, jax_side=True)
  assert got == want
  tasks = [level_id for level_id, _ in got]
  assert (tasks.count(0), tasks.count(1)) == (21, 11)


def test_a_mixed_fleet_with_disagreeing_action_widths_raises(tmp_path):
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig
  kw = dict(fleet_tasks='bandit,gridworld', num_actors=4, height=H,
            width=W, use_instruction=False, torso='shallow',
            logdir=str(tmp_path))
  for train, config in ((jax_driver.train, JaxConfig(**kw)),
                        (lambda c: driver.train(c, device='cpu'),
                         Config(**kw))):
    with pytest.raises(ValueError, match='disagree on action width'):
      train(config)


def test_a_mixed_fleet_trains_one_popart_slot_per_task(tmp_path):
  config = Config(fleet_tasks='gridworld:2,procgen', num_actions=4,
                  use_popart=True, torso='shallow', height=H, width=W,
                  batch_size=3, num_actors=3, unroll_length=20,
                  num_action_repeats=1, episode_length=10,
                  use_instruction=False, use_py_process=False,
                  summary_secs=0, total_environment_frames=10**6,
                  logdir=str(tmp_path))
  run = driver.train(config, max_steps=3, device='cpu')
  assert tuple(run.state.popart.mu.shape) == (2,)
  with open(tmp_path / 'summaries.jsonl') as f:
    tags = {json.loads(line)['tag'] for line in f}
  assert {'gridworld/episode_return', 'procgen/episode_return'} <= tags
