"""The port's host runtime (scalable_agent_tpu_torch/runtime/actor.py,
ring_buffer.py, fleet.py) against the JAX package's: `Actor.unroll` and
`batch_unrolls` bit-equal to JAX's with a shared scripted numpy policy
(the overlap frame, the episode info, the carry at the unroll's start),
and the buffer's, prefetcher's and fleet's contracts. Tolerance: exact
(numpy on both sides)."""

import threading
import time

import numpy as np
import pytest

from scalable_agent_tpu import structs as jax_structs
from scalable_agent_tpu.envs import fake as jax_fake
from scalable_agent_tpu.runtime import actor as jax_actor
from scalable_agent_tpu_torch import structs
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import fake
from scalable_agent_tpu_torch.runtime import actor, fleet, ring_buffer

A = 4


def _scripted_policy(agent_output_type):
  """A deterministic numpy policy of the observation, the previous action
  and the carry, built for either package's AgentOutput."""

  def policy(prev_action, env_output, core_state):
    frame, instr = env_output.observation
    c, h = core_state
    score = (int(np.asarray(frame, np.int64).sum()) + 7 * int(prev_action) +
             int(np.asarray(instr).sum()) + int(env_output.done))
    logits = (np.arange(A, dtype=np.float32) * np.float32(env_output.reward)
              + c[0, :A])
    out = agent_output_type(np.int32(score % A), logits, np.float32(h.sum()))
    return out, (c + np.float32(1.0),
                 h * np.float32(0.5) + np.float32(env_output.reward))

  return policy


def _leaves(tree, path=''):
  if isinstance(tree, tuple):
    fields = getattr(tree, '_fields', range(len(tree)))
    for name, part in zip(fields, tree):
      yield from _leaves(part, f'{path}.{name}')
  else:
    yield path, tree


def _assert_trees_equal(got, ref):
  got, ref = list(_leaves(got)), list(_leaves(ref))
  assert [p for p, _ in got] == [p for p, _ in ref]
  for (path, a), (_, b) in zip(got, ref):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


def _actors(env_name, seed, unroll_length=6, repeats=2):
  kwargs = dict(height=6, width=5, num_actions=A if env_name != 'CueMemoryEnv'
                else 3, episode_length=4, seed=seed)
  carry = (np.full((1, 8), 0.25, np.float32), np.zeros((1, 8), np.float32))
  port = actor.Actor(getattr(fake, env_name)(**kwargs),
                     _scripted_policy(structs.AgentOutput), carry,
                     unroll_length, num_action_repeats=repeats,
                     level_name_id=seed)
  ref = jax_actor.Actor(getattr(jax_fake, env_name)(**kwargs),
                        _scripted_policy(jax_structs.AgentOutput), carry,
                        unroll_length, num_action_repeats=repeats,
                        level_name_id=seed)
  return port, ref


@pytest.mark.parametrize('env_name', ['FakeEnv', 'CueMemoryEnv',
                                      'ContextualBanditEnv'])
def test_actor_unroll_is_bit_equal_to_jax(env_name):
  port, ref = _actors(env_name, seed=2)
  previous = None
  for _ in range(3):
    got, want = port.unroll(), ref.unroll()
    _assert_trees_equal(got, want)
    assert got.env_outputs.reward.shape == (7,)
    if previous is not None:
      # The overlap: timestep 0 is the previous unroll's last.
      _assert_trees_equal(
          structs.map_structure(lambda x: x[0], got.env_outputs),
          structs.map_structure(lambda x: x[-1], previous.env_outputs))
    previous = got
  # Episodes ended in these unrolls, with their stats in the info.
  assert got.env_outputs.done[1:].any() or previous.env_outputs.done.any()


def test_agent_state_is_the_carry_at_the_unroll_start():
  port, _ = _actors('FakeEnv', seed=0)
  first = port.unroll()
  second = port.unroll()
  np.testing.assert_array_equal(first.agent_state[0], np.full((1, 8), 0.25))
  # The scripted policy adds 1 to c per step: 6 steps later.
  np.testing.assert_array_equal(second.agent_state[0],
                                np.full((1, 8), 6.25, np.float32))


def test_batch_unrolls_is_bit_equal_to_jax():
  unrolls, refs = [], []
  for seed in range(3):
    port, ref = _actors('ContextualBanditEnv', seed)
    for _ in range(2):
      unrolls.append(port.unroll())
      refs.append(ref.unroll())
  got = actor.batch_unrolls(unrolls)
  _assert_trees_equal(got, jax_actor.batch_unrolls(refs))
  assert got.env_outputs.observation[0].shape == (7, 6, 6, 5, 3)
  assert got.agent_state[0].shape == (6, 8)
  allocated = []

  def empty(shape, dtype):
    allocated.append(shape)
    return np.empty(shape, dtype)

  _assert_trees_equal(actor.batch_unrolls(unrolls, empty=empty), got)
  assert len(allocated) == len(list(_leaves(got)))


def test_buffer_is_fifo_with_backpressure():
  buf = ring_buffer.TrajectoryBuffer(2)
  buf.put('a')
  buf.put('b')
  with pytest.raises(TimeoutError):
    buf.put('c', timeout=0.05)
  assert buf.stats()['put_waits'] == 1
  assert buf.get_unrolls(1) == (['a'], 1)
  buf.put('c', timeout=1)
  assert buf.get_unrolls(2) == (['b', 'c'], 2)
  stats = buf.stats()
  assert stats['high_water'] == 2 and stats['fresh_unrolls'] == 3


def test_buffer_get_unrolls_pushes_back_on_timeout():
  buf = ring_buffer.TrajectoryBuffer(4)
  buf.put(1)
  buf.put(2)
  with pytest.raises(TimeoutError):
    buf.get_unrolls(3, timeout=0.05)
  assert len(buf) == 2
  assert buf.get_unrolls(2) == ([1, 2], 2)


def test_buffer_close_wakes_getters_and_putters():
  buf = ring_buffer.TrajectoryBuffer(1)
  buf.put(0)
  errors = []

  def blocked(fn):
    try:
      fn()
    except ring_buffer.Closed:
      errors.append(fn)

  getter_buf = ring_buffer.TrajectoryBuffer(1)
  threads = [threading.Thread(target=blocked, args=(lambda: buf.put(1),)),
             threading.Thread(target=blocked,
                              args=(lambda: getter_buf.get_unrolls(1),))]
  for t in threads:
    t.start()
  time.sleep(0.05)
  buf.close()
  getter_buf.close()
  for t in threads:
    t.join(timeout=5)
    assert not t.is_alive()
  assert len(errors) == 2


def test_buffer_replay_raises():
  """Sample reuse is ported: the config takes it, and a buffer asked to
  replay without a replay tier raises."""
  for kw in ({'replay_ratio': 0.5}, {'replay_k': 2}):
    assert Config(**kw).reuse_on
  with pytest.raises(ValueError, match='ReplayTier'):
    ring_buffer.TrajectoryBuffer(4, replay_ratio=0.5)


def test_prefetcher_keeps_order_and_depth():
  buf = ring_buffer.TrajectoryBuffer(16)
  for i in range(12):
    buf.put(i)
  prefetcher = ring_buffer.BatchPrefetcher(
      buf, 3, place_fn=lambda batch: ('placed', batch), depth=2,
      stack_fn=list)
  try:
    deadline = time.monotonic() + 5
    while prefetcher.stats()['staged_batches'] < 2:
      assert time.monotonic() < deadline
      time.sleep(0.01)
    time.sleep(0.05)
    assert prefetcher.stats()['staged_batches'] == 2  # depth bounds it
    assert prefetcher.get(timeout=5) == ('placed', [0, 1, 2])
    assert prefetcher.get(timeout=5) == ('placed', [3, 4, 5])
    assert prefetcher.get(timeout=5) == ('placed', [6, 7, 8])
    stats = prefetcher.stats()
    assert stats['gets'] == 3 and stats['depth'] == 2
    assert prefetcher.get(timeout=5) == ('placed', [9, 10, 11])
    with pytest.raises(TimeoutError):
      prefetcher.get(timeout=0.05)
    assert prefetcher.stats()['blocked_gets'] >= 1
  finally:
    prefetcher.close()
  with pytest.raises(ring_buffer.Closed):
    prefetcher.get(timeout=1)
  with pytest.raises(ring_buffer.Closed):
    buf.put(99)


def test_prefetcher_raises_the_place_fn_error_in_get():
  buf = ring_buffer.TrajectoryBuffer(4)
  buf.put(1)

  def place(batch):
    raise RuntimeError('injected staging failure')

  prefetcher = ring_buffer.BatchPrefetcher(buf, 1, place_fn=place,
                                           stack_fn=list)
  try:
    with pytest.raises(RuntimeError, match='injected staging failure'):
      prefetcher.get(timeout=5)
  finally:
    prefetcher.close()


class _FailingEnv(fake.FakeEnv):

  def step(self, action):
    raise RuntimeError('injected env failure')


def _fleet(make_env, buffer, quarantine_after=5, num_actors=1,
           unroll_length=3):
  def make_actor(i):
    env = make_env(i)
    return env, None, actor.Actor(
        env, _scripted_policy(structs.AgentOutput),
        (np.zeros((1, 8), np.float32), np.zeros((1, 8), np.float32)),
        unroll_length=unroll_length)
  return fleet.ActorFleet(make_actor, buffer, num_actors,
                          quarantine_after=quarantine_after)


def _wait(predicate, what, timeout=20.0):
  deadline = time.monotonic() + timeout
  while not predicate():
    assert time.monotonic() < deadline, what
    time.sleep(0.02)


def test_fleet_respawns_a_failing_actor():
  spawned = []

  def make_env(i):
    spawned.append(i)
    return (_FailingEnv if len(spawned) == 1 else fake.FakeEnv)(
        height=4, width=4)

  buf = ring_buffer.TrajectoryBuffer(64)
  actors = _fleet(make_env, buf)
  actors.start()
  try:
    _wait(lambda: actors.errors(), 'the first actor did not fail')
    assert 'injected env failure' in str(actors.errors()[0])
    _wait(lambda: actors.check_health() or actors.stats()['respawns'],
          'no respawn')
    _wait(lambda: actors.stats()['unrolls'] >= 2, 'no unrolls after respawn')
    stats = actors.stats()
    assert stats['respawns'] == 1 and stats['healthy'] == 1
    assert not actors.errors()
    (unroll,), _ = buf.get_unrolls(1, timeout=5)
    assert unroll.env_outputs.reward.shape == (4,)
  finally:
    report = actors.stop(timeout=5)
  assert report == {'unjoined_actors': []}


def test_fleet_quiesce_lands_the_unrolls_in_flight():
  buf = ring_buffer.TrajectoryBuffer(100000)
  actors = _fleet(lambda i: fake.FakeEnv(height=4, width=4), buf,
                  num_actors=2, unroll_length=50)
  actors.start()
  _wait(lambda: actors.stats()['unrolls'] >= 2, 'no unrolls')
  assert actors.quiesce(timeout=10) == {'unjoined_actors': []}
  assert actors.stats()['alive'] == 0
  landed = len(buf)
  assert landed == actors.stats()['unrolls']
  buf.put('still open', timeout=1)  # quiesce leaves the buffer open
  assert len(buf) == landed + 1


def test_fleet_quarantines_after_repeated_failures():
  buf = ring_buffer.TrajectoryBuffer(8)
  actors = _fleet(lambda i: _FailingEnv(height=4, width=4), buf,
                  quarantine_after=2, num_actors=2)
  actors.start()
  try:
    _wait(lambda: (actors.check_health() is not None and
                   actors.stats()['slots_quarantined'] == 2),
          'the failing slots were not quarantined')
    stats = actors.stats()
    # Two respawns each, then the third attempt gives up.
    assert stats['respawns'] == 6 and stats['alive'] == 0
    assert actors.check_health() == []
    # A dead fleet's errors come back.
    assert len(actors.errors()) == 2
  finally:
    actors.stop(timeout=5)


def test_backoff_is_capped_full_jitter():
  rng = np.random.RandomState(0)

  class Uniform:
    def uniform(self, low, high):
      return low + (high - low) * rng.rand()

  backoff = fleet.Backoff(base=0.1, cap=0.5, rng=Uniform())
  delays = [backoff.next_delay() for _ in range(10)]
  assert all(0 <= d <= 0.5 for d in delays)
  assert backoff.attempt == 3  # stops growing at the cap
  backoff.reset()
  assert backoff.attempt == 0 and backoff.next_delay() <= 0.1
  with pytest.raises(ValueError):
    fleet.Backoff(base=0)


def test_run_actor_loop_failure_closes_the_buffer():
  buf = ring_buffer.TrajectoryBuffer(4)
  bad = actor.Actor(_FailingEnv(height=4, width=4),
                    _scripted_policy(structs.AgentOutput),
                    (np.zeros((1, 8), np.float32),) * 2, unroll_length=2)
  with pytest.raises(RuntimeError, match='injected env failure'):
    actor.run_actor_loop(bad, buf, threading.Event())
  with pytest.raises(ring_buffer.Closed):
    buf.get_unrolls(1, timeout=1)
