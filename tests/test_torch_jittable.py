"""The port's on-device env family (scalable_agent_tpu_torch/envs/
jittable.py and parallel/anakin.py's CueMemoryCore) against the JAX
package's: procgen's walls bit-equal to JAX's PRNG for every level id,
and from the same state and actions the same frames (bit-equal), rewards,
dones and episode stats (exact), and the same next state on the rows
that did not end an episode (a row that did draws a fresh episode from
the port's own generator: JAX's distribution, not its stream). Then the
host wrappers at batch 1 against their cores, the factory's specs
against JAX's, and the gridworld's no-op actions under a wide head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import factory as jax_factory
from scalable_agent_tpu.envs import jittable as jax_jittable
from scalable_agent_tpu.parallel import anakin as jax_anakin
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import factory
from scalable_agent_tpu_torch.envs import jittable
from scalable_agent_tpu_torch.parallel import anakin

torch.set_num_threads(1)


@pytest.mark.parametrize('seed, grid, density', [
    (1234, 5, 0.25), (0, 4, 0.25), (7, 9, 0.5), (1234, 5, 0.6),
    (2**31 + 5, 6, 0.1)])
def test_procgen_walls_are_jax_walls(seed, grid, density):
  jcore = jax_jittable.ProcgenCore(grid_size=grid, wall_density=density,
                                   layout_seed=seed, num_levels=16)
  ref = np.asarray(jcore._walls(jnp.arange(16, dtype=jnp.int32)))
  core = jittable.ProcgenCore(grid_size=grid, wall_density=density,
                              layout_seed=seed, num_levels=16)
  np.testing.assert_array_equal(core.wall_table('cpu').numpy(), ref)


def test_threefry_bernoulli_is_jax_bernoulli():
  for seed, data, shape, p in ((3, 11, (7, 5), 0.3), (99, 0, (64,), 0.5),
                               (2**32 - 1, 2**31, (3, 3), 0.9)):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    ref = np.asarray(jax.random.bernoulli(key, p, shape))
    mine = jittable.bernoulli(
        jittable.fold_in(jittable.prng_key(seed), data), p, shape)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(key)),
                                  jittable.fold_in(jittable.prng_key(seed),
                                                   data))
    np.testing.assert_array_equal(mine, ref)


def _port_state(core, jax_state, generator):
  """The port's state holding a JAX state's values."""
  fields = {}
  for name, value in jax_state._asdict().items():
    if name == 'rng':
      continue
    x = torch.from_numpy(np.array(value))
    fields[name] = x.long() if x.dtype == torch.int32 and name in (
        'agent_yx', 'goal_yx', 'level_id', 'context') else x
  return type(core.init(torch.Generator().manual_seed(0), 1)[0])(
      rng=generator, **fields)


def _cores(name, num_actions):
  if name == 'cue_memory':
    return (jax_anakin.CueMemoryCore(height=12, width=10),
            anakin.CueMemoryCore(height=12, width=10))
  kw = dict(height=20, width=28, num_actions=num_actions,
            episode_length=9)
  return (jax_jittable.JITTABLE_CORES[name](**kw),
          jittable.JITTABLE_CORES[name](**kw))


@pytest.mark.parametrize('name, num_actions', [
    ('gridworld', 4), ('gridworld', 6), ('procgen', 5), ('cue_memory', 3)])
def test_core_steps_match_jax(name, num_actions):
  """30 steps of 8 envs from JAX's states, with random actions: exact
  outputs, bit-equal frames, the same next state where not done."""
  jcore, core = _cores(name, num_actions)
  jstate, jout = jcore.init(jax.random.PRNGKey(5), 8)
  generator = torch.Generator().manual_seed(0)
  state0, out0 = core.init(generator, 8)
  assert out0.observation[0].shape == tuple(jout.observation[0].shape)
  assert bool(out0.done.all())
  rng = np.random.RandomState(1)
  for _ in range(30):
    action = rng.randint(0, num_actions, 8)
    state, out = core.step(_port_state(core, jstate, generator),
                           torch.from_numpy(action))
    jstate, jout = jcore.step(jstate, jnp.asarray(action, jnp.int32))
    done = np.asarray(jout.done)
    np.testing.assert_array_equal(out.done.numpy(), done)
    np.testing.assert_array_equal(out.reward.numpy(),
                                  np.asarray(jout.reward))
    for got, want in zip(out.info, jout.info):
      np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    frames = out.observation[0].numpy()
    assert frames.dtype == np.uint8
    np.testing.assert_array_equal(frames[~done],
                                  np.asarray(jout.observation[0])[~done])
    np.testing.assert_array_equal(out.observation[1].numpy(),
                                  np.asarray(jout.observation[1]))
    for field, value in jstate._asdict().items():
      if field in ('rng', 'level_scores', 'level_visits'):
        continue
      np.testing.assert_array_equal(
          getattr(state, field).numpy()[~done], np.asarray(value)[~done],
          err_msg=field)


def test_wide_head_no_ops_and_narrow_heads_raise():
  core = jittable.GridworldCore(num_actions=7)
  state, _ = core.init(torch.Generator().manual_seed(0), 6)
  state = state._replace(agent_yx=torch.tensor([[1, 2]] * 6))
  moved, _ = core.step(state, torch.tensor([4, 5, 6, 4, 5, 6]))
  np.testing.assert_array_equal(moved.agent_yx.numpy(), [[1, 2]] * 6)
  with pytest.raises(ValueError, match='num_actions'):
    jittable.GridworldCore(num_actions=3)
  with pytest.raises(ValueError, match='3-action'):
    anakin.CueMemoryCore(num_actions=4)


@pytest.mark.parametrize('name', ['gridworld', 'procgen'])
def test_host_env_is_its_core_at_batch_one(name):
  """The host wrapper plays its core at batch 1 from the same generator:
  the same observations, rewards and dones over 60 steps."""
  kw = dict(height=16, width=20, num_actions=5, episode_length=7)
  env = jittable.HOST_ENVS[name](seed=3, **kw)
  core = jittable.JITTABLE_CORES[name](**kw)
  state, out = core.init(torch.Generator().manual_seed(3), 1)
  frame, instr = env.initial()
  np.testing.assert_array_equal(frame, out.observation[0][0].numpy())
  assert instr.dtype == np.int32 and not instr.any()
  rng = np.random.RandomState(0)
  for _ in range(60):
    action = int(rng.randint(5))
    reward, done, (frame, _) = env.step(action)
    state, out = core.step(state, torch.tensor([action]))
    assert reward == float(out.reward[0]) and isinstance(reward, np.float32)
    assert bool(done) == bool(out.done[0])
    np.testing.assert_array_equal(frame, out.observation[0][0].numpy())


@pytest.mark.parametrize('backend, num_actions', [
    ('gridworld', None), ('procgen', None), ('procgen', 9)])
def test_factory_builds_the_host_envs(backend, num_actions):
  kw = dict(env_backend=backend, height=16, width=20, episode_length=6,
            num_action_repeats=2, num_actions=num_actions,
            use_instruction=False, procgen_num_levels=5,
            procgen_wall_density=0.4)
  spec = factory.make_env_spec(Config(**kw), 'lvl', seed=5)
  ref = jax_factory.make_env_spec(JaxConfig(**kw), 'lvl', seed=5)
  assert spec.env_class.__name__ == ref.env_class.__name__
  assert spec.constructor_kwargs == ref.constructor_kwargs
  assert (spec.num_actions, spec.frame_shape) == (ref.num_actions,
                                                  ref.frame_shape)
  env = spec.build()
  frame, _ = env.initial()
  assert frame.shape == (16, 20, 3)
  reward, done, _ = env.step(spec.num_actions - 1)
  assert np.isfinite(reward) and isinstance(done, np.bool_)


class _ThreadsProbe(jittable.ProcgenEnv):
  """A procgen host env that reports its process's torch threads."""

  def threads(self):
    return torch.get_num_threads()


def test_a_hosted_env_runs_torch_on_one_thread():
  """In its own process (py_process runs the class's _process_setup
  first) the host env steps on one intra-op thread: a pool per env
  process oversubscribed the fleet's cores (225 ms per step for 32 env
  processes on 8 cores, 1.5 ms with one thread each). In the caller's
  process nothing changes."""
  from scalable_agent_tpu_torch.runtime import py_process
  threads = torch.get_num_threads()
  process = py_process.PyProcess(_ThreadsProbe, constructor_kwargs=dict(
      height=8, width=8, num_actions=4, episode_length=5))
  process.start()
  try:
    assert process.proxy.threads() == 1
    assert process.proxy.step(1)[2][0].shape == (8, 8, 3)
  finally:
    process.close()
  _ThreadsProbe(8, 8, 4, 5).step(0)
  assert torch.get_num_threads() == threads
