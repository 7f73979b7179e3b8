"""The port's Atari adapter (scalable_agent_tpu_torch/envs/atari.py)
against the JAX package's, through the same scripted ALE (neither machine
has ale_py or gymnasium's ROMs): the pure preprocessing, a scripted run
whose frames, rewards, dones and executed actions are bit-equal in both
packages, sticky actions and no-op starts drawn from the same
RandomState, the action-count check, the factory's kwargs and the import
guard's message."""

import numpy as np
import pytest

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import atari as jax_atari
from scalable_agent_tpu.envs import factory as jax_factory
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import atari, factory


class ScriptedAle:
  """An ALE stand-in: the screen is a function of the act counter, an
  episode ends after `episode_len` acts, the reward is the action index;
  every executed action is recorded."""

  def __init__(self, episode_len=6, actions=4):
    self._episode_len = episode_len
    self._actions = actions
    self._t = 0
    self._acts = 0
    self.resets = 0
    self.acts = []

  def action_set(self):
    return list(range(self._actions))

  def reset(self):
    self.resets += 1
    self._acts = 0

  def act(self, action):
    self.acts.append(action)
    self._t += 1
    self._acts += 1
    return float(action)

  def game_over(self):
    return self._acts >= self._episode_len

  def screen_rgb(self):
    frame = np.zeros((210, 160, 3), np.uint8)
    frame[:, :, 0] = self._t % 256
    frame[self._t % 210] = 255
    return frame


def test_the_preprocessing_is_jax_s():
  rng = np.random.RandomState(3)
  frame = rng.randint(0, 256, (210, 160, 3)).astype(np.uint8)
  other = rng.randint(0, 256, (210, 160, 3)).astype(np.uint8)
  for h, w in ((72, 96), (84, 84), (210, 160), (5, 7)):
    np.testing.assert_array_equal(atari.resize_uint8(frame, h, w),
                                  jax_atari.resize_uint8(frame, h, w))
  np.testing.assert_array_equal(atari.pooled_frame((frame, other)),
                                jax_atari.pooled_frame((frame, other)))
  assert atari.DEFAULT_NUM_ACTIONS == jax_atari.DEFAULT_NUM_ACTIONS == 18
  assert atari.DEFAULT_NOOP_MAX == jax_atari.DEFAULT_NOOP_MAX
  for game in ('kung_fu_master', 'tic_tac_toe_3d', 'pong', 'Pong'):
    assert atari.gym_game_id(game) == jax_atari.gym_game_id(game)


@pytest.mark.parametrize('sticky, noop_max, seed', [
    (0.0, 0, 0), (0.0, 30, 7), (0.25, 30, 11), (1.0, 0, 2)])
def test_a_scripted_run_is_bit_equal_to_jax_s(sticky, noop_max, seed):
  """The same seed and actions through both adapters: no-op starts,
  sticky draws, pooled and resized frames, rewards, dones, auto-resets
  and every action the emulator executed."""
  ales = [ScriptedAle(episode_len=9), ScriptedAle(episode_len=9)]
  envs = [module.AtariEnv('pong', seed=seed, height=24, width=32,
                          num_action_repeats=4, noop_max=noop_max,
                          sticky_action_prob=sticky, num_actions=4, ale=ale)
          for module, ale in zip((jax_atari, atari), ales)]
  for a, b in zip(envs[0].initial(), envs[1].initial()):
    np.testing.assert_array_equal(a, b)
  rng = np.random.RandomState(seed)
  for _ in range(12):
    action = int(rng.randint(4))
    want, got = envs[0].step(action), envs[1].step(action)
    assert (got[0], got[1]) == (want[0], want[1])
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    for a, b in zip(want[2], got[2]):
      np.testing.assert_array_equal(a, b)
  assert ales[1].acts == ales[0].acts and ales[1].resets == ales[0].resets
  assert ales[1].resets > 1   # episodes ended and auto-reset
  if sticky == 1.0:
    assert set(ales[1].acts) == {0}  # NOOP carried from the reset


def test_a_wrong_action_count_fails_fast():
  for module in (jax_atari, atari):
    with pytest.raises(ValueError, match='num_actions=18'):
      module.AtariEnv('pong', seed=0, num_actions=18, ale=ScriptedAle())
    with pytest.raises(ValueError, match='sticky_action_prob'):
      module.AtariEnv('pong', seed=0, sticky_action_prob=25,
                      ale=ScriptedAle())
    env = module.AtariEnv('pong', seed=0, num_actions=4, noop_max=0,
                          ale=ScriptedAle())
    with pytest.raises(IndexError):
      env.step(-1)


def test_the_factory_s_kwargs_and_specs_are_jax_s():
  for kw in (dict(), dict(num_actions=6, sticky_action_prob=0.25)):
    for is_test in (False, True):
      spec = factory.make_env_spec(Config(env_backend='atari', **kw),
                                   'pong', seed=3, is_test=is_test)
      ref = jax_factory.make_env_spec(JaxConfig(env_backend='atari', **kw),
                                      'pong', seed=3, is_test=is_test)
      assert spec.constructor_kwargs == ref.constructor_kwargs
      assert (spec.num_actions, spec.frame_shape) == (ref.num_actions,
                                                      ref.frame_shape)
  for method in ('initial', 'step', 'close'):
    got = atari.AtariEnv._tensor_specs(method, None,
                                       {'height': 84, 'width': 84})
    want = jax_atari.AtariEnv._tensor_specs(method, None,
                                            {'height': 84, 'width': 84})
    assert repr(got) == repr(want)


def test_the_import_guard_says_what_jax_s_says():
  messages = []
  for module in (jax_atari, atari):
    with pytest.raises(ImportError, match='Atari backend') as e:
      module._make_ale('definitely_not_a_game_xyz', 0, True)
    messages.append(str(e.value))
  assert messages[0] == messages[1]
