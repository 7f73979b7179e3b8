"""Fake environments, copied from the JAX package's envs/fake.py (numpy
only, bit-equal to it for the same seeds and actions):

- `FakeEnv`: deterministic frames and rewards from a counter; fixed
  episode length; auto-reset. For plumbing and alignment tests.
- `CueMemoryEnv`: a two-step memory task (the cue is visible only on the
  first frame).
- `ContextualBanditEnv`: the frame's dominant colour channel names the
  action that pays — the simplest task where the IMPALA loss must
  visibly learn.

Each env stamps its level name's instruction ids
(models/instruction.hash_instruction) on every observation.
"""

import numpy as np

from scalable_agent_tpu_torch.envs import base
from scalable_agent_tpu_torch.models.instruction import (MAX_INSTRUCTION_LEN,
                                                        hash_instruction)


class FakeEnv(base.Environment):
  """Deterministic counter-driven env."""

  def __init__(self, height=24, width=32, num_actions=5,
               episode_length=10, seed=0, level_name='fake',
               num_action_repeats=1):
    self._h, self._w = height, width
    self._num_actions = num_actions
    self._episode_length = episode_length
    self._count = 0
    self._episode_step = 0
    self._seed = seed
    self._instr = hash_instruction(level_name)

  def _observation(self):
    frame = np.full((self._h, self._w, 3),
                    (self._count + self._seed) % 255, np.uint8)
    return (frame, self._instr.copy())

  def initial(self):
    return self._observation()

  def step(self, action):
    self._count += 1
    self._episode_step += 1
    reward = np.float32(0.1 * (int(action) % 2))
    done = self._episode_step >= self._episode_length
    if done:
      self._episode_step = 0
    return reward, np.bool_(done), self._observation()

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    h = constructor_kwargs.get('height', 24)
    w = constructor_kwargs.get('width', 32)
    if method_name == 'initial':
      return base.observation_specs(h, w, MAX_INSTRUCTION_LEN)
    if method_name == 'step':
      return base.step_output_specs(h, w, MAX_INSTRUCTION_LEN)
    return None


class CueMemoryEnv(base.Environment):
  """Two-step memory task: the cue (dominant colour channel 0..2) is
  visible only on the first frame; the action on the blank second frame
  earns 1 iff it matches the cue. The first action is paid 2.0 iff it is
  the fixed action 0, so relaying the cue through the previous action
  forfeits more than it gains: only a working recurrent carry clears an
  episode return of ~2.6 (memory 3.0, best memoryless 2 + 1/3)."""

  def __init__(self, height=16, width=16, num_actions=3,
               episode_length=2, seed=0, level_name='cue_memory',
               num_action_repeats=1):
    del episode_length  # fixed two-step episodes
    if num_actions != 3:
      raise ValueError('CueMemoryEnv is a 3-action task (one action '
                       'per RGB cue channel); got num_actions='
                       f'{num_actions}')
    self._h, self._w = height, width
    self._num_actions = num_actions
    self._rng = np.random.RandomState(seed)
    self._instr = hash_instruction(level_name)
    self._step_in_episode = 0
    self._cue = int(self._rng.randint(3))

  def _observation(self):
    frame = np.zeros((self._h, self._w, 3), np.uint8)
    if self._step_in_episode == 0:  # cue only on the first frame
      frame[:, :, self._cue] = 255
    return (frame, self._instr.copy())

  def initial(self):
    return self._observation()

  def step(self, action):
    if self._step_in_episode == 0:
      self._step_in_episode = 1
      reward = np.float32(2.0 if int(action) == 0 else 0.0)
      return reward, np.bool_(False), self._observation()
    reward = np.float32(1.0 if int(action) == self._cue else 0.0)
    self._cue = int(self._rng.randint(3))
    self._step_in_episode = 0
    return reward, np.bool_(True), self._observation()

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    h = constructor_kwargs.get('height', 16)
    w = constructor_kwargs.get('width', 16)
    if method_name == 'initial':
      return base.observation_specs(h, w, MAX_INSTRUCTION_LEN)
    if method_name == 'step':
      return base.step_output_specs(h, w, MAX_INSTRUCTION_LEN)
    return None


class ContextualBanditEnv(base.Environment):
  """One-step contextual bandit: acting the frame's dominant colour
  channel pays 1. Each episode is `episode_length` steps of one context;
  the rewarded channel is `randint(num_actions) % 3`."""

  def __init__(self, height=24, width=32, num_actions=3,
               episode_length=5, seed=0, level_name='bandit',
               num_action_repeats=1):
    self._h, self._w = height, width
    self._num_actions = num_actions
    self._episode_length = episode_length
    self._rng = np.random.RandomState(seed)
    self._instr = hash_instruction(level_name)
    self._episode_step = 0
    self._target = None
    self._reset_context()

  def _reset_context(self):
    self._target = int(self._rng.randint(self._num_actions)) % 3
    self._episode_step = 0

  def _observation(self):
    frame = np.zeros((self._h, self._w, 3), np.uint8)
    frame[:, :, self._target] = 255
    return (frame, self._instr.copy())

  def initial(self):
    return self._observation()

  def step(self, action):
    reward = np.float32(1.0 if int(action) == self._target else 0.0)
    self._episode_step += 1
    done = self._episode_step >= self._episode_length
    if done:
      self._reset_context()
    return reward, np.bool_(done), self._observation()

  _tensor_specs = FakeEnv.__dict__['_tensor_specs']
