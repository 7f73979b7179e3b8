"""Atari (ALE) environment adapter, the port's copy of the JAX
package's envs/atari.py (import-guarded: the backend is `ale_py`, else
gymnasium's ALE registration, and neither is needed to import this
module).

The observation contract is the DMLab path's (frame uint8 [H, W, 3] and
instruction ids, here empty), so every other layer is env-agnostic. The
preprocessing is host numpy:

- action repeat with a max-pool over the last two raw frames (flicker
  removal),
- nearest-neighbour resize to (height, width) in uint8,
- random no-op starts (<= 30) at episode begin,
- sticky actions at `sticky_action_prob` per frame (Machado et al.),
  drawn from the env's own RandomState,
- auto-reset on game over (done=True returns the next episode's first
  frame, as envs/base.py says).

`ale` injects a backend (tests).
"""

from typing import Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch.envs import base
from scalable_agent_tpu_torch.models.instruction import (
    empty_instruction, MAX_INSTRUCTION_LEN)

DEFAULT_NUM_ACTIONS = 18  # full ALE action set
DEFAULT_NOOP_MAX = 30


def resize_uint8(frame: np.ndarray, height: int, width: int
                 ) -> np.ndarray:
  """Nearest-neighbor resize of an [H, W, C] uint8 frame (pure numpy —
  no cv2/PIL dependency on the actor hot path)."""
  in_h, in_w = frame.shape[:2]
  rows = (np.arange(height) * in_h // height).astype(np.intp)
  cols = (np.arange(width) * in_w // width).astype(np.intp)
  return frame[rows[:, None], cols[None, :]]


def pooled_frame(last_two: Tuple[np.ndarray, np.ndarray]
                 ) -> np.ndarray:
  """Pixel-wise max over the last two raw frames (flicker removal)."""
  a, b = last_two
  return np.maximum(a, b)


class AtariEnv(base.Environment):
  """One ALE game behind the host env protocol."""

  def __init__(self, game: str, seed: int, height: int = 72,
               width: int = 96, num_action_repeats: int = 4,
               noop_max: int = DEFAULT_NOOP_MAX,
               full_action_set: bool = True, is_test: bool = False,
               num_actions: Optional[int] = None,
               sticky_action_prob: float = 0.0,
               ale: Optional[object] = None):
    """`ale` injects a backend (testing); otherwise ale_py/gymnasium.

    sticky_action_prob: per-FRAME probability that the previous
    executed action repeats instead of the policy's (Machado et al.
    2018 evaluation protocol, ς = 0.25). Implemented host-side in the
    adapter — backends run with their own stochastic repeat disabled —
    so it is deterministic under the env seed and testable without
    ALE. 0.0 (default) matches the reference-era deterministic
    protocol.

    is_test does NOT disable no-op starts: the random-≤30-no-op
    regime is the ALE *evaluation* protocol (DQN/IMPALA-era scores
    are reported under it) — without it a deterministic ALE would
    replay near-identical eval episodes. It is accepted for API
    symmetry with the DMLab adapter (whose test mode switches
    holdout levels/mixerSeed).
    """
    self._h, self._w = height, width
    self._num_action_repeats = num_action_repeats
    self._noop_max = noop_max
    self._sticky_prob = float(sticky_action_prob)
    if not 0.0 <= self._sticky_prob <= 1.0:
      # Fail fast: e.g. 25 meant-as-percent would otherwise make
      # every frame repeat NOOP forever, silently degenerate training.
      raise ValueError(
          f'sticky_action_prob={sticky_action_prob} not in [0, 1]')
    self._prev_exec_action = 0  # NOOP until the first step
    self._rng = np.random.RandomState(seed)
    self._instr = empty_instruction()
    self._ale = ale if ale is not None else _make_ale(
        game, self._rng.randint(0, 2 ** 31 - 1), full_action_set)
    self._actions = self._ale.action_set()
    if num_actions is not None and num_actions != len(self._actions):
      # Fail fast: a policy head sized differently from the backend's
      # action set would silently alias actions (e.g. num_actions=18
      # against a minimal set) and corrupt the policy/env
      # correspondence.
      raise ValueError(
          f'num_actions={num_actions} but the {game!r} backend exposes '
          f'{len(self._actions)} actions '
          f'(full_action_set={full_action_set})')
    self._reset()

  def _reset(self):
    self._ale.reset()
    self._prev_exec_action = 0  # stickiness does not cross episodes
    for _ in range(self._rng.randint(self._noop_max + 1)
                   if self._noop_max else 0):
      self._ale.act(0)  # NOOP
      if self._ale.game_over():
        self._ale.reset()
    self._raw = self._ale.screen_rgb()
    self._prev_raw = self._raw

  def _observation(self):
    frame = resize_uint8(pooled_frame((self._prev_raw, self._raw)),
                         self._h, self._w)
    return (frame, self._instr.copy())

  def initial(self):
    return self._observation()

  def step(self, action):
    a = int(action)
    if not 0 <= a < len(self._actions):
      # Python negative indexing would silently alias to the end of
      # the action set; out-of-range must raise either way.
      raise IndexError(
          f'action {a} outside [0, {len(self._actions)})')
    raw_action = self._actions[a]
    reward = 0.0
    for _ in range(self._num_action_repeats):
      if (self._sticky_prob and
          self._rng.random_sample() < self._sticky_prob):
        exec_action = self._prev_exec_action
      else:
        exec_action = raw_action
      self._prev_exec_action = exec_action
      reward += self._ale.act(exec_action)
      self._prev_raw = self._raw
      self._raw = self._ale.screen_rgb()
      if self._ale.game_over():
        break
    done = self._ale.game_over()
    if done:
      self._reset()
    return (np.float32(reward), np.bool_(done), self._observation())

  def close(self):
    pass

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    h = constructor_kwargs.get('height', 72)
    w = constructor_kwargs.get('width', 96)
    if method_name == 'initial':
      return base.observation_specs(h, w, MAX_INSTRUCTION_LEN)
    if method_name == 'step':
      return base.step_output_specs(h, w, MAX_INSTRUCTION_LEN)
    return None


class _AlePyBackend:
  """Thin uniform wrapper over ale_py.ALEInterface."""

  def __init__(self, game, seed, full_action_set):
    import ale_py
    self._ale = ale_py.ALEInterface()
    self._ale.setInt('random_seed', int(seed))
    self._ale.setFloat('repeat_action_probability', 0.0)
    self._ale.loadROM(ale_py.roms.get_rom_path(game))
    self._action_set = (self._ale.getLegalActionSet() if full_action_set
                        else self._ale.getMinimalActionSet())

  def action_set(self):
    return list(self._action_set)

  def reset(self):
    self._ale.reset_game()

  def act(self, action):
    return float(self._ale.act(action))

  def game_over(self):
    return bool(self._ale.game_over())

  def screen_rgb(self):
    return np.asarray(self._ale.getScreenRGB(), np.uint8)


# gymnasium registrations whose CamelCase is not capitalize-each-part
# (an irregular id would otherwise convert wrongly and fail later inside
# gymnasium.make). All 57 suite ids are regular.
_GYM_ID_OVERRIDES = {
    'tic_tac_toe_3d': 'TicTacToe3D',  # capitalize gives 'TicTacToe3d'
}


def gym_game_id(game: str) -> str:
  """Canonical snake_case rom id ('kung_fu_master', the envs/atari57.py
  convention) → gymnasium's CamelCase registration ('KungFuMaster').
  Already-CamelCase names pass through."""
  if game in _GYM_ID_OVERRIDES:
    return _GYM_ID_OVERRIDES[game]
  if '_' in game or game.islower():
    return ''.join(part.capitalize() for part in game.split('_'))
  return game


class _GymnasiumBackend:
  """Fallback over gymnasium's ALE envs (frameskip disabled — the
  adapter owns action repeat and pooling)."""

  def __init__(self, game, seed, full_action_set):
    import gymnasium
    self._env = gymnasium.make(
        f'ALE/{gym_game_id(game)}-v5', frameskip=1,
        repeat_action_probability=0.0,
        full_action_space=full_action_set, render_mode='rgb_array')
    self._seed = int(seed)
    self._frame = None
    self._over = True

  def action_set(self):
    return list(range(self._env.action_space.n))

  def reset(self):
    self._frame, _ = self._env.reset(seed=self._seed)
    self._seed = None  # seed only the first reset
    self._over = False

  def act(self, action):
    self._frame, reward, terminated, truncated, _ = self._env.step(
        action)
    self._over = bool(terminated or truncated)
    return float(reward)

  def game_over(self):
    return self._over

  def screen_rgb(self):
    return np.asarray(self._frame, np.uint8)


def _make_ale(game, seed, full_action_set):
  try:
    return _AlePyBackend(game, seed, full_action_set)
  except ImportError:
    pass
  try:
    return _GymnasiumBackend(game, seed, full_action_set)
  except Exception as e:  # gymnasium missing, or present without ROMs
    raise ImportError(
        f'no Atari backend available (ale_py missing, gymnasium ALE '
        f'failed: {e}); use --env_backend=fake/bandit in this sandbox'
    ) from e
