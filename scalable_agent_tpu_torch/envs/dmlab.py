"""DeepMind Lab environment adapter, the port's copy of the JAX
package's envs/dmlab.py (import-guarded: `deepmind_lab` is imported when
present, and `DmLabEnv` raises ImportError without it; the fake envs
stand in for it in tests).

The reference's `PyProcessDmLab` and `LocalLevelCache`, with the same
contracts:

- `DEFAULT_ACTION_SET`: the 9 discrete composite DMLab actions the
  agent's categorical policy indexes into.
- `step(action_index)` repeats the raw action `num_action_repeats`
  times, returns (reward f32[], done bool[], observation) and
  auto-resets on episode end (the returned observation is then the
  first frame of the next episode).
- a per-env `np.random.RandomState(seed)` draws the reset seeds.
- test mode: `allowHoldOutLevels=true` and the fixed
  `mixerSeed=0x600D5EED`.

The INSTR string is hashed on the host into fixed-shape int32 ids
(models/instruction.hash_instruction): strings never cross a process or
device boundary. `lab_cls` injects a scripted Lab (tests).
"""

import os
import shutil
import tempfile
from typing import Optional

import numpy as np

from scalable_agent_tpu_torch.envs import base
from scalable_agent_tpu_torch.models.instruction import (
    hash_instruction, MAX_INSTRUCTION_LEN)

try:  # pragma: no cover - not installed here
  import deepmind_lab
except ImportError:
  deepmind_lab = None

TEST_MIXER_SEED = 0x600D5EED

# Discrete composite actions over DMLab's 7 continuous/discrete axes
# (look_lr, look_ud, strafe_lr, move_bf, fire, jump, crouch); the
# reference's DEFAULT_ACTION_SET (environments.py ≈L40).
DEFAULT_ACTION_SET = (
    (0, 0, 0, 1, 0, 0, 0),     # Forward
    (0, 0, 0, -1, 0, 0, 0),    # Backward
    (0, 0, -1, 0, 0, 0, 0),    # Strafe Left
    (0, 0, 1, 0, 0, 0, 0),     # Strafe Right
    (-20, 0, 0, 0, 0, 0, 0),   # Look Left
    (20, 0, 0, 0, 0, 0, 0),    # Look Right
    (-20, 0, 0, 1, 0, 0, 0),   # Look Left + Forward
    (20, 0, 0, 1, 0, 0, 0),    # Look Right + Forward
    (0, 0, 0, 0, 1, 0, 0),     # Fire
)


class LocalLevelCache:
  """Level cache storing compiled DMLab maps on local disk
  (reference: environments.py ≈L20). DMLab calls `fetch` before
  compiling a level and `write` after."""

  def __init__(self, cache_dir: Optional[str] = None):
    # Default: level_cache under the temporary directory (TMPDIR).
    if cache_dir is None:
      cache_dir = os.path.join(tempfile.gettempdir(), 'level_cache')
    self._cache_dir = cache_dir
    os.makedirs(cache_dir, exist_ok=True)

  def fetch(self, key: str, pk3_path: str) -> bool:
    path = os.path.join(self._cache_dir, key)
    if os.path.isfile(path):
      shutil.copyfile(path, pk3_path)
      return True
    return False

  def write(self, key: str, pk3_path: str) -> None:
    path = os.path.join(self._cache_dir, key)
    if not os.path.isfile(path):
      shutil.copyfile(pk3_path, path)


def constructor_kwargs(level_name: str, seed: int, is_test: bool,
                       config) -> dict:
  """Kwargs for DmLabEnv from the experiment config (the reference's
  create_environment config block, experiment.py ≈L395–410)."""
  lab_config = {
      'width': str(config.width),
      'height': str(config.height),
      'logLevel': 'WARN',
  }
  if config.dataset_path:
    lab_config['datasetPath'] = config.dataset_path
  if is_test:
    lab_config['allowHoldOutLevels'] = 'true'
    lab_config['mixerSeed'] = str(TEST_MIXER_SEED)
  return dict(level=level_name, config=lab_config, seed=seed,
              num_action_repeats=config.num_action_repeats,
              level_cache_dir=config.level_cache_dir or None)


class DmLabEnv(base.Environment):
  """One DMLab level behind the host env protocol."""

  def __init__(self, level: str, config: dict, seed: int,
               num_action_repeats: int = 4,
               action_set=DEFAULT_ACTION_SET,
               level_cache: Optional[LocalLevelCache] = None,
               level_cache_dir: Optional[str] = None,
               runfiles_path: Optional[str] = None,
               lab_cls=None):
    # `lab_cls` injects a scripted Lab (tests, as AtariEnv's `ale=`),
    # so the step/auto-reset/INSTR path runs without deepmind_lab.
    # Otherwise the real module is resolved.
    if lab_cls is None:
      if deepmind_lab is None:
        raise ImportError(
            'deepmind_lab is not installed; use --env_backend=fake/'
            'bandit in this sandbox, or install DeepMind Lab (see its '
            'build docs) for real runs.')
      if runfiles_path:
        deepmind_lab.set_runfiles_path(runfiles_path)
      lab_cls = deepmind_lab.Lab
    self._num_action_repeats = num_action_repeats
    self._action_set = np.array(action_set, dtype=np.intc)
    self._random_state = np.random.RandomState(seed=seed)
    self._level_name = level
    if level_cache is None:
      level_cache = (LocalLevelCache(level_cache_dir)
                     if level_cache_dir else LocalLevelCache())
    self._env = lab_cls(
        level=level,
        observations=['RGB_INTERLEAVED', 'INSTR'],
        config={k: str(v) for k, v in config.items()},
        level_cache=level_cache)
    self._height = int(config['height'])
    self._width = int(config['width'])
    self._reset()

  def _reset(self):
    self._env.reset(seed=self._random_state.randint(0, 2 ** 31 - 1))

  def _observation(self):
    obs = self._env.observations()
    frame = np.asarray(obs['RGB_INTERLEAVED'], np.uint8)
    instr = hash_instruction(str(obs['INSTR']))
    return (frame, instr)

  def initial(self):
    return self._observation()

  def step(self, action):
    raw_action = self._action_set[int(action)]
    reward = self._env.step(raw_action,
                            num_steps=self._num_action_repeats)
    done = not self._env.is_running()
    if done:
      self._reset()
    return (np.float32(reward), np.bool_(done), self._observation())

  def close(self):
    self._env.close()

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    config = constructor_kwargs['config']
    h, w = int(config['height']), int(config['width'])
    if method_name == 'initial':
      return base.observation_specs(h, w, MAX_INSTRUCTION_LEN)
    if method_name == 'step':
      return base.step_output_specs(h, w, MAX_INSTRUCTION_LEN)
    return None
