"""Environment factory: config -> host environment instances, as in the
JAX package's envs/factory.py: `fake`, `bandit` and `cue_memory`
(envs/fake.py), `gridworld` and `procgen` (envs/jittable.py: the
on-device cores at batch 1 on the CPU), and the real simulators `dmlab`
(envs/dmlab.py) and `atari` (envs/atari.py), which raise ImportError at
construction when their emulator is not installed. A suite name
(`dmlab30`, `atari57`, envs/suites.py) expands into its level list, as
in JAX, so the fake backends run a suite's levels, one per actor slot.

With `use_py_process` each env is hosted in its own OS process
(runtime/py_process.py), the GIL escape of the reference's PyProcess.
"""

from typing import List, Optional, Tuple

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import fake, suites
from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN

_FAKE_ENVS = {'bandit': fake.ContextualBanditEnv,
              'cue_memory': fake.CueMemoryEnv,
              'fake': fake.FakeEnv}

class EnvSpec:
  """What the driver needs to know about a backend before building it."""

  def __init__(self, env_class, constructor_kwargs, num_actions,
               frame_shape):
    self.env_class = env_class
    self.constructor_kwargs = dict(constructor_kwargs)
    self.num_actions = num_actions
    self.frame_shape = tuple(frame_shape)

  @property
  def obs_spec(self):
    return {'frame': self.frame_shape, 'instr_len': MAX_INSTRUCTION_LEN}

  def build(self):
    return self.env_class(**self.constructor_kwargs)


def level_names(config: Config) -> List[str]:
  """The training levels: a suite name ('dmlab30', 'atari57') expands to
  its level list, any other name is the one level."""
  if config.level_name in suites.SUITES:
    return list(suites.SUITES[config.level_name].train_levels)
  return [config.level_name]


def test_level_names(config: Config) -> List[str]:
  """The held-out evaluation levels of a suite (envs/suites.py), or the
  one level."""
  if config.level_name in suites.SUITES:
    return list(suites.SUITES[config.level_name].test_levels)
  return [config.level_name]


def make_env_spec(config: Config, level_name: str, seed: int,
                  is_test: bool = False,
                  backend: Optional[str] = None) -> EnvSpec:
  """One environment spec for (backend, level, seed); `backend`
  overrides config.env_backend (a mixed fleet builds each actor's spec
  for its task's backend). `is_test` picks DMLab's held-out levels; the
  other backends have no held-out variants."""
  backend = backend or config.env_backend
  if backend == 'dmlab':
    from scalable_agent_tpu_torch.envs import dmlab
    return EnvSpec(dmlab.DmLabEnv, dmlab.constructor_kwargs(
        level_name=level_name, seed=seed, is_test=is_test, config=config),
                   len(dmlab.DEFAULT_ACTION_SET),
                   (config.height, config.width, 3))
  if backend == 'atari':
    from scalable_agent_tpu_torch.envs import atari
    num_actions = config.num_actions or atari.DEFAULT_NUM_ACTIONS
    # A head smaller than the full 18-action set asks for the game's
    # minimal set; the env checks the backend's set has num_actions.
    kwargs = dict(game=level_name, seed=seed, height=config.height,
                  width=config.width,
                  num_action_repeats=config.num_action_repeats,
                  is_test=is_test, num_actions=num_actions,
                  sticky_action_prob=config.sticky_action_prob,
                  full_action_set=num_actions == atari.DEFAULT_NUM_ACTIONS)
    return EnvSpec(atari.AtariEnv, kwargs, num_actions,
                   (config.height, config.width, 3))
  if backend in _FAKE_ENVS:
    env_class = _FAKE_ENVS[backend]
    num_actions = config.num_actions or (5 if backend == 'fake' else 3)
  elif backend in ('gridworld', 'procgen'):
    from scalable_agent_tpu_torch.envs import jittable
    env_class = jittable.HOST_ENVS[backend]
    num_actions = (config.num_actions or
                   jittable.DEFAULT_NUM_ACTIONS[backend])
  else:
    raise ValueError(f'unknown env backend: {backend!r}')
  kwargs = dict(height=config.height, width=config.width,
                num_actions=num_actions,
                episode_length=config.episode_length,
                seed=seed, level_name=level_name,
                num_action_repeats=config.num_action_repeats)
  if backend == 'procgen':
    kwargs.update(num_levels=config.procgen_num_levels,
                  wall_density=config.procgen_wall_density)
  return EnvSpec(env_class, kwargs, num_actions,
                 (config.height, config.width, 3))


def build_environment(spec: EnvSpec, use_py_process: bool = False
                      ) -> Tuple[object, Optional[object]]:
  """Instantiate (env, process): in-process, or hosted in its own OS
  process behind the py_process proxy (the PyProcess is returned so the
  caller controls its lifecycle)."""
  if not use_py_process:
    return spec.build(), None
  from scalable_agent_tpu_torch.runtime import py_process
  process = py_process.PyProcess(spec.env_class,
                                 constructor_kwargs=spec.constructor_kwargs)
  process.start()
  return py_process.ProxyEnv(process), process
