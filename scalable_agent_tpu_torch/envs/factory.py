"""Environment factory: config -> host environment instances, as in the
JAX package's envs/factory.py, for the backends the port has: `fake`,
`bandit` and `cue_memory` (envs/fake.py). The real simulators (DMLab,
Atari), the benchmark suites and the gridworld/procgen host wrappers
raise `NotImplementedError` naming the ROADMAP item that brings them.

With `use_py_process` each env is hosted in its own OS process
(runtime/py_process.py), the GIL escape of the reference's PyProcess.
"""

from typing import List, Optional, Tuple

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import fake
from scalable_agent_tpu_torch.envs.fake import MAX_INSTRUCTION_LEN

_FAKE_ENVS = {'bandit': fake.ContextualBanditEnv,
              'cue_memory': fake.CueMemoryEnv,
              'fake': fake.FakeEnv}
# The JAX factory's other backends, by the ROADMAP item that ports them.
_LATER_BACKENDS = {
    'dmlab': 'ROADMAP A7 (DMLab adapter)',
    'atari': 'ROADMAP A7 (Atari adapter)',
    'gridworld': 'ROADMAP A6 (envs/jittable.py host wrappers)',
    'procgen': 'ROADMAP A6 (envs/jittable.py host wrappers)',
}
# Suite names that the JAX factory expands into level lists.
_SUITES = ('dmlab30', 'atari57')


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
  """The training levels: the one level the config names. A suite name
  (multi-task DMLab-30, Atari-57) raises."""
  if config.level_name in _SUITES:
    raise NotImplementedError(
        f'level_name={config.level_name!r} (a benchmark suite) is not in '
        'the PyTorch port yet (ROADMAP A7)')
  return [config.level_name]


def make_env_spec(config: Config, level_name: str, seed: int,
                  is_test: bool = False,
                  backend: Optional[str] = None) -> EnvSpec:
  """One environment spec for (backend, level, seed); `backend`
  overrides config.env_backend."""
  del is_test  # the fake envs have no held-out variants
  backend = backend or config.env_backend
  if backend in _LATER_BACKENDS:
    raise NotImplementedError(
        f'env backend {backend!r} is not in the PyTorch port yet '
        f'({_LATER_BACKENDS[backend]}); the port has {sorted(_FAKE_ENVS)}')
  if backend not in _FAKE_ENVS:
    raise ValueError(f'unknown env backend: {backend!r}')
  num_actions = config.num_actions or (5 if backend == 'fake' else 3)
  kwargs = dict(height=config.height, width=config.width,
                num_actions=num_actions,
                episode_length=config.episode_length,
                seed=seed, level_name=level_name,
                num_action_repeats=config.num_action_repeats)
  return EnvSpec(_FAKE_ENVS[backend], kwargs, num_actions,
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
