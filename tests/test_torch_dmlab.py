"""The port's DMLab adapter (scalable_agent_tpu_torch/envs/dmlab.py)
against the JAX package's, through the same scripted Lab (neither machine
has deepmind_lab): the action set, the level cache, constructor_kwargs in
train and test mode, the tensor specs and the import guard, and a scripted
run whose observations, instruction ids, rewards, dones, raw actions and
reset seeds are bit-equal in both packages."""

import os
import tempfile

import numpy as np
import pytest

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import dmlab as jax_dmlab
from scalable_agent_tpu.envs import factory as jax_factory
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import dmlab, factory


class ScriptedLab:
  """A deepmind_lab.Lab stand-in: episodes end after `episode_len`
  steps, the reward is the raw action row's sum times num_steps, INSTR
  changes every step, and the constructor runs DMLab's level-cache
  protocol (fetch, else compile and write)."""

  episode_len = 3

  def __init__(self, level, observations, config, level_cache):
    self.level = level
    self.observations_spec = list(observations)
    self.config = dict(config)
    self.reset_seeds = []
    self.step_calls = []
    self.closed = False
    self._t = 0
    self._acts = 0
    self._started = False
    self.cache_hit = None
    with tempfile.NamedTemporaryFile(suffix='.pk3', delete=False) as f:
      pk3_path = f.name
    self.cache_hit = level_cache.fetch(level, pk3_path)
    if not self.cache_hit:
      with open(pk3_path, 'wb') as f:
        f.write(b'compiled:' + level.encode())
      level_cache.write(level, pk3_path)
    os.unlink(pk3_path)

  def reset(self, seed):
    self.reset_seeds.append(int(seed))
    self._acts = 0
    self._started = True

  def is_running(self):
    return self._started and self._acts < self.episode_len

  def step(self, action, num_steps):
    assert self.is_running()
    self.step_calls.append((np.array(action, copy=True), int(num_steps)))
    self._t += 1
    self._acts += 1
    return float(action.sum()) * num_steps

  def observations(self):
    h, w = int(self.config['height']), int(self.config['width'])
    return {'RGB_INTERLEAVED': np.full((h, w, 3), self._t % 256, np.uint8),
            'INSTR': f'go to step {self._t}'}

  def close(self):
    self.closed = True


def _pair(tmp_path, seed=11):
  envs = []
  for name, module in (('jax', jax_dmlab), ('port', dmlab)):
    envs.append(module.DmLabEnv(
        'rooms_watermaze', {'height': 8, 'width': 12}, seed=seed,
        num_action_repeats=4, lab_cls=ScriptedLab,
        level_cache_dir=str(tmp_path / f'cache_{name}')))
  return envs


def test_action_set_and_specs_are_jax_s():
  assert dmlab.DEFAULT_ACTION_SET == jax_dmlab.DEFAULT_ACTION_SET
  assert dmlab.TEST_MIXER_SEED == jax_dmlab.TEST_MIXER_SEED == 0x600D5EED
  kwargs = {'config': {'height': 72, 'width': 96}}
  for method in ('initial', 'step', 'close'):
    got = dmlab.DmLabEnv._tensor_specs(method, None, kwargs)
    want = jax_dmlab.DmLabEnv._tensor_specs(method, None, kwargs)
    assert repr(got) == repr(want)


@pytest.mark.parametrize('is_test', [False, True])
@pytest.mark.parametrize('fields', [
    {}, {'dataset_path': '/data/brady', 'level_cache_dir': '/data/cache'}])
def test_constructor_kwargs_are_jax_s(is_test, fields):
  kw = dict(width=96, height=72, num_action_repeats=4, **fields)
  got = dmlab.constructor_kwargs('rooms_watermaze', seed=7,
                                 is_test=is_test, config=Config(**kw))
  want = jax_dmlab.constructor_kwargs('rooms_watermaze', seed=7,
                                      is_test=is_test, config=JaxConfig(**kw))
  assert got == want
  assert ('mixerSeed' in got['config']) == is_test
  # Through the factory, in test mode too.
  spec = factory.make_env_spec(Config(env_backend='dmlab', **kw),
                               'rooms_watermaze', seed=7, is_test=is_test)
  ref = jax_factory.make_env_spec(JaxConfig(env_backend='dmlab', **kw),
                                  'rooms_watermaze', seed=7, is_test=is_test)
  assert spec.constructor_kwargs == ref.constructor_kwargs
  assert (spec.num_actions, spec.frame_shape) == (ref.num_actions,
                                                  ref.frame_shape)


def test_the_import_guard_says_what_jax_s_says():
  if dmlab.deepmind_lab is not None:
    pytest.skip('deepmind_lab is installed')
  messages = []
  for module in (jax_dmlab, dmlab):
    with pytest.raises(ImportError) as e:
      module.DmLabEnv('rooms_watermaze', {'height': 72, 'width': 96}, seed=1)
    messages.append(str(e.value))
  assert messages[0] == messages[1] and 'deepmind_lab' in messages[1]


def test_a_scripted_run_is_bit_equal_to_jax_s(tmp_path):
  """Two and a half episodes through both adapters: every observation,
  instruction id, reward and done, the raw action rows with their
  repeat, and the reset seeds of the per-env RandomState."""
  ref, port = _pair(tmp_path)
  for a, b in zip(ref.initial(), port.initial()):
    np.testing.assert_array_equal(a, b)
  rng = np.random.RandomState(0)
  dones = []
  for _ in range(2 * ScriptedLab.episode_len + 1):
    action = int(rng.randint(len(dmlab.DEFAULT_ACTION_SET)))
    want, got = ref.step(action), port.step(action)
    assert got[0] == want[0] and got[0].dtype == want[0].dtype
    assert got[1] == want[1] and got[1].dtype == want[1].dtype
    for a, b in zip(want[2], got[2]):
      np.testing.assert_array_equal(a, b)
      assert a.dtype == b.dtype
    dones.append(bool(got[1]))
  assert dones == [False, False, True] * 2 + [False]
  assert port._env.reset_seeds == ref._env.reset_seeds
  assert len(port._env.reset_seeds) == 3
  for (a, n), (b, m) in zip(ref._env.step_calls, port._env.step_calls):
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype == np.intc and n == m == 4
  port.close()
  assert port._env.closed


def test_the_level_cache_round_trips(tmp_path):
  """The first env misses the cache and writes the compiled level; the
  second hits it. A cache shared by object is honoured."""
  first = dmlab.DmLabEnv('lvl', {'height': 8, 'width': 12}, seed=1,
                         lab_cls=ScriptedLab,
                         level_cache_dir=str(tmp_path / 'c'))
  second = dmlab.DmLabEnv('lvl', {'height': 8, 'width': 12}, seed=2,
                          lab_cls=ScriptedLab,
                          level_cache_dir=str(tmp_path / 'c'))
  assert first._env.cache_hit is False and second._env.cache_hit is True
  assert (tmp_path / 'c' / 'lvl').read_bytes() == b'compiled:lvl'
  shared = dmlab.LocalLevelCache(str(tmp_path / 'shared'))
  a = dmlab.DmLabEnv('lvl', {'height': 8, 'width': 12}, seed=1,
                     level_cache=shared, lab_cls=ScriptedLab)
  b = dmlab.DmLabEnv('lvl', {'height': 8, 'width': 12}, seed=2,
                     level_cache=shared, lab_cls=ScriptedLab)
  assert (a._env.cache_hit, b._env.cache_hit) == (False, True)
  assert a._env.reset_seeds != b._env.reset_seeds


def test_the_default_cache_lives_under_the_temporary_directory(
    tmp_path, monkeypatch):
  monkeypatch.setenv('TMPDIR', str(tmp_path))
  tempfile.tempdir = None
  try:
    cache = dmlab.LocalLevelCache()
    assert os.path.isdir(tmp_path / 'level_cache')
    del cache
  finally:
    tempfile.tempdir = None
