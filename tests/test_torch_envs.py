"""The port's host environments (scalable_agent_tpu_torch/envs/,
runtime/py_process.py) against the JAX package's: the fake envs step
bit-equal for the same seeds and actions, the factory builds the same
specs, a process-hosted env gives the in-process stream, and the backends
the port does not have raise. Tolerance: exact (numpy on both sides)."""

import os

import numpy as np
import pytest

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.envs import factory as jax_factory
from scalable_agent_tpu.envs import fake as jax_fake
from scalable_agent_tpu.models import instruction as jax_instruction
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import base, factory, fake
from scalable_agent_tpu_torch.runtime import py_process

ENVS = ['FakeEnv', 'CueMemoryEnv', 'ContextualBanditEnv']


def _assert_same(got, ref, what):
  got, ref = np.asarray(got), np.asarray(ref)
  assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
  np.testing.assert_array_equal(got, ref, err_msg=what)


def _assert_same_step(got, ref, what):
  (reward, done, (frame, instr)), (ref_reward, ref_done,
                                   (ref_frame, ref_instr)) = got, ref
  for name, a, b in (('reward', reward, ref_reward), ('done', done, ref_done),
                     ('frame', frame, ref_frame), ('instr', instr, ref_instr)):
    _assert_same(a, b, f'{what} {name}')


@pytest.mark.parametrize('seed', [0, 1, 7])
@pytest.mark.parametrize('name', ENVS)
def test_fake_envs_are_bit_equal_to_jax(name, seed):
  kwargs = dict(height=12, width=10, num_actions=3, episode_length=4,
                seed=seed, level_name='some level')
  env, ref = getattr(fake, name)(**kwargs), getattr(jax_fake, name)(**kwargs)
  frame, instr = env.initial()
  ref_frame, ref_instr = ref.initial()
  _assert_same(frame, ref_frame, 'initial frame')
  _assert_same(instr, ref_instr, 'initial instr')
  actions = np.random.RandomState(100 + seed).randint(0, 3, size=200)
  for t, action in enumerate(actions):
    _assert_same_step(env.step(action), ref.step(action), f'step {t}')


@pytest.mark.parametrize('text', ['', 'bandit', 'pick the red one',
                                  b'bytes level', ' '.join(['w'] * 20)])
def test_hash_instruction_matches_jax(text):
  _assert_same(fake.hash_instruction(text),
               jax_instruction.hash_instruction(text), repr(text))
  assert fake.MAX_INSTRUCTION_LEN == jax_instruction.MAX_INSTRUCTION_LEN


def test_specs_match_jax():
  for name in ENVS:
    kwargs = {'height': 9, 'width': 7}
    for method in ('initial', 'step', 'close'):
      got = getattr(fake, name)._tensor_specs(method, {}, kwargs)
      ref = getattr(jax_fake, name)._tensor_specs(method, {}, kwargs)
      assert repr(got) == repr(ref), (name, method)


@pytest.mark.parametrize('backend', ['fake', 'bandit', 'cue_memory'])
@pytest.mark.parametrize('num_actions', [None, 3])
def test_make_env_spec_matches_jax(backend, num_actions):
  kw = dict(env_backend=backend, height=16, width=20, episode_length=6,
            num_action_repeats=2, num_actions=num_actions,
            use_instruction=False)
  spec = factory.make_env_spec(Config(**kw), 'lvl', seed=5)
  ref = jax_factory.make_env_spec(JaxConfig(**kw), 'lvl', seed=5)
  assert spec.env_class.__name__ == ref.env_class.__name__
  assert spec.constructor_kwargs == ref.constructor_kwargs
  assert spec.num_actions == ref.num_actions
  assert spec.frame_shape == ref.frame_shape
  assert spec.obs_spec == ref.obs_spec
  assert factory.level_names(Config(**kw)) == jax_factory.level_names(
      JaxConfig(**kw))


@pytest.mark.parametrize('backend, item', [('dmlab', 'A7'), ('atari', 'A7')])
def test_unported_backends_raise(backend, item):
  """The real simulators, ported in A7.1 (envs/dmlab.py, envs/atari.py):
  the factory builds their specs as JAX's does, and with no emulator
  installed the env's construction raises ImportError (the import
  guard)."""
  del item
  kw = dict(env_backend=backend)
  spec = factory.make_env_spec(Config(**kw), 'lvl', seed=1)
  ref = jax_factory.make_env_spec(JaxConfig(**kw), 'lvl', seed=1)
  assert spec.constructor_kwargs == ref.constructor_kwargs
  assert spec.num_actions == ref.num_actions
  with pytest.raises(ImportError):
    spec.build()


@pytest.mark.parametrize('backend', ['gridworld', 'procgen'])
def test_a6_backends_build_and_step(backend):
  """The gridworld and procgen host envs (envs/jittable.py), refused
  before their slice: the factory builds them as JAX's does, in a
  process too, and they step."""
  kw = dict(env_backend=backend, height=16, width=20, episode_length=6,
            use_instruction=False)
  spec = factory.make_env_spec(Config(**kw), 'lvl', seed=1)
  ref = jax_factory.make_env_spec(JaxConfig(**kw), 'lvl', seed=1)
  assert spec.constructor_kwargs == ref.constructor_kwargs
  env, process = factory.build_environment(spec, use_py_process=True)
  try:
    frame, _ = env.initial()
    assert frame.shape == (16, 20, 3) and frame.dtype == np.uint8
    for action in range(spec.num_actions):
      reward, done, (frame, _) = env.step(action)
      assert reward in (0.0, 1.0) and frame.shape == (16, 20, 3)
  finally:
    process.close()


@pytest.mark.parametrize('suite', ['dmlab30', 'atari57'])
def test_suites_raise(suite):
  """A suite name expands into its levels as in JAX (the fake backends
  then run them); the suites' real simulators build their specs as JAX's
  does, and raise ImportError at construction with no emulator."""
  kw = dict(level_name=suite, use_instruction=False)
  assert factory.level_names(Config(**kw)) == jax_factory.level_names(
      JaxConfig(**kw))
  assert factory.test_level_names(Config(**kw)) == (
      jax_factory.test_level_names(JaxConfig(**kw)))
  backend = {'dmlab30': 'dmlab', 'atari57': 'atari'}[suite]
  level = factory.test_level_names(Config(**kw))[0]
  spec = factory.make_env_spec(Config(env_backend=backend, **kw), level,
                               seed=1, is_test=True)
  ref = jax_factory.make_env_spec(JaxConfig(env_backend=backend, **kw),
                                  level, seed=1, is_test=True)
  assert spec.constructor_kwargs == ref.constructor_kwargs
  with pytest.raises(ImportError):
    spec.build()


def test_unknown_backend_is_a_value_error():
  with pytest.raises(ValueError, match='unknown env backend'):
    factory.make_env_spec(Config(env_backend='nope'), 'lvl', seed=1)


def test_proxy_env_in_a_forkserver_process_gives_the_same_stream():
  cfg = Config(env_backend='bandit', height=8, width=6, episode_length=3)
  spec = factory.make_env_spec(cfg, 'bandit', seed=11)
  local, _ = factory.build_environment(spec)
  env, process = factory.build_environment(spec, use_py_process=True)
  try:
    assert process.running
    assert process._ctx.get_start_method() == 'forkserver'
    for got, ref in zip(env.initial(), local.initial()):
      _assert_same(got, ref, 'initial')
    for t, action in enumerate(np.random.RandomState(3).randint(0, 3, 50)):
      _assert_same_step(env.step(int(action)), local.step(int(action)),
                        f'step {t}')
  finally:
    env.close()
  assert not process.running
  with pytest.raises(py_process.ProcessClosed):
    env.step(0)


def test_stop_forkserver_leaves_no_process():
  from multiprocessing import forkserver, resource_tracker
  py_process.warm_forkserver()
  pids = [forkserver._forkserver._forkserver_pid,
          resource_tracker._resource_tracker._pid]
  assert all(pids)
  py_process.stop_forkserver()
  for pid in pids:
    with pytest.raises(ChildProcessError):  # exited and reaped
      os.waitpid(pid, os.WNOHANG)
  py_process.stop_forkserver()  # a no-op when none runs
  py_process.warm_forkserver()  # and it starts again
  assert forkserver._forkserver._forkserver_pid not in (None, *pids)


def test_hosted_errors_come_back_with_the_remote_traceback():
  # CueMemoryEnv refuses 4 actions in its constructor: the error is
  # reported on the first call.
  process = py_process.PyProcess(
      fake.CueMemoryEnv, constructor_kwargs={'num_actions': 4}).start()
  try:
    with pytest.raises(py_process.RemoteError, match='3-action task'):
      process.proxy.initial()
  finally:
    process.close()
  process = py_process.PyProcess(fake.FakeEnv).start()
  try:
    with pytest.raises(py_process.RemoteError, match='no_such_method'):
      process.proxy.no_such_method()
    assert process.proxy.initial()[0].shape == (24, 32, 3)  # still serving
  finally:
    process.close()


def test_reply_specs_are_checked():
  spec = base.ArraySpec((2,), np.dtype(np.int32))
  py_process._validate_specs((np.zeros(2, np.int32),), (spec,), 'm')
  with pytest.raises(py_process.SpecMismatchError, match='dtype'):
    py_process._validate_specs(np.zeros(2, np.int64), spec, 'm')
  with pytest.raises(py_process.SpecMismatchError, match='structure'):
    py_process._validate_specs((1, 2), (spec,), 'm')
