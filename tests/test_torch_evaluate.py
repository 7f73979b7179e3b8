"""Evaluation in the port (driver.evaluate, `--mode=test`): end to end on
the CPU over the fake DMLab-30 levels (a trained checkpoint, every level's
returns, eval_summaries.jsonl's rows and the suite's scores); the scores
against the JAX package's EpisodeStats and suites.eval_scores on the same
returns; the level partition, level_offset and seed_base against the JAX
evaluate's own for 1, 2 and 3 processes over 30 levels; a 2-rank gloo
evaluation whose ranks return the same dict (JAX tests/test_multihost.py's
sharded eval); restore_latest_params (params and step bit-equal, no
optimizer moment read, the ladder past a bit-rotted newest step, None on
an empty directory) and evaluate's FileNotFoundError. Per-episode returns
are not held to JAX's: the packages sample actions from different
generators. Spawned ranks import no JAX: this module imports it inside
its tests."""

import json
import math
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import checkpoint, driver, experiment, learner
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import factory, suites
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.structs import (ActorOutput, StepOutput,
                                              StepOutputInfo)

torch.set_num_threads(1)

_KW = dict(env_backend='fake', level_name='dmlab30', torso='shallow',
           height=24, width=32, batch_size=4, num_actors=4, unroll_length=5,
           num_action_repeats=1, use_instruction=True, episode_length=4,
           use_py_process=False, summary_secs=0, test_num_episodes=2,
           total_environment_frames=10**6)
WORLD = 2
SPAWN_TIMEOUT_SECS = 120


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
  """A logdir holding a 2-step checkpoint of the small dmlab30 fleet."""
  logdir = str(tmp_path_factory.mktemp('trained'))
  run = driver.train(Config(**_KW, logdir=logdir), max_steps=2,
                     device='cpu')
  return logdir, {k: v.detach().clone() for k, v in run.state.params.items()}


def _rows(logdir):
  with open(os.path.join(logdir, 'eval_summaries.jsonl')) as f:
    return [json.loads(line) for line in f]


def test_evaluate_plays_every_level_and_writes_the_summaries(trained):
  logdir, _ = trained
  config = Config(**_KW, logdir=logdir)
  returns = driver.evaluate(config, device='cpu')
  train_levels = factory.level_names(config)
  test_levels = factory.test_level_names(config)
  assert sorted(returns) == sorted(train_levels)
  assert all(len(r) == 2 and all(map(math.isfinite, r))
             for r in returns.values())
  rows = _rows(logdir)
  means = {r['tag'].split('/')[0]: r['value'] for r in rows
           if r['tag'].endswith('/test_episode_return')}
  assert sorted(means) == sorted(test_levels)
  for train, test in zip(train_levels, test_levels):
    assert means[test] == float(np.mean(returns[train]))
  assert {r['step'] for r in rows} == {2}
  scores = {r['tag']: r['value'] for r in rows
            if r['tag'].startswith('dmlab30/')}
  assert scores == suites.SUITES['dmlab30'].eval_scores(returns)
  assert sorted(scores) == ['dmlab30/test_cap_100', 'dmlab30/test_no_cap']


def test_the_scores_are_jax_s(trained):
  """The JAX package's suite scores over the port's returns, and both
  EpisodeStats' multi-task training scores on the same batches."""
  from scalable_agent_tpu import observability as jax_observability
  from scalable_agent_tpu.envs import suites as jax_suites
  rng = np.random.RandomState(0)
  for name in ('dmlab30', 'atari57'):
    suite = suites.SUITES[name]
    returns = {level: list(rng.randn(3) * 10) for level in
               suite.train_levels}
    assert (suite.eval_scores(returns) ==
            jax_suites.SUITES[name].eval_scores(returns))
    stats = [observability.EpisodeStats(list(suite.train_levels),
                                        benchmark=name),
             jax_observability.EpisodeStats(list(suite.train_levels),
                                            benchmark=name)]
    n = len(suite.train_levels)
    for step in range(3):
      done = np.zeros((3, n), bool)
      done[1 + step % 2] = True
      batch = ActorOutput(
          level_name=np.arange(n, dtype=np.int32), agent_state=None,
          env_outputs=StepOutput(
              reward=None,
              info=StepOutputInfo(
                  rng.randn(3, n).astype(np.float32),
                  np.full((3, n), 7, np.int32)),
              done=done, observation=None),
          agent_outputs=None)
      got = [s.record_batch(batch, step) for s in stats]
      assert got[0] == got[1]
      assert stats[0].last_scores == stats[1].last_scores
    assert stats[0].last_scores is not None
  assert observability.EpisodeStats(['a'], multi_task=False).last_scores \
      is None
  with pytest.raises(ValueError, match='unknown benchmark'):
    observability.EpisodeStats(['a'], benchmark='nope')


@pytest.mark.parametrize('processes', [1, 2, 3])
def test_the_level_partition_is_jax_s(processes, monkeypatch):
  """JAX's evaluate, run with a stubbed checkpoint, server and fleet,
  for each process index: the levels it plays, its level_offset and
  seed_base, against the port's eval_partition."""
  import jax
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig

  class Stop(Exception):
    pass

  class Restorer:

    def __init__(self, *args, **kwargs):
      pass

    def restore_latest_params(self, params, make_state):
      return params, 0

    def close(self):
      pass

  class Server:

    def __init__(self, *args, **kwargs):
      pass

    def warmup(self, *args, **kwargs):
      pass

    def close(self):
      pass

    policy = initial_core_state = None

  seen = {}

  def make_fleet(config, agent, policy, buffer, levels, seed_base=0,
                 level_offset=0, is_test=False, num_actors=None,
                 initial_state_fn=None):
    seen.update(levels=list(levels), seed_base=seed_base,
                level_offset=level_offset, num_actors=num_actors)
    raise Stop()

  monkeypatch.setattr(jax_driver.checkpoint_lib, 'Checkpointer', Restorer)
  monkeypatch.setattr(jax_driver, 'InferenceServer', Server)
  monkeypatch.setattr(jax_driver, 'make_fleet', make_fleet)
  monkeypatch.setattr(jax_driver, 'init_params', lambda *a, **k: {})
  monkeypatch.setattr(jax_driver.multihost_utils, 'process_allgather',
                      lambda x, tiled=False: x)
  monkeypatch.setattr(jax, 'process_count', lambda: processes)
  kw = dict(level_name='dmlab30', env_backend='fake', seed=5,
            use_instruction=False)
  port_seen = {}

  def port_make_fleet(config, policy, buffer, levels, initial_state_fn,
                      seed_base=0, level_offset=0, is_test=False,
                      num_actors=None):
    port_seen.update(levels=list(levels), seed_base=seed_base,
                     level_offset=level_offset, num_actors=num_actors,
                     is_test=is_test)
    raise Stop()

  class PortRestorer:

    def restore_latest_params(self, params):
      return params, 0

  monkeypatch.setattr(driver, 'make_checkpointer',
                      lambda config: PortRestorer())
  monkeypatch.setattr(driver, 'InferenceServer', Server)
  monkeypatch.setattr(driver, 'make_fleet', port_make_fleet)
  monkeypatch.setattr(driver.distributed, 'world_size', lambda: processes)
  covered = []
  for index in range(processes):
    monkeypatch.setattr(jax, 'process_index', lambda i=index: i)
    monkeypatch.setattr(driver.distributed, 'rank', lambda i=index: i)
    seen.clear()
    with pytest.raises(Stop):
      jax_driver.evaluate(JaxConfig(**kw))
    with pytest.raises(Stop):
      driver.evaluate(Config(**kw, torso='shallow', height=24, width=32),
                      device='cpu')
    assert port_seen.pop('is_test')
    assert port_seen == seen
    start, count, counts = driver.eval_partition(30, processes, index)
    assert seen['num_actors'] == count and seen['level_offset'] == start
    assert seen['seed_base'] == Config(**kw).seed - 1 + start
    covered += list(range(start, start + count))
    assert sum(counts) == 30
  assert covered == list(range(30))


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _eval_rank(rank, world, port, logdir, outdir):
  torch.set_num_threads(1)
  config = Config(**_KW, logdir=logdir, coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  distributed.maybe_initialize(config, backend='gloo', device='cpu',
                               timeout_secs=60)
  returns = driver.evaluate(config, device='cpu')
  distributed.shutdown()
  loaded = sorted(m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'jaxlib',
                                         'scalable_agent_tpu'))
  with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
    json.dump({'returns': returns, 'jax_modules': loaded}, f)


def test_two_ranks_return_the_same_dict_and_rank_0_writes(trained, tmp_path):
  logdir, _ = trained
  summaries = os.path.join(logdir, 'eval_summaries.jsonl')
  if os.path.exists(summaries):
    os.remove(summaries)
  context = mp.spawn(_eval_rank, args=(WORLD, _free_port(), logdir,
                                       str(tmp_path)),
                     nprocs=WORLD, join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail('eval ranks still running')
  results = [json.load(open(tmp_path / f'rank{r}.json'))
             for r in range(WORLD)]
  assert results[0]['returns'] == results[1]['returns']
  assert not results[0]['jax_modules'] and not results[1]['jax_modules']
  returns = results[0]['returns']
  assert len(returns) == 30 and all(len(r) == 2 for r in returns.values())
  rows = _rows(logdir)
  assert len([r for r in rows if r['tag'].endswith('test_episode_return')
              ]) == 30
  assert not os.path.exists(os.path.join(logdir, 'eval_summaries_p1.jsonl'))


def test_restore_latest_params_reads_the_params_and_step_only(
    trained, tmp_path, monkeypatch):
  logdir, saved = trained
  ckpt = checkpoint.Checkpointer(os.path.join(logdir, 'checkpoints'),
                                 torso='shallow')
  agent = driver.build_agent(Config(**_KW), 5, 30)
  target = {k: torch.zeros_like(v) for k, v in agent.named_parameters()}
  loads, touched = [], []
  real_load = torch.load

  class Spy(dict):

    def __getitem__(self, key):
      touched.append(key)
      return super().__getitem__(key)

    def get(self, key, default=None):
      touched.append(key)
      return super().get(key, default)

  def load(*args, **kwargs):
    loads.append(kwargs)
    return Spy(real_load(*args, **kwargs))

  monkeypatch.setattr(torch, 'load', load)
  params, steps = ckpt.restore_latest_params(target)
  monkeypatch.setattr(torch, 'load', real_load)
  assert steps == 2 and params is target
  for k, v in saved.items():
    assert torch.equal(params[k], v), k
  assert loads and all(kw.get('mmap') for kw in loads)
  assert 'opt_state' not in touched and 'target_params' not in touched
  assert set(touched) <= {'params', 'update_steps', 'torso'}
  # A bit-rotted newest step: the ladder falls back past it.
  d = tmp_path / 'ckpt'
  rotten = checkpoint.Checkpointer(str(d), torso='shallow')
  state = learner.make_train_state(agent, Config(**_KW), 30)
  kept = {k: v.detach().clone() for k, v in state.params.items()}
  assert rotten.save(state._replace(update_steps=1), force=True)
  with torch.no_grad():
    for p in state.params.values():
      p.add_(1.0)
  assert rotten.save(state._replace(update_steps=2), force=True)
  payload = d / '2' / 'default' / 'state.pt'
  data = bytearray(payload.read_bytes())
  data[len(data) // 2] ^= 0x10
  payload.write_bytes(bytes(data))
  params, steps = rotten.restore_latest_params(
      {k: torch.zeros_like(v) for k, v in kept.items()})
  assert steps == 1
  for k, v in kept.items():
    assert torch.equal(params[k], v), k
  assert rotten.digest_fallbacks == 1
  # Nothing saved: None, and evaluate raises.
  empty = tmp_path / 'empty'
  assert checkpoint.Checkpointer(str(empty)).restore_latest_params(
      target) is None
  with pytest.raises(FileNotFoundError, match='no checkpoint'):
    driver.evaluate(Config(**_KW, logdir=str(empty)), device='cpu')


def test_the_cli_evaluates(trained):
  """`--mode=test` runs driver.evaluate (device='cpu' here)."""
  logdir, _ = trained
  flags = [f'--{k}={v}' for k, v in _KW.items()]
  returns = experiment.main(['--mode=test', '--device=cpu',
                             f'--logdir={logdir}'] + flags)
  assert len(returns) == 30 and all(len(r) == 2 for r in returns.values())


def test_evaluate_refuses_without_cuda_unless_the_cpu_is_asked_for(trained):
  assert not torch.cuda.is_available()
  logdir, _ = trained
  with pytest.raises(RuntimeError, match='cuda'):
    driver.evaluate(Config(**_KW, logdir=logdir))
