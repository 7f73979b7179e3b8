"""The port's fleet runtime end to end on the CPU
(scalable_agent_tpu_torch/driver.py `train`, `make_fleet`): it trains,
stops where the JAX driver stops, writes the JAX driver's summaries,
tears down after a failed set-up, hosts envs in processes, feeds the
learner batches that JAX's train step takes to the same result, and
learns the bandit to the bar of tests/test_e2e_smoke.py.

Tolerances: the train step on a fleet batch is held at
tests/test_torch_learner.py's bar (loss rtol 2e-4, params rtol 5e-4 /
atol 5e-6); episode extraction is exact."""

import json
import multiprocessing
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import learner as jax_learner
from scalable_agent_tpu import observability as jax_observability
from scalable_agent_tpu import structs as jax_structs
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import factory
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.runtime.inference import InferenceServer

torch.set_num_threads(1)

_RUNTIME_THREADS = ('actor-', 'inference-', 'batch-prefetcher')


def _config(tmp_path, **kw):
  """tests/test_driver.py's small config."""
  base = dict(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
              batch_size=2, unroll_length=5, num_action_repeats=1,
              episode_length=4, height=24, width=32, torso='shallow',
              use_py_process=False, use_instruction=False,
              total_environment_frames=10**6, inference_timeout_ms=5,
              summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


def _events(logdir):
  with open(os.path.join(str(logdir), 'summaries.jsonl')) as f:
    return [json.loads(line) for line in f]


def _runtime_threads(before):
  """The runtime's threads alive now that were not in `before` (other
  tests of the process may leave theirs)."""
  return [t.name for t in threading.enumerate()
          if t.is_alive() and t not in before
          and t.name.startswith(_RUNTIME_THREADS)]


def _new_children(before):
  return [p for p in multiprocessing.active_children() if p not in before]


def test_train_smoke_writes_the_summaries(tmp_path):
  threads = set(threading.enumerate())
  cfg = _config(tmp_path)
  run = driver.train(cfg, max_steps=3, device='cpu', stall_timeout_secs=60)
  assert run.state.update_steps == 3
  assert run.frames == 3 * cfg.frames_per_step
  assert len(run.step_log) == 3
  events = _events(tmp_path)
  tags = {e['tag'] for e in events}
  assert {'total_loss', 'env_frames_per_sec', 'inference_mean_batch',
          'buffer_high_water', 'actors_alive', 'actors_healthy',
          'prefetch_wait_secs'} <= tags
  assert f'{cfg.level_name}/episode_return' in tags
  assert all(np.isfinite(e['value']) for e in events
             if e['tag'] == 'total_loss')
  hists = [e for e in events if e.get('kind') == 'histogram'
           and e['tag'] == 'actions']
  assert hists and all(len(h['counts']) == 3 for h in hists)
  assert sum(sum(h['counts']) for h in hists) == (
      3 * cfg.unroll_length * cfg.batch_size)
  assert run.stats['server']['params_version'] == 4  # versions 0..3
  assert run.stats['fleet_stop'] == {'unjoined_actors': []}
  assert json.load(open(tmp_path / 'config.json'))['num_actors'] == 2
  assert not _runtime_threads(threads)


def test_train_stops_at_total_environment_frames(tmp_path):
  cfg = _config(tmp_path, total_environment_frames=2 * 2 * 5)
  run = driver.train(cfg, device='cpu', stall_timeout_secs=60)
  assert run.state.update_steps == 2


def test_a_short_run_writes_its_summaries_at_the_end(tmp_path):
  cfg = _config(tmp_path, summary_secs=3600)
  driver.train(cfg, max_steps=2, device='cpu', stall_timeout_secs=60)
  steps = [e['step'] for e in _events(tmp_path) if e['tag'] == 'total_loss']
  assert steps == [2]


def test_setup_failure_releases_everything_and_a_retry_works(tmp_path,
                                                              monkeypatch):
  threads = set(threading.enumerate())
  children = set(multiprocessing.active_children())
  cfg = _config(tmp_path, use_py_process=True)
  real_build = factory.build_environment
  built = []

  def fail_second(spec, use_py_process=False):
    if len(built) == 1:
      raise RuntimeError('injected env-construction failure')
    built.append(real_build(spec, use_py_process))
    return built[-1]

  monkeypatch.setattr(factory, 'build_environment', fail_second)
  with pytest.raises(RuntimeError, match='injected'):
    driver.train(cfg, max_steps=1, device='cpu', stall_timeout_secs=30)
  assert len(built) == 1
  _, process = built[0]
  assert process is not None and not process.running
  assert not _runtime_threads(threads)
  assert not _new_children(children)
  monkeypatch.setattr(factory, 'build_environment', real_build)
  run = driver.train(cfg, max_steps=1, device='cpu', stall_timeout_secs=60)
  assert run.state.update_steps == 1
  assert not _new_children(children)


def test_train_with_process_hosted_envs(tmp_path):
  children = set(multiprocessing.active_children())
  cfg = _config(tmp_path, use_py_process=True)
  run = driver.train(cfg, max_steps=2, device='cpu', stall_timeout_secs=60)
  assert run.state.update_steps == 2
  assert run.stats['fleet']['unrolls'] >= 4
  assert not _new_children(children)


def test_runtime_anakin_dispatches_to_the_anakin_trainer(tmp_path):
  cfg = _config(tmp_path, runtime='anakin', batch_size=4)
  run = driver.train(cfg, max_steps=2, device='cpu')
  assert run.state.update_steps == 2
  assert run.carry.train_state is run.state
  assert run.server is None and run.fleet is None
  assert {e['tag'] for e in _events(tmp_path)} >= {'mean_reward'}


def test_the_fleet_over_a_process_group_raises(tmp_path, monkeypatch):
  """The fleet runs over a process group now (tests/test_torch_dp_fleet.py
  drives it); what still raises, before any work, is a global batch the
  group's ranks do not divide (JAX's check)."""
  def no_work(*args, **kwargs):
    raise AssertionError('work started before the batch check')

  monkeypatch.setattr(driver, 'build_agent', no_work)
  monkeypatch.setattr(distributed, 'world_size', lambda: 2)
  cfg = _config(tmp_path, batch_size=3)
  with pytest.raises(ValueError, match='must divide by process count 2'):
    driver.train(cfg, max_steps=1, device='cpu')


def test_extract_episodes_matches_jax():
  rng = np.random.RandomState(0)
  t1, b = 7, 3
  done = rng.rand(t1, b) > 0.6
  ret = rng.randn(t1, b).astype(np.float32)
  steps = rng.randint(0, 50, (t1, b)).astype(np.int32)
  levels = np.array([0, 1, 0], np.int32)
  view = driver._stats_only_view(driver.ActorOutput(
      levels, None, driver.StepOutput(
          None, jax_structs.StepOutputInfo(ret, steps), done, None), None))
  assert observability.extract_episodes(view) == (
      jax_observability.extract_episodes(view))
  stats = observability.EpisodeStats(['a', 'b'])
  assert [n for n, _, _ in stats.record_batch(view, 1)] == [
      ['a', 'b'][levels[j]] for _, j in zip(*np.nonzero(done[1:]))]


def _fleet_batch(cfg, agent):
  """One [T+1, B] host batch from the port's fleet: actors and the
  inference server, in-process envs."""
  buf = ring_buffer.TrajectoryBuffer(cfg.batch_size)
  server = InferenceServer(agent, dict(agent.named_parameters()), cfg,
                           seed=cfg.seed + 1000, fleet_size=cfg.num_actors)
  actors = driver.make_fleet(cfg, server.policy, buf, ['bandit'],
                             initial_state_fn=server.initial_core_state)
  actors.start()
  try:
    return batch_unrolls(buf.get_unrolls(cfg.batch_size, timeout=60))
  finally:
    actors.stop(timeout=5)
    server.close()


def test_a_fleet_batch_trains_as_in_jax(tmp_path):
  a = 3
  kw = dict(torso='shallow', batch_size=2, unroll_length=5,
            num_action_repeats=1, total_environment_frames=60,
            use_instruction=False, use_pallas_vtrace=True)
  cfg = _config(tmp_path, **kw)
  jcfg = JaxConfig(**kw)
  jagent = jax_agent.ImpalaAgent(num_actions=a, torso='shallow',
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(2),
                           {'frame': (24, 32, 3), 'instr_len': 16})
  agent = ImpalaAgent(a, (24, 32, 3), torso='shallow')
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  batch = _fleet_batch(cfg, agent)
  assert batch.env_outputs.observation[0].shape == (6, 2, 24, 32, 3)
  assert batch.agent_state[0].shape == (2, 256)

  placed = learner.place_batch(batch, 'cpu')
  assert placed.agent_outputs.action.dtype == torch.int64
  assert placed.env_outputs.done.dtype == torch.bool
  jbatch = jax.tree_util.tree_map(jnp.asarray, jax_structs.ActorOutput(
      batch.level_name, batch.agent_state,
      jax_structs.StepOutput(batch.env_outputs.reward,
                             jax_structs.StepOutputInfo(
                                 *batch.env_outputs.info),
                             batch.env_outputs.done,
                             batch.env_outputs.observation),
      jax_structs.AgentOutput(*batch.agent_outputs)))
  jstate, jm = jax_learner.make_train_step(jagent, jcfg)(
      jax_learner.make_train_state(params, jcfg), jbatch)
  state, m = learner.make_train_step_fn(agent, cfg)(
      learner.make_train_state(agent, cfg), placed)
  np.testing.assert_allclose(float(m['total_loss']), float(jm['total_loss']),
                             rtol=2e-4)
  ref = convert.params_from_jax(jax.device_get(jstate.params))
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=k)


def test_bandit_learning_improves_return_through_the_fleet(tmp_path):
  """tests/test_e2e_smoke.py's bar, through driver.train: the late mean
  reward per step > 0.6 and > the early one + 0.2 (random play ~1/3)."""
  cfg = _config(tmp_path, num_actors=4, batch_size=4, unroll_length=20,
                episode_length=5, learning_rate=0.002, entropy_cost=0.003,
                discounting=0.0, total_environment_frames=200000,
                seed=7)
  steps = 60
  run = driver.train(cfg, max_steps=steps, device='cpu',
                     stall_timeout_secs=60)
  assert run.state.update_steps == steps
  per_step = {}
  for e in _events(tmp_path):
    if e['tag'].endswith('/episode_return'):
      per_step.setdefault(e['step'], []).append(e['value'] /
                                                cfg.episode_length)
  early = np.mean([r for s in range(1, 11) for r in per_step.get(s, [])])
  late = np.mean([r for s in range(steps - 9, steps + 1)
                  for r in per_step.get(s, [])])
  assert late > early + 0.2, (early, late)
  assert late > 0.6, late
