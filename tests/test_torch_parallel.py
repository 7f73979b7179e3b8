"""The port's data-parallel training (scalable_agent_tpu_torch/parallel/
distributed.py, mesh.py, sharding.py, train_parallel.py; the sharded
V-trace kernel's wrapper in ops/vtrace_cuda.py; anakin's scale-out)
against the JAX package's, on the CPU.

Ranks are processes started with torch.multiprocessing.spawn and joined
over gloo on a free port of this host: one group joined from the
config's coordinator fields, one from torch.distributed.run's
environment. A spawned rank re-imports this module, so it imports no JAX
at the top: the JAX references run in the test process, inside the tests.

Tolerances:
- the sharded kernel (K1b) against JAX's `sharded_from_importance_weights`
  (Pallas in interpret mode under shard_map), rtol/atol 1e-5: JAX's
  pointer doubling reassociates the sums;
- the sharded train step against JAX's, and the 2-rank Anakin against
  the 1-rank one: loss rtol 2e-4, params rtol 5e-4 / atol 5e-6, the gates
  of the JAX package's own sharded-step parity tests (gradients summed in
  another order, through RMSProp's 1/sqrt). The two ranks' params are
  bit-equal: both apply the one all-reduced gradient.
"""

import json
import logging
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config, validate_distributed
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

SPAWN_TIMEOUT_SECS = 150
GROUP_TIMEOUT_SECS = 60


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _start_rank():
  """A spawned rank's set-up: at these small shapes one thread per rank is
  fastest, and keeps the ranks from oversubscribing the cores."""
  torch.set_num_threads(1)


def _spawn(worker, world, *args):
  """Run `worker(rank, world, port, *args)` in `world` spawned ranks; a
  rank that raises fails the test (and the others are stopped)."""
  context = mp.spawn(worker, args=(world, _free_port()) + args,
                     nprocs=world, join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail(f'{worker.__name__} ranks still running after '
                  f'{SPAWN_TIMEOUT_SECS} s')
  assert not any(p.is_alive() for p in context.processes)


def _loaded_jax():
  return sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'scalable_agent_tpu'))


def _mesh(rank, size):
  return mesh_lib.Mesh(rank=rank, size=size, device=torch.device('cpu'))


# --- K1b: the sharded V-trace kernel's wrapper --------------------------

def _vtrace_inputs(shape, seed):
  rng = np.random.RandomState(seed)
  return dict(
      log_rhos=(rng.randn(*shape) * 0.8).astype(np.float32),
      discounts=(0.99 * (rng.rand(*shape) > 0.1)).astype(np.float32),
      rewards=rng.randn(*shape).astype(np.float32),
      values=rng.randn(*shape).astype(np.float32),
      bootstrap_value=rng.randn(*shape[1:]).astype(np.float32))


def _k1b_per_rank(arrays, shards, clips):
  """K1b once per rank of an explicit-rank mesh on its block of columns,
  the blocks concatenated back along the batch dim."""
  ndim = arrays['log_rhos'].ndim
  specs = {k: (sharding.spec_batch_lead(ndim - 1) if k == 'bootstrap_value'
               else sharding.spec_time_major(ndim)) for k in arrays}
  tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
  vs, pg = [], []
  for rank in range(shards):
    local = {k: sharding.local_shard(v, specs[k], rank, shards).contiguous()
             for k, v in tensors.items()}
    out = vtrace_cuda.sharded_from_importance_weights(
        _mesh(rank, shards), **local, clip_rho_threshold=clips[0],
        clip_pg_rho_threshold=clips[1],
        batch_size=arrays['log_rhos'].shape[1])
    vs.append(out[0])
    pg.append(out[1])
  return torch.cat(vs, dim=1).numpy(), torch.cat(pg, dim=1).numpy()


@pytest.mark.parametrize('clips', [(1.0, 1.0), (None, None), (3.7, 2.2)],
                         ids=str)
@pytest.mark.parametrize('shape', [(7, 8), (5, 4, 3)], ids=str)
@pytest.mark.parametrize('shards', [2, 4])
def test_sharded_vtrace_matches_jax_shard_map(shards, shape, clips):
  import jax
  import jax.numpy as jnp
  from scalable_agent_tpu.ops import vtrace_pallas
  from scalable_agent_tpu.parallel import mesh as jax_mesh

  arrays = _vtrace_inputs(shape, seed=shards * 10 + len(shape))
  vtrace_cuda.sharded_from_importance_weights.launches = 0
  vs, pg = _k1b_per_rank(arrays, shards, clips)
  assert vtrace_cuda.sharded_from_importance_weights.launches == 0  # twin
  assert vs.shape == shape and pg.shape == shape

  # Under jit: eager shard_map takes seconds a call here.
  mesh = jax_mesh.make_mesh(jax.devices()[:shards])
  ref_vs, ref_pg = jax.jit(
      lambda *xs: vtrace_pallas.sharded_from_importance_weights(
          mesh, *xs, clip_rho_threshold=clips[0],
          clip_pg_rho_threshold=clips[1]))(
              *(jnp.asarray(arrays[k]) for k in (
                  'log_rhos', 'discounts', 'rewards', 'values',
                  'bootstrap_value')))
  np.testing.assert_allclose(vs, np.asarray(ref_vs), rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(pg, np.asarray(ref_pg), rtol=1e-5, atol=1e-5)


def test_sharded_vtrace_checks_the_batch():
  local = {k: torch.from_numpy(v)
           for k, v in _vtrace_inputs((5, 3), seed=0).items()}
  with pytest.raises(ValueError, match='does not split'):
    vtrace_cuda.sharded_from_importance_weights(_mesh(0, 2), **local,
                                                batch_size=7)
  with pytest.raises(ValueError, match='not batch 8'):
    vtrace_cuda.sharded_from_importance_weights(_mesh(0, 2), **local,
                                                batch_size=8)
  with pytest.raises(ValueError, match='no axis'):
    vtrace_cuda.sharded_from_importance_weights(_mesh(0, 2), **local,
                                                batch_axis='rows')
  # The local shard times the axis' size is the global batch by default.
  vs, _ = vtrace_cuda.sharded_from_importance_weights(_mesh(1, 2), **local)
  assert vs.shape == (5, 3)


# --- sharding and the mesh ----------------------------------------------

T, B, A, H, W = 4, 4, 9, 24, 32


def _fixed_batch(seed=0, t=T, b=B):
  """A [T+1, B] ActorOutput as numpy arrays, behaviour logits random."""
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.zeros(b, np.int32),
      agent_state=(rng.randn(b, 256).astype(np.float32) * 0.3,
                   rng.randn(b, 256).astype(np.float32) * 0.3),
      env_outputs=StepOutput(
          rng.randn(t + 1, b).astype(np.float32),
          StepOutputInfo(np.zeros((t + 1, b), np.float32),
                         np.zeros((t + 1, b), np.int32)),
          rng.rand(t + 1, b) > 0.8,
          (rng.randint(0, 256, (t + 1, b, H, W, 3)).astype(np.uint8),
           np.zeros((t + 1, b, 16), np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, A, (t + 1, b)),
          rng.randn(t + 1, b, A).astype(np.float32),
          rng.randn(t + 1, b).astype(np.float32)))


def test_local_shards_tile_the_batch():
  batch = map_structure(torch.from_numpy, _fixed_batch(b=6))
  specs = sharding.batch_specs(batch)
  assert specs.level_name == ('data',)
  assert specs.agent_state[0] == ('data', None)
  assert specs.env_outputs.observation[0] == (None, 'data', None, None,
                                              None)
  shards = [sharding.local_shard(batch, specs, r, 3) for r in range(3)]
  leaves = []
  map_structure(lambda *xs: leaves.append(xs), batch, specs, *shards)
  assert len(leaves) == 12
  for whole, spec, *parts in leaves:
    dim = spec.index('data')
    assert [p.shape[dim] for p in parts] == [2, 2, 2]
    assert torch.equal(torch.cat(parts, dim=dim), whole)
  with pytest.raises(ValueError, match='equal blocks'):
    sharding.local_shard(batch, specs, 0, 4)


def test_explicit_rank_mesh_refuses_collectives():
  mesh = _mesh(1, 2)
  assert mesh.shape == {'data': 2, 'model': 1}
  with pytest.raises(RuntimeError, match='process group'):
    mesh.all_reduce_sum_(torch.zeros(3))
  one = _mesh(0, 1)
  x = torch.ones(2)
  assert one.all_reduce_sum_(x) is x and torch.equal(x, torch.ones(2))
  with pytest.raises(ValueError, match='out of range'):
    _mesh(2, 2)


# --- the sharded train step against JAX's --------------------------------

_STEP_KW = dict(torso='shallow', batch_size=B, unroll_length=T,
                num_action_repeats=1, total_environment_frames=10**6,
                use_pallas_vtrace=True, use_instruction=False, height=H,
                width=W)


def _agent(weights):
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  agent.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
  return agent


def _params(state):
  return {k: v.detach().numpy().copy() for k, v in state.params.items()}


def _train_step_rank(rank, world, port, outdir, weights, batch):
  """One rank of the 2-rank sharded step, its group joined from the
  config's coordinator fields; rank 0 also takes the 1-rank step on the
  global batch."""
  _start_rank()
  config = Config(**_STEP_KW, coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cpu',
                                        timeout_secs=GROUP_TIMEOUT_SECS)
  mesh = mesh_lib.make_mesh(device)
  assert (mesh.rank, mesh.size) == (rank, world)
  agent = _agent(weights)
  state = train_parallel.make_sharded_train_state(agent, config, mesh)
  host_batch = map_structure(torch.from_numpy, batch)
  step, place = train_parallel.make_sharded_train_step(agent, config, mesh,
                                                       host_batch)
  local = place(host_batch)
  assert local.env_outputs.reward.shape == (T + 1, B // world)
  state, metrics = step(state, local)
  result = {'metrics': {k: float(v) for k, v in metrics.items()},
            'params': _params(state), 'jax_modules': _loaded_jax()}
  if rank == 0:
    agent1 = _agent(weights)
    state1, metrics1 = learner.make_train_step_fn(agent1, config)(
        learner.make_train_state(agent1, config), host_batch)
    result['single'] = {'metrics': {k: float(v)
                                    for k, v in metrics1.items()},
                        'params': _params(state1)}
  torch.save(result, os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def _assert_params_close(got, ref, what):
  for k in ref:
    np.testing.assert_allclose(got[k], ref[k], rtol=5e-4, atol=5e-6,
                               err_msg=f'{what}: {k}')


def test_sharded_train_step_matches_jax_over_two_ranks(tmp_path):
  import jax
  from scalable_agent_tpu import structs as jax_structs
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.models import agent as jax_agent
  from scalable_agent_tpu.models import init_params as jax_init_params
  from scalable_agent_tpu.parallel import mesh as jax_mesh
  from scalable_agent_tpu.parallel import train_parallel as jax_tp
  from scalable_agent_tpu_torch import convert

  jcfg = JaxConfig(**_STEP_KW)
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (H, W, 3), 'instr_len': 16})
  weights = {k: v.numpy() for k, v in
             convert.params_from_jax(jax.device_get(params)).items()}
  batch = _fixed_batch()
  j = jax.numpy.asarray
  env, act = batch.env_outputs, batch.agent_outputs
  jbatch = jax_structs.ActorOutput(
      level_name=j(batch.level_name),
      agent_state=tuple(map(j, batch.agent_state)),
      env_outputs=jax_structs.StepOutput(
          j(env.reward), jax_structs.StepOutputInfo(*map(j, env.info)),
          j(env.done), tuple(map(j, env.observation))),
      agent_outputs=jax_structs.AgentOutput(
          j(act.action, jax.numpy.int32), j(act.policy_logits),
          j(act.baseline)))
  mesh = jax_mesh.make_mesh(jax.devices()[:2])
  jstate = jax_tp.make_sharded_train_state(params, jcfg, mesh)
  jstep, jplace = jax_tp.make_sharded_train_step(jagent, jcfg, mesh, jbatch)
  jstate, jm = jstep(jstate, jplace(jbatch))
  ref = {k: v.numpy() for k, v in convert.params_from_jax(
      jax.device_get(jstate.params)).items()}
  del ref['core.bias_ih']  # a buffer in the port, not a parameter
  ref_loss = float(jm['total_loss'])

  _spawn(_train_step_rank, 2, str(tmp_path), weights, batch)
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  for r, result in enumerate(ranks):
    assert result['jax_modules'] == [], result['jax_modules']
    np.testing.assert_allclose(result['metrics']['total_loss'], ref_loss,
                               rtol=2e-4, err_msg=f'rank {r}')
    np.testing.assert_allclose(result['metrics']['grad_norm'],
                               float(jm['grad_norm']), rtol=2e-4)
    assert result['metrics']['step_ok'] == 1.0
    _assert_params_close(result['params'], ref, f'rank {r} vs JAX')
  for k, p in ranks[0]['params'].items():
    np.testing.assert_array_equal(p, ranks[1]['params'][k], err_msg=k)
  single = ranks[0]['single']
  np.testing.assert_allclose(single['metrics']['total_loss'], ref_loss,
                             rtol=2e-4)
  np.testing.assert_allclose(ranks[0]['metrics']['total_loss'],
                             single['metrics']['total_loss'], rtol=2e-4)
  _assert_params_close(single['params'], ref, '1 rank vs JAX')
  _assert_params_close(ranks[0]['params'], single['params'],
                       '2 ranks vs 1 rank')


# --- Anakin over two ranks against one ----------------------------------

_ANAKIN_KW = dict(env_backend='bandit', batch_size=4, unroll_length=5,
                  num_action_repeats=1, episode_length=4, height=H,
                  width=W, torso='shallow', use_instruction=False,
                  learning_rate=2e-3, entropy_cost=3e-3, discounting=0.9,
                  use_pallas_vtrace=True, total_environment_frames=10**6,
                  seed=0)
ANAKIN_STEPS = 2


def _launcher_env(rank, world, port):
  """The environment torch.distributed.run gives rank `rank` of `world`
  on one host."""
  os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                    RANK=str(rank), WORLD_SIZE=str(world),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))


def _anakin_rank(rank, world, port, outdir):
  """One rank of a 2-rank Anakin run, its group joined from
  torch.distributed.run's environment variables."""
  _start_rank()
  _launcher_env(rank, world, port)
  config = Config(**_ANAKIN_KW)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cpu',
                                        timeout_secs=GROUP_TIMEOUT_SECS)
  mesh = driver.choose_mesh(config, device)
  carry, history, _ = anakin.run(config, ANAKIN_STEPS, device='cpu',
                                 mesh=mesh)
  torch.save({'history': history, 'params': _params(carry.train_state),
              'update_steps': carry.train_state.update_steps,
              'core_state': carry.core_state[1].numpy(),
              'mesh': (mesh.rank, mesh.size),
              'jax_modules': _loaded_jax()},
             os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def test_anakin_over_two_ranks_follows_one_rank(tmp_path):
  carry, history, _ = anakin.run(Config(**_ANAKIN_KW), ANAKIN_STEPS,
                                 device='cpu')
  single = _params(carry.train_state)

  _spawn(_anakin_rank, 2, str(tmp_path))
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  for r, result in enumerate(ranks):
    assert result['jax_modules'] == [], result['jax_modules']
    assert result['mesh'] == (r, 2)
    assert result['update_steps'] == ANAKIN_STEPS
    # Step 1 acts with the same params on the same draws: the same
    # actions, so the same rewards.
    assert result['history'][0]['mean_reward'] == history[0]['mean_reward']
    for got, want in zip(result['history'], history):
      for key in ('total_loss', 'pg_loss', 'baseline_loss', 'entropy_loss',
                  'grad_norm'):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4,
                                   atol=1e-6, err_msg=key)
    _assert_params_close(result['params'], single, f'rank {r} vs 1 rank')
  for k, p in ranks[0]['params'].items():
    np.testing.assert_array_equal(p, ranks[1]['params'][k], err_msg=k)
  # Each rank carries the LSTM state of its own columns.
  np.testing.assert_allclose(
      np.concatenate([r['core_state'] for r in ranks]),
      carry.core_state[1].numpy(), rtol=1e-4, atol=1e-5)


# --- the CLI over a group of two ranks -----------------------------------

_CLI_KW = dict(_ANAKIN_KW, summary_secs=0)
CLI_FAILURE_SECS = 30  # well inside the CLI's 300 s group timeout


def _cli_argv(logdir):
  frames = ANAKIN_STEPS * Config(**_ANAKIN_KW).frames_per_step
  return (['--mode=anakin', '--device=cpu', f'--logdir={logdir}',
           f'--total_environment_frames={frames}'] +
          [f'--{k}={v}' for k, v in _CLI_KW.items()
           if k != 'total_environment_frames'])


def _cli_rank(rank, world, port, outdir, fail_port):
  """One rank of `experiment.main` under torch.distributed.run's
  environment: a run of ANAKIN_STEPS fused steps, then a run in which
  rank 1 fails inside its first train step, before the gradient
  all-reduce that rank 0 waits in."""
  _start_rank()
  _launcher_env(rank, world, port)
  carry = experiment.main(_cli_argv(os.path.join(outdir, f'run{rank}')))
  result = {'update_steps': carry.train_state.update_steps,
            'local_batch': carry.core_state[1].shape[0],
            'params': _params(carry.train_state),
            'left_group': not distributed.is_initialized()}

  _launcher_env(rank, world, fail_port)
  if rank == 1:
    def fail(*args, **kwargs):
      raise RuntimeError('injected failure')
    learner._all_reduce_sum = fail
  t0 = time.monotonic()
  try:
    experiment.main(_cli_argv(os.path.join(outdir, f'fail{rank}')))
    result['failure'] = None
  except Exception as e:  # noqa: BLE001 -- recorded for the test process
    result['failure'] = repr(e)
  result['failure_secs'] = time.monotonic() - t0
  result['left_group_after_failure'] = not distributed.is_initialized()
  torch.save(result, os.path.join(outdir, f'rank{rank}.pt'))


def test_cli_trains_over_two_ranks_and_fails_fast(tmp_path):
  _spawn(_cli_rank, 2, str(tmp_path), _free_port())
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  for result in ranks:
    assert result['update_steps'] == ANAKIN_STEPS
    assert result['local_batch'] == _ANAKIN_KW['batch_size'] // 2
    assert result['left_group'] and result['left_group_after_failure']
  for k, p in ranks[0]['params'].items():
    np.testing.assert_array_equal(p, ranks[1]['params'][k], err_msg=k)
  # Rank 0 alone writes the logdir.
  assert not (tmp_path / 'run1').exists()
  with open(tmp_path / 'run0' / 'summaries.jsonl') as f:
    losses = [e['value'] for e in map(json.loads, f)
              if e['tag'] == 'total_loss']
  assert losses and all(np.isfinite(losses))
  # The failing rank leaves at once; its peer's collective then fails,
  # long before the group's timeout.
  assert 'injected failure' in ranks[1]['failure']
  assert ranks[0]['failure'] is not None
  assert 'injected failure' not in ranks[0]['failure']
  for result in ranks:
    assert result['failure_secs'] < CLI_FAILURE_SECS, result


def test_indivisible_batch_raises_before_any_work(monkeypatch):
  def no_work(*args, **kwargs):
    raise AssertionError('work started before the divisibility check')

  monkeypatch.setattr(anakin, 'make_env_core', no_work)
  monkeypatch.setattr(driver, 'build_agent', no_work)
  config = Config(**dict(_ANAKIN_KW, batch_size=6))
  with pytest.raises(ValueError, match='not divisible by the data axis'):
    anakin.build_run(config, device='cpu', mesh=_mesh(0, 4))
  with pytest.raises(ValueError, match='not divisible by the data axis'):
    anakin.init_carry(None, None, config, 0, 'cpu', mesh=_mesh(0, 4))


# --- topology rules -----------------------------------------------------

def test_choose_mesh_rules(monkeypatch, caplog):
  config = Config(**dict(_ANAKIN_KW, batch_size=6))
  assert driver.choose_mesh(config, 'cpu') is None  # one rank, no group
  monkeypatch.setattr(distributed, 'world_size', lambda: 4)
  for key, value in (('RANK', '0'), ('WORLD_SIZE', '4'),
                     ('LOCAL_RANK', '0'), ('LOCAL_WORLD_SIZE', '4')):
    monkeypatch.setenv(key, value)
  with caplog.at_level(logging.WARNING, logger='scalable_agent_tpu_torch'):
    assert driver.choose_mesh(config, 'cpu') is None
  assert 'not divisible by the 4 ranks' in caplog.text
  monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')  # 2 hosts of 2 ranks
  with pytest.raises(ValueError, match='only safe on one host'):
    driver.choose_mesh(config, 'cpu')


def test_model_parallelism_is_a_later_slice():
  """Tensor parallelism is in the port now: the config takes a model
  axis, and the mesh builds one over a group whose ranks it divides; with
  no group (one rank) a model axis of 2 raises JAX's ValueError, as does
  the Anakin runtime, which is data-parallel only."""
  config = Config(model_parallelism=2)
  assert config.model_parallelism == 2 and config.tp_compute == 'auto'
  with pytest.raises(ValueError, match='not divisible by '
                     'model_parallelism=2'):
    mesh_lib.make_mesh('cpu', model_parallelism=2)
  with pytest.raises(ValueError, match='data-parallel only'):
    anakin.build_run(Config(**dict(_ANAKIN_KW, model_parallelism=2)),
                     device='cpu')
  with pytest.raises(ValueError, match='data-parallel only'):
    driver.train_anakin(Config(**dict(_ANAKIN_KW, model_parallelism=2)),
                        device='cpu')


_DIST_CONFIGS = [
    {},
    {'num_processes': 0},
    {'num_processes': 2},
    {'coordinator_address': 'localhost'},
    {'coordinator_address': ':1234'},
    {'coordinator_address': 'host:port'},
    {'coordinator_address': 'localhost:1234'},
    {'coordinator_address': 'localhost:1234', 'num_processes': 2,
     'process_id': 1},
    {'coordinator_address': 'localhost:1234', 'num_processes': 2,
     'process_id': 2},
    {'process_id': 0},
]


@pytest.mark.parametrize('kw', _DIST_CONFIGS, ids=str)
def test_validate_distributed_matches_jax(kw):
  from scalable_agent_tpu import config as jax_config

  def outcome(validate, config):
    try:
      return 'ok', validate(config)
    except ValueError as e:
      return 'error', str(e)

  got = outcome(validate_distributed, Config(**kw))
  want = outcome(jax_config.validate_distributed, jax_config.Config(**kw))
  assert got[0] == want[0], (got, want)
  if got[0] == 'error':
    assert got[1] == want[1]
  elif kw.get('num_processes', 1) == 1:
    # The JAX multi-process cross-links (SDC, TP, filler) are not here.
    assert [w.split(':')[0] for w in got[1]] == [
        w.split(':')[0] for w in want[1]]


def test_declared_topology_and_rank_devices():
  config = Config()
  assert distributed.declared_topology(config, {}) is None
  env = {'RANK': '3', 'WORLD_SIZE': '8', 'LOCAL_RANK': '1',
         'LOCAL_WORLD_SIZE': '2'}
  topology = distributed.declared_topology(config, env)
  assert topology == distributed.Topology(3, 8, 1, 2)
  assert topology.num_nodes == 4
  by_config = distributed.declared_topology(
      Config(coordinator_address='localhost:1234', num_processes=2,
             process_id=1), {})
  assert by_config == distributed.Topology(1, 2, 1, 2)
  assert by_config.num_nodes == 1
  assert distributed.rank_device(by_config, 'gloo', 'cpu').type == 'cpu'
  with pytest.raises(ValueError, match='NCCL'):
    distributed.rank_device(by_config, 'nccl', 'cpu')
  with pytest.raises(ValueError, match='backend'):
    distributed.rank_device(by_config, 'mpi', 'cpu')
  if not torch.cuda.is_available():
    for backend in distributed.BACKENDS:
      with pytest.raises(RuntimeError, match='cuda'):
        distributed.rank_device(by_config, backend, 'cuda')


def test_cli_refuses_multi_node_anakin(monkeypatch, tmp_path):
  monkeypatch.setenv('RANK', '0')
  monkeypatch.setenv('WORLD_SIZE', '2')
  monkeypatch.setenv('LOCAL_RANK', '0')
  monkeypatch.setenv('LOCAL_WORLD_SIZE', '1')
  with pytest.raises(ValueError, match='single-host'):
    experiment.main(['--mode=anakin', '--device=cpu', '--env_backend=bandit',
                     f'--logdir={tmp_path}'])
  assert not distributed.is_initialized()
  for name in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
    monkeypatch.delenv(name)
  # Tensor parallelism with Anakin: JAX's refusal.
  with pytest.raises(ValueError, match='data-parallel only'):
    experiment.main(['--mode=anakin', '--device=cpu',
                     '--model_parallelism=2', f'--logdir={tmp_path}'])
