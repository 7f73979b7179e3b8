"""The port's tensor parallelism (parallel/train_parallel.py with the
`megatron` rules of parallel/sharding.py; the blocked forward of
models/torsos.py and models/agent.py; checkpoint.py's gather on save,
sharding manifest and resharded restore) against the JAX package's
single-device train step and its checkpoint manifest, on the CPU.

Ranks are spawned gloo processes (as tests/test_torch_parallel.py spawns
them): 2 ranks are a mesh of {data 1, model 2}, 4 ranks {data 2, model
2}. Each rank feeds its B/(D*M) rows of one fixed global batch, and runs
two steps in each compute mode (`gathered`, then `sharded`) from the same
converted weights. A spawned rank imports no JAX; the JAX references run
in the test process, once per module (a module fixture), and the tests
read the ranks' results.

Tolerances, the port's TP step against JAX's single-device step on the
same global batch and weights (gradients summed over ranks and, in the
sharded mode, matmuls cut over features: float32 in another order):
losses and grad_norm rtol 2e-4; params rtol 5e-4 / atol 5e-6; RMSProp's
nu rtol 2e-3 / atol 1e-9 (a square of the gradient, through a running
average). These are the data-parallel tests' gates (test_torch_parallel.
py), with nu's doubled for the square. Against the port's own one-rank
step: losses rtol 1e-5, params rtol 1e-5 / atol 1e-7. The checkpoint's
round trips between meshes are bit-equal: files hold full tensors, and a
restore slices them.
"""

import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import checkpoint as checkpoint_lib
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

T, B, A, H, W = 4, 8, 5, 24, 32
STEPS = 2
MODES = ('gathered', 'sharded')
SPAWN_TIMEOUT_SECS = 120
GROUP_TIMEOUT_SECS = 60

_KW = dict(torso='deep', batch_size=B, unroll_length=T, num_action_repeats=1,
           total_environment_frames=10**6, use_pallas_vtrace=True,
           use_instruction=False, height=H, width=W, grad_clip_norm=5.0)


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _spawn(worker, world, *args):
  context = mp.spawn(worker, args=(world, _free_port()) + args,
                     nprocs=world, join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail(f'{worker.__name__} ranks still running after '
                  f'{SPAWN_TIMEOUT_SECS} s')


def _loaded_jax():
  return sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'scalable_agent_tpu'))


def _fixed_batch(seed=0):
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.zeros(B, np.int32),
      agent_state=(rng.randn(B, 256).astype(np.float32) * 0.3,
                   rng.randn(B, 256).astype(np.float32) * 0.3),
      env_outputs=StepOutput(
          rng.randn(T + 1, B).astype(np.float32),
          StepOutputInfo(np.zeros((T + 1, B), np.float32),
                         np.zeros((T + 1, B), np.int32)),
          rng.rand(T + 1, B) > 0.8,
          (rng.randint(0, 256, (T + 1, B, H, W, 3)).astype(np.uint8),
           np.zeros((T + 1, B, 16), np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, A, (T + 1, B)),
          rng.randn(T + 1, B, A).astype(np.float32),
          rng.randn(T + 1, B).astype(np.float32)))


def _agent(weights):
  agent = ImpalaAgent(A, (H, W, 3), torso='deep')
  agent.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
  return agent


def _numpy(tree):
  return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _tp_rank(rank, world, port, outdir, weights, batch, one_rank_ckpt):
  """One rank of a TP group: STEPS steps in each mode; for 2 ranks also
  the checkpoint round trips."""
  torch.set_num_threads(1)
  results = {'jax_modules': _loaded_jax()}
  host_batch = map_structure(torch.from_numpy, batch)
  for mode in MODES:
    config = Config(**_KW, model_parallelism=2, tp_compute=mode,
                    coordinator_address=f'localhost:{port}',
                    num_processes=world, process_id=rank)
    if not distributed.is_initialized():
      device = distributed.maybe_initialize(
          config, backend='gloo', device='cpu',
          timeout_secs=GROUP_TIMEOUT_SECS)
      mesh = mesh_lib.make_mesh(device, model_parallelism=2)
    agent = _agent(weights)
    state = train_parallel.make_sharded_train_state(agent, config, mesh)
    step, place = train_parallel.make_sharded_train_step(
        agent, config, mesh, host_batch)
    local = place(host_batch)
    metrics = []
    for _ in range(STEPS):
      state, m = step(state, local)
      metrics.append({k: float(v) for k, v in m.items()})
    full = train_parallel.gather_state(state, step.layout)
    results[mode] = {
        'step_mode': step.tp_compute, 'rows': local.level_name.shape[0],
        'metrics': metrics, 'blocks': _numpy(state.params),
        'params': _numpy(full.params), 'nu': _numpy(full.opt_state.nu),
        'cuts': dict(step.layout.cuts)}
  results['mesh'] = (mesh.rank, mesh.size, mesh.model_index,
                     mesh.model_size)
  if world == 2:
    # Save at {data 1, model 2}: every rank gathers, rank 0 writes.
    registry = sharding.from_config(config)
    ckpt = checkpoint_lib.Checkpointer(
        os.path.join(outdir, 'ckpt_tp'), save_interval_secs=0,
        mesh=mesh, registry=registry, layout=step.layout)
    results['saved'] = ckpt.save(state, force=True)
    # Restore a one-rank checkpoint onto this mesh: each rank slices.
    target = train_parallel.make_sharded_train_state(_agent(weights),
                                                     config, mesh)
    ckpt_one = checkpoint_lib.Checkpointer(
        one_rank_ckpt, mesh=mesh, registry=registry, layout=step.layout)
    delta = distributed.topology_delta(ckpt_one.saved_mesh_shape(), mesh)
    results['delta'] = delta
    restored = ckpt_one.restore_resharded(target, registry, mesh)
    results['restored_blocks'] = _numpy(restored.params)
    results['restored_nu'] = _numpy(restored.opt_state.nu)
    results['restored_steps'] = restored.update_steps
  torch.save(results, os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def _jax_reference(weights_jax, batch):
  """JAX's single-device step, STEPS times on the global batch: losses,
  grad_norm, params and nu, each in the port's layout."""
  import jax
  import jax.numpy as jnp
  from scalable_agent_tpu import learner as jax_learner
  from scalable_agent_tpu import structs as jax_structs
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.models import agent as jax_agent
  jcfg = JaxConfig(**_KW)
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='deep',
                                 use_instruction=False)
  j = jnp.asarray
  env, act = batch.env_outputs, batch.agent_outputs
  jbatch = jax_structs.ActorOutput(
      level_name=j(batch.level_name),
      agent_state=tuple(map(j, batch.agent_state)),
      env_outputs=jax_structs.StepOutput(
          j(env.reward), jax_structs.StepOutputInfo(*map(j, env.info)),
          j(env.done), tuple(map(j, env.observation))),
      agent_outputs=jax_structs.AgentOutput(
          j(act.action, jnp.int32), j(act.policy_logits), j(act.baseline)))
  jstep = jax.jit(jax_learner.make_train_step(jagent, jcfg))
  jstate = jax_learner.make_train_state(weights_jax, jcfg)
  metrics = []
  for _ in range(STEPS):
    jstate, jm = jstep(jstate, jbatch)
    metrics.append({k: float(v) for k, v in jm.items()})

  def port(tree):
    out = {k: v.numpy() for k, v in convert.params_from_jax(
        jax.device_get(tree)).items()}
    del out['core.bias_ih']
    return out

  return {'metrics': metrics, 'params': port(jstate.params),
          'nu': port(next(
              x.nu for x in jax.tree_util.tree_leaves(
                  jstate.opt_state, is_leaf=lambda x: hasattr(x, 'nu'))
              if hasattr(x, 'nu')))}


def _one_rank(weights, batch, steps=STEPS):
  config = Config(**_KW)
  agent = _agent(weights)
  state = learner.make_train_state(agent, config)
  step = learner.make_train_step_fn(agent, config)
  metrics = []
  for _ in range(steps):
    state, m = step(state, map_structure(torch.from_numpy, batch))
    metrics.append({k: float(v) for k, v in m.items()})
  return state, metrics


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """The JAX reference, the port's one-rank run, a one-rank checkpoint
  (3 steps, so its tensors differ from the ranks' initial ones), and the
  2- and 4-rank groups' results."""
  import jax
  from scalable_agent_tpu.models import agent as jax_agent
  from scalable_agent_tpu.models import init_params as jax_init_params
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='deep',
                                 use_instruction=False)
  weights_jax = jax.device_get(jax_init_params(
      jagent, jax.random.PRNGKey(0), {'frame': (H, W, 3), 'instr_len': 16}))
  weights = {k: v.numpy() for k, v in
             convert.params_from_jax(weights_jax).items()}
  batch = _fixed_batch()
  out = {'weights': weights, 'weights_jax': weights_jax, 'batch': batch,
         'jax': _jax_reference(weights_jax, batch)}
  one_state, one_metrics = _one_rank(weights, batch)
  out['one'] = {'metrics': one_metrics, 'params': _numpy(one_state.params),
                'nu': _numpy(one_state.opt_state.nu)}
  one_dir = str(tmp_path_factory.mktemp('ckpt_one'))
  ckpt_state, _ = _one_rank(weights, batch, steps=3)
  out['one_ckpt'] = {'params': _numpy(ckpt_state.params),
                     'nu': _numpy(ckpt_state.opt_state.nu)}
  assert checkpoint_lib.Checkpointer(
      one_dir, mesh=mesh_lib.Mesh(0, 1, torch.device('cpu')),
      registry=sharding.from_config(Config())).save(ckpt_state, force=True)
  for world in (2, 4):
    outdir = tmp_path_factory.mktemp(f'tp{world}')
    _spawn(_tp_rank, world, str(outdir), weights, batch, one_dir)
    out[world] = {'dir': outdir, 'ranks': [
        torch.load(outdir / f'rank{r}.pt', weights_only=False)
        for r in range(world)]}
  return out


def _close(got, want, rtol, atol, what):
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                               err_msg=f'{what}: {k}')


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('world', [2, 4])
def test_tp_step_matches_jax_single_device(runs, world, mode):
  ref = runs['jax']
  for r, result in enumerate(runs[world]['ranks']):
    got = result[mode]
    assert result['jax_modules'] == [], result['jax_modules']
    assert got['step_mode'] == mode
    assert got['rows'] == B // world  # B/(D*M) distinct rows per rank
    for i, (m, jm) in enumerate(zip(got['metrics'], ref['metrics'])):
      for key in ('total_loss', 'grad_norm', 'learning_rate'):
        np.testing.assert_allclose(m[key], jm[key], rtol=2e-4,
                                   err_msg=f'rank {r} step {i} {key}')
      assert m['step_ok'] == 1.0
    _close(got['params'], ref['params'], 5e-4, 5e-6, f'{mode} rank {r}')
    _close(got['nu'], ref['nu'], 2e-3, 1e-9, f'{mode} nu rank {r}')


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('world', [2, 4])
def test_tp_step_matches_the_one_rank_step(runs, world, mode):
  one = runs['one']
  for r, result in enumerate(runs[world]['ranks']):
    got = result[mode]
    for m, m1 in zip(got['metrics'], one['metrics']):
      np.testing.assert_allclose(m['total_loss'], m1['total_loss'],
                                 rtol=1e-5)
    _close(got['params'], one['params'], 1e-5, 1e-7, f'{mode} rank {r}')
  # Every rank ends with the same full tensors.
  ranks = runs[world]['ranks']
  for k, v in ranks[0][mode]['params'].items():
    for other in ranks[1:]:
      np.testing.assert_array_equal(other[mode]['params'][k], v, err_msg=k)


@pytest.mark.parametrize('world', [2, 4])
def test_params_at_rest_are_cut_as_jax_cuts_them(runs, world):
  """Each rank holds, for every parameter, the block at its model index
  (the JAX device shard's slice: test_torch_sharding.py holds that
  mapping bit-equal); the heads and nothing else are whole."""
  for result in runs[world]['ranks']:
    _, data_size, model_index, model_size = result['mesh']
    assert (data_size, model_size) == (world // 2, 2)
    for mode in MODES:
      got = result[mode]
      for name, full in got['params'].items():
        cut = got['cuts'][name]
        assert (cut is None) == name.startswith(('policy_logits',
                                                 'baseline')), name
        want = sharding.take_block(torch.from_numpy(full), cut, model_index)
        np.testing.assert_array_equal(got['blocks'][name], want.numpy(),
                                      err_msg=name)
        if cut is not None:
          assert got['blocks'][name].shape[0] * 2 == full.shape[0], name


def test_tp_checkpoint_restores_on_one_rank(runs):
  """A save at {data 1, model 2} holds full tensors: a one-rank run
  restores it bit-equal to the ranks' gathered state."""
  ranks = runs[2]['ranks']
  assert ranks[0]['saved'] and ranks[1]['saved']
  directory = str(runs[2]['dir'] / 'ckpt_tp')
  agent = _agent(runs['weights'])
  config = Config(**_KW)
  ckpt = checkpoint_lib.Checkpointer(directory,
                                     registry=sharding.from_config(config))
  assert ckpt.saved_mesh_shape() == {'data': 1, 'model': 2}
  target = learner.make_train_state(agent, config)
  restored = ckpt.restore_resharded(target, sharding.from_config(config),
                                    mesh_lib.Mesh(0, 1, torch.device('cpu')))
  assert restored.update_steps == STEPS
  want = ranks[0]['sharded']
  for k, p in restored.params.items():
    np.testing.assert_array_equal(p.detach().numpy(), want['params'][k],
                                  err_msg=k)
    np.testing.assert_array_equal(restored.opt_state.nu[k].numpy(),
                                  want['nu'][k], err_msg=k)


def test_one_rank_checkpoint_restores_onto_tp_ranks(runs):
  """A one-rank checkpoint (no model axis) restored at {data 1, model 2}
  through the elastic gate: each rank holds its blocks of the saved
  tensors, bit-equal."""
  one = runs['one_ckpt']
  for r, result in enumerate(runs[2]['ranks']):
    assert result['delta'] == {'saved_mesh': {'data': 1, 'model': 1},
                               'live_mesh': {'data': 1, 'model': 2},
                               'processes': 2, 'process_index': r}
    assert result['restored_steps'] == 3
    model_index = result['mesh'][2]
    cuts = result['sharded']['cuts']
    for k in one['params']:
      want = sharding.take_block(torch.from_numpy(one['params'][k]),
                                 cuts[k], model_index)
      np.testing.assert_array_equal(result['restored_blocks'][k],
                                    want.numpy(), err_msg=f'rank {r} {k}')
      want_nu = sharding.take_block(torch.from_numpy(one['nu'][k]),
                                    cuts[k], model_index)
      np.testing.assert_array_equal(result['restored_nu'][k],
                                    want_nu.numpy(), err_msg=f'rank {r} {k}')


def test_tp_manifest_matches_jax(runs, tmp_path):
  """The port's SHARDING_<step>.json at {data 1, model 2} has JAX's
  fields and values for the same mesh: step, rule set, mesh, the spec
  table and its digest."""
  import json
  import jax
  from jax.sharding import Mesh
  from scalable_agent_tpu import checkpoint as jax_checkpoint
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  from scalable_agent_tpu.parallel import train_parallel as jax_tp
  jcfg = JaxConfig(**dict(_KW, model_parallelism=2))
  jax_mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2),
                  ('data', 'model'))
  registry = jax_sharding.from_config(jcfg)
  jstate = jax_tp.make_sharded_train_state(runs['weights_jax'], jcfg,
                                           jax_mesh, registry=registry)
  jckpt = jax_checkpoint.Checkpointer(str(tmp_path / 'jax'),
                                      save_interval_secs=0,
                                      registry=registry, mesh=jax_mesh)
  assert jckpt.save(jstate, step=STEPS)
  jckpt.wait_until_finished()
  want = jckpt.read_sharding_manifest(STEPS)
  jckpt.close()
  with open(runs[2]['dir'] / 'ckpt_tp' / f'SHARDING_{STEPS}.json') as f:
    got = json.load(f)
  assert got == want


def test_restore_resharded_strict_refusal_and_escape(tmp_path):
  """A leaf saved cut whose cut the target mesh cannot honor refuses
  (ShardingLayoutError, naming it); non-strict takes the guard's
  replicated fallback with the values intact. The torso's Dense (256
  features) is cut over model 2 at save; model 3 does not divide 256."""
  config = Config(**_KW)
  agent = ImpalaAgent(A, (H, W, 3), torso='deep')
  state = learner.make_train_state(agent, config)
  registry = sharding.ShardingRegistry((
      (r'.*Dense_\d+/kernel$', (None, sharding.MODEL_AXIS)),
      (r'.*', ()),
  ), rule_set='layout-test')
  ckpt = checkpoint_lib.Checkpointer(str(tmp_path), save_interval_secs=0,
                                     registry=registry)
  assert ckpt.save(state, force=True)
  manifest = ckpt.read_sharding_manifest(0)
  assert manifest['specs']['params/DeepResNetTorso_0/Dense_0/kernel'] == (
      "PartitionSpec(None, 'model')")
  target = {'data': 1, 'model': 3}
  with pytest.raises(sharding.ShardingLayoutError, match='Dense_0/kernel'):
    ckpt.restore_resharded(state, registry, target)
  restored = ckpt.restore_resharded(state, registry, target, strict=False)
  assert torch.equal(restored.params['torso.linear.weight'],
                     agent.torso.linear.weight.detach())
  # On model 2 the cut holds: a rank's block of the saved tensor.
  layout = checkpoint_lib.registry_restore_targets(
      {k: v.shape for k, v in state.params.items()}, registry,
      {'data': 1, 'model': 2})
  assert layout.cuts['torso.linear.weight'] == sharding.Cut(0, 1, 2)
  assert layout.cuts['torso.linear.bias'] is None


def _deep_fast_rank(rank, world, port, outdir, weights, batch):
  """One rank of a {data 1, model 2} group training the deep_fast agent
  in `gathered` compute."""
  torch.set_num_threads(1)
  config = Config(**dict(_KW, torso='deep_fast'), model_parallelism=2,
                  tp_compute='gathered',
                  coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo', device='cpu',
                                        timeout_secs=GROUP_TIMEOUT_SECS)
  mesh = mesh_lib.make_mesh(device, model_parallelism=2)
  agent = ImpalaAgent(A, (H, W, 3), torso='deep_fast')
  agent.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()},
                        strict=False)  # core.bias_ih: a zero buffer
  host_batch = map_structure(torch.from_numpy, batch)
  state = train_parallel.make_sharded_train_state(agent, config, mesh)
  step, place = train_parallel.make_sharded_train_step(agent, config, mesh,
                                                       host_batch)
  state, metrics = step(state, place(host_batch))
  full = train_parallel.gather_state(state, step.layout)
  torch.save({'loss': float(metrics['total_loss']),
              'cut': sum(c is not None for c in step.layout.cuts.values()),
              'params': _numpy(full.params)},
             os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def test_deep_fast_gathered_tp_step_matches_one_rank(tmp_path):
  """deep_fast's parameters are deep's, so the megatron rules cut them as
  deep's and its blocked layers run under TP: a gathered step over 2
  ranks against the one-rank step (the bar of the deep tests above)."""
  agent = ImpalaAgent(A, (H, W, 3), torso='deep_fast')
  init_params(agent, torch.Generator().manual_seed(3))
  weights = _numpy(dict(agent.named_parameters()))
  batch = _fixed_batch(seed=1)
  config = Config(**dict(_KW, torso='deep_fast'))
  state, m1 = learner.make_train_step_fn(agent, config)(
      learner.make_train_state(agent, config),
      map_structure(torch.from_numpy, batch))
  _spawn(_deep_fast_rank, 2, str(tmp_path), weights, batch)
  for r in range(2):
    got = torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
    assert got['cut'] > 0
    np.testing.assert_allclose(got['loss'], float(m1['total_loss']),
                               rtol=1e-5)
    _close(got['params'], _numpy(state.params), 1e-5, 1e-7,
           f'deep_fast rank {r}')
