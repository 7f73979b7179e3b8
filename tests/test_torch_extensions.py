"""The learner extensions through the port's learner, checkpoint, memory
fit, driver and Anakin runtime, against the JAX package where it has the
same function, on the CPU.

- The full-feature learner step (PopArt over 30 tasks, pixel control,
  the instruction encoder; shallow torso, T=5, B=4, 24x32) over three
  steps from one converted state (convert.train_state_from_jax): the
  losses and grad norm rtol 2e-4, the params rtol 5e-4 / atol 5e-6 and
  RMSProp's nu rtol 2e-3 / atol 1e-9 (the bar of tests/test_torch_
  learner.py's train-step parity: gradients of a deep graph summed in
  another order, through RMSProp's 1/sqrt; nu holds squared gradients,
  so its relative error is twice theirs), the PopArt statistics and
  sigma range rtol 1e-5 (an EMA of float32 sums).
- A checkpoint round trip and a health rollback carry the PopArt
  statistics and IMPACT's target network; a PopArt checkpoint restored
  into a config without PopArt is a config mismatch.
- parallel/fit.py's argument bytes against JAX's `argument_size_in_bytes`
  of the same step at a small shape (exact, with the accounting spelled
  out in the test).
- driver.train runs the full-feature fleet on the fake dmlab30 levels
  and the IMPACT fleet with sample reuse, whose frame clock counts fresh
  frames; anakin.train runs with the extensions.

IMPACT, the replay tier and a 2-rank group's step with the extensions
are in tests/test_torch_replay.py (whose spawned ranks import no JAX).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import learner as jax_learner
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu.testing import make_example_batch
from scalable_agent_tpu_torch import checkpoint
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import fit
from scalable_agent_tpu_torch.structs import map_structure

torch.set_num_threads(1)

T, B, H, W, A, K = 5, 4, 24, 32, 4, 30
FULL = dict(torso='shallow', batch_size=B, unroll_length=T,
            num_action_repeats=1, total_environment_frames=10**6,
            height=H, width=W, num_actions=A, use_popart=True,
            popart_beta=0.1, pixel_control_cost=0.01, use_instruction=True)
TASKS = np.array([0, 7, 29, 7], np.int32)


def _jax_setup(**overrides):
  kw = dict(FULL, **overrides)
  jcfg, cfg = JaxConfig(**kw), Config(**kw)
  jagent = jax_agent.ImpalaAgent(
      num_actions=A, torso='shallow', use_instruction=True,
      num_popart_tasks=K, use_pixel_control=cfg.pixel_control_cost > 0)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (H, W, 3), 'instr_len': 16})
  jstate = jax_learner.make_train_state(params, jcfg, num_popart_tasks=K)
  agent = driver.build_agent(cfg, A, K)
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  state = convert.train_state_from_jax(
      jax.device_get(jstate), learner.make_train_state(agent, cfg, K))
  return jcfg, cfg, jagent, jstate, agent, state


def _batches(n, seed=0):
  out = []
  for i in range(n):
    jbatch = make_example_batch(T + 1, B, H, W, A, 16, seed=seed + i,
                                done_prob=0.1)
    jbatch = jbatch._replace(level_name=jnp.asarray(TASKS))
    out.append((jbatch, map_structure(
        lambda x: torch.from_numpy(np.array(x)), jax.device_get(jbatch))))
  return out


def _port_tree(jax_tree):
  return {k: v.numpy() for k, v in convert.params_from_jax(
      jax.device_get(jax_tree)).items() if not k.endswith('bias_ih')}


def test_full_feature_learner_matches_jax_over_three_steps():
  jcfg, cfg, jagent, jstate, agent, state = _jax_setup()
  jstep = jax_learner.make_train_step(jagent, jcfg)
  step = learner.make_train_step_fn(agent, cfg)
  for i, (jbatch, batch) in enumerate(_batches(3)):
    jstate, jm = jstep(jstate, jbatch)
    state, m = step(state, batch)
    for key in ('total_loss', 'grad_norm', 'pixel_control_loss',
                'baseline_loss', 'entropy_loss', 'learning_rate'):
      np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4,
                                 err_msg=f'step {i} {key}')
    for key in ('popart_sigma_min', 'popart_sigma_max'):
      np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                 err_msg=f'step {i} {key}')
    assert float(m['step_ok']) == 1.0
  for name in ('mu', 'nu'):
    np.testing.assert_allclose(getattr(state.popart, name).numpy(),
                               np.asarray(getattr(jstate.popart, name)),
                               rtol=1e-5, atol=1e-7, err_msg=name)
  # Only the batch's tasks moved; the other 27 are still the identity.
  moved = np.flatnonzero(state.popart.mu.numpy())
  assert set(moved) == set(TASKS)
  ref = _port_tree(jstate.params)
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=5e-4,
                               atol=5e-6, err_msg=k)
  nu_ref = _port_tree(jstate.opt_state[0].nu)
  for k, v in state.opt_state.nu.items():
    np.testing.assert_allclose(v.numpy(), nu_ref[k], rtol=2e-3, atol=1e-9,
                               err_msg=f'nu {k}')


def _ckpt_setup(tmp_path, **overrides):
  cfg = Config(**dict(FULL, surrogate='impact', target_update_interval=2,
                      **overrides))
  agent = driver.build_agent(cfg, A, K)
  init_params(agent, torch.Generator().manual_seed(0))
  state = learner.make_train_state(agent, cfg, K)
  ckpt = checkpoint.Checkpointer(str(tmp_path / 'ckpt'))
  return cfg, agent, state, ckpt


def test_checkpoint_round_trip_and_rollback_carry_popart_and_target(
    tmp_path):
  cfg, agent, state, ckpt = _ckpt_setup(tmp_path)
  step = learner.make_train_step_fn(agent, cfg)
  batches = [b for _, b in _batches(3, seed=5)]
  state, _ = step(state, batches[0])
  assert ckpt.save(state, force=True)
  saved = learner.state_to_payload(state)
  assert saved['popart'] is not None and saved['target_params'] is not None
  # Train on: the stats, params and (at step 2) the target move.
  state, _ = step(state, batches[1])
  state, _ = step(state, batches[2])
  assert not torch.equal(state.popart.mu, saved['popart']['mu'])
  rolled = ckpt.restore_last_good(state)
  assert rolled.update_steps == 1
  back = learner.state_to_payload(rolled)
  for name in ('popart', 'target_popart', 'target_params', 'params'):
    for k, v in saved[name].items():
      assert torch.equal(back[name][k], v), (name, k)
  # The restore wrote into the state's own tensors (the agent trains
  # them, and the target network stays apart from them).
  assert all(p is rolled.params[k] for k, p in agent.named_parameters())
  assert all(t is not rolled.params[k]
             for k, t in rolled.target_params.items())
  # A fresh template restores the same values.
  _, _, template, _ = _ckpt_setup(tmp_path / 'other')
  restored = ckpt.restore_latest(template)
  for name in ('popart', 'target_params'):
    for k, v in learner.state_to_payload(restored)[name].items():
      assert torch.equal(v, saved[name][k]), (name, k)
  # PopArt saved, no PopArt configured: a config mismatch naming the flag.
  plain = Config(**dict(FULL, use_popart=False, surrogate='impact'))
  plain_agent = driver.build_agent(plain, A, K)
  with pytest.raises(checkpoint.CheckpointStructureError,
                     match='--use_popart'):
    ckpt.restore_latest(learner.make_train_state(plain_agent, plain))


def test_fit_argument_bytes_match_jax():
  """The port's CPU fit counts params, RMSProp state, the PopArt
  statistics and the batch. JAX's compiled step also holds optax's
  momentum trace (zeros at momentum 0; the port keeps none) and its
  device-side step counter (int32; the port counts steps on the host),
  and jit drops the batch leaves the step never reads (the episode
  stats and the recorded baseline)."""
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.parallel import fit as jax_fit
  t1, b = T + 1, B
  jcfg = jax_fit.full_feature_config(b, T, H, W)
  jcfg = dataclasses.replace(jcfg, torso='shallow')
  jagent = jax_driver.build_agent(jcfg, num_actions=fit.NUM_ACTIONS,
                                  num_tasks=K)
  params = jax.eval_shape(lambda: jax_init_params(
      jagent, jax.random.PRNGKey(0), {'frame': (H, W, 3), 'instr_len': 16}))
  jstate = jax.eval_shape(lambda p: jax_learner.make_train_state(
      p, jcfg, num_popart_tasks=K), params)
  jbatch = jax.eval_shape(lambda: make_example_batch(
      t1, b, H, W, fit.NUM_ACTIONS, 16))
  compiled = jax.jit(jax_learner.make_train_step_fn(jagent, jcfg)).lower(
      jstate, jbatch).compile()
  jax_bytes = compiled.memory_analysis().argument_size_in_bytes
  got = fit.memory_fit('cpu', batch_size=b, unroll_length=T, height=H,
                       width=W, torso='shallow')
  param_bytes = sum(int(np.prod(x.shape)) * 4
                    for x in jax.tree_util.tree_leaves(params))
  unread = t1 * b * (4 + 4 + 4)   # info (f32, int32), recorded baseline
  assert got['argument_bytes'] + param_bytes + 4 - unread == jax_bytes
  assert got['per_device_batch'] == b and got['backend'] == 'cpu'
  assert fit.full_feature_config().pixel_control_cost == (
      jax_fit.full_feature_config().pixel_control_cost)
  assert fit.HBM_BUDGET_FRACTION == jax_fit.HBM_BUDGET_FRACTION


_FLEET = dict(env_backend='fake', level_name='dmlab30', torso='shallow',
              height=H, width=W, batch_size=4, num_actors=4, unroll_length=5,
              num_action_repeats=1, total_environment_frames=200,
              summary_secs=0, use_popart=True, use_py_process=False)


@pytest.mark.parametrize('kind', ['full_feature', 'impact_reuse'])
def test_driver_trains_the_extensions_on_dmlab30(kind, tmp_path):
  kw = dict(_FLEET, logdir=str(tmp_path))
  if kind == 'full_feature':
    kw.update(pixel_control_cost=0.01, use_instruction=True)
  else:
    kw.update(surrogate='impact', replay_k=2, replay_ratio=0.5,
              target_update_interval=4, use_instruction=False)
  config = Config(**kw)
  run = driver.train(config, device='cpu', stall_timeout_secs=60)
  state = run.state
  assert state.popart.mu.shape == (30,)
  assert run.frames >= config.total_environment_frames
  served = run.stats['prefetcher']
  if kind == 'impact_reuse':
    # The frame clock counts fresh slots at serve time: twice as many
    # learner steps as a no-reuse run (replay_k 2), and half of a
    # batch's slots replayed (ratio .5) once the tier holds unrolls.
    assert run.frames == served['fresh_slots_served'] * 5
    assert state.update_steps > 200 // config.frames_per_step
    assert served['batch_reserves'] >= state.update_steps // 2 - 1
    assert run.stats['buffer']['replay_reused_unrolls'] > 0
    assert state.target_params is not None
  else:
    assert state.update_steps == 200 // config.frames_per_step
  with open(tmp_path / 'summaries.jsonl') as f:
    tags = {json.loads(line)['tag'] for line in f}
  assert {'popart_sigma_min', 'popart_sigma_max', 'total_loss'} <= tags
  assert ('pixel_control_loss' in tags) == (kind == 'full_feature')
  assert ('impact_clip_fraction' in tags) == (kind == 'impact_reuse')


def test_anakin_runs_the_extensions():
  config = Config(mode='anakin', env_backend='bandit', torso='shallow',
                  height=H, width=W, batch_size=4, unroll_length=5,
                  num_action_repeats=1, total_environment_frames=10**6,
                  use_popart=True, pixel_control_cost=0.01,
                  use_instruction=True, use_pallas_vtrace=True)
  _, agent, step, carry = anakin.build_run(config, device='cpu')
  assert agent.instruction is not None and agent.num_popart_tasks == 1
  for _ in range(2):
    carry, metrics = step(carry)
  assert carry.train_state.popart.mu.shape == (1,)
  for key in ('pixel_control_loss', 'popart_sigma_max', 'total_loss'):
    assert np.isfinite(float(metrics[key])), key
  assert float(metrics['step_ok']) == 1.0


def test_make_train_state_takes_the_agents_columns():
  cfg = Config(**FULL)
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow', num_popart_tasks=K)
  assert learner.make_train_state(agent, cfg).popart.mu.shape == (K,)
  assert learner.make_train_state(agent, cfg, 3).popart.mu.shape == (3,)
  assert learner.make_train_state(
      agent, dataclasses.replace(cfg, use_popart=False)).popart is None


def test_resharded_restore_carries_popart_and_target(tmp_path):
  """A full-tensor save restored onto a model axis of 2: each rank's
  blocks of the params and of IMPACT's target network are sliced out of
  the file, and the PopArt statistics come back whole."""
  from scalable_agent_tpu_torch.parallel import sharding
  cfg, agent, state, ckpt = _ckpt_setup(tmp_path)
  step = learner.make_train_step_fn(agent, cfg)
  state, _ = step(state, _batches(1, seed=9)[0][1])
  assert ckpt.save(state, force=True)
  saved = learner.state_to_payload(state)
  tp_cfg = dataclasses.replace(cfg, batch_size=8, model_parallelism=2)
  registry = sharding.from_config(tp_cfg)
  shapes = {k: tuple(v.shape) for k, v in state.params.items()}
  mesh = {'data': 1, 'model': 2}
  for index in range(2):
    layout = sharding.ParamLayout(registry, shapes, mesh)
    layout.index = index
    _, _, template, _ = _ckpt_setup(tmp_path / f"rank{index}")
    blocks = layout.local_tree({k: v.detach() for k, v in
                                template.params.items()})
    blocks = {k: v.clone() for k, v in blocks.items()}
    template = learner.with_target(template._replace(
        params=blocks, opt_state=learner.rmsprop_init(blocks, tp_cfg)),
        tp_cfg)
    reader = checkpoint.Checkpointer(str(tmp_path / 'ckpt'), layout=layout)
    restored = reader.restore_latest(template)
    assert restored.update_steps == 1
    for k, v in restored.target_params.items():
      assert torch.equal(v, layout.local(k, saved['target_params'][k])), k
    for k, v in restored.params.items():
      assert torch.equal(v, layout.local(k, saved['params'][k])), k
    assert torch.equal(restored.popart.mu, saved['popart']['mu'])
    assert any(layout.cuts[k] is not None for k in blocks)
