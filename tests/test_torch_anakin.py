"""The port's Anakin trainer (scalable_agent_tpu_torch/parallel/anakin.py):
the bandit core's semantics and the overlap contract (as
tests/test_anakin.py pins them for the JAX module), slice parity with one
JAX fused step, learning on the CPU, the CLI, and the device rule.

Parity tolerances are the learner's (tests/test_torch_learner.py): loss
rtol 2e-4, params rtol 5e-4 / atol 5e-6; the replayed behaviour logits
atol 1e-5 (the agent-unroll bar of tests/test_torch_models.py).
"""

import json

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu import driver as jax_driver
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.parallel import anakin as jax_anakin
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.structs import map_structure

# Small shapes: one thread per test process is fastest, and keeps the
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _anakin_kw(**kw):
  base = dict(env_backend='bandit', batch_size=4, unroll_length=5,
              num_action_repeats=1, episode_length=4, height=24,
              width=32, torso='shallow', use_instruction=False,
              learning_rate=2e-3, entropy_cost=3e-3, discounting=0.0,
              total_environment_frames=10**6, seed=0)
  base.update(kw)
  return base


def test_bandit_core_semantics():
  """Reward iff action == dominant channel; episode_length steps per
  context; flow-style stats: the emitted info carries the running totals,
  the carried state resets at done."""
  core = anakin.BanditCore(height=8, width=8, episode_length=3,
                           num_action_repeats=2)
  state, out0 = core.init(torch.Generator().manual_seed(0), batch=4)
  assert bool(out0.done.all())  # the priming output starts an episode
  frame0 = out0.observation[0].numpy()
  assert frame0.shape == (4, 8, 8, 3) and frame0.dtype == np.uint8
  np.testing.assert_array_equal(frame0.max(axis=(1, 2)).argmax(-1),
                                state.context.numpy())

  returns = np.zeros(4, np.float32)
  for t in range(1, 7):
    target = state.context.numpy()
    action = torch.from_numpy((target + (t % 2)) % 3)  # hit/miss in turn
    prev_state = state
    state, out = core.step(state, action)
    expected_reward = (action.numpy() == target).astype(np.float32)
    np.testing.assert_array_equal(out.reward.numpy(), expected_reward)
    assert bool(np.all(out.done.numpy() == (t % 3 == 0)))
    returns += expected_reward
    np.testing.assert_array_equal(out.info.episode_return.numpy(), returns)
    assert np.all(out.info.episode_step.numpy() == (t - 1) % 3 * 2 + 2)
    if t % 3 == 0:
      returns[:] = 0.0
      assert np.all(state.episode_return.numpy() == 0.0)
    else:
      np.testing.assert_array_equal(state.context.numpy(),
                                    prev_state.context.numpy())


def test_bandit_core_wide_head_keeps_three_targets():
  core = anakin.BanditCore(num_actions=9)
  state, _ = core.init(torch.Generator().manual_seed(1), batch=256)
  assert int(state.context.max()) <= 2
  assert len(torch.unique(state.context)) == 3


def test_overlap_contract_between_fused_steps():
  """Timestep 0 of each unroll == the last timestep of the previous one,
  and the batch is [T+1, B] time-major."""
  cfg = Config(**_anakin_kw(batch_size=2, unroll_length=3))
  core = anakin.make_env_core(cfg)
  from scalable_agent_tpu_torch import driver
  agent = driver.build_agent(cfg, core.num_actions)
  step = anakin.make_anakin_step(agent, core, cfg, return_batch=True)
  carry = anakin.init_carry(agent, core, cfg, 0, 'cpu')
  carry, m1 = step(carry)
  carry, m2 = step(carry)
  b1, b2 = m1['batch'], m2['batch']
  t1 = cfg.unroll_length + 1
  assert b1.env_outputs.reward.shape == (t1, cfg.batch_size)
  assert b1.agent_outputs.policy_logits.shape == (t1, cfg.batch_size,
                                                  core.num_actions)
  leaves = []
  map_structure(lambda x, y: leaves.append((x, y)),
                (b1.env_outputs, b1.agent_outputs),
                (b2.env_outputs, b2.agent_outputs))
  assert len(leaves) == 9
  for leaf1, leaf2 in leaves:
    assert torch.equal(leaf1[-1], leaf2[0])
  assert carry.train_state.update_steps == 2


def _port_train_state(agent, jax_state):
  """The port's TrainState holding a JAX TrainState's optimizer state."""
  rms, schedule, _ = jax_state.opt_state
  nu = convert.params_from_jax(rms.nu)
  del nu['core.bias_ih']  # a buffer in the port, not a parameter
  return learner.TrainState(
      params=dict(agent.named_parameters()),
      opt_state=learner.RMSPropState(
          count=torch.tensor(int(schedule.count), dtype=torch.int32),
          nu=nu),
      update_steps=int(jax_state.update_steps))


def _to_torch(tree):
  return map_structure(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize('use_pallas_vtrace', [False, True])
def test_slice_parity_with_one_jax_fused_step(use_pallas_vtrace):
  """One JAX fused step (act T steps, assemble [T+1, B], train): its
  pre-update params, converted, go through the port's train step on the
  JAX batch and must give JAX's metrics and new params; the port's agent
  replayed over the batch reproduces JAX's behaviour logits for t >= 1."""
  kw = _anakin_kw(torso='deep', num_actions=9,
                  use_pallas_vtrace=use_pallas_vtrace, discounting=0.9,
                  learning_rate=0.00048)
  jcfg, cfg = JaxConfig(**kw), Config(**kw)
  jcore = jax_anakin.make_env_core(jcfg)
  jagent = jax_driver.build_agent(jcfg, jcore.num_actions)
  jstep = jax_anakin.make_anakin_step(jagent, jcore, jcfg,
                                      return_batch=True)
  jcarry = jax_anakin.init_carry(jagent, jcore, jcfg,
                                 jax.random.PRNGKey(0))
  # A second JAX step acts from a nonzero carry with an overlap frame.
  jcarry, _ = jstep(jcarry)
  pre_state = jax.device_get(jcarry.train_state)
  jcarry, jm = jstep(jcarry)
  jm = jax.device_get(jm)
  batch = _to_torch(jm['batch'])

  agent = ImpalaAgent(9, (24, 32, 3), torso='deep')
  agent.load_state_dict(convert.params_from_jax(pre_state.params))
  with torch.no_grad():
    replay, _ = agent(batch.agent_outputs.action, batch.env_outputs,
                      batch.agent_state)
  np.testing.assert_allclose(replay.policy_logits[:-1].numpy(),
                             batch.agent_outputs.policy_logits[1:].numpy(),
                             atol=1e-5)
  np.testing.assert_allclose(replay.baseline[:-1].numpy(),
                             batch.agent_outputs.baseline[1:].numpy(),
                             atol=1e-5)

  state = _port_train_state(agent, pre_state)
  vtrace_cuda.from_importance_weights.launches = 0
  state, m = learner.make_train_step_fn(agent, cfg)(state, batch)
  assert vtrace_cuda.from_importance_weights.launches == 0  # CPU: twin
  for key in ('total_loss', 'grad_norm', 'learning_rate'):
    np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4,
                               err_msg=key)
  np.testing.assert_allclose(
      float(jm['mean_reward']),
      float(batch.env_outputs.reward[1:].mean()), rtol=1e-6)
  ref = convert.params_from_jax(jax.device_get(jcarry.train_state.params))
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=k)


def test_port_run_learns_the_bandit_on_cpu():
  """The fused loop drives the bandit to near-optimal mean reward
  (random = 1/3, optimal = 1.0), as the JAX loop does."""
  carry, history, fps = anakin.run(Config(**_anakin_kw(batch_size=8)), 150,
                                   device='cpu')
  rewards = [h['mean_reward'] for h in history]
  assert all(np.isfinite(h['total_loss']) for h in history)
  assert np.mean(rewards[-10:]) > 0.8, rewards[-10:]
  assert carry.train_state.update_steps == 150
  assert fps > 0


def test_cli_trains_and_writes_summaries(tmp_path):
  logdir = tmp_path / 'run'
  carry = experiment.main([
      '--mode=anakin', '--device=cpu', '--env_backend=bandit',
      '--torso=shallow', '--batch_size=2', '--unroll_length=4',
      '--num_action_repeats=1', '--height=24', '--width=32',
      '--num_actions=9', '--use_pallas_vtrace', '--use_instruction=false',
      '--total_environment_frames=16', '--summary_secs=0',
      f'--logdir={logdir}'])
  assert carry.train_state.update_steps == 2
  events = [json.loads(line) for line in open(logdir / 'summaries.jsonl')]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  assert losses and all(np.isfinite(losses))
  assert {'mean_reward', 'learning_rate', 'env_frames_per_sec'} <= {
      e['tag'] for e in events}
  saved = json.load(open(logdir / 'config.json'))
  assert saved['num_actions'] == 9 and saved['use_pallas_vtrace'] is True


@pytest.mark.parametrize('mode', ['test'])
def test_cli_other_modes_name_their_slice(mode, tmp_path):
  """--mode=test is evaluation (A7.1): with no checkpoint in the logdir
  it raises FileNotFoundError, as the JAX evaluate does."""
  with pytest.raises(FileNotFoundError, match='no checkpoint'):
    experiment.main([f'--mode={mode}', '--device=cpu',
                     '--env_backend=fake', '--torso=shallow',
                     '--height=24', '--width=32', '--use_instruction=false',
                     f'--logdir={tmp_path}'])


_SMALL_FLEET_FLAGS = [
    '--device=cpu', '--env_backend=bandit', '--torso=shallow',
    '--batch_size=2', '--num_actors=2', '--unroll_length=4',
    '--num_action_repeats=1', '--height=24', '--width=32',
    '--use_instruction=false', '--use_py_process=false',
    '--inference_timeout_ms=5', '--total_environment_frames=16',
    '--summary_secs=0']


def test_cli_train_runs_the_fleet_runtime(tmp_path):
  run = experiment.main(['--mode=train', '--runtime=fleet',
                         f'--logdir={tmp_path}'] + _SMALL_FLEET_FLAGS)
  assert run.state.update_steps == 2 and run.frames == 16
  events = [json.loads(line) for line in open(tmp_path / 'summaries.jsonl')]
  losses = [e['value'] for e in events if e['tag'] == 'total_loss']
  assert len(losses) == 2 and all(np.isfinite(losses))
  assert {'env_frames_per_sec', 'inference_mean_batch'} <= {
      e['tag'] for e in events}


def test_cli_train_with_runtime_anakin_runs_anakin(tmp_path):
  carry = experiment.main(['--mode=train', '--runtime=anakin',
                           f'--logdir={tmp_path}'] + _SMALL_FLEET_FLAGS)
  assert carry.train_state.update_steps == 2
  tags = {json.loads(line)['tag']
          for line in open(tmp_path / 'summaries.jsonl')}
  assert 'mean_reward' in tags


def test_entry_points_raise_without_cuda(tmp_path):
  """The default device is CUDA, and without it the entry points raise:
  they never fall back to the CPU."""
  if torch.cuda.is_available():
    pytest.skip('this machine has CUDA: the default device is usable')
  cfg = Config(**_anakin_kw(logdir=str(tmp_path)))
  with pytest.raises(RuntimeError, match='cuda'):
    anakin.run(cfg, 2)
  with pytest.raises(RuntimeError, match='cuda'):
    anakin.train(cfg, max_steps=1)
  with pytest.raises(RuntimeError, match='cuda'):
    experiment.main(['--mode=anakin', '--env_backend=bandit',
                     f'--logdir={tmp_path}'])
  with pytest.raises(RuntimeError, match='cuda'):
    driver.train(cfg, max_steps=1)
  with pytest.raises(RuntimeError, match='cuda'):
    experiment.main(['--mode=train', '--env_backend=bandit',
                     '--use_instruction=false', f'--logdir={tmp_path}'])


def test_unported_env_cores_raise():
  """A backend with no on-device core raises; cue_memory, refused before
  its slice, builds (at its fixed 3 actions) and steps."""
  core = anakin.make_env_core(Config(**_anakin_kw(env_backend='cue_memory')))
  assert isinstance(core, anakin.CueMemoryCore) and core.num_actions == 3
  state, out = core.init(torch.Generator().manual_seed(0), 4)
  state, out = core.step(state, torch.zeros(4, dtype=torch.int64))
  assert out.reward.tolist() == [2.0] * 4 and not out.done.any()
  with pytest.raises(ValueError, match='3-action'):
    anakin.make_env_core(Config(**_anakin_kw(env_backend='cue_memory',
                                             num_actions=9)))
  with pytest.raises(ValueError, match='on-device env core'):
    anakin.make_env_core(Config(**_anakin_kw(env_backend='dmlab')))


@pytest.mark.parametrize('backend, extra', [
    ('cue_memory', dict(episode_length=2)), ('gridworld', {}),
    ('procgen', dict(curriculum='td'))])
def test_the_other_cores_train(backend, extra):
  """Three fused steps of each other core through anakin.run: finite
  losses, and on procgen the curriculum's metrics."""
  carry, history, _ = anakin.run(
      Config(**_anakin_kw(env_backend=backend, **extra)), 3, device='cpu')
  assert carry.train_state.update_steps == 3
  assert all(np.isfinite(h['total_loss']) for h in history)
  curriculum = {k for k in history[-1] if k.startswith('curriculum_')}
  assert curriculum == ({'curriculum_entropy', 'curriculum_score_mean',
                         'curriculum_score_max', 'curriculum_levels_visited'}
                        if backend == 'procgen' else set())
