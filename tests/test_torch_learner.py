"""The port's learner (scalable_agent_tpu_torch/learner.py) against the JAX
package's: alignment, reward clipping, the schedule, the hand-written
RMSProp against optax, the train step on one fixed batch with converted
weights, and the health watchdog.

Tolerances: align/clip/schedule exact or rtol 1e-6 (the same float32
arithmetic); RMSProp rtol 1e-6 (the same update formula); the 3-step train
step loss rtol 2e-4 and params rtol 5e-4 / atol 5e-6, the bar of the JAX
package's own sharded-step parity gates (a deep torso's gradients summed
in another order, through RMSProp's 1/sqrt).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import learner as jax_learner
from scalable_agent_tpu import structs as jax_structs
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)

# Small shapes: one thread per test process is fastest, and keeps the
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)


def _both_configs(**kw):
  return JaxConfig(**kw), Config(**kw)


def test_align_batch_shifts_like_jax():
  t1, b, a = 5, 2, 3
  rng = np.random.RandomState(0)
  reward = rng.randn(t1, b).astype(np.float32) * 3
  done = rng.rand(t1, b) > 0.6
  action = rng.randint(0, a, size=(t1, b))
  logits = rng.randn(t1, b, a).astype(np.float32)
  base = rng.randn(t1, b).astype(np.float32)
  jcfg, cfg = _both_configs(reward_clipping='abs_one', discounting=0.9)
  ref = jax_learner.align_batch(
      jax_structs.StepOutput(jnp.asarray(reward), None, jnp.asarray(done),
                             None),
      jax_structs.AgentOutput(jnp.asarray(action), jnp.asarray(logits),
                              jnp.asarray(base)),
      jax_structs.AgentOutput(jnp.asarray(action), -jnp.asarray(logits),
                              -jnp.asarray(base)), jcfg)
  out = learner.align_batch(
      StepOutput(torch.from_numpy(reward), None, torch.from_numpy(done),
                 None),
      AgentOutput(torch.from_numpy(action), torch.from_numpy(logits),
                  torch.from_numpy(base)),
      AgentOutput(torch.from_numpy(action), -torch.from_numpy(logits),
                  -torch.from_numpy(base)), cfg)
  for field in ref._fields:
    np.testing.assert_array_equal(getattr(out, field).numpy(),
                                  np.asarray(getattr(ref, field)),
                                  err_msg=field)
  assert out.rewards.shape == (t1 - 1, b)


@pytest.mark.parametrize('mode', ['abs_one', 'soft_asymmetric', 'none'])
def test_clip_rewards_matches_jax(mode):
  r = np.asarray([-10.0, -5.0, -0.5, 0.0, 0.5, 5.0, 10.0], np.float32)
  np.testing.assert_allclose(
      learner.clip_rewards(torch.from_numpy(r), mode).numpy(),
      np.asarray(jax_learner.clip_rewards(jnp.asarray(r), mode)),
      rtol=1e-6)


def test_clip_rewards_unknown_raises():
  with pytest.raises(ValueError):
    learner.clip_rewards(torch.zeros(1), 'bogus')


@pytest.mark.parametrize('count', [0, 1, 5, 7, 1000])
def test_schedule_matches_jax(count):
  kw = dict(batch_size=2, unroll_length=10, num_action_repeats=4,
            total_environment_frames=800, learning_rate=0.1)
  jcfg, cfg = _both_configs(**kw)
  assert cfg.frames_per_step == 80
  ref = float(jax_learner.make_schedule(jcfg)(jnp.asarray(count,
                                                          jnp.int32)))
  got = float(learner.make_schedule(cfg)(count))
  np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-12)
  assert got >= 0.0


@pytest.mark.parametrize('extra', [{}, {'momentum': 0.9},
                                   {'grad_clip_norm': 0.5}], ids=str)
def test_rmsprop_matches_optax(extra):
  """optax puts eps inside the sqrt; torch.optim.RMSprop does not. Three
  updates through the decaying schedule, against optax itself."""
  kw = dict(learning_rate=0.01, decay=0.99, epsilon=0.1, batch_size=2,
            unroll_length=5, num_action_repeats=1,
            total_environment_frames=50, **extra)
  jcfg, cfg = _both_configs(**kw)
  rng = np.random.RandomState(4)
  params = {'w': rng.randn(4, 3).astype(np.float32),
            'b': rng.randn(3).astype(np.float32)}
  grads = [{k: (rng.randn(*v.shape) * 2).astype(np.float32)
            for k, v in params.items()} for _ in range(3)]

  opt = jax_learner.make_optimizer(jcfg)
  jparams = {k: jnp.asarray(v) for k, v in params.items()}
  jstate = opt.init(jparams)
  tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
  tstate = learner.rmsprop_init(tparams, cfg)
  schedule = learner.make_schedule(cfg)
  for g in grads:
    updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 jstate, jparams)
    jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    tupdates, tstate = learner.rmsprop_update(
        {k: torch.from_numpy(v) for k, v in g.items()}, tstate, cfg,
        schedule)
    tparams = {k: p + tupdates[k] for k, p in tparams.items()}
    for k in params:
      np.testing.assert_allclose(tupdates[k].numpy(),
                                 np.asarray(updates[k]), rtol=1e-6,
                                 atol=1e-9)
      np.testing.assert_allclose(tparams[k].numpy(),
                                 np.asarray(jparams[k]), rtol=1e-6)
  assert int(tstate.count) == 3


T, B, A, H, W = 5, 3, 9, 24, 32


def _fixed_batch(seed=0, nan_reward=False):
  """A [T+1, B] ActorOutput as numpy arrays (behaviour logits random, so
  the V-trace corrections are off-policy)."""
  rng = np.random.RandomState(seed)
  done = rng.rand(T + 1, B) > 0.8
  reward = rng.randn(T + 1, B).astype(np.float32)
  if nan_reward:
    reward[2, 1] = np.nan
  return dict(
      level_name=np.zeros(B, np.int32),
      c=rng.randn(B, 256).astype(np.float32) * 0.3,
      h=rng.randn(B, 256).astype(np.float32) * 0.3,
      reward=reward,
      episode_return=np.zeros((T + 1, B), np.float32),
      episode_step=np.zeros((T + 1, B), np.int32),
      done=done,
      frame=rng.randint(0, 256, size=(T + 1, B, H, W, 3)).astype(np.uint8),
      instr=np.zeros((T + 1, B, 16), np.int32),
      action=rng.randint(0, A, size=(T + 1, B)),
      policy_logits=rng.randn(T + 1, B, A).astype(np.float32),
      baseline=rng.randn(T + 1, B).astype(np.float32))


def _jax_batch(x):
  j = {k: jnp.asarray(v) for k, v in x.items()}
  return jax_structs.ActorOutput(
      level_name=j['level_name'], agent_state=(j['c'], j['h']),
      env_outputs=jax_structs.StepOutput(
          j['reward'],
          jax_structs.StepOutputInfo(j['episode_return'], j['episode_step']),
          j['done'], (j['frame'], j['instr'])),
      agent_outputs=jax_structs.AgentOutput(
          j['action'].astype(jnp.int32), j['policy_logits'], j['baseline']))


def _torch_batch(x):
  t = {k: torch.from_numpy(v) for k, v in x.items()}
  return ActorOutput(
      level_name=t['level_name'], agent_state=(t['c'], t['h']),
      env_outputs=StepOutput(
          t['reward'], StepOutputInfo(t['episode_return'],
                                      t['episode_step']),
          t['done'], (t['frame'], t['instr'])),
      agent_outputs=AgentOutput(t['action'], t['policy_logits'],
                                t['baseline']))


def _setup(config_kw, seed=0):
  jcfg, cfg = _both_configs(**config_kw)
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso=cfg.torso,
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(seed),
                           {'frame': (H, W, 3), 'instr_len': 16})
  agent = ImpalaAgent(A, (H, W, 3), torso=cfg.torso)
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  return jcfg, cfg, jagent, params, agent


_BASE = dict(torso='deep', batch_size=B, unroll_length=T,
             num_action_repeats=1, total_environment_frames=60, use_instruction=False)


@pytest.mark.parametrize('extra', [{}, {'use_pallas_vtrace': True},
                                   {'grad_clip_norm': 1.0,
                                    'reward_clipping': 'soft_asymmetric'}],
                         ids=['plain', 'fused', 'clip'])
def test_train_step_matches_jax_over_three_steps(extra):
  jcfg, cfg, jagent, params, agent = _setup({**_BASE, **extra})
  x = _fixed_batch()
  jstep = jax_learner.make_train_step(jagent, jcfg)
  jstate = jax_learner.make_train_state(params, jcfg)
  step = learner.make_train_step_fn(agent, cfg)
  state = learner.make_train_state(agent, cfg)
  initial = {k: v.detach().clone() for k, v in state.params.items()}
  for i in range(3):
    jstate, jm = jstep(jstate, _jax_batch(x))
    state, m = step(state, _torch_batch(x))
    for key in ('total_loss', 'grad_norm', 'learning_rate'):
      np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4,
                                 err_msg=f'step {i} {key}')
    # pg_loss sums terms of both signs, so its relative error can exceed
    # the total's: each component is held to 2e-4 of the loss scale.
    scale = sum(abs(float(jm[k])) for k in ('pg_loss', 'baseline_loss',
                                            'entropy_loss'))
    for key in ('pg_loss', 'baseline_loss', 'entropy_loss'):
      np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=0,
                                 atol=2e-4 * scale,
                                 err_msg=f'step {i} {key}')
    assert float(m['step_ok']) == 1.0
  assert state.update_steps == 3 == int(jstate.update_steps)
  ref = convert.params_from_jax(jax.device_get(jstate.params))
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=k)
    # The updates themselves, not only the params they moved.
    moved = (p.detach() - initial[k]).numpy()
    ref_moved = ref[k].numpy() - initial[k].numpy()
    np.testing.assert_allclose(moved, ref_moved, rtol=5e-2, atol=2e-6,
                               err_msg=k)
  assert any(float((p.detach() - initial[k]).abs().max()) > 1e-4
             for k, p in state.params.items())


def test_watchdog_keeps_old_state_on_a_nan_batch():
  _, cfg, _, _, agent = _setup(dict(_BASE, torso='shallow'))
  step = learner.make_train_step_fn(agent, cfg)
  state = learner.make_train_state(agent, cfg)
  state, m = step(state, _torch_batch(_fixed_batch(seed=1)))
  assert float(m['step_ok']) == 1.0
  before = {k: v.detach().clone() for k, v in state.params.items()}
  nu_before = {k: v.clone() for k, v in state.opt_state.nu.items()}
  state, m = step(state, _torch_batch(_fixed_batch(seed=2,
                                                   nan_reward=True)))
  assert not np.isfinite(float(m['total_loss']))
  assert float(m['step_ok']) == 0.0
  assert state.update_steps == 2           # the clock still advances
  assert int(state.opt_state.count) == 1   # the optimizer's does not
  for k, p in state.params.items():
    assert torch.equal(p.detach(), before[k]), k
    assert torch.equal(state.opt_state.nu[k], nu_before[k]), k
  # And agent's own parameters are those params.
  assert all(p is state.params[k] for k, p in agent.named_parameters())


def test_unported_settings_raise():
  for kw in ({'curriculum': 'regret'}, {'torso': 'deep_fast'}):
    with pytest.raises(NotImplementedError, match='not in the PyTorch'):
      Config(**kw)
  # The learner extensions are ported: the config takes them.
  for kw in ({'use_popart': True}, {'pixel_control_cost': 0.1},
             {'surrogate': 'impact'}, {'replay_k': 2},
             {'replay_ratio': 0.5}, {'use_instruction': True},
             {'level_name': 'dmlab30'}):
    Config(**kw)
  with pytest.raises(ValueError, match='mutually exclusive'):
    Config(use_pallas_vtrace=True, use_associative_scan=True)
  # The field names and defaults are the JAX package's.
  jax_defaults = dataclasses.asdict(JaxConfig())
  for field, value in dataclasses.asdict(Config()).items():
    assert jax_defaults[field] == value, field
