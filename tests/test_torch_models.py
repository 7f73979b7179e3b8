"""The port's torsos and agent (scalable_agent_tpu_torch/models) against the
JAX package's, on weights converted by `convert.params_from_jax`.

Inputs come from numpy seeds and go through both packages, float32 on the
CPU. Tolerances: torsos rtol 1e-5 (the same convolutions summed in
another order); the agent unroll atol 1e-5 (five LSTM steps on top).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import structs as jax_structs
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu.models import torsos as jax_torsos
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.models import torsos
from scalable_agent_tpu_torch.structs import (AgentOutput, StepOutput,
                                              StepOutputInfo)

# Small shapes: one thread per test process is fastest, and keeps the
# parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

NUM_ACTIONS = 9


def _jax_agent(torso, height, width, seed=0):
  agent = jax_agent.ImpalaAgent(num_actions=NUM_ACTIONS, torso=torso,
                                use_instruction=False)
  params = jax_init_params(agent, jax.random.PRNGKey(seed),
                           {'frame': (height, width, 3), 'instr_len': 16})
  return agent, params


def _port_agent(torso, height, width, flax_params):
  agent = ImpalaAgent(NUM_ACTIONS, (height, width, 3), torso=torso)
  agent.load_state_dict(convert.params_from_jax(jax.device_get(flax_params)))
  return agent


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
@pytest.mark.parametrize('size', [(24, 32), (21, 27)], ids=str)
def test_torso_matches_flax(torso, size):
  """(21, 27) is odd at 21, 27, 11 and 7: the SAME pool pads (1, 1) there
  and (0, 1) at the even sizes, which max_pool2d(padding=1) gets wrong."""
  height, width = size
  _, params = _jax_agent(torso, height, width)
  agent = _port_agent(torso, height, width, params)
  frames = np.random.RandomState(1).randint(
      0, 256, size=(6, height, width, 3)).astype(np.uint8)
  name = {'deep': 'DeepResNetTorso', 'shallow': 'ShallowTorso'}[torso]
  ref = jax_torsos.TORSOS[torso]().apply(
      {'params': params['params'][name + '_0']}, jnp.asarray(frames))
  with torch.no_grad():
    out = agent.torso(torch.from_numpy(frames))
  assert out.shape == (6, 256)
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                             atol=1e-6)


@pytest.mark.parametrize('size', [(72, 96), (21, 27)], ids=str)
def test_deep_fast_torso_matches_flax(size):
  """deep_fast's stride-2 SAME convs: (0, 1) padding at 72x96 (every
  stage even), (1, 1) at 21x27; N=2, atol 1e-5 against Flax's
  DeepFastTorso on the converted weights."""
  height, width = size
  _, params = _jax_agent('deep_fast', height, width, seed=4)
  assert 'DeepFastTorso_0' in params['params']
  agent = _port_agent('deep_fast', height, width, params)
  frames = np.random.RandomState(2).randint(
      0, 256, size=(2, height, width, 3)).astype(np.uint8)
  ref = jax_torsos.DeepFastTorso().apply(
      {'params': params['params']['DeepFastTorso_0']}, jnp.asarray(frames))
  with torch.no_grad():
    out = agent.torso(torch.from_numpy(frames))
  np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
  assert torsos.same_pads(72, 3, 2) == (0, 1)
  assert torsos.same_pads(21, 3, 2) == (1, 1)


def test_deep_fast_has_the_deep_param_tree():
  """deep_fast's parameters are deep's, by name and shape, in both
  packages, so params_from_jax, the sharding rules and the blocked TP
  layers apply unchanged: the megatron registry gives each of its leaves
  JAX's spec. (The port's manifest names the torso DeepResNetTorso_0 for
  both: a port parameter name does not say which of the two it is.)"""
  from scalable_agent_tpu.parallel import sharding as jax_sharding
  from scalable_agent_tpu_torch.parallel import sharding
  _, fast = _jax_agent('deep_fast', 24, 32)
  _, deep = _jax_agent('deep', 24, 32)
  shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa: E731
  assert shapes(fast['params']['DeepFastTorso_0']) == shapes(
      deep['params']['DeepResNetTorso_0'])
  port_fast = _port_agent('deep_fast', 24, 32, fast)
  port_deep = ImpalaAgent(NUM_ACTIONS, (24, 32, 3), torso='deep')
  assert {k: v.shape for k, v in port_fast.named_parameters()} == {
      k: v.shape for k, v in port_deep.named_parameters()}
  rules = jax_sharding.RULE_SETS['megatron']
  want = jax_sharding.ShardingRegistry(rules, 'megatron').describe(fast)
  got = sharding.ShardingRegistry(sharding.RULE_SETS['megatron'],
                                  'megatron').describe(
                                      dict(port_fast.named_parameters()))
  assert got == {k.replace('DeepFastTorso_0', 'DeepResNetTorso_0'): v
                 for k, v in want.items()}


def test_same_pool_pads_like_xla():
  assert torsos.same_pads(72, 3, 2) == (0, 1)
  assert torsos.same_pads(9, 3, 2) == (1, 1)
  x = torch.arange(16.0).reshape(1, 1, 4, 4)
  ref = jax.lax.reduce_window(
      jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 1, 3, 3),
      (1, 1, 2, 2), 'SAME')
  np.testing.assert_array_equal(torsos.max_pool_same(x).numpy(),
                                np.asarray(ref))


def _unroll_inputs(t, b, height, width, seed=2):
  rng = np.random.RandomState(seed)
  done = np.zeros((t, b), bool)
  done[2, 0] = True      # a mid-unroll episode start
  done[3, 2] = True
  return dict(
      reward=(rng.randn(t, b) * 2).astype(np.float32),  # clipping bites
      episode_return=np.zeros((t, b), np.float32),
      episode_step=np.zeros((t, b), np.int32),
      done=done,
      frame=rng.randint(0, 256, size=(t, b, height, width, 3)).astype(
          np.uint8),
      instr=np.zeros((t, b, 16), np.int32),
      prev_actions=rng.randint(0, NUM_ACTIONS, size=(t, b)),
      c=rng.randn(b, 256).astype(np.float32) * 0.5,
      h=rng.randn(b, 256).astype(np.float32) * 0.5)


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_agent_unroll_matches_flax(torso):
  t, b, height, width = 5, 3, 24, 32
  jagent, params = _jax_agent(torso, height, width, seed=3)
  agent = _port_agent(torso, height, width, params)
  x = _unroll_inputs(t, b, height, width)

  ref_out, (ref_c, ref_h) = jagent.apply(
      params, jnp.asarray(x['prev_actions'], jnp.int32),
      jax_structs.StepOutput(
          reward=jnp.asarray(x['reward']),
          info=jax_structs.StepOutputInfo(jnp.asarray(x['episode_return']),
                                          jnp.asarray(x['episode_step'])),
          done=jnp.asarray(x['done']),
          observation=(jnp.asarray(x['frame']), jnp.asarray(x['instr']))),
      (jnp.asarray(x['c']), jnp.asarray(x['h'])))

  tt = lambda k: torch.from_numpy(x[k])  # noqa: E731
  with torch.no_grad():
    out, (c, h) = agent(
        tt('prev_actions'),
        StepOutput(tt('reward'),
                   StepOutputInfo(tt('episode_return'), tt('episode_step')),
                   tt('done'), (tt('frame'), tt('instr'))),
        (tt('c'), tt('h')))
  np.testing.assert_allclose(out.policy_logits.numpy(),
                             np.asarray(ref_out.policy_logits), atol=1e-5)
  np.testing.assert_allclose(out.baseline.numpy(),
                             np.asarray(ref_out.baseline), atol=1e-5)
  np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), atol=1e-5)
  np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-5)
  np.testing.assert_array_equal(out.action.numpy(),
                                np.asarray(ref_out.action))


def test_parameters_mirror_flax_and_init_statistics():
  """The converted tree fills exactly the agent's parameters (bias_ih is a
  buffer: Flax's LSTM has one bias), and init_params draws Flax's
  initialisers: zero biases, lecun-normal kernels, orthogonal recurrent
  gate blocks."""
  _, params = _jax_agent('deep', 72, 96)
  agent = ImpalaAgent(NUM_ACTIONS, (72, 96, 3), torso='deep')
  converted = convert.params_from_jax(jax.device_get(params))
  state = agent.state_dict()
  assert set(converted) == set(state)
  for k, v in converted.items():
    assert v.shape == state[k].shape, k
  n_flax = sum(x.size for x in jax.tree_util.tree_leaves(params))
  assert sum(p.numel() for p in agent.parameters()) == n_flax

  init_params(agent, torch.Generator().manual_seed(0))
  for name, p in agent.named_parameters():
    if name.endswith('bias') or name.endswith('bias_hh'):
      assert torch.count_nonzero(p) == 0, name
  w = agent.torso.linear.weight.detach()
  assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1.0) < 0.05
  hh = agent.core.weight_hh.detach()
  for gate in range(4):
    block = hh[gate * 256:(gate + 1) * 256]
    torch.testing.assert_close(block @ block.T, torch.eye(256), atol=1e-4,
                               rtol=0)
  # Same seed, same params: the init does not depend on anything else.
  again = ImpalaAgent(NUM_ACTIONS, (72, 96, 3), torso='deep')
  init_params(again, torch.Generator().manual_seed(0))
  for (_, a), (_, b) in zip(agent.named_parameters(),
                            again.named_parameters()):
    assert torch.equal(a, b)


def test_step_fn_samples_with_a_generator():
  from scalable_agent_tpu_torch.models.agent import make_step_fn
  agent = ImpalaAgent(NUM_ACTIONS, (24, 32, 3), torso='shallow')
  init_params(agent, torch.Generator().manual_seed(0))
  b = 64
  env_output = StepOutput(
      torch.zeros(b), StepOutputInfo(torch.zeros(b), torch.zeros(b)),
      torch.ones(b, dtype=torch.bool),
      (torch.zeros(b, 24, 32, 3, dtype=torch.uint8),
       torch.zeros(b, 16, dtype=torch.int32)))
  step = make_step_fn(agent)
  state = agent.initial_state(b)
  out1, _ = step(torch.Generator().manual_seed(5), torch.zeros(b), env_output,
                 state)
  out2, _ = step(torch.Generator().manual_seed(5), torch.zeros(b), env_output,
                 state)
  assert isinstance(out1, AgentOutput)
  assert out1.action.shape == (b,) and out1.policy_logits.shape == (
      b, NUM_ACTIONS)
  assert torch.equal(out1.action, out2.action)  # seeded: reproducible
  # Sampled, not argmax: near-uniform logits spread the actions.
  assert len(torch.unique(out1.action)) > 3
  assert not out1.policy_logits.requires_grad


@pytest.mark.parametrize('runtime, dtype', [('anakin', 'float32'),
                                            ('fleet', 'bfloat16')])
def test_deep_fast_trains_in_both_runtimes(tmp_path, runtime, dtype):
  """torso=deep_fast through driver.train: the Anakin runtime in float32
  and the fleet in bf16, 2 steps each, finite losses."""
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch.config import Config
  config = Config(runtime=runtime, env_backend='bandit', torso='deep_fast',
                  compute_dtype=dtype, height=24, width=32, batch_size=2,
                  unroll_length=3, num_action_repeats=1, num_actors=2,
                  use_py_process=False, use_instruction=False,
                  total_environment_frames=10**6, summary_secs=0,
                  logdir=str(tmp_path))
  run = driver.train(config, max_steps=2, device='cpu',
                     stall_timeout_secs=60)
  assert run.state.update_steps == 2
  assert isinstance(run.agent.torso, torsos.DeepFastTorso)
  assert all(torch.isfinite(p).all() for p in run.state.params.values())
