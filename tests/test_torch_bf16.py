"""The port at `compute_dtype='bfloat16'` against the JAX package at
`dtype=jnp.bfloat16`, on weights converted by `convert.params_from_jax`.

bfloat16 rounds at other points in XLA:CPU (which may keep excess
precision inside a fusion) than in PyTorch's eager ops (which round after
each op), so the two bf16 results are held to bf16's own error. For every
compared tensor both of these hold:

  max|port_bf16 - jax_bf16| <= 2 * max|jax_bf16 - jax_f32| + 1e-3
  max|port_bf16 - jax_bf16| <= rtol * max|jax_f32|, rtol = 2**-5

The first says the two ports of the bf16 model disagree by no more than
twice the distance of the reference's bf16 model from its float32 one;
the second, set from the measured margin, caps that at four bf16 ulps of
the output's scale. Measured on the CPU: torsos max|port - jax_bf16|
0.0156 (deep, 24x32; bound 0.042) and 0 at the other three; the agent
unroll 0.0039 on the deep agent's logits (bound 0.0093), at most 0.0104
of the output's scale over logits, baseline, c and h; the train step's
loss after two steps 0.0194 (bound 0.0348).

The train step's parameter updates (lr * g / sqrt(nu + eps), of order
1e-4) are held by the same two rules with 1e-3 of the largest float32
update in place of the absolute 1e-3, and rtol 0.25: measured at most
0.092 of the largest float32 update, RMSProp's 1/sqrt passing on the
gradients' bf16 error.
"""

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
from scalable_agent_tpu.models import torsos as jax_torsos
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo
from tests.test_torch_learner import _fixed_batch, _jax_batch, _torch_batch
from tests.test_torch_models import _unroll_inputs

torch.set_num_threads(1)

NUM_ACTIONS = 9
BF16 = torch.bfloat16


def _assert_within_bf16_error(port, jax_bf16, jax_f32, what, atol=1e-3,
                              rtol=2**-5):
  port, jax_bf16, jax_f32 = (np.asarray(x, np.float32)
                             for x in (port, jax_bf16, jax_f32))
  err = float(np.max(np.abs(port - jax_bf16)))
  bound = 2 * float(np.max(np.abs(jax_bf16 - jax_f32))) + atol
  assert err <= bound, f'{what}: max|port - jax_bf16| {err} > {bound}'
  scale = float(np.max(np.abs(jax_f32)))
  assert err <= rtol * scale, (f'{what}: max|port - jax_bf16| {err} > '
                               f'{rtol} * max|jax_f32| {scale}')


def _flax_params(torso, height, width, seed=0):
  agent = jax_agent.ImpalaAgent(num_actions=NUM_ACTIONS, torso=torso,
                                use_instruction=False)
  return jax_init_params(agent, jax.random.PRNGKey(seed),
                         {'frame': (height, width, 3), 'instr_len': 16})


def _port_agent(torso, height, width, flax_params, dtype=BF16):
  agent = ImpalaAgent(NUM_ACTIONS, (height, width, 3), torso=torso,
                      dtype=dtype)
  agent.load_state_dict(convert.params_from_jax(jax.device_get(flax_params)))
  return agent


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
@pytest.mark.parametrize('size', [(24, 32), (21, 27)], ids=str)
def test_bf16_torso_matches_flax(torso, size):
  height, width = size
  params = _flax_params(torso, height, width)
  agent = _port_agent(torso, height, width, params)
  frames = np.random.RandomState(1).randint(
      0, 256, size=(6, height, width, 3)).astype(np.uint8)
  name = {'deep': 'DeepResNetTorso', 'shallow': 'ShallowTorso'}[torso]
  tree = {'params': params['params'][name + '_0']}
  refs = {dtype: jax_torsos.TORSOS[torso](dtype=dtype).apply(
      tree, jnp.asarray(frames)).astype(jnp.float32)
          for dtype in (jnp.bfloat16, jnp.float32)}
  with torch.no_grad():
    out = agent.torso(torch.from_numpy(frames))
  assert out.dtype == BF16 and out.shape == (6, 256)
  _assert_within_bf16_error(out.float(), refs[jnp.bfloat16],
                            refs[jnp.float32], f'{torso} torso')


@pytest.mark.parametrize('torso', ['deep', 'shallow'])
def test_bf16_agent_unroll_matches_flax(torso):
  t, b, height, width = 5, 3, 24, 32
  params = _flax_params(torso, height, width, seed=3)
  agent = _port_agent(torso, height, width, params)
  x = _unroll_inputs(t, b, height, width)
  refs = {}
  for dtype in (jnp.bfloat16, jnp.float32):
    jagent = jax_agent.ImpalaAgent(num_actions=NUM_ACTIONS, torso=torso,
                                   use_instruction=False, dtype=dtype)
    out, carry = jagent.apply(
        params, jnp.asarray(x['prev_actions'], jnp.int32),
        jax_structs.StepOutput(
            reward=jnp.asarray(x['reward']),
            info=jax_structs.StepOutputInfo(
                jnp.asarray(x['episode_return']),
                jnp.asarray(x['episode_step'])),
            done=jnp.asarray(x['done']),
            observation=(jnp.asarray(x['frame']), jnp.asarray(x['instr']))),
        (jnp.asarray(x['c']), jnp.asarray(x['h'])))
    refs[dtype] = (out.policy_logits, out.baseline) + tuple(carry)

  tt = lambda k: torch.from_numpy(x[k])  # noqa: E731
  with torch.no_grad():
    out, (c, h) = agent(
        tt('prev_actions'),
        StepOutput(tt('reward'),
                   StepOutputInfo(tt('episode_return'), tt('episode_step')),
                   tt('done'), (tt('frame'), tt('instr'))),
        (tt('c'), tt('h')))
  got = (out.policy_logits, out.baseline, c, h)
  for i, what in enumerate(('policy_logits', 'baseline', 'c', 'h')):
    assert got[i].dtype == torch.float32, what
    _assert_within_bf16_error(got[i].numpy(), refs[jnp.bfloat16][i],
                              refs[jnp.float32][i], f'{torso} {what}')


T, B, A, H, W = 5, 3, 9, 24, 32
_BASE = dict(torso='deep', batch_size=B, unroll_length=T,
             num_action_repeats=1, total_environment_frames=60,
             use_instruction=False)


def _jax_run(params, jcfg, dtype, x, steps):
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso=jcfg.torso,
                                 use_instruction=False, dtype=dtype)
  jstep = jax_learner.make_train_step(jagent, jcfg)
  # A fresh copy: the JAX step donates its state.
  jstate = jax_learner.make_train_state(
      jax.tree_util.tree_map(jnp.asarray, params), jcfg)
  losses = []
  for _ in range(steps):
    jstate, jm = jstep(jstate, _jax_batch(x))
    losses.append(float(jm['total_loss']))
  return losses, convert.params_from_jax(jax.device_get(jstate.params))


@pytest.mark.parametrize('extra', [{}, {'use_pallas_vtrace': True}],
                         ids=['plain', 'fused'])
def test_bf16_train_step_matches_jax_over_two_steps(extra):
  kw = dict(_BASE, compute_dtype='bfloat16', **extra)
  jcfg, cfg = JaxConfig(**kw), Config(**kw)
  params = jax.device_get(_flax_params('deep', H, W))
  x = _fixed_batch()
  ref16 = _jax_run(params, jcfg, jnp.bfloat16, x, 2)
  ref32 = _jax_run(params, jcfg, jnp.float32, x, 2)

  agent = _port_agent('deep', H, W, params)
  initial = {k: v.detach().clone() for k, v in agent.named_parameters()}
  step = learner.make_train_step_fn(agent, cfg)
  state = learner.make_train_state(agent, cfg)
  losses = []
  for _ in range(2):
    state, m = step(state, _torch_batch(x))
    losses.append(float(m['total_loss']))
    assert float(m['step_ok']) == 1.0
  _assert_within_bf16_error(losses, ref16[0], ref32[0], 'total_loss')
  for k, p in state.params.items():
    moved = p.detach() - initial[k]
    moved16 = ref16[1][k] - initial[k]
    moved32 = ref32[1][k] - initial[k]
    _assert_within_bf16_error(moved, moved16, moved32, k,
                              atol=1e-3 * float(moved32.abs().max()),
                              rtol=0.25)
  # Params and optimizer state stay float32; the params moved.
  for tree in (state.params, state.opt_state.nu):
    assert all(v.dtype == torch.float32 for v in tree.values())
  assert max(float((p.detach() - initial[k]).abs().max())
             for k, p in state.params.items()) > 1e-5


def test_bf16_anakin_run_keeps_float32_state_on_cpu():
  cfg = Config(env_backend='bandit', batch_size=4, unroll_length=5,
               num_action_repeats=1, episode_length=4, height=24, width=32,
               torso='deep', use_instruction=False, use_pallas_vtrace=True,
               compute_dtype='bfloat16', seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  carry, history, _ = anakin.run(cfg, 2, device='cpu')
  assert vtrace_cuda.from_importance_weights.launches == 0  # CPU: twin
  assert carry.train_state.update_steps == 2
  assert all(np.isfinite(h['total_loss']) for h in history)
  assert all(s.dtype == torch.float32 for s in carry.core_state)
  assert carry.agent_output.policy_logits.dtype == torch.float32
  assert carry.agent_output.baseline.dtype == torch.float32
  assert all(p.dtype == torch.float32
             for p in carry.train_state.params.values())


def test_cli_takes_compute_dtype(tmp_path):
  carry = experiment.main([
      '--mode=anakin', '--device=cpu', '--env_backend=bandit',
      '--torso=shallow', '--batch_size=2', '--unroll_length=4',
      '--num_action_repeats=1', '--height=24', '--width=32',
      '--num_actions=9', '--use_instruction=false',
      '--compute_dtype=bfloat16', '--total_environment_frames=16',
      '--summary_secs=0', f'--logdir={tmp_path}'])
  assert carry.train_state.update_steps == 2


@pytest.mark.parametrize('dtype', ['float16', 'bf16', 'float64'])
def test_other_compute_dtypes_raise(dtype):
  with pytest.raises(ValueError, match='compute_dtype'):
    Config(compute_dtype=dtype)
