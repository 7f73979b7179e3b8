"""The port's UNREAL pixel control (scalable_agent_tpu_torch/unreal.py)
against the JAX package's, on the same numpy-seeded inputs and, for the
head, on Flax parameters converted by `convert.conv_from_jax`.

Tolerances: the pseudo-rewards exact for the integer form and rtol 1e-6
for the float32 form (the same float32 mean in another order); the head
(forward and gradient) rtol 1e-5 and atol 1e-6 of the compared
tensor's scale (max |ref|, floored at 1) in float32: a Q value of
magnitude ~10 is a sum of ~10^4 float32 products, summed in another
order than XLA's (measured max |diff| 5e-6 on Q values up to 11). The
port's `deconv` and `d2s` are each held to both Flax forms, on an even
cell grid (72x96 frames: 18x24) and an odd one (84x84: 21x21, cropped).
The loss rtol 1e-5; the bf16 head within tests/test_torch_bf16.py's
bf16 rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu import unreal as jax_unreal
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import unreal
from tests.test_torch_bf16 import _assert_within_bf16_error

torch.set_num_threads(1)

HIDDEN, ACTIONS = 256, 5


@pytest.mark.parametrize('form', ['f32', 'integer', 'auto_float'])
def test_pixel_control_rewards_match_jax(form):
  rng = np.random.RandomState(0)
  frames = rng.randint(0, 256, size=(4, 2, 8, 12, 3)).astype(np.uint8)
  if form == 'auto_float':
    frames = frames.astype(np.float32)
  integer = {'f32': False, 'integer': True, 'auto_float': None}[form]
  ref = np.asarray(jax_unreal.pixel_control_rewards(
      jnp.asarray(frames), 4, integer_path=integer))
  out = unreal.pixel_control_rewards(torch.from_numpy(frames), 4,
                                     integer_path=integer).numpy()
  assert out.shape == (3, 2, 2, 3) and out.dtype == np.float32
  if form == 'integer':
    np.testing.assert_array_equal(out, ref)
  else:
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_pixel_control_rewards_refusals():
  frames = torch.zeros((2, 1, 6, 8, 3), dtype=torch.uint8)
  with pytest.raises(ValueError, match='not divisible'):
    unreal.pixel_control_rewards(frames, 4)
  with pytest.raises(ValueError, match='needs uint8'):
    unreal.pixel_control_rewards(frames.float()[:, :, :4], 4,
                                 integer_path=True)


def _head_params(grid, seed=0):
  flax_head = jax_unreal.PixelControlHead(ACTIONS, grid)
  return flax_head, flax_head.init(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, HIDDEN)))


def _port_head(flax_params, grid, impl, dtype=torch.float32, out_f32=True):
  head = unreal.PixelControlHead(HIDDEN, ACTIONS, grid, dtype=dtype,
                                 head_impl=impl, out_f32=out_f32)
  p = jax.device_get(flax_params)['params']
  state = {}
  for name, _ in convert._PIXEL_CONTROL:
    if name == 'pc_fc':
      state['pc_fc.weight'] = torch.from_numpy(
          np.asarray(p[name]['kernel']).T.copy())
      state['pc_fc.bias'] = torch.from_numpy(
          np.array(p[name]['bias'], np.float32))
    else:
      state[f'{name}.weight'], state[f'{name}.bias'] = convert.conv_from_jax(
          p[name]['kernel'], p[name]['bias'])
  head.load_state_dict(state)
  return head


@pytest.mark.parametrize('grid', [(18, 24), (21, 21)], ids=str)
@pytest.mark.parametrize('flax_impl', ['deconv', 'd2s'])
@pytest.mark.parametrize('port_impl', ['deconv', 'd2s'])
def test_head_matches_flax_forward_and_gradient(port_impl, flax_impl, grid):
  _, params = _head_params(grid)
  flax_head = jax_unreal.PixelControlHead(ACTIONS, grid,
                                          head_impl=flax_impl)
  rng = np.random.RandomState(1)
  x = rng.randn(3, HIDDEN).astype(np.float32)
  probe = rng.randn(3, grid[0], grid[1], ACTIONS).astype(np.float32)

  def jloss(p, xx):
    return jnp.sum(flax_head.apply(p, xx) * probe)

  ref = np.asarray(flax_head.apply(params, jnp.asarray(x)))

  def close(got, want, what=''):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-6 * max(1.0, np.abs(want).max()),
        err_msg=what)

  jgrad_p, jgrad_x = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
  head = _port_head(params, grid, port_impl)
  xt = torch.from_numpy(x).requires_grad_(True)
  out = head(xt)
  assert out.shape == (3,) + grid + (ACTIONS,)
  close(out.detach().numpy(), ref, 'q')
  torch.sum(out * torch.from_numpy(probe)).backward()
  close(xt.grad.numpy(), jgrad_x, 'input gradient')
  ref_grads = dict(_port_head(jgrad_p, grid, port_impl).named_parameters())
  for name, param in head.named_parameters():
    close(param.grad.numpy(), ref_grads[name].detach().numpy(), name)


def test_head_rejects_an_unknown_impl():
  with pytest.raises(ValueError, match='head_impl'):
    unreal.PixelControlHead(HIDDEN, ACTIONS, (4, 4), head_impl='fft')


@pytest.mark.parametrize('out_f32', [True, False])
def test_bf16_head_within_bf16_error(out_f32):
  grid = (18, 24)
  _, params = _head_params(grid, seed=2)
  x = np.random.RandomState(3).randn(4, HIDDEN).astype(np.float32)
  ref32 = jax_unreal.PixelControlHead(ACTIONS, grid).apply(params,
                                                           jnp.asarray(x))
  ref16 = jax_unreal.PixelControlHead(
      ACTIONS, grid, dtype=jnp.bfloat16, head_impl='d2s',
      out_f32=out_f32).apply(params, jnp.asarray(x))
  head = _port_head(params, grid, 'deconv', dtype=torch.bfloat16,
                    out_f32=out_f32)
  with torch.no_grad():
    out = head(torch.from_numpy(x))
  assert out.dtype == (torch.float32 if out_f32 else torch.bfloat16)
  assert np.asarray(ref16).dtype == (np.float32 if out_f32 else jnp.bfloat16)
  _assert_within_bf16_error(out.float().numpy(), ref16, ref32, 'q')


@pytest.mark.parametrize('q_dtype', ['float32', 'bfloat16'])
def test_pixel_control_loss_matches_jax(q_dtype):
  rng = np.random.RandomState(4)
  t, b, hc, wc = 6, 3, 2, 3
  q = rng.randn(t + 1, b, hc, wc, ACTIONS).astype(np.float32)
  actions = rng.randint(0, ACTIONS, size=(t, b)).astype(np.int32)
  rewards = rng.rand(t, b, hc, wc).astype(np.float32)
  done = rng.rand(t, b) < 0.3
  jq = jnp.asarray(q).astype(jnp.dtype(q_dtype))
  ref = float(jax_unreal.pixel_control_loss(
      jq, jnp.asarray(actions), jnp.asarray(rewards), jnp.asarray(done),
      discount=0.8))
  tq = torch.from_numpy(q).to(getattr(torch, q_dtype))
  out = unreal.pixel_control_loss(tq, torch.from_numpy(actions),
                                  torch.from_numpy(rewards),
                                  torch.from_numpy(done), discount=0.8)
  np.testing.assert_allclose(float(out), ref, rtol=1e-5)
  # A rank's share of a global mean: the same sum over twice the T*B.
  half = unreal.pixel_control_loss(
      tq, torch.from_numpy(actions), torch.from_numpy(rewards),
      torch.from_numpy(done), discount=0.8, denominator=2 * t * b)
  np.testing.assert_allclose(float(half), ref / 2, rtol=1e-6)
