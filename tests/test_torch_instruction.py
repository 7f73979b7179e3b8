"""The port's instruction pathway (models/instruction.py) against the
JAX package's, on Flax parameters converted by `convert.params_from_jax`
and the same numpy-seeded ids: rows of every length, an all-pad row
(zeros out) and a full-length one.

Tolerances: the host hashing exact; the float32 encoder, forward and
gradient, rtol 1e-5 / atol 1e-6 (16 LSTM-64 steps on top of the
embedding, summed in another order); the bf16 encoder within
tests/test_torch_bf16.py's bf16 rule against the JAX bf16 and float32
encoders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.models import instruction as jax_instruction
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.models import instruction
from scalable_agent_tpu_torch.models.lstm import unroll_lstm
from tests.test_torch_bf16 import _assert_within_bf16_error

torch.set_num_threads(1)


@pytest.mark.parametrize('text', ['', 'go to the red ball',
                                  b'pick up\xff the key', ' '.join(
                                      f'w{i}' for i in range(20))])
def test_hashing_matches_jax(text):
  np.testing.assert_array_equal(instruction.hash_instruction(text),
                                jax_instruction.hash_instruction(text))
  np.testing.assert_array_equal(instruction.empty_instruction(),
                                jax_instruction.empty_instruction())
  assert (instruction.VOCAB_SIZE, instruction.MAX_INSTRUCTION_LEN,
          instruction.EMBED_SIZE, instruction.LSTM_SIZE) == (
              jax_instruction.VOCAB_SIZE, jax_instruction.MAX_INSTRUCTION_LEN,
              jax_instruction.EMBED_SIZE, jax_instruction.LSTM_SIZE)


def _ids(seed=0):
  rng = np.random.RandomState(seed)
  ids = np.zeros((6, 16), np.int32)
  for row, length in enumerate((0, 1, 5, 9, 15, 16)):
    ids[row, :length] = rng.randint(1, 1001, size=length)
  return ids


def _encoders(dtype=torch.float32, seed=0):
  flax_encoder = jax_instruction.InstructionEncoder()
  params = flax_encoder.init(jax.random.PRNGKey(seed),
                             jnp.zeros((1, 16), jnp.int32))
  p = jax.device_get(params)['params']
  encoder = instruction.InstructionEncoder(dtype=dtype)
  encoder.load_state_dict(_port_tree(p))
  return params, encoder


def _port_tree(p):
  """An InstructionEncoder_0 subtree in the port's names."""
  state = {'embed.weight': torch.from_numpy(
      np.array(p['Embed_0']['embedding'], np.float32))}
  convert._lstm('cell', p['OptimizedLSTMCell_0'], state)
  return state


def test_encoder_matches_flax_forward_and_gradient():
  params, encoder = _encoders()
  ids = _ids()
  flax_encoder = jax_instruction.InstructionEncoder()
  probe = np.random.RandomState(1).randn(6, 64).astype(np.float32)
  ref = np.asarray(flax_encoder.apply(params, jnp.asarray(ids)))
  jgrad = jax.grad(lambda p: jnp.sum(
      flax_encoder.apply(p, jnp.asarray(ids)) * probe))(params)
  out = encoder(torch.from_numpy(ids))
  assert out.shape == (6, 64) and out.dtype == torch.float32
  np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                             atol=1e-6)
  assert not out[0].any()       # an all-pad row encodes to zeros
  torch.sum(out * torch.from_numpy(probe)).backward()
  ref_grads = _port_tree(jax.device_get(jgrad)['params'])
  for name, param in encoder.named_parameters():
    np.testing.assert_allclose(param.grad.numpy(), ref_grads[name].numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=name)


def test_bf16_encoder_within_bf16_error():
  params, encoder = _encoders(dtype=torch.bfloat16, seed=3)
  ids = _ids(seed=4)
  ref32 = jax_instruction.InstructionEncoder().apply(params,
                                                     jnp.asarray(ids))
  ref16 = jax_instruction.InstructionEncoder(dtype=jnp.bfloat16).apply(
      params, jnp.asarray(ids))
  with torch.no_grad():
    out = encoder(torch.from_numpy(ids))
  # The carry is float32 (Flax's initialize_carry), so the output is too.
  assert out.dtype == torch.float32 and np.asarray(ref16).dtype == np.float32
  _assert_within_bf16_error(out.numpy(), ref16, ref32, 'encoding')


def test_unroll_lstm_resets_zero_the_carry():
  """The core's done-reset: a reset step starts from a zero carry, so
  its output equals a fresh unroll's first step."""
  cell = torch.nn.LSTMCell(4, 8)
  x = torch.randn(3, 2, 4)
  zeros = torch.zeros(2, 8)
  resets = torch.tensor([[False, False], [True, False], [False, False]])
  out, _, _ = unroll_lstm(cell, x, torch.ones(2, 8), torch.ones(2, 8),
                          torch.float32, resets=resets)
  fresh, _, _ = unroll_lstm(cell, x[1:2], zeros, zeros, torch.float32)
  torch.testing.assert_close(out[1, 0], fresh[0, 0])
