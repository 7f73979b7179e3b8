"""The port's int8 publish codec (scalable_agent_tpu_torch/runtime/
codec.py) against the JAX package's runtime/codec.py on the same float32
trees: int8 values and scales bit-equal from both the host form
(`quantize_np`) and the device form (`quantize`), ties at .5 and an
all-zero leaf included; `dequantize_tree`, `tree_nbytes`, `max_abs_error`,
`wire_sizes` and `greedy_agreement` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu.runtime import codec as jax_codec
from scalable_agent_tpu_torch.runtime import codec


def _trees():
  rng = np.random.RandomState(0)
  # Ties: absmax 127 makes scale 1.0, so x / scale lands on .5 exactly.
  ties = np.array([127.0, -0.5, 0.5, 1.5, 2.5, -2.5, 126.5, -126.5, 3.5],
                  np.float32)
  yield {'w': rng.randn(64, 33).astype(np.float32),
         'b': np.zeros((7,), np.float32),
         'ties': ties,
         'big': (rng.randn(5, 3, 3, 16) * 40).astype(np.float32),
         'tiny': (rng.randn(9) * 1e-30).astype(np.float32),
         'steps': np.arange(12, dtype=np.int32),
         'empty': np.zeros((0,), np.float32)}
  yield {'core/kernel': np.linspace(-3, 3, 101).astype(np.float32),
         'scalar': np.float32(-2.0) * np.ones((), np.float32)}


def _leaves_equal(port, ref):
  assert sorted(port) == sorted(ref)
  for k in ref:
    if isinstance(ref[k], jax_codec.Int8Leaf):
      assert isinstance(port[k], codec.Int8Leaf), k
      q = np.asarray(port[k].q.cpu() if torch.is_tensor(port[k].q)
                     else port[k].q)
      scale = np.asarray(port[k].scale.cpu() if torch.is_tensor(
          port[k].scale) else port[k].scale)
      np.testing.assert_array_equal(q, np.asarray(ref[k].q))
      assert q.dtype == np.int8
      assert scale.dtype == np.float32 and scale.shape == ()
      assert scale.tobytes() == np.float32(ref[k].scale).tobytes(), k
    else:
      np.testing.assert_array_equal(np.asarray(port[k]), np.asarray(ref[k]))


@pytest.mark.parametrize('index', [0, 1])
def test_host_and_device_quantize_are_bit_equal_to_jax_s(index):
  tree = list(_trees())[index]
  ref = jax_codec.quantize_np(tree)
  _leaves_equal(codec.quantize_np(tree), ref)
  on_device = codec.quantize({k: torch.from_numpy(np.array(v))
                              for k, v in tree.items()})
  _leaves_equal(on_device, ref)
  # JAX's own device form (which refuses an empty leaf) agrees on the
  # values.
  jax_dev = jax.device_get(jax_codec.quantize_device(
      {k: jnp.asarray(v) for k, v in tree.items() if np.size(v)}))
  for k, leaf in jax_dev.items():
    if isinstance(leaf, jax_codec.Int8Leaf):
      np.testing.assert_array_equal(np.asarray(leaf.q), ref[k].q)


def test_ties_round_half_to_even_and_zero_leaves_get_scale_0():
  q = codec.quantize({'t': torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5,
                                         -0.5])})['t']
  assert float(q.scale) == 1.0
  assert q.q.tolist() == [127, 0, 2, 2, -2, 0]
  zero = codec.quantize_np({'z': np.zeros((3,), np.float32)})['z']
  assert float(zero.scale) == 0.0
  np.testing.assert_array_equal(
      codec.dequantize_tree({'z': zero})['z'], np.zeros((3,), np.float32))


@pytest.mark.parametrize('index', [0, 1])
def test_dequantize_sizes_and_error_bounds_are_jax_s(index):
  tree = list(_trees())[index]
  ref_q = jax_codec.quantize_np(tree)
  port_q = codec.quantize_np(tree)
  want = jax_codec.dequantize_np(ref_q)
  got_np = codec.dequantize_tree(port_q)
  got_dev = codec.dequantize_tree(codec.quantize(
      {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}))
  for k in want:
    np.testing.assert_array_equal(got_np[k], np.asarray(want[k]))
    np.testing.assert_array_equal(np.asarray(got_dev[k]),
                                  np.asarray(want[k]))
  assert codec.tree_nbytes(port_q) == jax_codec.tree_nbytes(ref_q)
  assert codec.tree_nbytes(tree) == jax_codec.tree_nbytes(tree)
  assert codec.max_abs_error(port_q) == jax_codec.max_abs_error(ref_q)
  assert codec.wire_sizes(tree) == jax_codec.wire_sizes(tree)
  assert codec.is_quantized(port_q) and not codec.is_quantized(tree)
  # The bound holds.
  for k, x in tree.items():
    if np.asarray(x).dtype == np.float32 and np.asarray(x).size:
      err = np.max(np.abs(got_np[k] - x))
      assert err <= float(port_q[k].scale) / 2 * (1 + 1e-6)


def test_greedy_agreement_is_jax_s():
  rng = np.random.RandomState(1)
  a = rng.randn(50, 9).astype(np.float32)
  b = a + rng.randn(50, 9).astype(np.float32) * 0.3
  for x, y in ((a, a), (a, b), (np.zeros((0, 2)), np.zeros((0, 2)))):
    assert codec.greedy_agreement(x, y) == jax_codec.greedy_agreement(x, y)
  assert codec.greedy_agreement(a, a) == 1.0
