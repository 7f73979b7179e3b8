"""The port's fused conv3x3 + max-pool (ops/conv_pool_cuda.py) against the
JAX script it ports, scripts/pallas_conv_pool.py, on the CPU.

The script is loaded as it stands with SMOKE=1, so its `pallas_call` runs
in interpret mode; nothing in it changes. On CPU tensors the port's
`fused_conv_pool` runs its plain twin, which rounds where the kernel
does. Weights are the script's bf16 HWIO draw carried across by
`convert.conv_from_jax`, with a nonzero bias.

Tolerance: max|port - ref| <= 2**-7 * max|ref|, one bf16 ulp at the
output's scale (the float32 sums of bf16 products may be taken in another
order, and a value near a rounding boundary then rounds the other way).
Measured: 0 against the Pallas kernel at N=16, 24x32 and against
`xla_conv_pool` at 24x32 and 21x27 (bit-equal).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script

torch.set_num_threads(1)

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'scripts', 'pallas_conv_pool.py')


@pytest.fixture(scope='module')
def pallas_script():
  with pytest.MonkeyPatch.context() as mp:
    mp.setenv('SMOKE', '1')
    spec = importlib.util.spec_from_file_location('pallas_conv_pool', SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
  assert module.SMOKE
  return module


def _inputs(n, h, w, seed=0):
  rng = np.random.RandomState(seed)
  frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
  kernel = jax.random.normal(jax.random.PRNGKey(seed), (3, 3, 3, 16),
                             jnp.bfloat16) * 0.3
  bias = jnp.asarray(rng.randn(16) * 0.3, jnp.bfloat16)
  weight, torch_bias = convert.conv_from_jax(np.asarray(kernel, np.float32),
                                             np.asarray(bias, np.float32))
  return frames, kernel, bias, weight, torch_bias


def _assert_close(got, ref):
  got = got.float().numpy()
  ref = np.asarray(ref, np.float32)
  assert got.shape == ref.shape
  err = float(np.max(np.abs(got - ref)))
  assert err <= 2**-7 * float(np.max(np.abs(ref))), err


def test_port_matches_the_pallas_kernel(pallas_script):
  frames, kernel, bias, weight, torch_bias = _inputs(16, 24, 32)
  ref = pallas_script.fused_conv_pool(jnp.asarray(frames), kernel, bias)
  got = conv_pool_cuda.fused_conv_pool(torch.from_numpy(frames), weight,
                                       torch_bias)
  assert got.dtype == torch.bfloat16 and got.shape == (16, 12, 16, 16)
  _assert_close(got, ref)


@pytest.mark.parametrize('size', [(24, 32), (21, 27)], ids=str)
def test_port_matches_xla_conv_pool(pallas_script, size):
  """21x27 is odd in both dims: the SAME pool pads (1, 1) there."""
  frames, kernel, bias, weight, torch_bias = _inputs(5, *size, seed=1)
  ref = pallas_script.xla_conv_pool(jnp.asarray(frames), kernel, bias)
  got = conv_pool_cuda.fused_conv_pool(torch.from_numpy(frames), weight,
                                       torch_bias)
  assert got.shape == conv_pool_cuda.output_shape(5, *size)
  _assert_close(got, ref)


def test_weight_dtype_is_cast_like_flax():
  """Any float weight is cast to bf16 first: float32 and its bf16 copy
  give the same output."""
  frames, _, _, weight, bias = _inputs(2, 9, 11)
  frames = torch.from_numpy(frames)
  a = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
  b = conv_pool_cuda.fused_conv_pool(frames, weight.to(torch.bfloat16),
                                     bias.double())
  assert torch.equal(a, b)


def test_wrapper_refuses_what_the_kernel_does_not_take():
  frames = torch.zeros(2, 6, 8, 3, dtype=torch.uint8)
  weight, bias = torch.zeros(16, 3, 3, 3), torch.zeros(16)
  fn = conv_pool_cuda.fused_conv_pool
  with pytest.raises(TypeError, match='uint8'):
    fn(frames.float(), weight, bias)
  with pytest.raises(ValueError, match=r'\[N, H, W, 3\]'):
    fn(torch.zeros(2, 6, 8, 4, dtype=torch.uint8), weight, bias)
  with pytest.raises(ValueError, match=r'\[N, H, W, 3\]'):
    fn(torch.zeros(6, 8, 3, dtype=torch.uint8), weight, bias)
  with pytest.raises(ValueError, match=r'\[N, H, W, 3\]'):
    fn(torch.zeros(0, 6, 8, 3, dtype=torch.uint8), weight, bias)
  with pytest.raises(ValueError, match='contiguous'):
    fn(frames.transpose(1, 2), weight, bias)
  with pytest.raises(ValueError, match='weight has shape'):
    fn(frames, torch.zeros(16, 3, 5, 5), bias)
  with pytest.raises(ValueError, match='bias has shape'):
    fn(frames, weight, torch.zeros(32))
  with pytest.raises(TypeError, match='weight must be floating'):
    fn(frames, weight.int(), bias)
  with pytest.raises(ValueError, match='expected cpu'):
    fn(frames, weight.to('meta'), bias)
  with pytest.raises(ValueError, match='CUDA or CPU'):
    fn(frames.to('meta'), weight.to('meta'), bias.to('meta'))
  assert fn.launches == 0  # the CPU path never counts a launch


def test_work_and_bound_at_the_learner_shape():
  """(T+1)*B = 3232 frames of 72x96: 245.7 MB moved, 19.3 GFLOP; the
  bytes set the bound on one H100."""
  nbytes, flops = conv_pool_cuda.work(3232, 72, 96)
  assert nbytes == 67_018_752 + 178_716_672 + 2 * (16 * 27 + 16)
  assert flops == 19_301_400_576
  bound_ms, bound_by, _, _ = conv_pool_script.bound(3232, 72, 96)
  assert bound_by == 'bytes'
  assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_entry_point_runs_on_the_cpu(capsys):
  result = conv_pool_script.main(['--device=cpu'])
  lines = capsys.readouterr().out.strip().splitlines()
  assert len(lines) == 1  # parity only: no times from the CPU
  printed = json.loads(lines[0])
  assert printed['shape'] == [64, 24, 32] and printed['device'] == 'cpu'
  assert printed['max_abs_err'] == result['max_abs_err'] == 0.0
  assert printed['scale'] > 0


def test_entry_point_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip('this machine has CUDA: the default device is usable')
  with pytest.raises(RuntimeError, match='cuda'):
    conv_pool_script.main([])
