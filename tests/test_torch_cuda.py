"""Tests of the port that need an NVIDIA card (marker `requires_cuda`).

On a machine without CUDA they skip. On the card they build the CUDA
kernels with nvcc and hold each against its plain twin. This file imports
no JAX, so it also runs where JAX is not installed:

  python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerances: the V-trace kernel against its twin on the card, bit-equal
(torch.equal: the kernel rounds each product and sum where the twin's
PyTorch ops round). The fused conv+pool kernel against its twin,
max|kernel - plain| <= 2**-7 * max|plain|: one bf16 ulp at the output's
scale, since the tensor cores sum the float32 products in another order
before rounding to bf16.
"""

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs CUDA: torch.cuda.is_available() is False')
  return torch.device('cuda')


def _inputs(shape, device, seed=0):
  rng = np.random.RandomState(seed)
  arrays = dict(
      log_rhos=rng.randn(*shape) * 0.8,
      discounts=0.99 * (rng.rand(*shape) > 0.1),
      rewards=rng.randn(*shape),
      values=rng.randn(*shape),
      bootstrap_value=rng.randn(*shape[1:]))
  return {k: torch.tensor(v, dtype=torch.float32, device=device)
          for k, v in arrays.items()}


@pytest.mark.parametrize('clips', [(1.0, 1.0), (None, None), (3.7, 2.2)],
                         ids=str)
@pytest.mark.parametrize('shape', [(100, 32), (7, 300), (6, 70, 3), (1, 1),
                                   (257, 45), (1000, 32), (100, 16)],
                         ids=str)
def test_vtrace_kernel_matches_twin(cuda, shape, clips):
  x = _inputs(shape, cuda)
  before = vtrace_cuda.from_importance_weights.launches
  vs, pg = vtrace_cuda.from_importance_weights(
      **x, clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
  torch.cuda.synchronize()
  assert vtrace_cuda.from_importance_weights.launches == before + 1
  ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(
      **x, clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
  assert torch.equal(vs, ref_vs)
  assert torch.equal(pg, ref_pg)


def test_vtrace_kernel_keeps_nan_like_the_twin(cuda):
  x = _inputs((5, 4), cuda)
  x['log_rhos'][2, 1] = float('nan')
  vs, pg = vtrace_cuda.from_importance_weights(**x)
  ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(**x)
  torch.testing.assert_close(vs, ref_vs, rtol=1e-5, atol=1e-6,
                             equal_nan=True)
  torch.testing.assert_close(pg, ref_pg, rtol=1e-5, atol=1e-6,
                             equal_nan=True)
  assert torch.isnan(vs[:3, 1]).all()


def test_vtrace_wrapper_refuses_mixed_devices(cuda):
  x = _inputs((4, 3), cuda)
  x['values'] = x['values'].cpu()
  with pytest.raises(ValueError, match='expected cuda'):
    vtrace_cuda.from_importance_weights(**x)


@pytest.mark.parametrize('shards', [1, 2, 4])
def test_sharded_vtrace_kernel_is_k1_per_rank(cuda, shards):
  """K1b on each rank's block of columns, the blocks together: bit-equal
  to K1 on the whole batch, and counted on K1b's own counter."""
  x = _inputs((100, 32), cuda, seed=shards)
  before = (vtrace_cuda.from_importance_weights.launches,
            vtrace_cuda.sharded_from_importance_weights.launches)
  parts = []
  for rank in range(shards):
    local = {k: (v[rank * 32 // shards:(rank + 1) * 32 // shards]
                 if k == 'bootstrap_value'
                 else v[:, rank * 32 // shards:(rank + 1) * 32 // shards]
                 ).contiguous() for k, v in x.items()}
    mesh = mesh_lib.Mesh(rank=rank, size=shards, device=cuda)
    parts.append(vtrace_cuda.sharded_from_importance_weights(
        mesh, **local, batch_size=32))
  vs, pg = vtrace_cuda.from_importance_weights(**x)
  torch.cuda.synchronize()
  assert torch.equal(torch.cat([p[0] for p in parts], dim=1), vs)
  assert torch.equal(torch.cat([p[1] for p in parts], dim=1), pg)
  assert (vtrace_cuda.from_importance_weights.launches,
          vtrace_cuda.sharded_from_importance_weights.launches) == (
              before[0] + 1, before[1] + shards)


def test_nccl_refuses_more_ranks_than_cards(cuda):
  count = torch.cuda.device_count()
  topology = distributed.Topology(0, count + 1, 0, count + 1)
  with pytest.raises(RuntimeError, match='one card per rank'):
    distributed.rank_device(topology, 'nccl')
  assert distributed.rank_device(distributed.Topology(0, count, 0, count),
                                 'nccl') == torch.device('cuda', 0)


def test_anakin_on_card_launches_the_kernel_once_per_step(cuda):
  cfg = Config(env_backend='bandit', batch_size=4, unroll_length=5,
               num_action_repeats=1, episode_length=4, height=24,
               width=32, torso='shallow', use_instruction=False,
               use_pallas_vtrace=True, seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  carry, history, _ = anakin.run(cfg, 3)
  assert vtrace_cuda.from_importance_weights.launches == 3
  assert carry.train_state.update_steps == 3
  assert all(np.isfinite(h['total_loss']) for h in history)


@pytest.mark.parametrize('shape', [(3232, 72, 96), (32, 72, 96), (5, 21, 27),
                                   (1, 1, 1), (7, 72, 96), (3, 1, 1),
                                   (2, 20, 150)], ids=str)
def test_conv_pool_kernel_matches_twin(cuda, shape):
  frames, weight, bias = conv_pool_script.make_inputs(*shape, cuda, seed=1)
  before = conv_pool_cuda.fused_conv_pool.launches
  out = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
  torch.cuda.synchronize()
  assert conv_pool_cuda.fused_conv_pool.launches == before + 1
  assert out.dtype == torch.bfloat16
  assert out.shape == conv_pool_cuda.output_shape(*shape)
  ref = conv_pool_cuda.plain_conv_pool(frames, weight, bias)
  conv_pool_script.parity(out, ref)  # raises past 2**-7 * max|plain|


def test_refused_launches_raise(cuda, monkeypatch):
  """A geometry the kernel cannot run comes back as a CUDA error, and the
  wrapper raises; nothing falls back to the twin."""
  x = _inputs((100, 32), cuda)
  geometry = vtrace_cuda.launch_geometry(100, 32)
  monkeypatch.setattr(vtrace_cuda, 'launch_geometry', lambda t, n: (
      geometry._replace(smem_bytes=geometry.smem_bytes + 4)))
  with pytest.raises(RuntimeError, match='vtrace kernel launch failed'):
    vtrace_cuda.from_importance_weights(**x)
  frames, weight, bias = conv_pool_script.make_inputs(2, 72, 96, cuda)
  k2 = conv_pool_cuda.launch_geometry(2, 72, 96)
  monkeypatch.setattr(conv_pool_cuda, 'launch_geometry', lambda n, h, w: (
      k2._replace(smem_bytes=300000)))
  with pytest.raises(RuntimeError, match='conv_pool kernel launch failed'):
    conv_pool_cuda.fused_conv_pool(frames, weight, bias)


def test_bf16_anakin_on_card_keeps_float32_state(cuda):
  cfg = Config(env_backend='bandit', batch_size=4, unroll_length=5,
               num_action_repeats=1, episode_length=4, height=24,
               width=32, torso='deep', use_instruction=False,
               use_pallas_vtrace=True, compute_dtype='bfloat16', seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  carry, history, _ = anakin.run(cfg, 3)
  assert vtrace_cuda.from_importance_weights.launches == 3
  assert carry.train_state.update_steps == 3
  assert all(np.isfinite(h['total_loss']) for h in history)
  assert all(p.dtype == torch.float32 and p.is_cuda
             for p in carry.train_state.params.values())
  assert all(s.dtype == torch.float32 for s in carry.core_state)
