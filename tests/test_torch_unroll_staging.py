"""Unroll staging (staging_mode='unroll': runtime/ring_buffer.py's
UnrollBatchStager and BatchPrefetcher(stager=); the placement helpers of
parallel/train_parallel.py; driver.train's unroll path) against the JAX
package's UnrollBatchStager and the port's batch staging, on the CPU.

The arena is built by copies alone, so it is held bit-equal (every leaf,
every dtype's values) to JAX's arena and to `batch_unrolls` placed as
batch staging places it. The placement predicates decide as JAX's do on
the same topologies (JAX's with fake devices, as
tests/test_multihost_unit.py builds them).
"""

import json
import os

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

T1, A = 6, 4


def _unroll(rng, level):
  """One actor's unroll as the port's actors emit it: [T+1, ...] leaves,
  a scalar level id and a [1, hidden] carry."""
  return ActorOutput(
      level_name=np.int32(level),
      agent_state=(rng.randn(1, 8).astype(np.float32),
                   rng.randn(1, 8).astype(np.float32)),
      env_outputs=StepOutput(
          rng.randn(T1).astype(np.float32),
          StepOutputInfo(rng.randn(T1).astype(np.float32),
                         rng.randint(0, 99, T1).astype(np.int32)),
          rng.rand(T1) > 0.5,
          (rng.randint(0, 256, (T1, 4, 6, 3)).astype(np.uint8),
           rng.randint(0, 1000, (T1, 16)).astype(np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, A, T1).astype(np.int32),
          rng.randn(T1, A).astype(np.float32),
          rng.randn(T1).astype(np.float32)))


def _unrolls(n, seed=0):
  rng = np.random.RandomState(seed)
  return [_unroll(rng, i % 3) for i in range(n)]


def _leaves(tree):
  out = []
  map_structure(lambda x: out.append(np.asarray(x)), tree)
  return out


def test_arena_is_batch_unrolls_bit_for_bit():
  unrolls = _unrolls(4)
  stager = ring_buffer.UnrollBatchStager(4)
  for u in unrolls:
    stager.add(u)
  arena = stager.finish()
  placed = learner.place_batch(batch_unrolls(unrolls), 'cpu')
  got, want = _leaves(arena), _leaves(placed)
  assert len(got) == len(want) == 12
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)
  assert arena.agent_outputs.action.dtype == torch.int64  # as placed
  assert stager.stats() == {'unrolls_staged': 4, 'batches_assembled': 1,
                            'aborted_partials': 0}


def test_arena_matches_jax_unroll_batch_stager():
  from scalable_agent_tpu.runtime import ring_buffer as jax_ring_buffer
  unrolls = _unrolls(5, seed=1)
  jax_stager = jax_ring_buffer.UnrollBatchStager(5)
  stager = ring_buffer.UnrollBatchStager(5)
  for u in unrolls:
    jax_stager.add(u)
    stager.add(u)
  want, got = _leaves(jax_stager.finish()), _leaves(stager.finish())
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b.astype(a.dtype))


def test_stager_views_finish_and_abort():
  stager = ring_buffer.UnrollBatchStager(
      2, host_view_fn=lambda u: int(u.level_name),
      finalize_fn=lambda v, batch: (list(v), batch))
  unrolls = _unrolls(4)
  stager.add(unrolls[0])
  with pytest.raises(RuntimeError, match='1/2 slots'):
    stager.finish()
  stager.abort()
  stager.abort()  # idempotent
  assert stager.stats()['aborted_partials'] == 1
  for u in unrolls[1:3]:
    stager.add(u)
  with pytest.raises(RuntimeError, match='already full'):
    stager.add(unrolls[3])
  views, batch = stager.finish()
  assert views == [1, 2]
  first = batch
  for u in unrolls[:2]:
    stager.add(u)
  _, second = stager.finish()
  # A fresh arena per batch: the emitted one is never written again.
  assert first.env_outputs.reward.data_ptr() != (
      second.env_outputs.reward.data_ptr())
  np.testing.assert_array_equal(
      first.env_outputs.reward.numpy(),
      np.stack([u.env_outputs.reward for u in unrolls[1:3]], 1))
  with pytest.raises(ValueError, match='batch_size must be >= 1'):
    ring_buffer.UnrollBatchStager(0)


def test_prefetcher_with_a_stager_serves_the_batches_batch_staging_does():
  unrolls = _unrolls(6, seed=2)
  batches = {}
  for mode in ('batch', 'unroll'):
    buffer = ring_buffer.TrajectoryBuffer(6)
    for u in unrolls:
      buffer.put(u)
    stager = (ring_buffer.UnrollBatchStager(3) if mode == 'unroll'
              else None)
    prefetcher = ring_buffer.BatchPrefetcher(
        buffer, 3, place_fn=lambda b: learner.place_batch(b, 'cpu'),
        stager=stager)
    batches[mode] = [prefetcher.get(timeout=10) for _ in range(2)]
    stats = prefetcher.stats()
    prefetcher.close()
    assert stats['mode'] == mode
    if stager is not None:
      assert stats['unrolls_staged'] == 6
      assert stats['batches_assembled'] == 2
  for got, want in zip(batches['unroll'], batches['batch']):
    for a, b in zip(_leaves(got), _leaves(want)):
      np.testing.assert_array_equal(a, b)


# --- placement against JAX's -----------------------------------------------

class _FakeDevice:

  def __init__(self, did, process_index):
    self.id = did
    self.process_index = process_index


@pytest.mark.parametrize('devices,local_batch', [
    ([(0, 0), (1, 0), (2, 0), (3, 0)], 8), ([(2, 1), (3, 1)], 4),
    ([(7, 3)], 4), ([(0, 0)], 1)])
def test_unroll_slot_owners_match_jax(devices, local_batch):
  from scalable_agent_tpu.parallel import train_parallel as jax_tp
  local = [_FakeDevice(*d) for d in devices]
  want = [d.id for d in jax_tp.unroll_slot_owners(local, local_batch)]
  got = [d.id for d in train_parallel.unroll_slot_owners(local, local_batch)]
  assert got == want


@pytest.mark.parametrize('devices,local_batch', [(3, 4), (0, 4)])
def test_unroll_slot_owners_refuse_as_jax_does(devices, local_batch):
  from scalable_agent_tpu.parallel import train_parallel as jax_tp
  local = [_FakeDevice(i, 0) for i in range(devices)]
  for module in (jax_tp, train_parallel):
    with pytest.raises(ValueError, match='does not divide'):
      module.unroll_slot_owners(local, local_batch)


def test_supports_unroll_staging_decides_as_jax(monkeypatch):
  """The same topologies in both packages: no mesh; a pure data-parallel
  mesh of 2 (2 devices of one JAX process, 2 ranks of the port); a
  model axis of 2 (one process in JAX; in the port every rank is a
  process, so its TP batch also shards over the model axis)."""
  import jax
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.parallel import mesh as jax_mesh
  from scalable_agent_tpu.parallel import train_parallel as jax_tp
  cpu = torch.device('cpu')
  assert jax_tp.supports_unroll_staging(JaxConfig(batch_size=4), None)
  assert train_parallel.supports_unroll_staging(Config(batch_size=4), None)

  jmesh = jax_mesh.make_mesh(jax.devices()[:2])
  assert jax_tp.supports_unroll_staging(JaxConfig(batch_size=4), jmesh)
  mesh = mesh_lib.Mesh(rank=0, size=2, device=cpu)
  assert train_parallel.supports_unroll_staging(Config(batch_size=4), mesh)

  jtp = jax_mesh.make_mesh(jax.devices()[:2], model_parallelism=2)
  assert not jax_tp.supports_unroll_staging(
      JaxConfig(batch_size=4, model_parallelism=2), jtp)
  tp_mesh = mesh_lib.Mesh(rank=0, size=1, device=cpu, model_index=0,
                          model_size=2)
  monkeypatch.setattr(distributed, 'world_size', lambda: 2)
  tp = Config(batch_size=4, model_parallelism=2)
  assert not train_parallel.supports_unroll_staging(tp, tp_mesh)


def test_resolve_tp_compute():
  # The port departs from JAX here: 'auto' is gathered on CUDA too.
  assert train_parallel.resolve_tp_compute(Config()) == 'gathered'
  for mode in ('gathered', 'sharded'):
    assert train_parallel.resolve_tp_compute(Config(tp_compute=mode)) == mode


# --- the one-rank fleet with unroll staging --------------------------------

def test_the_fleet_trains_with_unroll_staging(tmp_path):
  config = Config(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
                  batch_size=2, unroll_length=5, num_action_repeats=1,
                  episode_length=4, height=24, width=32, torso='shallow',
                  use_py_process=False, use_instruction=False,
                  total_environment_frames=10**6, inference_timeout_ms=5,
                  summary_secs=0, seed=3, staging_mode='unroll',
                  use_pallas_vtrace=True)
  run = driver.train(config, max_steps=3, device='cpu',
                     stall_timeout_secs=30)
  assert run.state.update_steps == 3
  stats = run.stats['prefetcher']
  assert stats['mode'] == 'unroll'
  assert stats['unrolls_staged'] >= 3 * config.batch_size
  with open(tmp_path / 'summaries.jsonl') as f:
    tags = {json.loads(line)['tag'] for line in f}
  assert {'total_loss', 'actions', 'env_frames_per_sec'} <= tags
  assert os.path.exists(tmp_path / 'checkpoints' / '3')
