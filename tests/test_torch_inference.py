"""The port's dynamic batcher and inference server
(scalable_agent_tpu_torch/ops/dynamic_batching.py, runtime/inference.py)
against the JAX package's: the batcher merges, bounds, times out, passes
errors and cancels; `InferenceServer.policy` on converted params gives
the JAX server's logits, baseline and new carry within atol 1e-5 (the
agent tolerance of tests/test_torch_models.py) for 4 concurrent callers;
a published snapshot is isolated from the learner's in-place updates; and
the batcher library is the port's own build."""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu import structs as jax_structs
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu.runtime import inference as jax_inference
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.ops import build, dynamic_batching
from scalable_agent_tpu_torch.runtime import inference
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

torch.set_num_threads(1)

A, H, W = 5, 24, 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_batcher(batcher, fn, sizes):
  """The computation thread: answers each merged batch with fn(rows) and
  records the merged sizes."""

  def alloc(total_rows):
    (dtype, trail), = batcher.input_meta()
    return [np.empty((total_rows,) + tuple(trail), dtype)]

  def loop():
    while True:
      item = batcher.get_batch_into(alloc)
      if item is None:
        return
      batch_id, _, (rows,) = item
      sizes.append(rows.shape[0])
      try:
        batcher.set_outputs(batch_id, fn(rows))
      except ValueError as e:
        batcher.set_error(batch_id, str(e))

  thread = threading.Thread(target=loop, daemon=True)
  thread.start()
  return thread


def _call_concurrently(fn, args):
  results, errors = [None] * len(args), [None] * len(args)

  def call(i):
    try:
      results[i] = fn(args[i])
    except Exception as e:
      errors[i] = e

  threads = [threading.Thread(target=call, args=(i,))
             for i in range(len(args))]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
    assert not t.is_alive()
  return results, errors


def test_batcher_merges_concurrent_calls():
  batcher = dynamic_batching.Batcher(1, minimum_batch_size=4,
                                     maximum_batch_size=16, timeout_ms=5000)
  sizes = []
  thread = _serve_batcher(batcher, lambda x: [x * 10, x + 1], sizes)
  results, errors = _call_concurrently(
      lambda i: batcher.compute([np.array([[i, i]], np.int64)]), range(4))
  batcher.close()
  thread.join(timeout=5)
  assert errors == [None] * 4 and sizes == [4]
  for i, (times_ten, plus_one) in enumerate(results):
    np.testing.assert_array_equal(times_ten, [[10 * i, 10 * i]])
    np.testing.assert_array_equal(plus_one, [[i + 1, i + 1]])


def test_batcher_respects_the_maximum_and_the_timeout():
  batcher = dynamic_batching.Batcher(1, minimum_batch_size=8,
                                     maximum_batch_size=2, timeout_ms=30)
  sizes = []
  thread = _serve_batcher(batcher, lambda x: [x], sizes)
  t0 = time.monotonic()
  results, errors = _call_concurrently(
      lambda i: batcher.compute([np.array([i], np.float32)]), range(5))
  elapsed = time.monotonic() - t0
  with pytest.raises(ValueError, match='maximum_batch_size'):
    batcher.compute([np.zeros(3, np.float32)])
  batcher.close()
  thread.join(timeout=5)
  assert errors == [None] * 5
  assert [float(r[0][0]) for r in results] == [0, 1, 2, 3, 4]
  # The floor of 8 is never reached: every batch left on the timeout,
  # none above the maximum of 2.
  assert sum(sizes) == 5 and max(sizes) <= 2 and elapsed >= 0.03


def test_batcher_passes_errors_to_the_batch_callers():
  batcher = dynamic_batching.Batcher(1, minimum_batch_size=2,
                                     timeout_ms=5000)

  def fail_on_negative(rows):
    if (rows < 0).any():
      raise ValueError('negative row in the batch')
    return [rows]

  thread = _serve_batcher(batcher, fail_on_negative, [])
  _, errors = _call_concurrently(
      lambda v: batcher.compute([np.array([v], np.int32)]), [-1, 2])
  assert all(isinstance(e, dynamic_batching.BatcherError) and
             'negative row' in str(e) for e in errors)
  results, errors = _call_concurrently(
      lambda v: batcher.compute([np.array([v], np.int32)]), [3, 4])
  assert errors == [None, None]  # the next batch is served
  batcher.close()
  thread.join(timeout=5)


def test_batcher_cancels_parked_callers_on_close():
  batcher = dynamic_batching.Batcher(1, minimum_batch_size=8,
                                     timeout_ms=60000)
  errors = []

  def call():
    try:
      batcher.compute([np.zeros(1, np.float32)])
    except dynamic_batching.BatcherCancelled as e:
      errors.append(e)

  threads = [threading.Thread(target=call) for _ in range(3)]
  for t in threads:
    t.start()
  time.sleep(0.1)
  batcher.close()
  for t in threads:
    t.join(timeout=5)
    assert not t.is_alive()
  assert len(errors) == 3
  assert batcher.get_batch_into(lambda rows: []) is None
  with pytest.raises(dynamic_batching.BatcherCancelled):
    batcher.compute([np.zeros(1, np.float32)])


def test_the_batcher_library_is_the_ports_own_build():
  lib = dynamic_batching.library()
  path = os.path.realpath(lib._name)
  assert path == os.path.realpath(build.host_library_path('batcher'))
  assert path.startswith(os.path.join(REPO, 'scalable_agent_tpu_torch',
                                      '_build') + os.sep)
  assert os.path.isfile(path)


def _callers(num, hidden, seed=0):
  rng = np.random.RandomState(seed)
  calls = []
  for i in range(num):
    frame = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    instr = np.zeros(16, np.int32)
    info = (np.float32(0), np.int32(0))
    reward, done = np.float32(rng.randn()), np.bool_(i % 2 == 0)
    carry = tuple(rng.randn(1, hidden).astype(np.float32) * 0.3
                  for _ in range(2))
    calls.append((np.int32(rng.randint(A)), reward, done, frame, instr,
                  info, carry))
  return calls


def _policy_call(server, step_output, info_type, call):
  prev_action, reward, done, frame, instr, info, carry = call
  env_output = step_output(reward, info_type(*info), done, (frame, instr))
  return server.policy(prev_action, env_output, carry)


@pytest.mark.parametrize('torso', ['shallow', 'deep'])
def test_server_policy_matches_jax(torso):
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso=torso,
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (H, W, 3), 'instr_len': 16})
  agent = ImpalaAgent(A, (H, W, 3), torso=torso)
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  calls = _callers(4, agent.hidden_size)
  kw = dict(inference_timeout_ms=2000, use_instruction=False)
  jserver = jax_inference.InferenceServer(jagent, params, JaxConfig(**kw),
                                          seed=1, fleet_size=4)
  server = inference.InferenceServer(agent, dict(agent.named_parameters()),
                                     Config(**kw), seed=1, fleet_size=4)
  try:
    ref, errors = _call_concurrently(
        lambda c: _policy_call(jserver, jax_structs.StepOutput,
                               jax_structs.StepOutputInfo, c), calls)
    assert errors == [None] * 4
    got, errors = _call_concurrently(
        lambda c: _policy_call(server, StepOutput, StepOutputInfo, c), calls)
    assert errors == [None] * 4
    stats = server.stats()
  finally:
    jserver.close()
    server.close()
  assert stats['requests'] == 4 and stats['mean_batch'] > 1
  for (out, carry), (ref_out, ref_carry) in zip(got, ref):
    np.testing.assert_allclose(out.policy_logits,
                               np.asarray(ref_out.policy_logits), atol=1e-5)
    np.testing.assert_allclose(out.baseline, np.asarray(ref_out.baseline),
                               atol=1e-5)
    for part, ref_part in zip(carry, ref_carry):
      assert part.shape == (1, agent.hidden_size)
      np.testing.assert_allclose(part, np.asarray(ref_part), atol=1e-5)
    assert out.action.dtype == np.int32 and 0 <= int(out.action) < A


def _shallow_server(**kw):
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  params = dict(agent.named_parameters())
  config = Config(inference_timeout_ms=1, use_instruction=False, **kw)
  return agent, params, inference.InferenceServer(agent, params, config,
                                                   seed=0, fleet_size=1)


def _outputs(server, call):
  out, carry = _policy_call(server, StepOutput, StepOutputInfo, call)
  return [out.policy_logits, out.baseline, *carry]


def test_a_published_snapshot_is_isolated_from_the_learner():
  agent, params, server = _shallow_server()
  call = _callers(1, agent.hidden_size)[0]
  try:
    server.update_params(params, version=1)
    before = _outputs(server, call)
    with torch.no_grad():  # the learner's in-place update
      for p in params.values():
        p.add_(0.5)
    for got, ref in zip(_outputs(server, call), before):
      np.testing.assert_array_equal(got, ref)
    assert not any(torch.equal(server.live_params()[k], p)
                   for k, p in params.items())
    assert server.stats()['live_version'] == 1
    server.update_params(params, version=2)
    assert all(torch.equal(server.live_params()[k], p)
               for k, p in params.items())
    after = _outputs(server, call)
    assert not np.array_equal(after[0], before[0])
    stats = server.stats()
    assert stats['params_version'] == 2 and stats['live_version'] == 2
    # Retired snapshots are reused once no dispatch holds them.
    for version in range(3, 9):
      server.update_params(params, version=version)
    assert server.stats()['snapshots'] <= 3
  finally:
    server.close()


def test_padded_buckets_answer_only_the_real_rows():
  agent, params, server = _shallow_server()
  calls = _callers(3, agent.hidden_size, seed=4)
  try:
    server.warmup({'frame': (H, W, 3), 'instr_len': 16}, max_size=4)
    alone = [_outputs(server, c) for c in calls]
    merged, errors = _call_concurrently(lambda c: _outputs(server, c), calls)
    assert errors == [None] * 3
    assert server._padded_size(3) == 4 and server._padded_size(5) == 8
  finally:
    server.close()
  for got, ref in zip(merged, alone):
    for a, b in zip(got, ref):
      np.testing.assert_allclose(a, b, atol=1e-5)


@pytest.mark.parametrize('setting', [
    {'inference_state_cache': True}, {'inference_admission': 'shed'},
    {'publish_codec': 'int8'}, {'serving_resident_versions': 2},
    {'serving_aot': True}, {'staging_mode': 'unroll'},
    {'serving_replicas': 'localhost:1'}])
def test_unported_server_settings_raise(setting):
  """Every serving setting builds a server now: those of A7.2, and
  routed serving's serving_replicas (A7.3b), which on a learner is JAX's
  warning from validate_serving, an actor-host knob the server ignores."""
  if setting == {'serving_replicas': 'localhost:1'}:
    from scalable_agent_tpu.config import validate_serving as jax_validate
    from scalable_agent_tpu_torch.config import validate_serving
    warnings = validate_serving(Config(**setting))
    assert warnings == jax_validate(JaxConfig(**setting))
    assert len(warnings) == 1 and 'learner_address' in warnings[0]
  _, _, server = _shallow_server(**setting)
  try:
    assert server.stats()['state_cache'] == bool(
        setting.get('inference_state_cache'))
  finally:
    server.close()


def test_bad_server_settings_are_value_errors():
  with pytest.raises(ValueError, match='inference_admission'):
    _shallow_server(inference_admission='drop')
  with pytest.raises(ValueError, match='staging_depth'):
    _shallow_server(staging_depth=0)
