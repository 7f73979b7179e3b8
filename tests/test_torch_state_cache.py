"""The device-resident state arena of the port's inference server
(runtime/inference.py, `inference_state_cache`): the cache path is
bit-equal to the port's carry path on the CPU (multi-unroll, done edges,
a slot reused after release, through the Actor's unroll with its
unroll-start snapshot), and within atol 1e-5 (the bar of
tests/test_torch_inference.py for the carry path) of the JAX package's
cache path on converted params; a failed forward leaves the generator and
the arena as they were (`_recover_chain`); slots come back when an actor
dies or the server closes under it. Mirrors JAX tests/test_runtime.py's
TestStateCache."""

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
from scalable_agent_tpu_torch.envs.fake import FakeEnv
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.ops.dynamic_batching import BatcherError
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import Actor, run_actor_loop
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

torch.set_num_threads(1)

A, H, W = 5, 24, 32
_KW = dict(use_instruction=False, inference_timeout_ms=1)


def _agent():
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  return agent, init_params(agent, torch.Generator().manual_seed(0))


def _server(agent, params, seed=3, **kw):
  return InferenceServer(agent, params, Config(**dict(_KW, **kw)), seed=seed,
                         fleet_size=1)


def _scripted(steps, seed=0, step_output=StepOutput,
              info_type=StepOutputInfo):
  rng = np.random.RandomState(seed)
  frames = rng.randint(0, 256, (steps, H, W, 3)).astype(np.uint8)
  rewards = rng.randn(steps).astype(np.float32)

  def env_out(t):
    return step_output(rewards[t], info_type(np.float32(0), np.int32(0)),
                       np.bool_(t % 5 == 0), (frames[t],
                                              np.zeros(16, np.int32)))
  return env_out


def _drive(server, env_out, steps, state=None, feedback=True):
  """`steps` policy calls of one actor; (trace, final carry, state)."""
  if state is None:
    state = server.initial_core_state()
  prev, trace = np.int32(0), []
  for t in range(steps):
    out, state = server.policy(prev, env_out(t), state)
    trace.append((int(out.action), np.asarray(out.policy_logits).copy(),
                  float(out.baseline)))
    if feedback:
      prev = np.int32(out.action)
  snap = state.snapshot() if hasattr(state, 'snapshot') else state
  return trace, tuple(np.asarray(x) for x in snap), state


def _traces_equal(a, b):
  assert len(a) == len(b)
  for t, (x, y) in enumerate(zip(a, b)):
    assert x[0] == y[0], f'step {t}: action'
    np.testing.assert_array_equal(x[1], y[1], err_msg=f'step {t}')
    assert x[2] == y[2], f'step {t}: baseline'


def test_golden_parity_multi_unroll_with_done_edges():
  agent, params = _agent()
  carry = _server(agent, params)
  cache = _server(agent, params, inference_state_cache=True)
  try:
    env_out = _scripted(24)
    a, snap_a, _ = _drive(carry, env_out, 24)
    b, snap_b, _ = _drive(cache, env_out, 24)
    _traces_equal(a, b)
    for x, y in zip(snap_a, snap_b):
      np.testing.assert_array_equal(x, y)
  finally:
    carry.close()
    cache.close()


def test_merged_callers_match_the_carry_path_bit_for_bit():
  """4 callers in one merged batch per step, each from its own carry
  (written into its slot), 3 steps with done edges: every output and
  new carry bit-equal, the padded rows leaving no trace in live slots."""
  agent, params = _agent()
  kw = dict(inference_min_batch=3, inference_timeout_ms=5000)
  carry = _server(agent, params, **kw)
  cache = _server(agent, params, inference_state_cache=True,
                  inference_state_slots=4, **kw)
  rng = np.random.RandomState(5)
  states = [tuple(rng.randn(1, 256).astype(np.float32) for _ in range(2))
            for _ in range(3)]
  handles = [cache.initial_core_state() for _ in range(3)]
  for handle, state in zip(handles, states):
    handle.write(state)
  try:
    for step in range(3):
      env = [_scripted(1, seed=10 * step + i)(0) for i in range(3)]
      want = _concurrently(carry, [(np.int32(i), e, s) for i, (e, s) in
                                   enumerate(zip(env, states))])
      got = _concurrently(cache, [(np.int32(i), e, h) for i, (e, h) in
                                  enumerate(zip(env, handles))])
      for (w_out, w_carry), (g_out, handle) in zip(want, got):
        for x, y in zip(tuple(w_out) + tuple(w_carry),
                        tuple(g_out) + handle.snapshot()):
          np.testing.assert_array_equal(x, y)
      states = [c for _, c in want]
    assert cache.stats()['calls'] == carry.stats()['calls'] == 3
    assert cache.stats()['mean_batch'] == 3.0
  finally:
    carry.close()
    cache.close()


def _concurrently(server, calls):
  outs = [None] * len(calls)

  def call(i):
    outs[i] = server.policy(*calls[i])

  threads = [threading.Thread(target=call, args=(i,))
             for i in range(len(calls))]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  return outs


def test_the_cache_path_matches_jax_s_cache_path():
  """4 concurrent callers on converted params through JAX's and the
  port's cache-mode servers, 2 steps: logits, baseline and each slot's
  new carry within atol 1e-5. Actions are not compared: the packages
  sample from different generators."""
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  jparams = jax_init_params(jagent, jax.random.PRNGKey(0),
                            {'frame': (H, W, 3), 'instr_len': 16})
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  agent.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
  kw = dict(inference_timeout_ms=2000, use_instruction=False,
            inference_state_cache=True)
  jserver = jax_inference.InferenceServer(jagent, jparams, JaxConfig(**kw),
                                          seed=1, fleet_size=4)
  server = InferenceServer(agent, dict(agent.named_parameters()),
                           Config(**kw), seed=1, fleet_size=4)
  rng = np.random.RandomState(2)
  carries = [tuple(rng.randn(1, 256).astype(np.float32) * 0.3
                   for _ in range(2)) for _ in range(4)]
  try:
    jhandles = [jserver.initial_core_state() for _ in range(4)]
    handles = [server.initial_core_state() for _ in range(4)]
    for jh, h, c in zip(jhandles, handles, carries):
      jh.write(c)
      h.write(c)
    for step in range(2):
      ref = _concurrently(jserver, [
          (np.int32(i), _scripted(1, 7 * step + i, jax_structs.StepOutput,
                                  jax_structs.StepOutputInfo)(0), h)
          for i, h in enumerate(jhandles)])
      got = _concurrently(server, [
          (np.int32(i), _scripted(1, 7 * step + i)(0), h)
          for i, h in enumerate(handles)])
      for (r, jh), (g, h) in zip(ref, got):
        np.testing.assert_allclose(g.policy_logits,
                                   np.asarray(r.policy_logits), atol=1e-5)
        np.testing.assert_allclose(g.baseline, np.asarray(r.baseline),
                                   atol=1e-5)
        for x, y in zip(h.snapshot(), jh.snapshot()):
          np.testing.assert_allclose(x, np.asarray(y), atol=1e-5)
  finally:
    jserver.close()
    server.close()


def test_slot_release_and_zeroed_reuse():
  agent, params = _agent()
  server = _server(agent, params, inference_state_cache=True,
                   inference_state_slots=2)
  try:
    env_out = _scripted(6)
    outs1, snap1, handle1 = _drive(server, env_out, 6, feedback=False)
    assert np.abs(snap1[0]).max() > 0
    assert server.slots_free() == 1
    handle1.release()
    handle1.release()  # idempotent
    assert server.slots_free() == 2
    outs2, snap2, handle2 = _drive(server, env_out, 6, feedback=False)
    assert handle2.slot == handle1.slot
    for x, y in zip(outs1, outs2):
      np.testing.assert_array_equal(x[1], y[1])
      assert x[2] == y[2]
    for x, y in zip(snap1, snap2):
      np.testing.assert_array_equal(x, y)
    with pytest.raises(RuntimeError, match='released'):
      server.policy(np.int32(0), env_out(0), handle1)
    with pytest.raises(RuntimeError, match='released'):
      handle1.snapshot()
    with pytest.raises(TypeError, match='slot handle'):
      server.policy(np.int32(0), env_out(0), snap1)
  finally:
    server.close()


def test_actor_unroll_parity_with_the_carry_path():
  """Through the Actor (its priming call written back): two unrolls of
  the cache path equal the carry path's, agent_state (the unroll-start
  snapshot) included."""
  agent, params = _agent()
  results = {}
  for cache in (False, True):
    server = _server(agent, params, seed=11, inference_state_cache=cache)
    try:
      actor = Actor(FakeEnv(height=H, width=W, num_actions=A, seed=5,
                            episode_length=4),
                    server.policy, server.initial_core_state(), 6)
      results[cache] = (actor.unroll(), actor.unroll())
      actor.close()
      if cache:
        assert server.slots_free() == server.stats()['num_slots']
    finally:
      server.close()
  for a, b in zip(results[False], results[True]):
    for x, y in zip(a.agent_outputs, b.agent_outputs):
      np.testing.assert_array_equal(x, y)
    for x, y in zip(a.agent_state, b.agent_state):
      np.testing.assert_array_equal(x, y)
  assert np.abs(results[True][1].agent_state[0]).max() > 0


def test_an_actor_that_dies_mid_unroll_returns_its_slot():
  agent, params = _agent()
  server = _server(agent, params, inference_state_cache=True,
                   inference_timeout_ms=5)
  buf = ring_buffer.TrajectoryBuffer(8)
  total = server.slots_free()

  class DyingEnv(FakeEnv):

    def step(self, action):
      self._steps = getattr(self, '_steps', 0) + 1
      if self._steps >= 3:
        raise RuntimeError('env crashed mid-unroll')
      return super().step(action)

  failures = []
  actor = Actor(DyingEnv(height=H, width=W, num_actions=A, seed=0),
                server.policy, server.initial_core_state(), 8)
  try:
    assert server.slots_free() == total - 1
    run_actor_loop(actor, buf, threading.Event(), on_failure=failures.append)
    assert len(failures) == 1 and server.slots_free() == total
    snap = server.initial_core_state().snapshot()
    assert not np.abs(snap[0]).max() and not np.abs(snap[1]).max()
  finally:
    server.close()
    buf.close()


def test_a_close_under_parked_callers_releases_their_slots():
  agent, params = _agent()
  server = _server(agent, params, inference_state_cache=True,
                   inference_min_batch=8, inference_timeout_ms=60_000)
  buf = ring_buffer.TrajectoryBuffer(8)
  stop = threading.Event()
  total = server.slots_free()
  actors = [Actor(FakeEnv(height=H, width=W, num_actions=A, seed=i),
                  server.policy, server.initial_core_state(), 8)
            for i in range(2)]
  threads = [threading.Thread(target=run_actor_loop, args=(a, buf, stop),
                              daemon=True) for a in actors]
  for t in threads:
    t.start()
  time.sleep(0.3)
  assert server.slots_free() == total - 2
  stop.set()
  server.close()
  for t in threads:
    t.join(timeout=10)
  assert not any(t.is_alive() for t in threads)
  assert server.slots_free() == total
  buf.close()


@pytest.mark.parametrize('cache', [False, True])
def test_a_failed_forward_leaves_the_generator_and_the_arena(cache):
  """One forward raises: that batch's caller gets the error, the
  generator and the arena are as before the call, and the next calls
  draw and compute what a server that never failed gives."""
  agent, params = _agent()
  failing = _server(agent, params, inference_state_cache=cache)
  healthy = _server(agent, params, inference_state_cache=cache)
  try:
    env_out = _scripted(6)
    a, _, state_a = _drive(failing, env_out, 2)
    b, _, state_b = _drive(healthy, env_out, 2)
    _traces_equal(a, b)
    gen_before = failing._generator.get_state().clone()
    arena_before = ([t.clone() for t in failing._arena] if cache else None)
    real_apply = failing._apply
    calls = {'n': 0}

    def apply(snapshot, inputs, core, generator):
      calls['n'] += 1
      if calls['n'] == 1:
        torch.rand(4, generator=generator)  # a draw, then the failure
        raise RuntimeError('forward failed (injected)')
      return real_apply(snapshot, inputs, core, generator)

    failing._apply = apply
    with pytest.raises(BatcherError, match='injected'):
      failing.policy(np.int32(0), env_out(2), state_a)
    assert torch.equal(failing._generator.get_state(), gen_before)
    if cache:
      for x, y in zip(failing._arena, arena_before):
        assert torch.equal(x, y)
    assert failing.stats()['chain_recoveries'] == 1
    a, snap_a, _ = _drive(failing, lambda t: env_out(t + 2), 4, state_a)
    b, snap_b, _ = _drive(healthy, lambda t: env_out(t + 2), 4, state_b)
    _traces_equal(a, b)
    for x, y in zip(snap_a, snap_b):
      np.testing.assert_array_equal(x, y)
  finally:
    failing.close()
    healthy.close()


def test_stats_and_the_auto_arena_size():
  agent, params = _agent()
  server = _server(agent, params, inference_state_cache=True)
  try:
    _drive(server, _scripted(3), 3)
    stats = server.stats()
    assert stats['state_cache'] is True and stats['num_slots'] == 8
    assert stats['slots_free'] == 7 and stats['acquires'] == 1
    assert stats['h2d_bytes'] > 0 and stats['d2h_bytes'] > 0
  finally:
    server.close()
  server = InferenceServer(agent, params, Config(
      **_KW, inference_state_cache=True), fleet_size=16, pad_batch_to=30)
  try:
    assert server.stats()['num_slots'] == 60  # 2 x max(fleet, pad)
  finally:
    server.close()
  server = _server(agent, params)
  try:
    stats = server.stats()
    assert stats['state_cache'] is False and stats['slots_free'] is None
    assert server.initial_core_state()[0].shape == (1, 256)
  finally:
    server.close()
