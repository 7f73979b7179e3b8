"""Slot admission of the port's inference server (runtime/inference.py),
mirroring the JAX package's tests/test_overload.py: the block waitlist's
direct handover, priority order, shed counts, grow keeping carries,
close() answering parked waiters, the `slot_exhaustion` fault site,
set_admission, the fleet's deterministic quarantine of admission-denied
slots, and the counters in driver.train's summaries. One scripted
sequence runs through both packages' servers and their admission
counters agree."""

import json
import os
import random
import threading
import time

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu.runtime import inference as jax_inference
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.runtime import faults, ring_buffer
from scalable_agent_tpu_torch.runtime.fleet import ActorFleet, Backoff
from scalable_agent_tpu_torch.runtime.inference import (
    PRIORITY_EVAL, PRIORITY_LIVE, PRIORITY_RESPAWN, InferenceClosed,
    InferenceServer, SlotUnavailable)
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

torch.set_num_threads(1)

H, W, A = 24, 32, 3
_KW = dict(inference_state_cache=True, inference_min_batch=1,
           inference_timeout_ms=5, height=H, width=W, torso='shallow',
           use_instruction=False)


def _server(**overrides):
  config = Config(**dict(_KW, **overrides))
  agent = driver.build_agent(config, A)
  params = init_params(agent, torch.Generator().manual_seed(0))
  return InferenceServer(agent, params, config, seed=3, device='cpu')


def _wait_depth(server, depth):
  deadline = time.monotonic() + 5
  while (server.stats()['waitlist_depth'] < depth
         and time.monotonic() < deadline):
    time.sleep(0.01)
  assert server.stats()['waitlist_depth'] == depth


def test_block_waitlist_hands_over_released_slot():
  server = _server(inference_state_slots=1,
                   inference_admission_timeout_secs=10.0)
  try:
    h1 = server.initial_core_state()
    got = {}
    t = threading.Thread(
        target=lambda: got.update(handle=server.initial_core_state()),
        daemon=True)
    t.start()
    _wait_depth(server, 1)
    h1.release()
    t.join(timeout=5)
    assert not t.is_alive()
    h2 = got['handle']
    assert h2.slot == h1.slot
    with pytest.raises(RuntimeError, match='released'):
      h1.snapshot()
    with pytest.raises(RuntimeError, match='released'):
      h1.write((np.zeros((1, 256), np.float32),) * 2)
    assert not np.abs(h2.snapshot()[0]).max()
    assert server.stats()['admission_waits'] == 1
    h2.release()
  finally:
    server.close()


def test_priority_classes_order_the_waitlist():
  """A released slot goes to the LIVE waiter before the RESPAWN and EVAL
  ones parked earlier."""
  server = _server(inference_state_slots=1,
                   inference_admission_timeout_secs=10.0)
  try:
    h1 = server.initial_core_state()
    order = []

    def waiter(name, priority):
      handle = server.initial_core_state(priority=priority)
      order.append(name)
      handle.release()

    threads = []
    for depth, (name, priority) in enumerate(
        (('eval', PRIORITY_EVAL), ('respawn', PRIORITY_RESPAWN),
         ('live', PRIORITY_LIVE)), start=1):
      threads.append(threading.Thread(target=waiter, args=(name, priority),
                                      daemon=True))
      threads[-1].start()
      _wait_depth(server, depth)
    h1.release()
    for t in threads:
      t.join(timeout=5)
    assert order == ['live', 'respawn', 'eval']
  finally:
    server.close()


def test_shed_policy_counts_deadline_rejections():
  server = _server(inference_state_slots=1, inference_admission='shed',
                   inference_admission_timeout_secs=0.1)
  try:
    h1 = server.initial_core_state()
    with pytest.raises(SlotUnavailable, match='shed'):
      server.initial_core_state()
    stats = server.stats()
    assert (stats['sheds'], stats['admission_timeouts'],
            stats['admission']) == (1, 0, 'shed')
    h1.release()
  finally:
    server.close()


def test_block_deadline_is_an_admission_timeout_not_a_raise_on_exhaustion():
  server = _server(inference_state_slots=1,
                   inference_admission_timeout_secs=0.2)
  try:
    h1 = server.initial_core_state()
    with pytest.raises(SlotUnavailable, match='admission timeout'):
      server.initial_core_state()
    stats = server.stats()
    assert (stats['admission_timeouts'], stats['admission_waits'],
            stats['sheds']) == (1, 1, 0)
    h1.release()
    server.initial_core_state()
  finally:
    server.close()


def test_grow_policy_doubles_arena_and_preserves_carries():
  server = _server(inference_state_slots=2, inference_admission='grow')
  try:
    handles = [server.initial_core_state() for _ in range(2)]
    marker = (np.full((1, 256), 3.5, np.float32),
              np.full((1, 256), -1.25, np.float32))
    handles[0].write(marker)
    handles.append(server.initial_core_state())
    stats = server.stats()
    assert (stats['arena_grows'], stats['admission_waits'],
            stats['num_slots']) == (1, 0, 4)
    snap = handles[0].snapshot()
    np.testing.assert_array_equal(snap[0], marker[0])
    np.testing.assert_array_equal(snap[1], marker[1])
    assert not np.abs(handles[2].snapshot()[0]).max()
    for h in handles:
      h.release()
    assert server.slots_free() == 4
  finally:
    server.close()


def test_a_grow_between_staging_and_dispatch_keeps_the_scatter():
  """Callers step while another thread grows the arena: every carry the
  steps wrote is in the grown arena (the grow's copy is ordered after
  the scatters issued before it) and padded rows touch no live slot."""
  merged = dict(inference_min_batch=2, inference_timeout_ms=5000)
  server = _server(inference_state_slots=2, inference_admission='grow',
                   **merged)
  reference = _server(inference_state_slots=8, **merged)
  try:
    handles = [server.initial_core_state() for _ in range(2)]
    ref_handles = [reference.initial_core_state() for _ in range(2)]
    frame = np.random.RandomState(0).randint(0, 256, (H, W, 3)).astype(
        np.uint8)
    env = StepOutput(np.float32(0.5), StepOutputInfo(np.float32(0),
                                                     np.int32(0)),
                     np.bool_(False), (frame, np.zeros(16, np.int32)))
    grown = []

    def step_all(srv, hs, grow):
      threads = [threading.Thread(target=srv.policy,
                                  args=(np.int32(0), env, h)) for h in hs]
      for t in threads:
        t.start()
      if grow:
        grown.append(srv.initial_core_state())
      for t in threads:
        t.join(timeout=30)

    for k in range(3):
      step_all(server, handles, grow=k == 1)
      step_all(reference, ref_handles, grow=False)
    assert server.stats()['arena_grows'] == 1
    for h, r in zip(handles, ref_handles):
      for x, y in zip(h.snapshot(), r.snapshot()):
        np.testing.assert_array_equal(x, y)
    assert not np.abs(grown[0].snapshot()[0]).max()
  finally:
    server.close()
    reference.close()


def test_close_answers_parked_waiters():
  server = _server(inference_state_slots=1,
                   inference_admission_timeout_secs=60.0)
  h1 = server.initial_core_state()
  result = {}

  def waiter():
    try:
      server.initial_core_state()
      result['outcome'] = 'acquired'
    except InferenceClosed:
      result['outcome'] = 'closed'

  t = threading.Thread(target=waiter, daemon=True)
  t.start()
  _wait_depth(server, 1)
  server.close()
  t.join(timeout=5)
  assert not t.is_alive() and result['outcome'] == 'closed'
  assert server.stats()['unjoined_threads'] == 0
  with pytest.raises(InferenceClosed):
    server.initial_core_state()
  del h1


def test_slot_exhaustion_fault_forces_contended_path():
  assert 'slot_exhaustion' in faults.PORTED_SITES
  server = _server(inference_state_slots=4,
                   inference_admission_timeout_secs=10.0)
  plan = faults.FaultPlan([faults.Fault('slot_exhaustion', 0, 'force')])
  faults.install(plan)
  try:
    t0 = time.monotonic()
    h = server.initial_core_state()
    assert time.monotonic() - t0 < 5.0
    assert server.stats()['admission_waits'] == 1
    assert plan.stats()['slot_exhaustion']['fired'] == 1
    h.release()
  finally:
    faults.clear()
    server.close()
  # Under grow the forced acquire grows the arena.
  server = _server(inference_state_slots=2, inference_admission='grow')
  faults.install(faults.FaultPlan.storm(seed=0, slot_exhaustion_at=0,
                                        slot_exhaustion_len=1))
  try:
    server.initial_core_state()
    assert server.stats()['arena_grows'] == 1
  finally:
    faults.clear()
    server.close()


def test_set_admission_flips_live_policy_and_counters():
  server = _server(inference_state_slots=2,
                   inference_admission_timeout_secs=0.2)
  try:
    assert server.admission == 'block'
    held = [server.initial_core_state() for _ in range(2)]
    with pytest.raises(SlotUnavailable):
      server.initial_core_state()
    assert server.stats()['admission_timeouts'] == 1
    assert server.set_admission('shed') == 'block'
    assert server.admission == 'shed'
    with pytest.raises(SlotUnavailable):
      server.initial_core_state()
    assert server.stats()['sheds'] == 1
    server.set_admission('grow')
    server.initial_core_state().release()
    assert server.stats()['arena_grows'] == 1
    with pytest.raises(ValueError):
      server.set_admission('banana')
    for h in held:
      h.release()
  finally:
    server.close()


def test_the_admission_counters_are_jax_s_on_one_sequence():
  """block timeout, shed, grow and a handover, in the same order through
  both packages' servers: the same admission counters."""
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  jparams = jax_init_params(jagent, jax.random.PRNGKey(0),
                            {'frame': (H, W, 3), 'instr_len': 16})
  kw = dict(_KW, inference_state_slots=2,
            inference_admission_timeout_secs=0.1)
  servers = [jax_inference.InferenceServer(jagent, jparams,
                                           JaxConfig(**kw), seed=3),
             _server(**kw)]
  keys = ('acquires', 'admission_waits', 'sheds', 'admission_timeouts',
          'arena_grows', 'slots_free')
  stats = []
  try:
    for server in servers:
      held = [server.initial_core_state() for _ in range(2)]
      with pytest.raises(Exception, match='admission timeout'):
        server.initial_core_state()
      server.set_admission('shed')
      with pytest.raises(Exception, match='shed'):
        server.initial_core_state()
      server.set_admission('grow')
      held.append(server.initial_core_state())
      server.set_admission('block')
      held.pop(0).release()
      held.append(server.initial_core_state())
      stats.append({k: server.stats()[k] for k in keys})
  finally:
    for server in servers:
      server.close()
  assert stats[0] == stats[1]
  assert stats[1]['arena_grows'] == 1 and stats[1]['sheds'] == 1


def test_admission_denied_slots_quarantine_deterministically():
  """Slots whose every spawn is refused by admission quarantine after
  exactly quarantine_after + 1 denials, driven by health checks alone
  (zero-jitter backoff); start() degrades instead of raising."""

  class _ZeroJitter(random.Random):

    def uniform(self, a, b):
      return 0.0

  quarantine_after = 2
  attempts = {0: 0, 1: 0}

  def make_actor(i):
    attempts[i] += 1
    raise SlotUnavailable(f'arena exhausted (slot {i})')

  buffer = ring_buffer.TrajectoryBuffer(4)
  fleet = ActorFleet(make_actor, buffer, num_actors=2,
                     quarantine_after=quarantine_after)
  for slot in fleet._slots:
    slot.backoff = Backoff(base=1e-6, cap=1e-6, rng=_ZeroJitter())
  fleet.start()
  assert fleet.stats()['slots_quarantined'] == 0
  checks = 0
  while fleet.stats()['slots_quarantined'] < 2:
    fleet.check_health()
    checks += 1
    assert checks <= 2 * (quarantine_after + 2), attempts
  assert attempts == {0: quarantine_after, 1: quarantine_after}
  for _ in range(3):
    assert fleet.check_health() == []
  assert attempts == {0: quarantine_after, 1: quarantine_after}
  fleet.stop(timeout=2)

  def bad_actor(i):
    raise ValueError('a set-up error')

  with pytest.raises(ValueError, match='set-up'):
    ActorFleet(bad_actor, buffer, num_actors=1).start()
  buffer.close()


def test_overload_counters_reach_summaries(tmp_path):
  config = Config(env_backend='bandit', torso='shallow', height=H, width=W,
                  batch_size=2, num_actors=3, unroll_length=4,
                  num_action_repeats=1, use_instruction=False,
                  use_py_process=False, summary_secs=0,
                  total_environment_frames=10**6, inference_state_cache=True,
                  inference_state_slots=2, inference_admission='shed',
                  inference_admission_timeout_secs=0.05,
                  logdir=str(tmp_path))
  run = driver.train(config, max_steps=3, device='cpu')
  assert run.stats['server']['sheds'] >= 1
  with open(os.path.join(tmp_path, 'summaries.jsonl')) as f:
    events = [json.loads(line) for line in f]
  tags = {e['tag'] for e in events}
  for tag in ('inference_sheds', 'inference_admission_waits',
              'inference_arena_grows', 'slots_quarantined',
              'buffer_high_water', 'buffer_put_waits',
              'inference_resident_versions', 'inference_shadow_divergence'):
    assert tag in tags, tag
  assert max(e['value'] for e in events
             if e['tag'] == 'inference_sheds') >= 1
