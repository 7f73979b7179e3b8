"""The port's lock-order checker (scalable_agent_tpu_torch/analysis/
runtime.py) against the JAX package's, on the CPU: the OrderedLock cases
of tests/test_analysis.py run through the port, the same acquisition
sequences through both packages give the same cycle reports, the
runtime's locks are built by `make_lock` under the JAX package's names
with its `guarded_by` annotations, and an armed tiny CPU fleet reads 0
cycles.

tests/conftest.py sets LOCK_ORDER_CHECK=1 before anything imports, so
both packages' checkers are armed here, as the JAX tests run them.
"""

import threading

import pytest

from scalable_agent_tpu.analysis import runtime as jax_runtime
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis import runtime as lock_runtime
from scalable_agent_tpu_torch.config import Config

BOTH = [pytest.param(jax_runtime, id='jax'),
        pytest.param(lock_runtime, id='port')]


def _isolate(module):
  module.reset()
  was = module.is_armed(), module._raise_on_cycle
  return was


def _restore(module, was):
  module.arm(was[0], raise_on_cycle=was[1])
  module.set_incident_sink(None)
  module.reset()


@pytest.fixture
def clean_graph():
  """Isolate the port's process-wide graph and raise mode per test."""
  was = _isolate(lock_runtime)
  yield
  _restore(lock_runtime, was)


@pytest.fixture
def clean_graphs():
  was = [_isolate(m) for m in (jax_runtime, lock_runtime)]
  yield
  for m, w in zip((jax_runtime, lock_runtime), was):
    _restore(m, w)


def _run(fn):
  th = threading.Thread(target=fn)
  th.start()
  th.join()


def _nest(*locks):
  def body():
    if not locks:
      return
    with locks[0]:
      _nest(*locks[1:])()
  return body


def test_make_lock_arming_seam(clean_graph):
  assert lock_runtime.is_armed()  # LOCK_ORDER_CHECK=1 (conftest)
  assert isinstance(lock_runtime.make_lock('t.armed'),
                    lock_runtime.OrderedLock)
  lock_runtime.arm(False)
  try:
    plain = lock_runtime.make_lock('t.plain')
    assert not isinstance(plain, lock_runtime.OrderedLock)
    assert isinstance(lock_runtime.make_lock('t.r', recursive=True),
                      type(threading.RLock()))
  finally:
    lock_runtime.arm(True)


def test_two_thread_opposite_order_detects_deterministically(clean_graph):
  """Thread 1 takes A then B; thread 2 takes B then A. They run one
  after the other, so nothing deadlocks, yet the cycle is flagged at
  thread 2's acquisition attempt."""
  a = lock_runtime.OrderedLock('t.A')
  b = lock_runtime.OrderedLock('t.B')
  events = []
  lock_runtime.set_incident_sink(lambda kind, **f: events.append((kind, f)))
  _run(_nest(a, b))
  assert lock_runtime.cycles_detected() == 0
  _run(_nest(b, a))
  assert lock_runtime.cycles_detected() == 1
  report = lock_runtime.cycle_reports()[0]
  assert report['holding'] == 't.B' and report['acquiring'] == 't.A'
  assert report['cycle'] == ['t.A', 't.B', 't.A']
  assert events and events[0][0] == 'lock_order_inversion'
  assert events[0][1]['cycle'] == 't.A -> t.B -> t.A'
  assert telemetry.registry().snapshot()['analysis/lock_cycles'] >= 1


def test_one_acquisition_closing_two_cycles_reports_both(clean_graph):
  a, b, c = (lock_runtime.OrderedLock(f't.M{i}') for i in (1, 2, 3))
  _run(_nest(c, a))
  _run(_nest(c, b))
  assert lock_runtime.cycles_detected() == 0
  _run(_nest(a, b, c))  # holding [A, B], acquire C: two cycles
  assert lock_runtime.cycles_detected() == 2
  assert {(r['holding'], r['acquiring'])
          for r in lock_runtime.cycle_reports()} == {('t.M1', 't.M3'),
                                                     ('t.M2', 't.M3')}


def test_consistent_order_never_flags(clean_graph):
  a = lock_runtime.OrderedLock('t.C')
  b = lock_runtime.OrderedLock('t.D')

  def worker():
    for _ in range(50):
      _nest(a, b)()

  threads = [threading.Thread(target=worker) for _ in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  assert lock_runtime.cycles_detected() == 0


def test_raise_mode_raises(clean_graph):
  lock_runtime.arm(True, raise_on_cycle=True)
  a = lock_runtime.OrderedLock('t.E')
  b = lock_runtime.OrderedLock('t.F')
  _nest(a, b)()
  caught = []

  def t2():
    try:
      _nest(b, a)()
    except lock_runtime.LockOrderInversion as e:
      caught.append(e)

  _run(t2)
  assert len(caught) == 1
  assert 't.E' in str(caught[0]) and 't.F' in str(caught[0])
  # The raise left no lock held.
  assert a.acquire(blocking=False) and b.acquire(blocking=False)
  a.release()
  b.release()


def test_raise_mode_nonblocking_cycle_releases_lock(clean_graph):
  lock_runtime.arm(True, raise_on_cycle=True)
  a = lock_runtime.OrderedLock('t.NBR1')
  b = lock_runtime.OrderedLock('t.NBR2')
  _run(_nest(b, a))  # b -> a
  caught = []

  def t2():
    with a:
      try:
        b.acquire(blocking=False)  # succeeds, closes the cycle
      except lock_runtime.LockOrderInversion as e:
        caught.append(e)

  _run(t2)
  assert len(caught) == 1
  assert b.acquire(blocking=False)  # the raise path released it
  b.release()


def test_reentrant_lock_draws_no_self_edge(clean_graph):
  r = lock_runtime.OrderedLock('t.R', recursive=True)
  with r:
    with r:
      assert r._is_owned()
  assert not r._is_owned()
  assert lock_runtime.cycles_detected() == 0


def test_condition_over_an_ordered_lock(clean_graph):
  lock = lock_runtime.OrderedLock('t.cond')
  cv = threading.Condition(lock)
  box = []

  def consumer():
    with cv:
      while not box:
        cv.wait(timeout=5.0)
      box.append('seen')

  th = threading.Thread(target=consumer)
  th.start()
  with cv:
    box.append('item')
    cv.notify()
  th.join(timeout=5.0)
  assert not th.is_alive() and box == ['item', 'seen']
  assert lock_runtime.cycles_detected() == 0


def test_nonblocking_acquire_failure_records_no_edge(clean_graph):
  a = lock_runtime.OrderedLock('t.NB1')
  b = lock_runtime.OrderedLock('t.NB2')
  b.acquire()

  def prober():
    with a:
      assert not b.acquire(blocking=False)

  _run(prober)
  b.release()
  _nest(b, a)()  # had the failed probe recorded a -> b, this would flag
  assert lock_runtime.cycles_detected() == 0


def test_guarded_by_is_inert_and_validates():
  for module in (jax_runtime, lock_runtime):
    g = module.guarded_by('_a', '_b')
    assert g.locks == ('_a', '_b') and repr(g) == "guarded_by('_a', '_b')"
    with pytest.raises(ValueError):
      module.guarded_by()


# Acquisition scripts: each a list of per-thread nestings, run in order.
_SCRIPTS = {
    'abba': [('A', 'B'), ('B', 'A')],
    'triangle': [('A', 'B'), ('B', 'C'), ('C', 'A')],
    'two_at_once': [('C', 'A'), ('C', 'B'), ('A', 'B', 'C')],
    'consistent': [('A', 'B', 'C'), ('A', 'C'), ('B', 'C')],
    'reentrant': [('R', 'R', 'A'), ('A', 'B')],
}


@pytest.mark.parametrize('script', sorted(_SCRIPTS))
def test_cycle_reports_match_jax(script, clean_graphs):
  reports = {}
  for module in (jax_runtime, lock_runtime):
    locks = {n: module.OrderedLock(f'p.{n}', recursive=n == 'R')
             for n in 'ABCR'}
    for nesting in _SCRIPTS[script]:
      _run(_nest(*[locks[n] for n in nesting]))
    reports[module] = [
        {k: v for k, v in r.items() if k != 'thread'}
        for r in module.cycle_reports()]
  assert reports[lock_runtime] == reports[jax_runtime]
  assert (len(reports[lock_runtime]) > 0) == (script in (
      'abba', 'triangle', 'two_at_once'))


# --- the runtime's locks -------------------------------------------------


def _lock_classes():
  from scalable_agent_tpu.ops import dynamic_batching as jax_db
  from scalable_agent_tpu.runtime import fleet as jax_fleet
  from scalable_agent_tpu.runtime import ring_buffer as jax_rb
  from scalable_agent_tpu_torch.ops import dynamic_batching
  from scalable_agent_tpu_torch.runtime import fleet, ring_buffer
  return [(ring_buffer.ReplayTier, jax_rb.ReplayTier),
          (ring_buffer.TrajectoryBuffer, jax_rb.TrajectoryBuffer),
          (ring_buffer.BatchPrefetcher, jax_rb.BatchPrefetcher),
          (fleet.ActorFleet, jax_fleet.ActorFleet),
          (dynamic_batching.Batcher, jax_db.Batcher)]


@pytest.mark.parametrize('index', range(5))
def test_guarded_by_annotations_match_jax(index):
  port_cls, jax_cls = _lock_classes()[index]

  def guarded(cls):
    return {k: v.locks for k, v in vars(cls).get(
        '__annotations__', {}).items()
            if type(v).__name__ == 'GuardedBy'}

  assert guarded(port_cls) and guarded(port_cls) == guarded(jax_cls)


def test_the_runtime_builds_its_locks_under_the_jax_names():
  from scalable_agent_tpu_torch.runtime import ring_buffer
  tier = ring_buffer.ReplayTier(2)
  buffer = ring_buffer.TrajectoryBuffer(2, replay=tier, replay_ratio=0.5)
  prefetcher = ring_buffer.BatchPrefetcher(buffer, 1)
  try:
    names = {lock.name for lock in (tier._lock, buffer._lock,
                                    prefetcher._lock)}
    assert names == {'ring_buffer.ReplayTier._lock',
                     'ring_buffer.TrajectoryBuffer._lock',
                     'ring_buffer.BatchPrefetcher._lock'}
    # The conditions wrap the ordered lock.
    assert buffer._not_full._lock is buffer._lock
    assert prefetcher._ready._lock is prefetcher._lock
  finally:
    prefetcher.close()


def test_an_armed_fleet_reads_no_cycle(tmp_path):
  lock_runtime.reset()
  before = telemetry.registry().snapshot().get('analysis/lock_cycles', 0)
  cfg = Config(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
               batch_size=2, unroll_length=5, num_action_repeats=1,
               episode_length=4, height=24, width=32, torso='shallow',
               use_py_process=False, use_instruction=False,
               inference_timeout_ms=5, summary_secs=0, seed=3,
               inference_state_cache=True, lock_order_check=True)
  run = driver.train(cfg, max_steps=3, device='cpu', stall_timeout_secs=60)
  assert run.state.update_steps == 3
  # The server's and the buffer's locks were ordered locks in this run.
  assert isinstance(run.server._slot_lock, lock_runtime.OrderedLock)
  assert run.server._lock.name == 'inference._params_lock'
  assert run.fleet._lock.name == 'fleet._lock'
  assert lock_runtime.cycles_detected() == 0, lock_runtime.cycle_reports()
  assert telemetry.registry().snapshot()['analysis/lock_cycles'] == before
  with open(tmp_path / 'incidents.jsonl') as f:
    assert 'lock_order_inversion' not in f.read()
