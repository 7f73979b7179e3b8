"""Actor fleet: env processes, actor threads and their health, ported
from the JAX package's runtime/fleet.py.

Beyond the reference's implicit fleet (queue-runner threads with no
failure detection), each actor slot has:
- a heartbeat (the last completed unroll),
- dead/stalled detection and a respawn of the env (process) and thread
  that leaves the rest of the fleet and the learner alone,
- a capped exponential respawn backoff with full jitter per slot, and a
  quarantine after `quarantine_after` consecutive respawns without one
  completed unroll,
- an elastic size (`set_target_size`): shrinking parks the
  highest-index contributing slots (each actor exits after its current
  unroll, and a parked slot leaves the quorum denominator); growing
  unparks parked slots first, then rehabilitates quarantined slots whose
  `probation_secs` cool-down has passed, on probation: one completed
  unroll clears it, a repeat failure re-quarantines at once.

A spawn refused by the inference server's slot admission
(SlotUnavailable, InferenceClosed) is overload, not a set-up error: at
start it is recorded on the slot and retried on the slot's backoff.
Trajectories of a respawned actor restart from a fresh episode.
"""

import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from scalable_agent_tpu_torch.analysis.runtime import guarded_by, make_lock
from scalable_agent_tpu_torch.runtime.actor import Actor, run_actor_loop

log = logging.getLogger('scalable_agent_tpu_torch')


def _is_admission_error(e: BaseException) -> bool:
  """Whether a spawn failure is inference-slot admission (retry later)
  rather than a set-up error (raise)."""
  from scalable_agent_tpu_torch.runtime.inference import (InferenceClosed,
                                                          SlotUnavailable)
  return isinstance(e, (SlotUnavailable, InferenceClosed))


class Backoff:
  """Capped exponential backoff with full jitter: the n-th delay is
  uniform in [0, min(cap, base * 2**n)], which keeps a fleet of retrying
  slots from moving in lockstep. `rng` is injectable for tests."""

  def __init__(self, base: float = 0.2, cap: float = 5.0, rng=None):
    if base <= 0 or cap <= 0:
      raise ValueError('base and cap must be > 0')
    self._base = base
    self._cap = cap
    self._rng = rng if rng is not None else random
    self._attempt = 0

  @property
  def attempt(self) -> int:
    return self._attempt

  def next_delay(self) -> float:
    ceiling = min(self._cap, self._base * (2 ** self._attempt))
    if self._base * (2 ** self._attempt) < self._cap:
      self._attempt += 1
    return self._rng.uniform(0.0, ceiling)

  def reset(self):
    self._attempt = 0


class _Slot:
  """One actor's mutable runtime state (env, thread, health)."""

  def __init__(self, index):
    self.index = index
    self.process = None          # PyProcess when process-hosted
    self.actor: Optional[Actor] = None
    self.thread: Optional[threading.Thread] = None
    self.generation = 0          # bumped on every (re)spawn
    self.last_heartbeat = time.monotonic()
    self.unrolls_done = 0
    self.respawns = 0
    self.error: Optional[BaseException] = None
    # Consecutive respawns since the last completed unroll, the slot's
    # jittered backoff, its earliest next respawn, and the give-up flag.
    self.respawn_streak = 0
    self.backoff = Backoff(base=0.5, cap=30.0)
    self.next_respawn_time = 0.0
    self.quarantined = False
    # The elastic size: a parked slot is idle on purpose (no spawn, no
    # health check, out of the quorum); `quarantined_at` starts the
    # probation cool-down, and a slot on `probation` re-quarantines at
    # its next failure.
    self.parked = False
    self.quarantined_at = 0.0
    self.probation = False


class ActorFleet:
  """N actors producing unrolls into a shared TrajectoryBuffer.

  Args:
    make_actor: (slot_index) -> (env, process_or_None, Actor); called at
      start and on every respawn, and must build a fresh env.
    buffer: the shared TrajectoryBuffer.
    num_actors: fleet size.
    quarantine_after: consecutive respawns without one completed unroll
      before the slot gives up (0 = never).
    probation_secs: the cool-down before `set_target_size` may
      rehabilitate a quarantined slot.
  """

  # Slot mutation and the rehabilitation counters happen under _lock;
  # the _Slot objects are reached only through _slots.
  _slots_rehabilitated: guarded_by('_lock')
  _rehabilitations: guarded_by('_lock')

  def __init__(self, make_actor: Callable, buffer, num_actors: int,
               quarantine_after: int = 5, probation_secs: float = 30.0):
    self._make_actor = make_actor
    self._buffer = buffer
    self._quarantine_after = int(quarantine_after)
    self._probation_secs = float(probation_secs)
    self._stop = threading.Event()
    self._lock = make_lock('fleet._lock')
    self._slots: List[_Slot] = [_Slot(i) for i in range(num_actors)]
    self._slots_rehabilitated = 0  # probations cleared by an unroll
    self._rehabilitations = 0      # probations started

  @property
  def stop_event(self):
    return self._stop

  def start(self):
    for slot in self._slots:
      if slot.parked:
        continue  # parked before start
      try:
        self._spawn(slot)
      except Exception as e:
        if not _is_admission_error(e):
          raise
        with self._lock:
          slot.error = e
          slot.thread = None
          slot.respawn_streak += 1
          slot.next_respawn_time = (time.monotonic()
                                    + slot.backoff.next_delay())
        log.warning('actor %d: start-time slot admission denied (%s); '
                    'retrying on its backoff', slot.index, e)

  def _spawn(self, slot: _Slot):
    _, process, actor = self._make_actor(slot.index)
    with self._lock:
      slot.generation += 1
      generation = slot.generation
      slot.process = process
      slot.actor = actor
      slot.error = None
      slot.last_heartbeat = time.monotonic()
    slot.thread = threading.Thread(
        target=self._run, args=(slot, generation, actor, process),
        name=f'actor-{slot.index}', daemon=True)
    slot.thread.start()

  def _run(self, slot: _Slot, generation: int, actor: Actor, process):
    """Thread body: run_actor_loop with the fleet's bookkeeping. It
    writes slot state only while it is the slot's current generation, so
    a thread orphaned by a respawn cannot mark its replacement dead.
    Failures are recorded on the slot; the buffer stays open for the
    other actors."""

    def still_current():
      return slot.generation == generation

    def on_unroll():
      with self._lock:
        if not still_current():
          return False  # orphaned: a replacement owns the slot
        slot.last_heartbeat = time.monotonic()
        slot.unrolls_done += 1
        slot.respawn_streak = 0
        slot.backoff.reset()
        slot.next_respawn_time = 0.0
        if slot.probation:
          slot.probation = False
          self._slots_rehabilitated += 1
          log.info('actor %d rehabilitated: its probation unroll '
                   'completed', slot.index)
        # Parked under us: this unroll landed; exit.
        return not slot.parked

    def on_failure(exc):
      with self._lock:
        if still_current():
          slot.error = exc

    try:
      run_actor_loop(actor, self._buffer, self._stop,
                     on_unroll=on_unroll, on_failure=on_failure)
    finally:
      if process is not None:
        try:
          process.close(timeout=2.0)
        except Exception:
          pass

  def check_health(self, stall_timeout_secs: Optional[float] = None
                   ) -> List[int]:
    """Detect failed or stalled actors and respawn them once their
    backoff has elapsed; returns the indices acted upon. The learner loop
    calls it while it waits for data."""
    if self._stop.is_set():
      return []
    now = time.monotonic()
    bad: List[_Slot] = []
    with self._lock:
      for slot in self._slots:
        if slot.quarantined or slot.parked:
          continue
        # A thread-less slot (unparked, never spawned) counts as dead.
        dead = (slot.error is not None or slot.thread is None
                or not slot.thread.is_alive())
        stalled = (stall_timeout_secs is not None and
                   now - slot.last_heartbeat > stall_timeout_secs)
        if (dead or stalled) and now >= slot.next_respawn_time:
          bad.append(slot)
    for slot in bad:
      self._respawn(slot)
    return [s.index for s in bad]

  def _respawn(self, slot: _Slot):
    # A stalled thread blocked in env.step cannot be killed: it is
    # orphaned (daemon) and a fresh actor takes the slot; its arena slot
    # frees when the thread unwinds. A dead thread's actor normally
    # released its slot on exit: releasing again is the backstop.
    if slot.process is not None:
      try:
        slot.process.close(timeout=1.0)
      except Exception:
        pass
    if (slot.actor is not None and
        (slot.thread is None or not slot.thread.is_alive())):
      slot.actor.release_policy_state()
    with self._lock:
      slot.respawns += 1
      slot.respawn_streak += 1
      slot.next_respawn_time = (time.monotonic()
                                + slot.backoff.next_delay())
      # A rehabilitated slot gets one probe spawn: a second respawn
      # without a completed unroll re-quarantines at once.
      give_up = ((self._quarantine_after > 0 and
                  slot.respawn_streak > self._quarantine_after) or
                 (slot.probation and slot.respawn_streak > 1))
      if give_up:
        slot.quarantined = True
        slot.quarantined_at = time.monotonic()
        slot.probation = False
        slot.thread = None
    if give_up:
      log.error(
          'actor %d QUARANTINED after %d consecutive respawns without '
          'a completed unroll (last error: %s); the rest of the fleet '
          'keeps feeding', slot.index, slot.respawn_streak, slot.error)
      return
    try:
      self._spawn(slot)
    except Exception as e:
      # A failed respawn stays on the slot: the next health check
      # retries after the slot's backoff.
      with self._lock:
        slot.error = e
        slot.thread = None

  def target_size(self) -> int:
    """Contributing slots: neither parked nor quarantined."""
    with self._lock:
      return sum(1 for s in self._slots
                 if not s.parked and not s.quarantined)

  def set_target_size(self, n: int) -> Dict[str, List[int]]:
    """Resize toward `n` contributing slots (thread-safe), never past the
    constructed count. Shrinking parks the highest-index contributing
    slots (each actor exits after its current unroll). Growing unparks
    parked slots, then rehabilitates quarantined slots whose cool-down
    has passed (on probation, their respawn ladder reset); the next
    check_health spawns them. Returns {'parked', 'unparked',
    'rehabilitated'} slot indices; fewer than asked when the remaining
    quarantined slots are still cooling down."""
    now = time.monotonic()
    report = {'parked': [], 'unparked': [], 'rehabilitated': []}
    with self._lock:
      n = max(0, min(int(n), len(self._slots)))
      contributing = [s for s in self._slots
                      if not s.parked and not s.quarantined]
      if n < len(contributing):
        for slot in reversed(contributing[n:]):
          slot.parked = True
          report['parked'].append(slot.index)
      elif n > len(contributing):
        need = n - len(contributing)
        for slot in self._slots:
          if need == 0:
            break
          if slot.parked and not slot.quarantined:
            # Spawn-eligible at once; an error from before the park is a
            # closed incident.
            slot.parked = False
            slot.error = None
            slot.next_respawn_time = 0.0
            report['unparked'].append(slot.index)
            need -= 1
        if need:
          ready = sorted((s for s in self._slots if s.quarantined and
                          now - s.quarantined_at >= self._probation_secs),
                         key=lambda s: s.quarantined_at)
          for slot in ready[:need]:
            slot.quarantined = False
            slot.probation = True
            slot.parked = False
            slot.respawn_streak = 0
            slot.backoff.reset()
            slot.next_respawn_time = 0.0
            slot.error = None
            self._rehabilitations += 1
            report['rehabilitated'].append(slot.index)
    for which in ('parked', 'unparked', 'rehabilitated'):
      if report[which]:
        log.warning('fleet resize -> %d contributing: %s slots %s', n,
                    which, report[which])
    return report

  def errors(self) -> List[BaseException]:
    """Errors the learner should act on now: those of live, unparked
    slots, or, when every active slot is quarantined, those of the dead
    fleet."""
    with self._lock:
      live = [s.error for s in self._slots
              if s.error is not None and not s.quarantined
              and not s.parked]
      if live:
        return live
      active = [s for s in self._slots if not s.parked]
      if active and all(s.quarantined for s in active):
        return [s.error for s in active if s.error is not None]
      return []

  def stats(self, healthy_horizon_secs: float = 60.0) -> Dict:
    """{'unrolls', 'respawns', 'alive', 'healthy', 'wedged',
    'healthy_fraction', 'slots_quarantined', 'parked', 'target_size',
    'rehabilitations', 'slots_rehabilitated'}. `healthy` is a live
    current-generation thread with no error and a heartbeat within the
    horizon; `wedged` is alive with no heartbeat in it; the quorum's
    denominator is the active (unparked) slots."""
    now = time.monotonic()
    with self._lock:
      alive = [s for s in self._slots
               if s.thread is not None and s.thread.is_alive()]
      fresh = [s for s in alive
               if s.error is None and not s.quarantined and not s.parked]
      healthy = [s for s in fresh
                 if now - s.last_heartbeat <= healthy_horizon_secs]
      active = sum(1 for s in self._slots if not s.parked)
      return {
          'unrolls': sum(s.unrolls_done for s in self._slots),
          'respawns': sum(s.respawns for s in self._slots),
          'alive': len(alive),
          'healthy': len(healthy),
          'wedged': len(fresh) - len(healthy),
          'healthy_fraction': len(healthy) / active if active else 1.0,
          'slots_quarantined': sum(1 for s in self._slots
                                   if s.quarantined),
          'parked': len(self._slots) - active,
          'target_size': sum(1 for s in self._slots
                             if not s.parked and not s.quarantined),
          'rehabilitations': self._rehabilitations,
          'slots_rehabilitated': self._slots_rehabilitated,
      }

  def _join_all(self, timeout: float, what: str) -> Dict[str, List[int]]:
    deadline = time.monotonic() + timeout
    unjoined: List[int] = []
    for slot in self._slots:
      if slot.thread is not None:
        slot.thread.join(max(0.0, deadline - time.monotonic()))
        if slot.thread.is_alive():
          unjoined.append(slot.index)
    if unjoined:
      log.warning('fleet %s: actors %s did not stop within %.1fs', what,
                  unjoined, timeout)
    return {'unjoined_actors': unjoined}

  def quiesce(self, timeout: float = 10.0) -> Dict[str, List[int]]:
    """Stop production without closing the buffer: each actor ends after
    its current unroll, which lands in the buffer for the learner to
    flush. Returns {'unjoined_actors': [...]}."""
    self._stop.set()
    return self._join_all(timeout, 'quiesce')

  def stop(self, timeout: float = 10.0) -> Dict[str, List[int]]:
    """Stop the fleet and close the buffer first, so an actor blocked in
    a full buffer's put wakes (Closed) and exits. Returns the same
    report as `quiesce`."""
    self._stop.set()
    self._buffer.close()
    return self._join_all(timeout, 'stop')
