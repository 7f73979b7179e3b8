"""Lock-order detection and the `guarded_by` annotation, copied from
scalable_agent_tpu/analysis/runtime.py.

The threaded runtime (fleet, inference server, ring buffer, batcher)
holds a dozen locks whose nesting order is a convention. A lock-order
inversion there is a deadlock of the whole fleet. Two pieces:

1. `guarded_by('<lock_attr>')`, a class-body annotation::

       class InferenceServer:
         _free: guarded_by('_slot_lock')

   declares that `self._free` is read and written only under
   `self._slot_lock`. It is an ordinary variable annotation: no
   attribute is made and nothing runs. The static pass that enforces it
   is ROADMAP A7.5.

2. `OrderedLock` / `make_lock(name)`: a drop-in `threading.Lock` /
   `RLock` that records the process-wide acquired-before graph over
   lock names and reports a `lock_order_inversion` the moment a thread
   attempts an acquisition that closes a cycle, whether or not the
   interleaving that deadlocks ever happens. Edges are recorded before
   a blocking acquire parks, so the half of an inversion that would
   have deadlocked still lands in the graph.

   Unarmed (the default) `make_lock` returns a plain
   `threading.Lock` / `RLock`: no cost, the same behaviour. Armed (the
   LOCK_ORDER_CHECK environment variable, or `--lock_order_check`
   through `driver.train`) it returns an `OrderedLock`. A detection
   increments the `analysis/lock_cycles` registry counter and, when a
   sink is wired (driver.train wires its EventLog), writes a durable
   `lock_order_inversion` incident.

Standard library only on the import path: the telemetry counter is
imported at the first arm or detection.
"""

import logging
import os
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

log = logging.getLogger('scalable_agent_tpu_torch')


class GuardedBy:
  """Sentinel produced by `guarded_by` — carries the lock attribute
  names for anyone introspecting `__annotations__` at runtime; the
  static checker reads the annotation call itself."""

  __slots__ = ('locks',)

  def __init__(self, locks: Tuple[str, ...]):
    self.locks = locks

  def __repr__(self):
    return f'guarded_by({", ".join(map(repr, self.locks))})'


def guarded_by(*lock_attrs: str) -> GuardedBy:
  """Annotation for attributes that must only be touched under a lock.

  Usage (class body)::

      class Fleet:
        _slots_rehabilitated: guarded_by('_lock')

  Multiple lock names mean ANY of them protects the attribute (the
  Condition-sharing case where several conditions wrap one mutex is
  instead auto-detected by the checker via
  `self.cond = threading.Condition(self.lock)` aliasing).
  """
  if not lock_attrs or not all(
      isinstance(a, str) and a for a in lock_attrs):
    raise ValueError('guarded_by needs at least one lock attribute '
                     f'name, got {lock_attrs!r}')
  return GuardedBy(tuple(lock_attrs))


class LockOrderInversion(RuntimeError):
  """Raised (raise mode only) when an acquisition closes a cycle in
  the process-wide lock-order graph."""


class _LockGraph:
  """Process-wide acquired-before graph over lock NAMES.

  An edge a -> b means some thread held `a` while acquiring (or
  attempting to acquire) `b`. A cycle means two threads disagree
  about the order — the classic ABBA deadlock shape — whether or not
  the deadlocking interleaving ever happened.
  """

  def __init__(self):
    self._mutex = threading.Lock()
    self._edges: Dict[str, Set[str]] = {}
    self._cycles: List[dict] = []

  def _path(self, src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst over current edges (called with _mutex)."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
      node, path = stack.pop()
      if node == dst:
        return path
      for nxt in self._edges.get(node, ()):
        if nxt not in seen:
          seen.add(nxt)
          stack.append((nxt, path + [nxt]))
    return None

  def record(self, target: str, held: List[str]) -> List[dict]:
    """Record held -> target edges; returns a report per NEW edge
    that closes a cycle (one acquisition while holding several locks
    can close several — each must be recorded, because the edge is
    inserted either way and the fast path below would suppress an
    unreported one forever). Fast path: every edge already known ->
    one set lookup per held lock, no mutex."""
    reports = []
    for h in held:
      if h == target:        # re-entry (RLock) — never an ordering edge
        continue
      known = self._edges.get(h)
      if known is not None and target in known:
        continue
      with self._mutex:
        edges = self._edges.setdefault(h, set())
        if target in edges:
          continue
        # Adding h -> target closes a cycle iff target already
        # reaches h. Find the path BEFORE inserting the edge so the
        # report shows the pre-existing opposite ordering.
        path = self._path(target, h)
        edges.add(target)
        if path is not None:
          report = {
              'holding': h,
              'acquiring': target,
              'cycle': path + [target],
              'thread': threading.current_thread().name,
          }
          self._cycles.append(report)
          reports.append(report)
    return reports

  def cycles(self) -> List[dict]:
    with self._mutex:
      return list(self._cycles)

  def reset(self):
    with self._mutex:
      self._edges.clear()
      self._cycles.clear()


_graph = _LockGraph()
_tls = threading.local()

_armed = os.environ.get('LOCK_ORDER_CHECK', '').lower() in (
    '1', 'true', 'yes')
_raise_on_cycle = False
_incident_sink: Optional[Callable] = None
_cycle_counter = None  # telemetry.Counter once armed


def _held_names() -> List[str]:
  return getattr(_tls, 'held', [])


def _ensure_counter():
  global _cycle_counter
  if _cycle_counter is None:
    try:
      from scalable_agent_tpu_torch import telemetry
      _cycle_counter = telemetry.counter('analysis/lock_cycles')
    except Exception:  # contexts without numpy
      pass


def _on_cycle(report: dict):
  _ensure_counter()
  log.error(
      'LOCK ORDER INVERSION: thread %s acquiring %r while holding %r '
      'but the opposite order is already recorded (cycle: %s) — two '
      'threads disagree about lock order; this is a latent deadlock',
      report['thread'], report['acquiring'], report['holding'],
      ' -> '.join(report['cycle']))
  if _cycle_counter is not None:
    _cycle_counter.inc()
  sink = _incident_sink
  if sink is not None:
    try:
      sink('lock_order_inversion', holding=report['holding'],
           acquiring=report['acquiring'],
           cycle=' -> '.join(report['cycle']),
           thread=report['thread'])
    except Exception:
      log.exception('lock_order_inversion incident sink failed')
  if _raise_on_cycle:
    raise LockOrderInversion(
        f"lock order inversion: acquiring {report['acquiring']!r} "
        f"while holding {report['holding']!r} (cycle "
        f"{' -> '.join(report['cycle'])})")


class OrderedLock:
  """Drop-in `threading.Lock`/`RLock` that records acquisition order.

  Works as a context manager, with `acquire(blocking, timeout)` /
  `release()` / `locked()`, and as the lock behind a
  `threading.Condition` (`_is_owned` answers from the per-thread held
  list, so `Condition.wait/notify` ownership asserts are exact, not
  the try-acquire probe the default fallback uses).

  Ordering edges are recorded at acquisition ATTEMPT time for
  blocking acquires (a thread parked forever in the deadlock still
  contributed its half of the cycle) and at SUCCESS time for
  non-blocking ones (a failed try-acquire — Condition's ownership
  probe shape — must not invent an edge that was never an ordering
  commitment).
  """

  __slots__ = ('name', '_lock', '_recursive')

  def __init__(self, name: str, recursive: bool = False):
    self.name = name
    self._recursive = recursive
    self._lock = threading.RLock() if recursive else threading.Lock()

  # -- ordering bookkeeping ------------------------------------------

  def _record_edges(self, held):
    for report in _graph.record(self.name, held):
      _on_cycle(report)  # raise mode: the first cycle raises; the
      # rest are already in the graph's report list either way

  # -- the lock API ---------------------------------------------------

  def acquire(self, blocking: bool = True, timeout: float = -1):
    held = getattr(_tls, 'held', None)
    if held is None:
      held = _tls.held = []
    # Fast path: nothing held -> no edge can exist; skip the graph.
    if blocking and held:
      self._record_edges(held)
    ok = self._lock.acquire(blocking, timeout)
    if ok:
      if not blocking and held:
        try:
          self._record_edges(held)
        except BaseException:
          # Raise mode: the cycle raises out of acquire() — the
          # just-acquired lock must be released first or it leaks
          # held-forever (the caller never saw a successful acquire).
          self._lock.release()
          raise
      held.append(self.name)
    return ok

  def release(self):
    held = _held_names()
    # Remove the most recent entry for this lock (re-entrant locks
    # stack duplicates).
    for i in range(len(held) - 1, -1, -1):
      if held[i] == self.name:
        del held[i]
        break
    self._lock.release()

  def __enter__(self):
    self.acquire()
    return self

  def __exit__(self, *exc):
    self.release()
    return False

  def locked(self) -> bool:
    probe = getattr(self._lock, 'locked', None)
    if probe is not None:
      return probe()
    # RLock pre-3.12 has no locked(); owned-by-someone approximation.
    if self._lock.acquire(False):
      self._lock.release()
      return False
    return True

  def _is_owned(self) -> bool:
    """threading.Condition ownership probe."""
    return self.name in _held_names()

  def __repr__(self):
    return f'OrderedLock({self.name!r})'


def make_lock(name: str, recursive: bool = False):
  """The adoption seam: an `OrderedLock` when detection is armed,
  else the plain stdlib lock (zero overhead, byte-identical). Armed
  state is read at CONSTRUCTION — arm before building components
  (driver.train does)."""
  if _armed:
    return OrderedLock(name, recursive=recursive)
  return threading.RLock() if recursive else threading.Lock()


def arm(enabled: bool = True, raise_on_cycle: Optional[bool] = None):
  """Turn detection on/off for locks constructed from here on. Lazily
  registers the `analysis/lock_cycles` counter on first arm (the
  telemetry import stays off the import path)."""
  global _armed, _raise_on_cycle, _cycle_counter
  _armed = enabled
  if raise_on_cycle is not None:
    _raise_on_cycle = raise_on_cycle
  if enabled:
    _ensure_counter()


def is_armed() -> bool:
  return _armed


def set_incident_sink(sink: Optional[Callable]):
  """`sink(kind, **fields)` — driver.train wires its EventLog.event so
  a detection lands as a durable `lock_order_inversion` incident."""
  global _incident_sink
  _incident_sink = sink


def cycles_detected() -> int:
  return len(_graph.cycles())


def cycle_reports() -> List[dict]:
  return _graph.cycles()


def reset():
  """Clear the graph and the held-lock bookkeeping (tests)."""
  _graph.reset()
  if hasattr(_tls, 'held'):
    _tls.held = []
