"""Trajectory transport: a bounded unroll buffer and a batch prefetcher,
ported from the JAX package's runtime/ring_buffer.py (batch staging).

- `TrajectoryBuffer`: a bounded FIFO of completed unrolls. Producers
  (actor threads) block when it is full — capacity is the backpressure
  that bounds policy lag, the reference's capacity-1 queue.
- `BatchPrefetcher`: one thread that stacks [T+1, B] batches and stages
  the next `depth` of them while the learner trains on the current one
  (the reference's StagingArea). `place_fn` is where a batch moves to the
  device; the driver's stacks it into pinned host memory and copies it
  on a side stream (learner.place_batch), so the copy overlaps the
  learner's step.

The JAX module's replay tier (IMPACT sample reuse, ROADMAP A2) and its
per-unroll device staging (ROADMAP A5b) are not ported: `Config` refuses
both settings.
"""

import collections
import threading
import time
from typing import Callable, List, Optional

from scalable_agent_tpu_torch.runtime.actor import batch_unrolls


class Closed(Exception):
  """The buffer was closed while blocking."""


def _wait_until(cond: threading.Condition, predicate,
                deadline: Optional[float], what: str):
  """Wait on `cond` (held) until predicate() or the deadline (spurious
  wakeups do not restart the clock)."""
  while not predicate():
    remaining = None if deadline is None else deadline - time.monotonic()
    if remaining is not None and remaining <= 0:
      raise TimeoutError(f'{what} timed out')
    cond.wait(remaining)


class TrajectoryBuffer:
  """Bounded FIFO of unrolls with blocking put/get and backpressure."""

  def __init__(self, capacity_unrolls: int):
    if capacity_unrolls < 1:
      raise ValueError('capacity must be >= 1')
    self._capacity = capacity_unrolls
    self._deque = collections.deque()
    self._lock = threading.Lock()
    self._not_full = threading.Condition(self._lock)
    self._not_empty = threading.Condition(self._lock)
    self._closed = False
    self._high_water = 0
    self._put_waits = 0
    self._put_wait_secs = 0.0
    self._fresh_unrolls = 0

  def put(self, unroll, timeout: Optional[float] = None):
    """Block while full (backpressure); raises Closed after close() and
    TimeoutError past `timeout` seconds in all."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._not_full:
      if len(self._deque) >= self._capacity and not self._closed:
        self._put_waits += 1
        t0 = time.monotonic()
        try:
          _wait_until(self._not_full,
                      lambda: (len(self._deque) < self._capacity
                               or self._closed),
                      deadline, 'TrajectoryBuffer.put')
        finally:
          self._put_wait_secs += time.monotonic() - t0
      if self._closed:
        raise Closed()
      self._deque.append(unroll)
      self._high_water = max(self._high_water, len(self._deque))
      self._not_empty.notify()

  def get_unrolls(self, batch_size: int,
                  timeout: Optional[float] = None) -> List:
    """Dequeue `batch_size` unrolls in FIFO order. Each dequeue frees a
    producer slot at once; on timeout or close the partial batch goes
    back to the front, so no trajectory is dropped."""
    deadline = None if timeout is None else time.monotonic() + timeout
    items: List = []
    with self._not_empty:
      try:
        while len(items) < batch_size:
          _wait_until(self._not_empty, lambda: self._deque or self._closed,
                      deadline, 'TrajectoryBuffer.get_unrolls')
          if not self._deque:
            raise Closed()
          while self._deque and len(items) < batch_size:
            items.append(self._deque.popleft())
          self._not_full.notify_all()
      except (TimeoutError, Closed):
        # The push-back may briefly exceed capacity; keeping the
        # trajectories beats the strict lag bound on this error path.
        self._deque.extendleft(reversed(items))
        self._high_water = max(self._high_water, len(self._deque))
        if items:
          self._not_empty.notify_all()
        raise
      self._fresh_unrolls += len(items)
    return items

  def close(self):
    with self._lock:
      self._closed = True
      self._not_full.notify_all()
      self._not_empty.notify_all()

  def stats(self):
    """{'occupancy', 'capacity', 'high_water', 'put_waits',
    'put_wait_secs', 'fresh_unrolls'}: high_water at capacity with
    growing put_waits means the producers are throttled by backpressure
    — the bound working, not a failure."""
    with self._lock:
      return {
          'occupancy': len(self._deque),
          'capacity': self._capacity,
          'high_water': self._high_water,
          'put_waits': self._put_waits,
          'put_wait_secs': round(self._put_wait_secs, 4),
          'fresh_unrolls': self._fresh_unrolls,
      }

  def __len__(self):
    with self._lock:
      return len(self._deque)


class BatchPrefetcher:
  """Stages up to `depth` batches ahead of the learner.

  The staging thread takes `batch_size` unrolls, stacks them with
  `stack_fn` (actor.batch_unrolls by default) and hands the host batch to
  `place_fn`, whose result `get()` returns in FIFO order. An exception in
  the staging thread (place_fn's included) is raised by the next `get()`.
  `stats()` counts the gets that found nothing staged and blocked, and
  the seconds they waited: the share of the learner's time spent
  starved.
  """

  def __init__(self, buffer: TrajectoryBuffer, batch_size: int,
               place_fn: Callable = lambda batch: batch, depth: int = 2,
               stack_fn: Callable = batch_unrolls):
    if depth < 1:
      raise ValueError('staging depth must be >= 1')
    self._buffer = buffer
    self._batch_size = batch_size
    self._place_fn = place_fn
    self._stack_fn = stack_fn
    self._depth = depth
    self._out = collections.deque()
    self._lock = threading.Lock()
    self._ready = threading.Condition(self._lock)
    self._space = threading.Condition(self._lock)
    self._closed = False
    self._error: Optional[BaseException] = None
    self._staged = 0
    self._gets = 0
    self._blocked_gets = 0
    self._wait_secs = 0.0
    self._thread = threading.Thread(target=self._loop,
                                    name='batch-prefetcher', daemon=True)
    self._thread.start()

  def _loop(self):
    try:
      while True:
        items = self._buffer.get_unrolls(self._batch_size)
        staged = self._place_fn(self._stack_fn(items))
        with self._space:
          while len(self._out) >= self._depth and not self._closed:
            self._space.wait()
          if self._closed:
            return
          self._out.append(staged)
          self._staged += 1
          self._ready.notify()
    except Closed:
      with self._lock:
        self._closed = True
        self._ready.notify_all()
    except BaseException as e:  # raised by the consumer's get
      with self._lock:
        self._error = e
        self._closed = True
        self._ready.notify_all()

  def get(self, timeout: Optional[float] = None):
    """The next staged batch; raises the staging thread's error, Closed
    once closed and drained, TimeoutError past `timeout` seconds."""
    deadline = None if timeout is None else time.monotonic() + timeout
    t0 = time.monotonic()
    with self._ready:
      self._gets += 1
      blocked = not self._out and not self._closed
      if blocked:
        self._blocked_gets += 1
      try:
        _wait_until(self._ready, lambda: self._out or self._closed,
                    deadline, 'BatchPrefetcher.get')
      finally:
        if blocked:
          self._wait_secs += time.monotonic() - t0
      if self._error is not None:
        raise self._error
      if not self._out:
        raise Closed()
      item = self._out.popleft()
      self._space.notify()
      return item

  def stats(self):
    """{'depth', 'mode', 'staged_batches', 'gets', 'blocked_gets',
    'wait_secs', 'h2d_overlap_fraction'}: the overlap fraction is the
    share of gets that found a batch already staged."""
    with self._lock:
      gets = self._gets
      return {
          'depth': self._depth,
          'mode': 'batch',
          'staged_batches': self._staged,
          'gets': gets,
          'blocked_gets': self._blocked_gets,
          'wait_secs': round(self._wait_secs, 6),
          'h2d_overlap_fraction': ((gets - self._blocked_gets) / gets
                                   if gets else 0.0),
      }

  def close(self):
    """Stop staging, close the buffer (waking its producers), join the
    thread and drop the staged batches."""
    with self._lock:
      self._closed = True
      self._ready.notify_all()
      self._space.notify_all()
    self._buffer.close()
    self._thread.join(timeout=5)
    with self._lock:
      self._out.clear()
