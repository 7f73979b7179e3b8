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
- `UnrollBatchStager` (staging_mode='unroll'): the prefetcher hands it
  each unroll as it leaves the buffer; the unroll is copied into pinned
  memory and from there, on a side stream, into its slot of a zeroed
  device arena, so the copies trickle in while the learner trains
  instead of bursting at the step boundary, and the host stack of the
  frames disappears.

The JAX module's replay tier (IMPACT sample reuse, ROADMAP A2) is not
ported: `Config` refuses its settings.
"""

import collections
import contextlib
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.structs import ActorOutput, map_structure


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


class UnrollBatchStager:
  """A [T+1, B] device batch assembled from per-unroll copies (the JAX
  class of the same name, config.staging_mode='unroll').

  `add(unroll)` runs the moment an unroll (host numpy, an ActorOutput)
  leaves the TrajectoryBuffer: `host_view_fn` first peels its small host
  view (the batch never comes back to the host), then each leaf is
  copied into pinned memory and, on `copy_stream`, into its slot of a
  zeroed arena on `device`. A rank of the port has one device, so one
  arena holds its whole local batch (JAX's per-device arenas and their
  assembly into a global array have no counterpart). The arena holds
  the dtypes learner.place_batch gives (int64 actions), so the learner
  sees the batch the batch staging would give it, bit for bit.

  `finish()` waits for the batch's copies, marks the arena as used on
  `consumer_stream` (the learner's; default: the current stream), and
  emits it, through `finalize_fn(views, batch)` when given. The next
  `add` starts a fresh arena, so an emitted batch is never written
  again. On the CPU the copies are plain ones.

  Not thread-safe: the BatchPrefetcher's thread owns it. `abort()` drops
  a partial batch (idempotent).
  """

  def __init__(self, batch_size: int, device='cpu', host_view_fn=None,
               finalize_fn=None, copy_stream=None, consumer_stream=None):
    if batch_size < 1:
      raise ValueError('batch_size must be >= 1')
    self._batch_size = batch_size
    self._device = torch.device(device)
    self._host_view_fn = host_view_fn
    self._finalize_fn = finalize_fn
    self._cuda = self._device.type == 'cuda'
    self._copy_stream = copy_stream
    self._consumer_stream = consumer_stream
    self._arena = None
    self._views = []
    self._pinned = []   # this batch's host sources, alive to finish()
    self._next_slot = 0
    self.unrolls_staged = 0
    self.batches_assembled = 0
    self.aborted_partials = 0

  def _zero_arena(self, unroll):
    """A zeroed arena of the batch's rows, shaped from a real unroll."""

    def zeros(shape, dtype):
      dtype = torch.from_numpy(np.empty(0, dtype)).dtype
      return torch.zeros(shape, dtype=dtype, device=self._device)

    def traj(x):
      x = np.asarray(x)
      return zeros((x.shape[0], self._batch_size) + x.shape[1:], x.dtype)

    def lead(x):
      x = np.asarray(x)
      return zeros((self._batch_size,) + (x.shape[1:] if x.ndim else ()),
                   x.dtype)

    arena = ActorOutput(
        level_name=lead(unroll.level_name),
        agent_state=map_structure(lead, unroll.agent_state),
        env_outputs=map_structure(traj, unroll.env_outputs),
        agent_outputs=map_structure(traj, unroll.agent_outputs))
    actions = arena.agent_outputs.action.long()
    return arena._replace(
        agent_outputs=arena.agent_outputs._replace(action=actions))

  def _source(self, x):
    x = torch.as_tensor(np.asarray(x)).contiguous()
    if not self._cuda:
      return x
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    pinned.copy_(x)
    self._pinned.append(pinned)
    return pinned

  def _stream(self):
    return self._copy_stream or torch.cuda.current_stream(self._device)

  def add(self, unroll):
    """Stage one unroll into the next slot of the current batch."""
    if self._next_slot >= self._batch_size:
      raise RuntimeError('batch already full; call finish()')
    if self._host_view_fn is not None:
      self._views.append(self._host_view_fn(unroll))
    slot = self._next_slot
    with (torch.cuda.stream(self._stream()) if self._cuda
          else contextlib.nullcontext()):
      if self._arena is None:
        self._arena = self._zero_arena(unroll)
      arena = self._arena

      def traj(a, x):
        a[:, slot].copy_(self._source(x), non_blocking=self._cuda)

      def lead(a, x):
        x = np.asarray(x)
        a[slot].copy_(self._source(x[0] if x.ndim == a.ndim else x),
                      non_blocking=self._cuda)

      map_structure(traj, arena.env_outputs, unroll.env_outputs)
      map_structure(traj, arena.agent_outputs, unroll.agent_outputs)
      lead(arena.level_name, unroll.level_name)
      map_structure(lead, arena.agent_state, unroll.agent_state)
    self._next_slot += 1
    self.unrolls_staged += 1

  def finish(self):
    """Emit the completed batch (through `finalize_fn` when given) and
    start a fresh one."""
    if self._next_slot != self._batch_size:
      raise RuntimeError(
          f'finish() with {self._next_slot}/{self._batch_size} slots '
          'staged')
    batch, views = self._arena, self._views
    if self._cuda:
      done = torch.cuda.Event()
      done.record(self._stream())
      done.synchronize()  # the pinned sources may be freed after this
      consumer = (self._consumer_stream or
                  torch.cuda.current_stream(self._device))
      consumer.wait_event(done)
      map_structure(lambda t: t.record_stream(consumer), batch)
    self._arena, self._views, self._pinned = None, [], []
    self._next_slot = 0
    self.batches_assembled += 1
    if self._finalize_fn is not None:
      return self._finalize_fn(views, batch)
    return batch

  def abort(self):
    """Drop a partially staged batch. Idempotent."""
    if self._arena is not None or self._next_slot:
      self.aborted_partials += 1
    self._arena, self._views, self._pinned = None, [], []
    self._next_slot = 0

  def stats(self):
    return {'unrolls_staged': self.unrolls_staged,
            'batches_assembled': self.batches_assembled,
            'aborted_partials': self.aborted_partials}


class BatchPrefetcher:
  """Stages up to `depth` batches ahead of the learner.

  The staging thread takes `batch_size` unrolls, stacks them with
  `stack_fn` (actor.batch_unrolls by default) and hands the host batch to
  `place_fn`, whose result `get()` returns in FIFO order. An exception in
  the staging thread (place_fn's included) is raised by the next `get()`.
  `stats()` counts the gets that found nothing staged and blocked, and
  the seconds they waited: the share of the learner's time spent
  starved.

  With a `stager` (UnrollBatchStager) each unroll is staged the moment
  it leaves the buffer and the stager assembles the batch; `place_fn`
  and `stack_fn` are then unused.
  """

  def __init__(self, buffer: TrajectoryBuffer, batch_size: int,
               place_fn: Callable = lambda batch: batch, depth: int = 2,
               stack_fn: Callable = batch_unrolls,
               stager: Optional[UnrollBatchStager] = None):
    if depth < 1:
      raise ValueError('staging depth must be >= 1')
    self._buffer = buffer
    self._batch_size = batch_size
    self._place_fn = place_fn
    self._stack_fn = stack_fn
    self._stager = stager
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

  def _stage_next(self):
    if self._stager is None:
      return self._place_fn(self._stack_fn(
          self._buffer.get_unrolls(self._batch_size)))
    for _ in range(self._batch_size):
      self._stager.add(self._buffer.get_unrolls(1)[0])
    return self._stager.finish()

  def _loop(self):
    try:
      while True:
        staged = self._stage_next()
        with self._space:
          while len(self._out) >= self._depth and not self._closed:
            self._space.wait()
          if self._closed:
            return
          self._out.append(staged)
          self._staged += 1
          self._ready.notify()
    except Closed:
      if self._stager is not None:
        self._stager.abort()
      with self._lock:
        self._closed = True
        self._ready.notify_all()
    except BaseException as e:  # raised by the consumer's get
      if self._stager is not None:
        self._stager.abort()
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
    'wait_secs', 'h2d_overlap_fraction'} and, in unroll mode, the
    stager's counters: the overlap fraction is the share of gets that
    found a batch already staged."""
    with self._lock:
      gets = self._gets
      out = {
          'depth': self._depth,
          'mode': 'batch' if self._stager is None else 'unroll',
          'staged_batches': self._staged,
          'gets': gets,
          'blocked_gets': self._blocked_gets,
          'wait_secs': round(self._wait_secs, 6),
          'h2d_overlap_fraction': ((gets - self._blocked_gets) / gets
                                   if gets else 0.0),
      }
    if self._stager is not None:
      out.update(self._stager.stats())
    return out

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
