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
- `ReplayTier` (IMPACT sample reuse, arXiv 1912.00167): a circular arena
  of consumed unrolls behind the TrajectoryBuffer. `get_unrolls`
  composes each batch fresh first, then a replay_ratio share of replayed
  unrolls, and the prefetcher serves every staged batch `replay_k` times
  before it frees the slot (the staged device batch is handed over
  unchanged: no re-stage, no second copy). Episode stats and fresh-frame
  counts take only the fresh slots of a batch's first serve.
"""

import collections
import contextlib
import logging
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.structs import ActorOutput, map_structure

log = logging.getLogger('scalable_agent_tpu_torch')


class Closed(Exception):
  """The buffer was closed while blocking."""


class ReplayTier:
  """Circular replay arena of completed unrolls (the JAX class).

  Consumed unrolls are retained by reference (host numpy, immutable once
  an actor enqueued them) with the param version current at retention.
  `sample(n)` hands out up to n unrolls from a circular read cursor
  (IMPACT reads its buffer sequentially), evicting in passing:

  - by AGE: a full ring's oldest entry is overwritten by a new unroll
    (`evictions_age`): capacity is the age bound;
  - by VERSION: an entry more than `max_staleness` published param
    versions behind the current one (`evictions_version`); 0 = no bound;
  - by CONTENT (`verify_crc`): each entry keeps the CRC of its bytes at
    insert and is re-verified at every serve; a mismatch evicts instead
    of serving (`evictions_crc`).

  Thread-safe (its own lock; it never calls back into the buffer).
  """

  def __init__(self, capacity_unrolls: int, max_staleness: int = 0,
               verify_crc: bool = True):
    if capacity_unrolls < 1:
      raise ValueError('replay capacity must be >= 1')
    self._capacity = capacity_unrolls
    self._max_staleness = max_staleness
    self._verify_crc = bool(verify_crc)
    self._entries = collections.deque()  # (unroll, version, crc or None)
    self._cursor = 0
    self._lock = threading.Lock()
    self._version = 0
    self.evictions_age = 0
    self.evictions_version = 0
    self.evictions_crc = 0
    self.reused_unrolls = 0
    self._staleness_sum = 0
    self._staleness_samples = 0
    self._last_sample = (0, 0)  # (count, staleness sum): unsample_last

  def note_param_version(self, version: int):
    """Advance the current published param version: the clock of the
    staleness accounting and of the version eviction."""
    with self._lock:
      self._version = max(self._version, int(version))

  def add(self, unroll: ActorOutput):
    # The insert-time CRC is computed outside the lock.
    crc = integrity.tree_digest(unroll) if self._verify_crc else None
    with self._lock:
      if len(self._entries) >= self._capacity:
        self._entries.popleft()
        self.evictions_age += 1
        if self._cursor > 0:
          self._cursor -= 1  # the cursor stays on the same entry
      self._entries.append((unroll, self._version, crc))

  def sample(self, n: int) -> List[ActorOutput]:
    """Up to `n` unrolls from the circular cursor, at most one lap per
    call (fewer when the tier is short, or when version or CRC eviction
    thins the pick). Each delivered serve counts toward `reused_unrolls`
    and the mean staleness. The CRC verification runs outside the lock;
    a rotted entry is evicted by identity and shrinks this call's pick."""
    picked: List[Tuple] = []  # (entry, staleness), CRC pending
    with self._lock:
      budget = len(self._entries)
      while len(picked) < n and self._entries and budget > 0:
        budget -= 1
        if self._cursor >= len(self._entries):
          self._cursor = 0
        entry = self._entries[self._cursor]
        staleness = self._version - entry[1]
        if self._max_staleness and staleness > self._max_staleness:
          del self._entries[self._cursor]
          self.evictions_version += 1
          continue
        picked.append((entry, staleness))
        self._cursor += 1
    verified, rotten = [], []
    for entry, staleness in picked:
      unroll, _, crc = entry
      if crc is not None and integrity.tree_digest(unroll) != crc:
        rotten.append(entry)
      else:
        verified.append((entry, staleness))
    with self._lock:
      for entry in rotten:
        for idx, cand in enumerate(self._entries):
          if cand is entry:
            del self._entries[idx]
            if idx < self._cursor:
              self._cursor -= 1
            self.evictions_crc += 1
            break
      sample_staleness = 0
      for _, staleness in verified:
        self.reused_unrolls += 1
        self._staleness_sum += staleness
        self._staleness_samples += 1
        sample_staleness += staleness
      self._last_sample = (len(verified), sample_staleness)
    return [entry[0] for entry, _ in verified]

  def unsample_last(self):
    """Undo the accounting of the most recent sample(), whose batch was
    not delivered (the fresh side timed out or closed): the cursor steps
    back so the same entries serve next, and the reuse and staleness
    counters forget them. Version evictions stand. A repeated call is a
    no-op."""
    with self._lock:
      n, staleness_sum = self._last_sample
      self._last_sample = (0, 0)
      if n == 0:
        return
      if self._entries:
        self._cursor = (self._cursor - n) % len(self._entries)
      self.reused_unrolls -= n
      self._staleness_sum -= staleness_sum
      self._staleness_samples -= n

  def __len__(self):
    with self._lock:
      return len(self._entries)

  def stats(self):
    with self._lock:
      mean_staleness = (self._staleness_sum / self._staleness_samples
                        if self._staleness_samples else 0.0)
      return {
          'replay_occupancy': len(self._entries),
          'replay_capacity': self._capacity,
          'replay_evictions_age': self.evictions_age,
          'replay_evictions_version': self.evictions_version,
          'replay_evictions_crc': self.evictions_crc,
          'replay_reused_unrolls': self.reused_unrolls,
          'replay_mean_staleness': round(mean_staleness, 3),
      }


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
  """Bounded FIFO of unrolls with blocking put/get and backpressure.

  With a `ReplayTier` every fresh unroll dequeued is retained into the
  tier on its way out, and `get_unrolls` composes each batch fresh
  first, then replayed, per `replay_ratio`. The FIFO's semantics
  (backpressure, order, push-back on timeout or close) are unchanged.
  """

  def __init__(self, capacity_unrolls: int,
               replay: Optional[ReplayTier] = None,
               replay_ratio: float = 0.0):
    if capacity_unrolls < 1:
      raise ValueError('capacity must be >= 1')
    if not 0.0 <= replay_ratio < 1.0:
      raise ValueError('replay_ratio must be in [0, 1)')
    if replay_ratio > 0 and replay is None:
      raise ValueError('replay_ratio > 0 needs a ReplayTier')
    self._capacity = capacity_unrolls
    self._replay = replay
    self._replay_ratio = replay_ratio
    self._deque = collections.deque()
    self._lock = threading.Lock()
    self._not_full = threading.Condition(self._lock)
    self._not_empty = threading.Condition(self._lock)
    self._closed = False
    self._high_water = 0
    self._put_waits = 0
    self._put_wait_secs = 0.0
    # Unrolls that left the FIFO toward the learner. It runs ahead of
    # training by the prefetch lookahead: frame budgets read the
    # prefetcher's serve-time fresh_slots_served instead.
    self._fresh_unrolls = 0

  @property
  def replay(self) -> Optional[ReplayTier]:
    return self._replay

  def note_param_version(self, version: int):
    """The publish cadence -> the replay tier's staleness clock (a no-op
    without a tier)."""
    if self._replay is not None:
      self._replay.note_param_version(version)

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

  def get(self, timeout: Optional[float] = None):
    """One fresh unroll (retained into the replay tier); blocks while
    empty, raises Closed once closed and drained."""
    deadline = None if timeout is None else time.monotonic() + timeout
    with self._not_empty:
      _wait_until(self._not_empty, lambda: self._deque or self._closed,
                  deadline, 'TrajectoryBuffer.get')
      if not self._deque:
        raise Closed()
      item = self._deque.popleft()
      self._fresh_unrolls += 1
      self._not_full.notify()
    if self._replay is not None:
      self._replay.add(item)
    return item

  def sample_replay(self, batch_size: int) -> List:
    """The replayed part of one composed batch: up to
    floor(batch_size * replay_ratio) unrolls from the tier, [] without
    one. Sampled before the fresh fetch, so a batch never replays an
    unroll it also consumes fresh."""
    if self._replay is None or self._replay_ratio == 0:
      return []
    return self._replay.sample(int(batch_size * self._replay_ratio))

  def get_unrolls(self, batch_size: int, timeout: Optional[float] = None
                  ) -> Tuple[List, int]:
    """One batch's unrolls and the count of fresh ones among them: the
    fresh unrolls first (slots
    [0, n_fresh)), then the replayed ones. Each dequeue frees a producer
    slot at once; on timeout or close the partial fresh batch goes back
    to the front, so no trajectory is dropped, and the replayed part's
    accounting is given back to the tier. Every fresh dequeue is
    retained into the tier."""
    replayed = self.sample_replay(batch_size)
    n_fresh = batch_size - len(replayed)
    deadline = None if timeout is None else time.monotonic() + timeout
    items: List = []
    with self._not_empty:
      try:
        while len(items) < n_fresh:
          _wait_until(self._not_empty, lambda: self._deque or self._closed,
                      deadline, 'TrajectoryBuffer.get_unrolls')
          if not self._deque:
            raise Closed()
          while self._deque and len(items) < n_fresh:
            items.append(self._deque.popleft())
          self._not_full.notify_all()
      except (TimeoutError, Closed):
        # The push-back may briefly exceed capacity; keeping the
        # trajectories beats the strict lag bound on this error path.
        self._deque.extendleft(reversed(items))
        self._high_water = max(self._high_water, len(self._deque))
        if items:
          self._not_empty.notify_all()
        if replayed:
          self._replay.unsample_last()
        raise
      self._fresh_unrolls += len(items)
    if self._replay is not None:
      for item in items:
        self._replay.add(item)
    return items + replayed, n_fresh

  def close(self):
    with self._lock:
      self._closed = True
      self._not_full.notify_all()
      self._not_empty.notify_all()

  def stats(self):
    """{'occupancy', 'capacity', 'high_water', 'put_waits',
    'put_wait_secs', 'fresh_unrolls'}, and the replay tier's counters
    when one is attached: high_water at capacity with growing put_waits
    means the producers are throttled by backpressure — the bound
    working, not a failure."""
    with self._lock:
      out = {
          'occupancy': len(self._deque),
          'capacity': self._capacity,
          'high_water': self._high_water,
          'put_waits': self._put_waits,
          'put_wait_secs': round(self._put_wait_secs, 4),
          'fresh_unrolls': self._fresh_unrolls,
      }
    if self._replay is not None:
      out.update(self._replay.stats())
    return out

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

  def add(self, unroll, peel_view: bool = True):
    """Stage one unroll into the next slot of the current batch;
    `peel_view=False` (a replayed unroll, whose episodes were recorded
    at its first consumption) skips the host view."""
    if self._next_slot >= self._batch_size:
      raise RuntimeError('batch already full; call finish()')
    if peel_view and self._host_view_fn is not None:
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

  The staging thread takes a batch's unrolls (`TrajectoryBuffer.
  get_unrolls`), stacks them with `stack_fn` (actor.batch_unrolls by
  default) and hands the host batch to `place_fn`, whose result `get()`
  returns in FIFO order. An exception in the staging thread (place_fn's
  included) is raised by the next `get()`. `stats()` counts the gets
  that found nothing staged and blocked, and the seconds they waited:
  the share of the learner's time spent starved.

  With a `stager` (UnrollBatchStager) each unroll is staged the moment
  it leaves the buffer and the stager assembles the batch; `place_fn`
  and `stack_fn` are then unused.

  Sample reuse: each staged batch is served `replay_k` times before its
  slot frees, the staged batch handed over unchanged; serves after the
  first go through `reserve_fn` (when given), so the caller can blank
  the host stats view (a re-serve consumes no new env frames). When the
  buffer has a replay tier, `place_fn` is called as `place_fn(batch,
  n_fresh)`, the composed batch's count of fresh slots (first), and in
  unroll mode the replayed unrolls are staged without their host view.
  `fresh_slots_served()` counts the fresh slots of first-served
  batches: the serve-time env-frame clock, immune to the lookahead.
  `set_replay_k` changes the count for batches staged after the call.
  """

  def __init__(self, buffer: TrajectoryBuffer, batch_size: int,
               place_fn: Callable = lambda batch, n_fresh=None: batch,
               depth: int = 2, stack_fn: Callable = batch_unrolls,
               stager: Optional[UnrollBatchStager] = None,
               replay_k: int = 1, reserve_fn: Optional[Callable] = None):
    if depth < 1:
      raise ValueError('staging depth must be >= 1')
    if replay_k < 1:
      raise ValueError('replay_k must be >= 1')
    self._buffer = buffer
    self._batch_size = batch_size
    self._place_fn = place_fn
    self._stack_fn = stack_fn
    self._stager = stager
    self._depth = depth
    self._replay_k = replay_k
    self._reserve_fn = reserve_fn
    self._fresh_aware = buffer.replay is not None
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
    self._serves = 0
    self._reserves = 0
    self._fresh_served = 0
    self._thread = threading.Thread(target=self._loop,
                                    name='batch-prefetcher', daemon=True)
    self._thread.start()

  def _stage_next(self):
    """Stage one batch; returns (staged, n_fresh)."""
    if self._stager is None:
      items, n_fresh = self._buffer.get_unrolls(self._batch_size)
      batch = self._stack_fn(items)
      if self._fresh_aware:
        return self._place_fn(batch, n_fresh), n_fresh
      return self._place_fn(batch), n_fresh
    # Each fresh unroll is staged the moment it leaves the buffer; the
    # replayed ones, at hand at once, fill the tail of the batch.
    replayed = self._buffer.sample_replay(self._batch_size)
    n_fresh = self._batch_size - len(replayed)
    for _ in range(n_fresh):
      self._stager.add(self._buffer.get())
    for unroll in replayed:
      self._stager.add(unroll, peel_view=False)
    return self._stager.finish(), n_fresh

  def _loop(self):
    try:
      while True:
        staged, n_fresh = self._stage_next()
        with self._space:
          while len(self._out) >= self._depth and not self._closed:
            self._space.wait()
          if self._closed:
            return
          # [staged, serves left, n_fresh, the K it was staged under]:
          # the entry frees its slot after its K-th serve; its fresh
          # slots count at its first serve.
          k = self._replay_k
          self._out.append([staged, k, n_fresh, k])
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

  def ready(self) -> bool:
    """Whether a `get()` now would not block: a batch is staged, or the
    prefetcher is closed or failed (get() then raises at once). A probe:
    it consumes nothing and counts in no wait statistic (the hybrid
    filler's yield check)."""
    with self._lock:
      return bool(self._out) or self._closed

  def get(self, timeout: Optional[float] = None):
    """The next staged batch (a batch is served replay_k times in a
    row); raises the staging thread's error, Closed once closed and
    drained, TimeoutError past `timeout` seconds."""
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
      entry = self._out[0]
      item = entry[0]
      first_serve = entry[1] == entry[3]
      entry[1] -= 1
      if entry[1] <= 0:
        self._out.popleft()
        self._space.notify()
      self._serves += 1
      if first_serve:
        self._fresh_served += entry[2]
      else:
        self._reserves += 1
    if not first_serve and self._reserve_fn is not None:
      item = self._reserve_fn(item)
    return item

  @property
  def replay_k(self) -> int:
    with self._lock:
      return self._replay_k

  def set_replay_k(self, k: int):
    """Change replay_k for the batches staged after this call; staged
    entries finish the K they were staged under."""
    k = int(k)
    if k < 1:
      raise ValueError('replay_k must be >= 1')
    with self._lock:
      if k != self._replay_k:
        log.warning('prefetcher replay_k: %d -> %d', self._replay_k, k)
      self._replay_k = k

  def fresh_slots_served(self) -> int:
    """Fresh unroll slots of first-served batches, cumulative."""
    with self._lock:
      return self._fresh_served

  def stats(self):
    """{'depth', 'mode', 'staged_batches', 'gets', 'blocked_gets',
    'wait_secs', 'h2d_overlap_fraction', 'replay_k', 'serves',
    'batch_reserves', 'fresh_slots_served'} and, in unroll mode, the
    stager's counters. The overlap fraction is the share of first serves
    that found a batch already staged (a re-serve never blocks)."""
    with self._lock:
      first_gets = max(self._gets - self._reserves, 0)
      out = {
          'depth': self._depth,
          'mode': 'batch' if self._stager is None else 'unroll',
          'staged_batches': self._staged,
          'gets': self._gets,
          'blocked_gets': self._blocked_gets,
          'wait_secs': round(self._wait_secs, 6),
          'h2d_overlap_fraction': ((first_gets - self._blocked_gets) /
                                   first_gets if first_gets else 0.0),
          'replay_k': self._replay_k,
          'serves': self._serves,
          'batch_reserves': self._reserves,
          'fresh_slots_served': self._fresh_served,
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
