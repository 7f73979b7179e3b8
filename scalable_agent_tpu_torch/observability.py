"""Summaries, incidents, episode stats and the frames/sec meter, copied
from scalable_agent_tpu/observability.py (`SummaryWriter` with its
histogram, `EventLog`, `FpsMeter`, `extract_episodes`, `EpisodeStats`
with the suites' human-normalised scores) over one JSONL appender.

Summaries are JSONL events, one object per line (wall_time, step, tag,
value), in `<logdir>/summaries.jsonl`, and incidents in
`<logdir>/incidents.jsonl`: the same files and formats as the JAX package
writes. Episode statistics travel through the trajectory as
`StepOutputInfo`; `EpisodeStats` reads finished episodes out of each
batch the learner consumes.

`LatencyReservoir` is the seconds-native veneer over
`telemetry.Histogram` (the inference server's admission waits), and
`ThreadWatchdog` the liveness ledger of the remote ingest's service
threads (runtime/remote.py).
`cuda_median_ms` and `profiled_device_us` are the port's own: the kernel
timers of chip_smoke.py and the port's scripts.
"""

import collections
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.envs import suites


class _JsonlAppender(telemetry.JsonlAppender):
  """Append-only, line-buffered JSONL file (thread-safe). One
  implementation, telemetry.JsonlAppender, writes the summaries, the
  incidents and the tracer's traces.jsonl: a write after close() is
  dropped and counted on `dropped_writes` and on the registry's
  'observability/dropped_writes', never raised."""


class SummaryWriter(_JsonlAppender):
  """JSONL scalar and histogram summaries."""

  def __init__(self, logdir: str, filename: str = 'summaries.jsonl'):
    super().__init__(logdir, filename)

  def scalar(self, tag: str, value, step: int):
    self.write({'wall_time': round(time.time(), 3), 'step': int(step),
                'tag': tag, 'value': float(value)})

  def scalars(self, values: Dict[str, float], step: int):
    for tag, value in values.items():
      self.scalar(tag, value, step)

  def histogram(self, tag: str, counts, step: int):
    """Fixed-bin histogram event (the reference's per-update action
    histogram): `counts[i]` is the count of bin i."""
    self.write({'wall_time': round(time.time(), 3), 'step': int(step),
                'tag': tag, 'kind': 'histogram',
                'counts': [int(c) for c in np.asarray(counts).ravel()]})


class EventLog(_JsonlAppender):
  """JSONL of structured incident events ({wall_time, kind, step, ...}),
  written when something happens, not on a cadence. Every line reaches
  the operating system as it is written (the file is line-buffered, so
  a killed process loses none); a kind that contains one of
  `_DURABLE_MARKERS` is also fsync'd, so its record survives the machine
  crash it may narrate."""

  # JAX's tuple. Each marker covers the kinds a postmortem starts from:
  # halts, rollbacks, SDC mismatches, quarantines, SLO violations and
  # captures, controller moves, lock-order inversions, hosts joining and
  # leaving, reshards and PBT exploits (the provenance of a member's
  # weights). The durable-markers checker (analysis/contracts.py) holds
  # it against the kinds the port emits and against the
  # "Durable incident markers" section of the port's OBSERVABILITY.md.
  _DURABLE_MARKERS = ('halt', 'rollback', 'sdc', 'quarantin', 'slo',
                      'controller', 'lock_order', 'host_', 'reshard',
                      'pbt')

  def __init__(self, logdir: str, filename: str = 'incidents.jsonl'):
    super().__init__(logdir, filename)

  def event(self, kind: str, step: Optional[int] = None, **fields):
    record = {'wall_time': round(time.time(), 3), 'kind': str(kind)}
    if step is not None:
      record['step'] = int(step)
    record.update(fields)
    durable = any(m in kind for m in self._DURABLE_MARKERS)
    self.write(record, durable=durable, default=str)


class FpsMeter:
  """Environment-frames/sec over a sliding window of learner steps
  (frames after action repeat)."""

  def __init__(self, window_secs: float = 30.0):
    self._window_secs = window_secs
    self._events = collections.deque()  # (t, frame_delta)
    self._start = time.monotonic()

  def update(self, frames: int):
    now = time.monotonic()
    self._events.append((now, frames))
    self._prune(now)

  def _prune(self, now: float):
    cutoff = now - self._window_secs
    while self._events and self._events[0][0] < cutoff:
      self._events.popleft()

  def fps(self) -> float:
    """Rate over the trailing window, anchored at now — a stalled learner
    reads as decaying-to-zero fps, not the last healthy rate."""
    now = time.monotonic()
    self._prune(now)
    span = min(now - self._start, self._window_secs)
    if span <= 0:
      return 0.0
    return sum(delta for _, delta in self._events) / span


def extract_episodes(batch) -> List[Tuple[int, float, int]]:
  """Finished episodes in a [T+1, B] batch (numpy or CPU tensors):
  [(level_id, episode_return, episode_frames)]. A done at timestep t > 0
  ends an episode whose final stats ride in that step's info; timestep 0
  is the overlap frame, counted with the previous batch."""
  done = np.asarray(batch.env_outputs.done)[1:]          # [T, B]
  returns = np.asarray(batch.env_outputs.info.episode_return)[1:]
  steps = np.asarray(batch.env_outputs.info.episode_step)[1:]
  levels = np.asarray(batch.level_name)                  # [B]
  t_idx, b_idx = np.nonzero(done)
  return [(int(levels[b]), float(returns[t, b]), int(steps[t, b]))
          for t, b in zip(t_idx, b_idx)]


class EpisodeStats:
  """Per-level episode summaries of the learner loop, and the suites'
  periodic human-normalised training scores.

  Every finished episode writes `<level>/episode_return` and
  `<level>/episode_frames`. With a `benchmark` (a suite of
  envs/suites.py: 'dmlab30' or 'atari57'; `multi_task` is the JAX
  package's alias for 'dmlab30'), once every level has a finished
  episode the suite's training scores over the per-level returns are
  written (`dmlab30/training_no_cap` and `dmlab30/training_cap_100`, or
  `atari57/training_median` and `atari57/training_mean`), kept in
  `last_scores`, and the accumulator restarts.
  """

  def __init__(self, level_names: List[str], multi_task: bool = False,
               writer: Optional[SummaryWriter] = None,
               benchmark: Optional[str] = None):
    self._level_names = list(level_names)
    if benchmark is None and multi_task:
      benchmark = 'dmlab30'
    if benchmark is not None and benchmark not in suites.SUITES:
      raise ValueError(f'unknown benchmark {benchmark!r} '
                       f'(suites: {sorted(suites.SUITES)})')
    self._suite = suites.SUITES[benchmark] if benchmark else None
    self._writer = writer
    self._level_returns: Dict[str, List[float]] = {
        name: [] for name in self._level_names}
    self.last_scores: Optional[Dict[str, float]] = None

  def record_batch(self, batch, step: int) -> List[Tuple[str, float, int]]:
    """Write the batch's finished episodes, and the suite's scores when
    every level has one; returns [(level_name, episode_return,
    episode_frames)]."""
    episodes = []
    for level_id, ep_return, ep_frames in extract_episodes(batch):
      name = self._level_names[level_id]
      episodes.append((name, ep_return, ep_frames))
      if self._suite is not None:
        self._level_returns.setdefault(name, []).append(ep_return)
      if self._writer is not None:
        self._writer.scalar(f'{name}/episode_return', ep_return, step)
        self._writer.scalar(f'{name}/episode_frames', ep_frames, step)
    if self._suite is not None:
      self._maybe_score(step)
    return episodes

  def _maybe_score(self, step: int):
    if not all(self._level_returns.get(name)
               for name in self._level_names):
      return
    self.last_scores = self._suite.training_scores(self._level_returns)
    if self._writer is not None:
      self._writer.scalars(self.last_scores, step)
    self._level_returns = {name: [] for name in self._level_names}


class ThreadWatchdog:
  """Liveness ledger of long-running service threads: each thread
  `beat()`s once per loop iteration, idle poll timeouts included (an
  idle thread is not a wedged one); `wedged(stall_secs)` names the
  threads with no beat for that long. The remote ingest's stats()
  reports the count (`ingest_threads_wedged`), which the driver writes
  as a summary and an incident. Thread-safe; a beat registers."""

  def __init__(self):
    self._beats: Dict[str, float] = {}
    self._lock = threading.Lock()

  def beat(self, name: str):
    with self._lock:
      self._beats[name] = time.monotonic()

  def unregister(self, name: str):
    with self._lock:
      self._beats.pop(name, None)

  def names(self) -> List[str]:
    with self._lock:
      return sorted(self._beats)

  def wedged(self, stall_secs: float) -> List[str]:
    """Registered threads with no beat for `stall_secs` (sorted)."""
    cutoff = time.monotonic() - stall_secs
    with self._lock:
      return sorted(n for n, t in self._beats.items() if t < cutoff)


class LatencyReservoir:
  """Bounded recent-sample reservoir for latency percentiles
  (thread-safe): seconds in, p50/p99 out, for consumers that want the
  seconds-native API without a registry name (inference admission
  waits). A veneer over `telemetry.Histogram`, so the registry's
  numbers and this surface share one bounded-window / nearest-rank /
  NaN-on-empty implementation."""

  def __init__(self, maxlen: int = 4096):
    self._hist = telemetry.Histogram('latency_reservoir', maxlen=maxlen)

  def record(self, seconds: float):
    self._hist.observe(float(seconds))

  @property
  def count(self) -> int:
    return self._hist.count

  def percentiles(self, *qs: float) -> Tuple[float, ...]:
    return self._hist.percentiles(*qs)

  def percentile_ms(self, *qs: float) -> Tuple[float, ...]:
    """`percentiles`, in rounded milliseconds."""
    return tuple(round(v * 1e3, 3) for v in self.percentiles(*qs))


def cuda_median_ms(fn, repeats: int, warmup: int = 10) -> float:
  """Median time of one call of `fn` on the current CUDA device, each call
  timed by its own pair of CUDA events after `warmup` untimed calls."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(repeats):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def profiled_device_us(fn, launches: int, kernel_name=None):
  """Device time per launch, in microseconds, of the kernel whose name
  holds `kernel_name` (None: every kernel) over `launches` calls of `fn`,
  by torch.profiler; None when the profiler shows no device time."""
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    for _ in range(launches):
      fn()
    torch.cuda.synchronize()

  def self_device_us(event):
    return getattr(event, 'self_device_time_total',
                   getattr(event, 'self_cuda_time_total', 0.0))

  # Kernels are the events with device time of their own; host-side ops
  # have none.
  found = [e for e in prof.key_averages()
           if (kernel_name in e.key if kernel_name else self_device_us(e) > 0)]
  total = sum(self_device_us(e) for e in found)
  count = sum(e.count for e in found)
  return total / count if count and total else None
