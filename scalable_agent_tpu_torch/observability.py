"""Summaries and the frames/sec meter, copied from
scalable_agent_tpu/observability.py (`SummaryWriter`, `FpsMeter`) with the
JSONL appender they share inlined.

Summaries are JSONL events, one object per line (wall_time, step, tag,
value), in `<logdir>/summaries.jsonl`: the same file and format as the JAX
package writes.

`cuda_median_ms` is the port's own: the kernel timer of chip_smoke.py and
scripts/conv_pool.py.
"""

import collections
import json
import os
import statistics
import threading
import time
from typing import Dict

import torch


class SummaryWriter:
  """Append-only JSONL scalar writer (thread-safe). A write after close()
  is dropped and counted on `dropped_writes`, never raised."""

  def __init__(self, logdir: str, filename: str = 'summaries.jsonl'):
    os.makedirs(logdir, exist_ok=True)
    self.path = os.path.join(logdir, filename)
    self._file = open(self.path, 'a', buffering=1)
    self._lock = threading.Lock()
    self._closed = False
    self.dropped_writes = 0

  def scalar(self, tag: str, value, step: int):
    record = {'wall_time': round(time.time(), 3), 'step': int(step),
              'tag': tag, 'value': float(value)}
    with self._lock:
      if self._closed:
        self.dropped_writes += 1
        return
      self._file.write(json.dumps(record) + '\n')

  def scalars(self, values: Dict[str, float], step: int):
    for tag, value in values.items():
      self.scalar(tag, value, step)

  def close(self):
    with self._lock:
      if not self._closed:
        self._closed = True
        self._file.close()


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
