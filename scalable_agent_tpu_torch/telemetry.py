"""The fleet's telemetry plane, copied from scalable_agent_tpu/telemetry.py:
one metrics registry, per-unroll trace spans and the incident flight
recorder.

1. **Metrics registry.** `Counter` / `Gauge` / `Histogram` objects that
   every component registers into one process-wide `MetricsRegistry`,
   by name, latest registration winning. `snapshot()` is what the drain
   manifest, the health halt bundle and the flight recorder read. Every
   registration in the port uses the module helpers with a literal name
   (`telemetry.counter('<component>/<name>')`, and so for gauge and
   histogram), the same names as the JAX package registers:
   tests/test_torch_telemetry.py collects both packages' literals and
   holds them equal.

2. **Trace spans.** A compact per-unroll trace context (actor id,
   per-actor sequence number, session epoch, behaviour params version)
   stamped with wall-clock hop times as the unroll moves through the
   pipeline: the actor completes it (`done`), batch assembly stages it
   (`staged`), the learner's get() serves it (`serve`) and the train
   step that consumes it is dispatched (`step`). Inside a process the
   context travels beside the unroll in a bounded identity-keyed
   sidecar (`tag_unroll` / `pop_unroll`), since the trajectory cannot
   carry extra leaves. The learner-side `PipelineTracer` writes one line
   per trained batch to `traces.jsonl`, with every member unroll's hops
   and the batch's policy-lag vector (published version at train time
   minus each unroll's behaviour version); `scripts/trace_report.py`
   reads the file. The wire hops (`send`, `wire`, `commit`), the
   commit-time version clock `'cv'` and the `install` records belong to
   remote actors (runtime/remote.py): an actor host stamps `done` and
   `send` (`configure_actor_tracing`), the learner's ingest `wire` and
   `commit`, and the install notice riding an unroll becomes the
   tracer's install record.

   Hop times are `time.time()` (wall clock), as in the JAX package:
   spans cross process boundaries, where monotonic clocks do not
   compare.

3. **Flight recorder.** A bounded ring of the latest trace records and
   registry snapshots, dumped into the health halt bundle, so an
   incident ships the pipeline's recent history.

Standard library and numpy only: actor processes import it before
torch does anything.
"""

import collections
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

NAN = float('nan')


# --------------------------------------------------------------------
# Metrics registry.
# --------------------------------------------------------------------


class Counter:
  """Monotone (well, add-only) counter. Thread-safe."""

  def __init__(self, name: str):
    self.name = name
    self._value = 0
    self._lock = threading.Lock()

  def inc(self, n: int = 1):
    with self._lock:
      self._value += n

  @property
  def value(self):
    with self._lock:
      return self._value

  def snapshot_value(self):
    return self.value


class Gauge:
  """Point-in-time value: either `set()` by its owner, or backed by a
  zero-argument callable (`fn=`) read lazily at snapshot time — the
  adoption path for existing stats surfaces (a component registers
  `telemetry.gauge('<component>/<name>', fn=lambda: self._n)` and its
  module-local bookkeeping becomes registry-visible without rewriting
  the bookkeeping). A callback that raises reads as NaN: a torn-down
  component must never break the snapshot that is trying to describe
  the teardown."""

  def __init__(self, name: str, fn: Optional[Callable] = None):
    self.name = name
    self._fn = fn
    self._value = 0.0
    self._lock = threading.Lock()

  def set(self, value):
    with self._lock:
      self._value = value

  @property
  def value(self):
    if self._fn is not None:
      try:
        return self._fn()
      except Exception:
        return NAN
    with self._lock:
      return self._value

  def snapshot_value(self):
    return self.value


class Histogram:
  """Bounded-reservoir histogram: cumulative count/sum plus sample
  percentiles over the most recent `maxlen` observations (the
  LatencyReservoir design, promoted to a registry citizen). Empty →
  NaN percentiles — reports render '-', nothing crashes."""

  def __init__(self, name: str, maxlen: int = 4096):
    self.name = name
    self._samples = collections.deque(maxlen=maxlen)
    self._lock = threading.Lock()
    self._count = 0
    self._sum = 0.0
    self._max = NAN

  def observe(self, value):
    v = float(value)
    with self._lock:
      self._samples.append(v)
      self._count += 1
      self._sum += v
      self._max = v if math.isnan(self._max) else max(self._max, v)

  @property
  def count(self) -> int:
    with self._lock:
      return self._count

  def percentiles(self, *qs: float) -> Tuple[float, ...]:
    with self._lock:
      snap = sorted(self._samples)
    if not snap:
      return tuple(NAN for _ in qs)
    last = len(snap) - 1
    return tuple(snap[min(last, int(round(q * last)))] for q in qs)

  def snapshot_value(self) -> Dict:
    p50, p99 = self.percentiles(0.5, 0.99)
    with self._lock:
      return {'count': self._count, 'sum': round(self._sum, 6),
              'max': self._max, 'p50': p50, 'p99': p99}


class MetricsRegistry:
  """Name → metric map with a thread-safe `snapshot()`.

  Registration replaces by name (latest instance wins): components are
  per-run objects and the registry is process-global, so the snapshot
  must describe the LIVE incarnation — a test constructing ten ingest
  servers leaves the last one's counters registered, which is exactly
  the production semantics (one live server per process)."""

  def __init__(self):
    self._metrics: Dict[str, object] = {}
    self._lock = threading.Lock()

  def register(self, metric):
    with self._lock:
      self._metrics[metric.name] = metric
    return metric

  def counter(self, name: str) -> Counter:
    return self.register(Counter(name))

  def gauge(self, name: str, fn: Optional[Callable] = None) -> Gauge:
    return self.register(Gauge(name, fn=fn))

  def histogram(self, name: str, maxlen: int = 4096) -> Histogram:
    return self.register(Histogram(name, maxlen=maxlen))

  def get(self, name: str):
    with self._lock:
      return self._metrics.get(name)

  def unregister(self, name: str, metric=None):
    """Remove `name` — but when `metric` is given, only if it is the
    REGISTERED instance (identity check): a closing component must
    not evict a newer incarnation that already replaced it under the
    same name. fn-gauges close over their owner, so unregistering at
    teardown is what lets a finished run's pipeline objects be
    collected instead of pinned by the registry for the process
    lifetime."""
    with self._lock:
      if metric is None or self._metrics.get(name) is metric:
        self._metrics.pop(name, None)

  def names(self) -> List[str]:
    with self._lock:
      return sorted(self._metrics)

  def snapshot(self) -> Dict:
    """One JSON-serializable dict of every registered metric's current
    value (counters/gauges → number, histograms → {count, sum, max,
    p50, p99}). The read is point-in-time per metric, not a global
    atomic cut — consumers (drain manifest, flight recorder, fleet
    stats request) want recency, not transactional consistency."""
    with self._lock:
      metrics = list(self._metrics.values())
    out = {}
    for m in metrics:
      v = m.snapshot_value()
      if isinstance(v, (np.integer, np.floating)):
        v = v.item()
      out[m.name] = v
    return out


# The process-wide default registry. The module helpers below are the
# only registration spellings in the port: the name-parity test collects
# their literal names.
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
  return _REGISTRY


def counter(name: str) -> Counter:
  return _REGISTRY.counter(name)


def gauge(name: str, fn: Optional[Callable] = None) -> Gauge:
  return _REGISTRY.gauge(name, fn=fn)


def histogram(name: str, maxlen: int = 4096) -> Histogram:
  return _REGISTRY.histogram(name, maxlen=maxlen)


# --------------------------------------------------------------------
# Trace spans.
# --------------------------------------------------------------------

# Hop names, in pipeline order. Spans may omit hops (a local-fleet
# unroll never crosses the wire; an old-protocol peer stamps nothing) —
# scripts/trace_report.py computes deltas between the hops that ARE
# present, in this order.
HOP_DONE = 'done'        # env-step loop completed the unroll (actor)
HOP_SEND = 'send'        # remote pump handed it to the socket
HOP_WIRE = 'wire'        # ingest reader finished receiving the frame
HOP_COMMIT = 'commit'    # validate/commit worker landed the buffer put
HOP_STAGED = 'staged'    # batch assembly picked it (host stack or
                         # per-unroll device staging)
HOP_SERVE = 'serve'      # the learner's get() took the staged batch
HOP_STEP = 'step'        # the train step consuming it was dispatched
HOP_ORDER = (HOP_DONE, HOP_SEND, HOP_WIRE, HOP_COMMIT, HOP_STAGED,
             HOP_SERVE, HOP_STEP)


def make_trace(actor, seq: int, epoch=None,
               behavior_version=None) -> Dict:
  """A fresh per-unroll trace context. Compact keys on purpose — this
  dict rides every v8 unroll frame: 'a' actor id, 's' per-actor unroll
  sequence, 'e' session epoch (the learner incarnation the actor
  believes it feeds), 'bv' the params version the actor ACTED with
  (the behaviour policy — policy lag is published-at-train minus
  this), 'h' the [hop, wall_time] stamp list."""
  trace = {'a': str(actor), 's': int(seq), 'h': []}
  if epoch is not None:
    trace['e'] = int(epoch)
  if behavior_version is not None:
    trace['bv'] = int(behavior_version)
  return trace


def stamp(trace: Optional[Dict], hop: str, t: Optional[float] = None):
  """Append one [hop, wall_time] stamp. None-tolerant (call sites
  stay unconditional on untraced old-peer unrolls) AND shape-tolerant:
  a malformed context from a buggy/skewed peer — a dict missing 'h',
  or carrying a non-list there — gets a fresh stamp list instead of
  raising into whoever stamps it (the ingest READER stamps wire
  frames; a KeyError there would drop the connection outside the
  quarantine accounting every other malformed-frame path gets)."""
  if trace is None:
    return trace
  hops = trace.get('h')
  if not isinstance(hops, list):
    hops = trace['h'] = []
  hops.append([hop, round(time.time() if t is None else t, 6)])
  return trace


class _TagStore:
  """Bounded identity-keyed sidecar: unroll pytree → trace context.

  Trajectory pytrees cannot carry extra leaves (the wire contract and
  the learner's tree_flatten would both see them), so inside a process
  the trace context travels NEXT TO the unroll, keyed by `id()`. The
  store holds NO reference to the unroll itself — a tagged unroll
  that never reaches consumption (a drain drop, a fleet-stop discard)
  must cost a stale ~200-byte trace entry, not a multi-MB pytree
  pinned for the rest of the run (the soak's slow-leak shape). The
  id-only key admits one benign hazard: a freed unroll's id can be
  reused, and a LATER untraced object at the same address could pop
  the stale trace — a mislabeled span in the telemetry stream, never
  a correctness issue (and a re-tag at the same address simply
  overwrites the stale entry). Bounded: oldest entries evicted,
  counted."""

  def __init__(self, capacity: int = 8192):
    self._capacity = capacity
    self._entries: 'collections.OrderedDict' = collections.OrderedDict()
    self._lock = threading.Lock()
    self.evicted = 0

  def tag(self, obj, trace: Dict):
    with self._lock:
      self._entries[id(obj)] = trace
      while len(self._entries) > self._capacity:
        self._entries.popitem(last=False)
        self.evicted += 1

  def pop(self, obj) -> Optional[Dict]:
    with self._lock:
      return self._entries.pop(id(obj), None)

  def __len__(self):
    with self._lock:
      return len(self._entries)


_UNROLL_TAGS = _TagStore()


def tag_unroll(unroll, trace: Optional[Dict]):
  if trace is not None:
    _UNROLL_TAGS.tag(unroll, trace)


def pop_unroll(unroll) -> Optional[Dict]:
  return _UNROLL_TAGS.pop(unroll)


# --- Actor-side stamping switch. The learner process enables it by
# installing a PipelineTracer (set_tracer); a REMOTE actor host — which
# has no tracer, its spans complete learner-side — enables it
# explicitly with configure_actor_tracing. `version_fn` supplies the
# behaviour params version stamped on each fresh trace (a mutable-cell
# closure at both call sites: reading a stats surface per unroll would
# put a lock on the env loop). ---
_actor_tracing_lock = threading.Lock()
_actor_tracing: Optional[Dict] = None


def configure_actor_tracing(version_fn: Optional[Callable] = None,
                            epoch=None):
  global _actor_tracing
  with _actor_tracing_lock:
    _actor_tracing = {'version_fn': version_fn, 'epoch': epoch}


def clear_actor_tracing():
  global _actor_tracing
  with _actor_tracing_lock:
    _actor_tracing = None


def begin_unroll_trace(actor, seq: int) -> Optional[Dict]:
  """A fresh trace for one just-completed unroll, or None when
  tracing is off in this process (the actor loop's one-line seam)."""
  with _actor_tracing_lock:
    cfg = _actor_tracing
  if cfg is None:
    tracer = get_tracer()
    if tracer is None:
      return None
    cfg = {'version_fn': tracer.behavior_version,
           'epoch': tracer.epoch}
  version = None
  if cfg.get('version_fn') is not None:
    try:
      version = cfg['version_fn']()
    except Exception:
      version = None
  return make_trace(actor, seq, epoch=cfg.get('epoch'),
                    behavior_version=version)


# --------------------------------------------------------------------
# Flight recorder.
# --------------------------------------------------------------------


class FlightRecorder:
  """Bounded ring of recent telemetry: the last `capacity` trace
  records (batches, publishes, installs) plus the last `snapshots`
  registry snapshots — dumped into the health halt bundle and the
  rollback diagnostics so an incident ships the preceding pipeline
  history, not a point-in-time counter read. Thread-safe."""

  def __init__(self, capacity: int = 512, snapshots: int = 16):
    self._records = collections.deque(maxlen=max(capacity, 8))
    self._snapshots = collections.deque(maxlen=max(snapshots, 2))
    self._lock = threading.Lock()

  def record(self, rec: Dict):
    with self._lock:
      self._records.append(rec)

  def note_registry(self, snapshot: Dict):
    """Stash one registry snapshot (call on the summary cadence)."""
    with self._lock:
      self._snapshots.append({'wall_time': round(time.time(), 3),
                              'metrics': snapshot})

  def __len__(self) -> int:
    """Trace records currently retained in the ring."""
    with self._lock:
      return len(self._records)

  @property
  def snapshots_held(self) -> int:
    with self._lock:
      return len(self._snapshots)

  def dump(self) -> Dict:
    with self._lock:
      return {'wall_time': round(time.time(), 3),
              'records': list(self._records),
              'registry_snapshots': list(self._snapshots)}

  def write(self, path: str) -> str:
    """Atomic JSON dump (tmp + rename — incident artifacts must be
    complete or absent)."""
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(self.dump(), f, indent=2, default=str)
    os.replace(tmp, path)
    return path


# --------------------------------------------------------------------
# The learner-side pipeline tracer.
# --------------------------------------------------------------------


# Writes that raced (or followed) close() and were dropped, across every
# JSONL appender in the process: a late write is counted, never raised
# into the writing thread (a respawning actor logging one last episode
# must not take its fleet slot down over a log line).
_DROPPED_WRITES = counter('observability/dropped_writes')


def dropped_writes_total() -> int:
  """Process-wide silently-dropped JSONL writes (the driver's summary
  export reads this instead of reaching for the private counter)."""
  return _DROPPED_WRITES.value


class JsonlAppender:
  """THE thread-safe line-buffered append-only JSONL plumbing — one
  implementation behind the scalar summaries, the incident stream
  (observability._JsonlAppender subclasses this; it lives here
  because telemetry must stay importable without the observability
  module's env-suite dependency chain, and observability already
  imports telemetry), and the tracer's traces.jsonl.

  Crash-safety contract: a write AFTER close() is a silent drop,
  counted on `dropped_writes` (+ the process-wide
  'observability/dropped_writes' registry counter) — never a raise
  into the writing thread. `durable=True` flushes + fsyncs before
  returning, so records that must survive a kill -9 (halt/rollback
  incidents) reach the disk instead of dying in the userspace buffer
  with the process."""

  def __init__(self, logdir: str, filename: str):
    os.makedirs(logdir, exist_ok=True)
    self._path = os.path.join(logdir, filename)
    self._file = open(self._path, 'a', buffering=1)
    self._lock = threading.Lock()
    self._closed = False
    self.dropped_writes = 0

  @property
  def path(self):
    return self._path

  def write(self, record: Dict, durable: bool = False,
            **dumps_kwargs):
    with self._lock:
      if self._closed:
        self.dropped_writes += 1
        _DROPPED_WRITES.inc()
        return
      self._file.write(json.dumps(record, **dumps_kwargs) + '\n')
      if durable:
        try:
          self._file.flush()
          os.fsync(self._file.fileno())
        except OSError:
          pass  # best effort: the record is written either way

  def close(self):
    with self._lock:
      if self._closed:
        return
      self._closed = True
      self._file.close()


class PipelineTracer:
  """Assembles per-unroll spans into `traces.jsonl` + the flight ring.

  One per training run, installed process-globally via `set_tracer`
  (the faults_lib.install pattern — threading a tracer through every
  constructor between the driver and the prefetcher would touch ten
  signatures for one optional observer). The staged/served FIFOs
  mirror the BatchPrefetcher's own FIFO semantics: batches are staged
  in order, served in order (re-serves skip `on_serve`), and trained
  in order — so `on_step` always completes the OLDEST served batch.
  Both FIFOs are bounded: a consumer that stops calling on_step (a
  bench loop, a halted learner) must cost dropped trace records, not
  unbounded memory.

  Emitted records (one JSON object per line in traces.jsonl):
    {'k': 'batch', 'step', 'pv' (published version at train time),
     't' (step wall time), 'n_fresh', 'lag' ([pv - bv per unroll with
     a known behaviour version]), 'spans' ([{a, s, e, bv, h}, ...])}
    {'k': 'publish', 'v', 't'}
    {'k': 'install', 'a', 'v', 't' (actor-side install time),
     't_seen' (when the notice reached the learner)}
  """

  def __init__(self, logdir: str, filename: str = 'traces.jsonl',
               flight_capacity: int = 512, epoch=None,
               version_fn: Optional[Callable] = None):
    self._writer = JsonlAppender(logdir, filename)
    self.flight = FlightRecorder(capacity=flight_capacity)
    self.epoch = epoch
    self.version_fn = version_fn
    # The local publish clock: policy lag is a PUBLISH-COUNT delta
    # (the unit V-trace's staleness story is written in), so the
    # tracer counts publishes itself for locally produced unrolls.
    # Remote unrolls arrive with a behaviour version in the ingest
    # lane's OWN publish counter — the ingest worker stamps the
    # commit-time counter value ('cv') into the trace so the delta is
    # computed within one clock; two clocks never mix.
    self._publish_count = 0
    self._lock = threading.Lock()
    self._staged = collections.deque(maxlen=64)
    self._served = collections.deque(maxlen=64)
    # Registry-backed telemetry about the telemetry (meta, but the
    # overhead/coverage questions are real: untagged unrolls mean a
    # peer isn't stamping; dropped batches mean the FIFOs overflowed).
    self._m_batches = counter('trace/batches')
    self._m_unrolls = counter('trace/unrolls')
    self._m_untagged = counter('trace/untagged_unrolls')
    self._m_installs = counter('trace/param_installs')
    self._m_dropped = counter('trace/dropped_records')
    self._h_lag = histogram('trace/policy_lag')
    self._h_e2e = histogram('trace/e2e_ms')
    # Flight-recorder occupancy: fn-gauges over the ring so
    # the registry snapshot (and the driver's summary export) can say
    # how much incident history a dump would ship. Unregistered at
    # close() — they close over this per-run tracer's flight ring.
    self._flight_gauges = [
        gauge('trace/flight_records', fn=lambda: len(self.flight)),
        gauge('trace/flight_snapshots',
              fn=lambda: self.flight.snapshots_held),
    ]

  @property
  def path(self) -> str:
    return self._writer.path

  @property
  def publish_count(self) -> int:
    return self._publish_count

  def behavior_version(self) -> Optional[int]:
    """The behaviour-policy version a locally produced unroll should
    stamp: the injected version_fn when one is set, else this
    tracer's own publish count (local actors install every publish
    synchronously, so count-at-act-time IS their behaviour version)."""
    if self.version_fn is not None:
      try:
        return self.version_fn()
      except Exception:
        return None
    return self._publish_count

  # --- ingest/commit side ---

  def tag(self, unroll, trace: Optional[Dict]):
    tag_unroll(unroll, trace)

  def on_install(self, actor, version, t_install):
    rec = {'k': 'install', 'a': str(actor), 'v': int(version),
           't': float(t_install), 't_seen': round(time.time(), 6)}
    self._m_installs.inc()
    self._writer.write(rec, default=str)
    self.flight.record(rec)

  # --- feed pipeline side (BatchPrefetcher hooks) ---

  def on_batch(self, unrolls, n_fresh: int):
    """A batch's unrolls were picked for staging (in slot order,
    fresh first). Pops their sidecar tags; replayed slots (consumed
    once already) legitimately have none."""
    now = round(time.time(), 6)
    spans = []
    for u in unrolls[:n_fresh]:
      trace = pop_unroll(u)
      if trace is None:
        self._m_untagged.inc()
      else:
        stamp(trace, HOP_STAGED, now)
        spans.append(trace)
    with self._lock:
      if len(self._staged) == self._staged.maxlen:
        self._m_dropped.inc()
      self._staged.append({'spans': spans, 'n_fresh': int(n_fresh)})

  def on_serve(self):
    """The learner's get() took a batch's FIRST serve (re-serves ride
    the same staged arena and are not new pipeline traversals)."""
    now = round(time.time(), 6)
    with self._lock:
      if not self._staged:
        return
      entry = self._staged.popleft()
      if len(self._served) == self._served.maxlen:
        self._m_dropped.inc()
      self._served.append(entry)
    for trace in entry['spans']:
      stamp(trace, HOP_SERVE, now)

  def on_step(self, step: int):
    """The train step consuming the oldest served batch was
    dispatched: complete its spans, compute the policy-lag vector
    (publish-count delta, each unroll judged within ITS clock — the
    commit-time 'cv' for remote unrolls, this tracer's publish count
    for local ones), emit the batch record."""
    now = round(time.time(), 6)
    with self._lock:
      if not self._served:
        return
      entry = self._served.popleft()
    lags = []
    for trace in entry['spans']:
      stamp(trace, HOP_STEP, now)
      bv = trace.get('bv')
      current = trace.get('cv')
      if current is None:
        current = self._publish_count
      if bv is not None:
        lag = max(int(current) - int(bv), 0)
        lags.append(lag)
        self._h_lag.observe(lag)
      if trace['h']:
        self._h_e2e.observe((trace['h'][-1][1] - trace['h'][0][1])
                            * 1e3)
    self._m_batches.inc()
    self._m_unrolls.inc(len(entry['spans']))
    rec = {'k': 'batch', 'step': int(step), 't': now,
           'pv': self._publish_count,
           'n_fresh': entry['n_fresh'], 'lag': lags,
           'spans': entry['spans']}
    self._writer.write(rec, default=str)
    self.flight.record(rec)

  def on_publish(self, version: int,
                 remote_version: Optional[int] = None):
    """A param publish landed (version is the caller's label — the
    driver publishes step-stamped snapshots); bumps the local publish
    clock the policy-lag arithmetic counts in.

    `remote_version` is the INGEST LANE's version for this snapshot
    when it was also published to the remote fleet — actors' install
    notices carry ingest-lane versions (a different sequence from the
    step-stamped label), so the publish→install join in trace_report
    must key on it ('rv'). Without it, installs at production publish
    cadences would join nothing (or the wrong publish)."""
    self._publish_count += 1
    rec = {'k': 'publish', 'v': int(version),
           'count': self._publish_count, 't': round(time.time(), 6)}
    if remote_version is not None:
      rec['rv'] = int(remote_version)
    self._writer.write(rec, default=str)
    self.flight.record(rec)

  def span_percentiles(self) -> Dict[str, float]:
    """The live policy-lag / end-to-end percentiles (the summary
    export's supported surface — keeps the driver off the tracer's
    internal histogram objects). NaN until traffic flows."""
    lag_p50, lag_p99 = self._h_lag.percentiles(0.5, 0.99)
    e2e_p50, e2e_p99 = self._h_e2e.percentiles(0.5, 0.99)
    return {'policy_lag_p50': lag_p50, 'policy_lag_p99': lag_p99,
            'unroll_e2e_p50_ms': e2e_p50, 'unroll_e2e_p99_ms': e2e_p99}

  def stats(self) -> Dict:
    return {'batches': self._m_batches.value,
            'unrolls': self._m_unrolls.value,
            'untagged_unrolls': self._m_untagged.value,
            'param_installs': self._m_installs.value,
            'dropped_records': self._m_dropped.value,
            'tag_store_size': len(_UNROLL_TAGS),
            'dropped_writes': self._writer.dropped_writes}

  def close(self):
    self._writer.close()
    for g in self._flight_gauges:
      _REGISTRY.unregister(g.name, g)


_tracer_lock = threading.Lock()
_tracer: Optional[PipelineTracer] = None


def set_tracer(tracer: Optional[PipelineTracer]):
  """Install (or clear, with None) the process-global tracer. The
  driver owns the lifecycle: set before the fleet starts, cleared —
  and closed — in its teardown finally."""
  global _tracer
  with _tracer_lock:
    _tracer = tracer


def get_tracer() -> Optional[PipelineTracer]:
  return _tracer
