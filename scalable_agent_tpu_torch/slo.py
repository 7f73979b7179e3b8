"""The SLO engine, ported from scalable_agent_tpu/slo.py under its names:
declarative objectives over the metrics registry, burn-rate evaluation,
triggered deep diagnostics and the per-run verdict.

1. **Declarative objectives** (`Objective`): named targets over registry
   metric names (`policy_lag_p99 <= N`, `env_plane_utilization >= x`,
   `wire_crc_rejected rate == 0`, an fps floor against a per-host
   baseline file), each with a comparison, a target, fast and slow
   evaluation windows and a severity (info < ticket < page).
   `DEFAULT_OBJECTIVES` is the JAX package's set, one objective per
   instrumented plane; `--slo_spec` loads a JSON list instead.

2. **Burn-rate evaluation** (`SloEvaluator`): registry snapshots go into
   a bounded history, and each objective is judged over a FAST and a
   SLOW window (a blip must not page, a sustained burn must). A value
   objective burns when every fast-window sample violates (at least
   `min_samples` of them) and at least half the slow-window samples do;
   a rate objective (a counter) burns on its windowed delta or rate. A
   missing or NaN metric is `no_data`: in the verdict, never a
   violation.

3. **Triggered deep diagnostics** (`SloEngine`): on the first burn of a
   page-severity objective the engine dumps the flight recorder and a
   `scripts/trace_report.py` slice of traces.jsonl over the violation
   window into `<logdir>/diagnostics/`, and queues a bounded profiler
   capture of the next K learner steps, which the driver loop takes
   (`take_profile_request`) and runs with torch.profiler. One capture per
   objective per run.

4. **The verdict** (`SLO_VERDICT.json`): pass or fail, and each
   objective's state, value, target, margin and burn count; the drain
   manifest carries the verdict so far under 'slo'.

Standard library only (no torch): actor hosts and scripts import it
without touching a device.
"""

import collections
import dataclasses
import json
import logging
import math
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis.runtime import guarded_by, make_lock

log = logging.getLogger('scalable_agent_tpu_torch')

# Severity ladder. Only `page` triggers deep diagnostics; `info`
# objectives are recorded in the verdict but never fail it.
SEVERITIES = ('info', 'ticket', 'page')

# Objective states in the verdict.
OK = 'ok'
BURNING = 'burning'
NO_DATA = 'no_data'          # metric absent/NaN over the window
NO_BASELINE = 'no_baseline'  # baseline-relative target, no baseline

_COMPARATORS = {
    '<=': lambda v, t: v <= t,
    '>=': lambda v, t: v >= t,
    '==': lambda v, t: v == t,
}


@dataclasses.dataclass(frozen=True)
class Objective:
  """One declarative objective over a registry metric.

  Args:
    name: the objective's name (verdict key, incident label, diagnostics
      filename stem).
    metric: the registry metric name judged.
    comparison: '<=', '>=' or '==': `value comparison target` holds when
      healthy.
    target: the threshold; with `baseline` set, a fraction of the
      per-host baseline value instead.
    kind: 'value' (judge the sampled values in the windows) or 'rate'
      (judge the counter's movement over the window: the per-second rate
      for <= and >=, the raw delta for '==', so `rate == 0` means "this
      counter must not move").
    field: for a histogram metric, the snapshot field judged ('p50',
      'p99', 'max', 'count' or 'sum').
    fast_window_secs / slow_window_secs: the two burn windows; None
      takes the evaluator's configured defaults.
    severity: 'info', 'ticket' or 'page'.
    baseline: key into the per-host baseline file; the effective target
      is baseline_value * target, and no file or entry is NO_BASELINE.
    description: one line for the verdict.
  """
  name: str
  metric: str
  comparison: str
  target: float
  kind: str = 'value'
  field: Optional[str] = None
  fast_window_secs: Optional[float] = None
  slow_window_secs: Optional[float] = None
  severity: str = 'ticket'
  baseline: Optional[str] = None
  description: str = ''

  def validate(self):
    if self.comparison not in _COMPARATORS:
      raise ValueError(f'objective {self.name!r}: comparison must be '
                       f'one of {sorted(_COMPARATORS)}, got '
                       f'{self.comparison!r}')
    if self.kind not in ('value', 'rate'):
      raise ValueError(f'objective {self.name!r}: kind must be '
                       f'value|rate, got {self.kind!r}')
    if self.severity not in SEVERITIES:
      raise ValueError(f'objective {self.name!r}: severity must be '
                       f'one of {SEVERITIES}, got {self.severity!r}')
    if not self.metric or '/' not in self.metric:
      raise ValueError(f'objective {self.name!r}: metric must be a '
                       f'registry name (component/name), got '
                       f'{self.metric!r}')
    return self


# The default set: the JAX package's objectives, literal for literal.
# Targets are loose "is the system sane" floors; an operator tightens
# them per deployment with --slo_spec.
DEFAULT_OBJECTIVES = (
    # Policy lag: the publish-count delta V-trace corrects for; p99 past
    # 16 published versions is off the V-trace design point.
    Objective(name='policy_lag_p99', metric='trace/policy_lag',
              field='p99', comparison='<=', target=16.0,
              severity='page',
              description='behaviour-vs-train publish-count delta p99'),
    # Unroll end-to-end latency: done -> step p99.
    Objective(name='unroll_e2e_p99_ms', metric='trace/e2e_ms',
              field='p99', comparison='<=', target=30000.0,
              severity='ticket',
              description='per-unroll done->step span p99 (ms)'),
    # The env plane: the floor detects a dead env plane (nothing
    # produced all window), not a backpressured one.
    Objective(name='env_plane_utilization',
              metric='driver/env_plane_utilization',
              comparison='>=', target=0.001, severity='ticket',
              description='producers not parked on backpressure'),
    # The actor plane: the quorum fraction the fleet feeds with.
    Objective(name='fleet_healthy_fraction',
              metric='driver/fleet_healthy_fraction',
              comparison='>=', target=0.25, severity='page',
              description='healthy actor slots / fleet size'),
    # Throughput floor against the per-host baseline file.
    Objective(name='fps_floor', metric='driver/env_frames',
              kind='rate', comparison='>=', target=0.5,
              baseline='fps', severity='ticket',
              description='env frames/sec >= 0.5x per-host baseline'),
    # Data-plane integrity: any movement is an incident.
    Objective(name='wire_crc_rejected_zero',
              metric='ingest/wire_crc_rejected',
              kind='rate', comparison='==', target=0.0,
              severity='page',
              description='unroll frames refused for CRC mismatch'),
    Objective(name='sdc_mismatch_zero', metric='health/sdc_mismatches',
              kind='rate', comparison='==', target=0.0,
              severity='page',
              description='per-replica param fingerprint disagreements'),
    Objective(name='ckpt_digest_fallbacks_zero',
              metric='checkpoint/digest_fallbacks',
              kind='rate', comparison='==', target=0.0,
              severity='ticket',
              description='restore rungs refused for content digests'),
    # The transport plane: quarantines, reaps and stale epochs flat at
    # zero on a healthy fleet.
    Objective(name='ingest_quarantine_zero', metric='ingest/quarantined',
              kind='rate', comparison='==', target=0.0,
              severity='ticket',
              description='connections dropped for unparseable frames'),
    Objective(name='conns_reaped_zero', metric='ingest/conns_reaped',
              kind='rate', comparison='==', target=0.0,
              severity='ticket',
              description='idle/half-open connections reaped'),
    Objective(name='stale_epoch_zero',
              metric='ingest/stale_epoch_rejected',
              kind='rate', comparison='==', target=0.0,
              severity='ticket',
              description='unrolls refused from a dead incarnation'),
    # The learner's failure domain: a rollback is the ladder working,
    # and still an incident someone should read.
    Objective(name='rollbacks_zero', metric='health/rollbacks',
              kind='rate', comparison='==', target=0.0,
              severity='ticket',
              description='automatic checkpoint rollbacks'),
    # Plane balance (advisory): the learner mostly parked on the feed
    # means the env plane is the bound, a capacity shape.
    Objective(name='learner_plane_utilization',
              metric='driver/learner_plane_utilization',
              comparison='>=', target=0.05, severity='info',
              description='learner not starved by the env plane'),
    # The hybrid filler's floor (advisory): with the filler on, or under
    # the Anakin runtime, the learner plane is ~1.0 by construction.
    Objective(name='learner_plane_utilization_filler',
              metric='driver/learner_plane_utilization',
              comparison='>=', target=0.9, severity='info',
              description='hybrid filler keeps the learner plane '
                          '~fully busy'),
    # Transport pressure (advisory): the ack service time remote pumps
    # feel.
    Objective(name='ingest_ack_p99_ms', metric='ingest/ack_ms',
              field='p99', comparison='<=', target=5000.0,
              severity='info',
              description='ingest ack service time p99 (ms)'),
    # Telemetry self-health (advisory).
    Objective(name='dropped_writes_zero',
              metric='observability/dropped_writes',
              kind='rate', comparison='==', target=0.0,
              severity='info',
              description='JSONL writes dropped after close'),
    Objective(name='trace_drops_zero', metric='trace/dropped_records',
              kind='rate', comparison='==', target=0.0,
              severity='info',
              description='tracer FIFO overflows'),
    # The serving plane: the service latency of the shared inference
    # step, local merged calls and routed batches alike.
    Objective(name='serving_latency_p99_ms', metric='serving/latency_ms',
              field='p99', comparison='<=', target=30000.0,
              severity='ticket',
              description='inference serve latency p99 (ms), local '
                          'and routed'),
    # The population plane (advisory): the worst suite's best member
    # return; the gauge exists only inside a PBT run.
    Objective(name='per_task_return_floor',
              metric='population/task_return_min',
              comparison='>=', target=0.0, severity='info',
              description='worst suite best-member return >= 0'),
)


def load_objectives(spec_path: str = '',
                    fast_window_secs: float = 30.0,
                    slow_window_secs: float = 300.0
                    ) -> List[Objective]:
  """The objective set: `spec_path` (a JSON list of Objective field
  dicts) when given, else the defaults; either way with the configured
  windows wherever an entry does not pin its own. Raises on an
  unreadable or invalid spec (a typo'd objective fails the run at
  spin-up, not silently judging nothing)."""
  if spec_path:
    with open(spec_path) as f:
      raw = json.load(f)
    if not isinstance(raw, list) or not raw:
      raise ValueError(f'SLO spec {spec_path!r} must be a non-empty '
                       'JSON list of objective dicts')
    objectives = []
    for entry in raw:
      try:
        objectives.append(Objective(**entry))
      except TypeError as e:
        raise ValueError(f'SLO spec {spec_path!r}: bad objective '
                         f'entry {entry!r}: {e}') from e
  else:
    objectives = list(DEFAULT_OBJECTIVES)
  seen = set()
  resolved = []
  for o in objectives:
    o.validate()
    if o.name in seen:
      raise ValueError(f'duplicate SLO objective name {o.name!r}')
    seen.add(o.name)
    resolved.append(dataclasses.replace(
        o,
        fast_window_secs=(o.fast_window_secs
                          if o.fast_window_secs is not None
                          else fast_window_secs),
        slow_window_secs=(o.slow_window_secs
                          if o.slow_window_secs is not None
                          else slow_window_secs)))
  return resolved


# --------------------------------------------------------------------
# Per-host fps baseline file.
# --------------------------------------------------------------------


def load_baseline(path: str, host: Optional[str] = None) -> Dict:
  """The per-host baseline entry ({'fps': ...}) of a JSON file keyed by
  hostname. An absent file (or entry) is {}: the baseline-relative
  objectives evaluate NO_BASELINE, never a violation. A present but
  unreadable file raises: a typo must not silently disarm the floor."""
  if not path:
    return {}
  host = host or socket.gethostname()
  try:
    with open(path) as f:
      table = json.load(f)
  except FileNotFoundError:
    return {}
  except (OSError, ValueError) as e:
    raise ValueError(
        f'SLO fps baseline file {path!r} exists but is unreadable '
        f'({e}) — fix or remove it; a corrupt baseline must not '
        'silently disarm the fps_floor objective') from e
  entry = table.get(host)
  return dict(entry) if isinstance(entry, dict) else {}


def update_baseline(path: str, values: Dict,
                    host: Optional[str] = None) -> str:
  """Merge `values` (e.g. {'fps': measured}) into the per-host entry
  (atomic tmp + rename), recording a known-good run as the floor later
  runs are judged against."""
  host = host or socket.gethostname()
  try:
    with open(path) as f:
      table = json.load(f)
  except (OSError, ValueError):
    table = {}
  entry = table.setdefault(host, {})
  entry.update(values)
  entry['wall_time'] = round(time.time(), 3)
  tmp = path + '.tmp'
  with open(tmp, 'w') as f:
    json.dump(table, f, indent=2, sort_keys=True)
  os.replace(tmp, path)
  return path


# --------------------------------------------------------------------
# Evaluation.
# --------------------------------------------------------------------


def _metric_value(snapshot: Dict, objective: Objective):
  """The judged scalar of one registry snapshot, or None when the
  metric (or its histogram field) is absent or NaN."""
  raw = snapshot.get(objective.metric)
  if raw is None:
    return None
  if isinstance(raw, dict):
    raw = raw.get(objective.field or 'p99')
  if raw is None:
    return None
  try:
    value = float(raw)
  except (TypeError, ValueError):
    return None
  if math.isnan(value):
    return None
  return value


class SloEvaluator:
  """Windowed burn-rate evaluation of objectives over a history of
  registry snapshots.

  `observe(snapshot, now)` appends one sample and re-judges every
  objective into {state, value, target, margin, burns, ...}:

  - value objectives burn when the fast window holds >= `min_samples`
    valid samples, all of them violating, and >= half the slow-window
    samples violate;
  - rate objectives judge the counter's movement over each window: the
    per-second rate for <= and >= (confirmed by the slow window), the
    raw delta for '=='.

  `burns` counts burn episodes (entries into the burning state); an
  objective with burns > 0 fails the verdict at ticket or page
  severity.
  """

  def __init__(self, objectives: List[Objective],
               min_samples: int = 3,
               baseline: Optional[Dict] = None):
    self._objectives = list(objectives)
    self._min_samples = max(int(min_samples), 2)
    self._baseline = dict(baseline or {})
    horizon = max([o.slow_window_secs or 300.0
                   for o in self._objectives] or [300.0])
    self._horizon = horizon * 1.25
    self._samples = collections.deque()   # (t, snapshot)
    self._state: Dict[str, Dict] = {
        o.name: {'name': o.name, 'metric': o.metric,
                 'comparison': o.comparison, 'kind': o.kind,
                 'severity': o.severity, 'state': NO_DATA,
                 'value': None, 'target': o.target, 'margin': None,
                 'burns': 0, 'last_burn_wall_time': None,
                 'description': o.description}
        for o in self._objectives}

  @property
  def objectives(self) -> List[Objective]:
    return list(self._objectives)

  def _resolved_target(self, o: Objective) -> Optional[float]:
    if o.baseline is None:
      return o.target
    base = self._baseline.get(o.baseline)
    if base is None:
      return None
    return float(base) * o.target

  def _window(self, now: float, secs: float):
    cutoff = now - secs
    return [(t, snap) for t, snap in self._samples if t >= cutoff]

  def _judge_value(self, o: Objective, now: float, target: float):
    holds = _COMPARATORS[o.comparison]
    fast = [(t, v) for t, snap in self._window(now, o.fast_window_secs)
            if (v := _metric_value(snap, o)) is not None]
    if not fast:
      return NO_DATA, None
    value = fast[-1][1]
    if len(fast) < self._min_samples:
      return OK, value
    if any(holds(v, target) for _, v in fast):
      # One healthy fast-window sample: not burning.
      return OK, value
    slow = [v for t, snap in self._window(now, o.slow_window_secs)
            if (v := _metric_value(snap, o)) is not None]
    bad = sum(1 for v in slow if not holds(v, target))
    if slow and bad >= max(len(slow) / 2.0, 1):
      return BURNING, value
    return OK, value

  def _rate_over(self, o: Objective, now: float, secs: float):
    """(window delta, per-second rate) of a counter over the trailing
    `secs`, or (None, None) below two valid samples."""
    samples = [(t, v) for t, snap in self._window(now, secs)
               if (v := _metric_value(snap, o)) is not None]
    if len(samples) < 2:
      return None, None
    (t0, v0), (t1, v1) = samples[0], samples[-1]
    dt = t1 - t0
    if dt <= 0:
      return None, None
    return v1 - v0, (v1 - v0) / dt

  def _judge_rate(self, o: Objective, now: float, target: float):
    delta, rate = self._rate_over(o, now, o.fast_window_secs)
    if delta is None:
      return NO_DATA, None
    if o.comparison == '==':
      # The counter must not move inside the fast window; a monotone
      # counter's fast-window bump is a slow-window bump too.
      return (OK if delta == target else BURNING), delta
    if _COMPARATORS[o.comparison](rate, target):
      return OK, rate
    # <= and >= rates: one fast-window stall (a checkpoint save) must not
    # fail the run; the slow window's rate must agree.
    _, slow_rate = self._rate_over(o, now, o.slow_window_secs)
    if slow_rate is None or _COMPARATORS[o.comparison](slow_rate,
                                                      target):
      return OK, rate
    return BURNING, rate

  def observe(self, snapshot: Dict,
              now: Optional[float] = None) -> List[str]:
    """Append one snapshot and re-judge everything. Returns the names of
    the objectives that entered the burning state on this observation."""
    now = time.time() if now is None else float(now)
    self._samples.append((now, snapshot))
    while self._samples and self._samples[0][0] < now - self._horizon:
      self._samples.popleft()
    newly = []
    for o in self._objectives:
      entry = self._state[o.name]
      target = self._resolved_target(o)
      if target is None:
        entry.update(state=NO_BASELINE, value=None, margin=None)
        continue
      entry['target'] = target
      if o.kind == 'rate':
        state, value = self._judge_rate(o, now, target)
      else:
        state, value = self._judge_value(o, now, target)
      margin = None
      if value is not None:
        # Signed headroom: positive is inside the objective.
        if o.comparison == '<=':
          margin = target - value
        elif o.comparison == '>=':
          margin = value - target
        else:
          margin = -abs(value - target)
      was_burning = entry['state'] == BURNING
      entry.update(state=state, value=value, margin=margin)
      if state == BURNING and not was_burning:
        entry['burns'] += 1
        entry['last_burn_wall_time'] = round(now, 3)
        newly.append(o.name)
    return newly

  def burning(self) -> List[str]:
    return [n for n, e in self._state.items()
            if e['state'] == BURNING]

  def states(self) -> Dict[str, Dict]:
    """A copy of every objective's judged state ({name: {state, value,
    target, margin, severity, burns, ...}}). Each entry was written by
    one `entry.update(...)`, so each copy is consistent in itself; a
    caller that needs consistency across objectives holds the owning
    engine's lock (SloEngine.control_snapshot does)."""
    return {n: dict(e) for n, e in self._state.items()}

  def verdict(self) -> Dict:
    """Pass or fail, and every objective's final state and burn count:
    `pass` fails on any ticket or page objective that ever burned."""
    violations = sorted(
        n for n, e in self._state.items()
        if e['burns'] > 0 and e['severity'] in ('ticket', 'page'))
    return {
        'pass': not violations,
        'violations': violations,
        'wall_time': round(time.time(), 3),
        'objectives': {n: dict(e) for n, e in self._state.items()},
    }


# --------------------------------------------------------------------
# The engine: thread, emission and triggered diagnostics.
# --------------------------------------------------------------------


class SloEngine:
  """The driver-resident judge: snapshots the registry on a cadence (its
  own `slo-engine` thread, and `observe()` calls from the driver's
  summary block, so detection is step-synchronous when summaries are
  frequent), writes each burn as an `slo_violation` incident, the
  `slo_violations` summary scalar and a note in the health monitor's
  external-incident ledger, and on the first page-severity burn of an
  objective captures into `<logdir>/diagnostics/`:

    slo_flight_<objective>.json   the flight recorder's dump
    slo_trace_<objective>.json    trace_report's slice of traces.jsonl
                                  over the violation window
    slo_profile_<objective>/      a bounded torch.profiler capture of
                                  the next K learner steps (queued for
                                  the driver loop, which owns the
                                  profiler: `take_profile_request`)

  One capture per objective per run; `finalize()` writes
  SLO_VERDICT.json (atomic) and returns the verdict."""

  # observe() runs on two threads (the engine's and the driver's summary
  # block): the evaluator, the capture table and both queues change
  # under _lock only.
  _captures: guarded_by('_lock')
  _profile_queue: guarded_by('_lock')
  _capture_queue: guarded_by('_lock')

  def __init__(self, objectives: List[Objective], logdir: str,
               registry: Optional[telemetry.MetricsRegistry] = None,
               writer=None, incidents=None, flight=None, health=None,
               capture: bool = True, interval_secs: float = 5.0,
               baseline: Optional[Dict] = None,
               min_samples: int = 3,
               trace_slice_fn: Optional[Callable] = None):
    self._evaluator = SloEvaluator(objectives,
                                   min_samples=min_samples,
                                   baseline=baseline)
    self._logdir = logdir
    self._registry = registry or telemetry.registry()
    self._writer = writer
    self._incidents = incidents
    self._flight = flight
    self._health = health
    self._capture = bool(capture)
    self._interval = max(float(interval_secs), 0.25)
    self._trace_slice_fn = trace_slice_fn or _trace_slice
    self._lock = make_lock('slo.SloEngine._lock')
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._captures: Dict[str, Dict] = {}
    self._profile_queue: collections.deque = collections.deque()
    # Captures waiting for their artifacts: queued by whichever observe()
    # detects the burn, written on the engine thread (flush_captures), so
    # the training loop never pays the flight dump and the trace slice.
    self._capture_queue: collections.deque = collections.deque()
    # The judge's own registry view (the gauge is unregistered at stop:
    # it closes over this per-run engine).
    self._m_violations = telemetry.counter('slo/violations')
    self._g_burning = telemetry.gauge(
        'slo/burning', fn=lambda: len(self._evaluator.burning()))

  # --- lifecycle ---

  def start(self):
    self.observe()  # the t0 sample: rate objectives span the whole run
    self._thread = threading.Thread(target=self._loop,
                                    name='slo-engine', daemon=True)
    self._thread.start()

  def _loop(self):
    while not self._stop.wait(self._interval):
      try:
        self.observe()
      except Exception:  # must never kill the run
        log.exception('SLO evaluator tick failed')
      self.flush_captures()

  def stop(self):
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None
    telemetry.registry().unregister(self._g_burning.name,
                                    self._g_burning)

  # --- evaluation and emission ---

  def observe(self, now: Optional[float] = None) -> List[str]:
    """One evaluation pass (thread-safe). Returns the newly burning
    objective names. Only the evaluator's update runs under the lock;
    the incident and summary writes follow outside it, guarded (a full
    disk at a burn must not kill the calling thread, which may be the
    training loop), and the heavy capture artifacts are only queued
    (flush_captures writes them). The one-capture-per-objective limit is
    kept under the lock."""
    snapshot = self._registry.snapshot()
    with self._lock:
      newly = self._evaluator.observe(snapshot, now=now)
      if not newly:
        return newly
      states = {name: dict(self._evaluator._state[name])
                for name in newly}
      for name in newly:
        if (self._capture and states[name]['severity'] == 'page'
            and name not in self._captures):
          capture: Dict = {
              'objective': name, 'wall_time': round(time.time(), 3),
              'flight': None, 'trace_slice': None, 'profile': None}
          self._captures[name] = capture
          self._capture_queue.append((name, capture, states[name]))
    try:
      step = int(snapshot.get('driver/update_steps') or 0)
      for name in newly:
        state = states[name]
        self._m_violations.inc()
        if self._incidents is not None:
          self._incidents.event(
              'slo_violation', step=step, objective=name,
              severity=state['severity'], metric=state['metric'],
              value=state['value'], target=state['target'],
              margin=state['margin'], burns=state['burns'])
        if self._health is not None:
          self._health.note_external(f'slo_{name}')
      if self._writer is not None:
        self._writer.scalar('slo_violations',
                            self._m_violations.value, step)
    except Exception:  # judging survives a sick disk
      log.exception('SLO violation emission failed')
    return newly

  # --- the control surface (controller.py) ---

  def burning(self) -> List[str]:
    """The names of the objectives burning now, read under the engine's
    lock (stable against a concurrent observe(); the controller thread's
    read API)."""
    with self._lock:
      return self._evaluator.burning()

  def control_snapshot(self) -> Dict[str, Dict]:
    """A copy of every objective's judged state, taken under the lock,
    so it describes one evaluation pass: two objectives over the same
    metric never disagree about its value inside one snapshot. The
    controller's input."""
    with self._lock:
      return self._evaluator.states()

  def flush_captures(self):
    """Write the queued capture artifacts (the engine thread each tick;
    finalize for burns after the last tick), each best-effort."""
    while True:
      with self._lock:
        if not self._capture_queue:
          return
        name, capture, state = self._capture_queue.popleft()
      try:
        self._write_capture_artifacts(name, capture, state)
      except Exception:  # never take down the run
        log.exception('SLO capture artifacts for %r failed', name)

  # --- triggered deep diagnostics ---

  def _write_capture_artifacts(self, name: str, capture: Dict,
                               state: Dict):
    """The first page-severity burn of `name` (its entry reserved under
    the lock): dump the flight recorder, slice the trace stream over the
    violation window, and queue a profiler capture for the driver loop.
    Each artifact is best-effort; the profiler request needs no disk."""
    out_dir = os.path.join(self._logdir, 'diagnostics')
    try:
      os.makedirs(out_dir, exist_ok=True)
    except OSError:
      out_dir = None
    if out_dir is not None and self._flight is not None:
      try:
        capture['flight'] = self._flight.write(
            os.path.join(out_dir, f'slo_flight_{name}.json'))
      except Exception:
        pass
    if out_dir is not None:
      try:
        objective = next(o for o in self._evaluator.objectives
                         if o.name == name)
        window_secs = objective.slow_window_secs or 300.0
        slice_path = os.path.join(out_dir, f'slo_trace_{name}.json')
        if self._trace_slice_fn(self._logdir, window_secs, slice_path,
                                state):
          capture['trace_slice'] = slice_path
      except Exception:
        pass
    with self._lock:
      self._profile_queue.append(name)
    if self._incidents is not None:
      try:
        self._incidents.event('slo_capture', objective=name,
                              flight=capture['flight'],
                              trace_slice=capture['trace_slice'])
      except Exception:
        pass

  def take_profile_request(self) -> Optional[str]:
    """Pop the next queued profiler capture (the driver loop; None when
    idle). The driver starts a bounded trace into
    diagnostics/slo_profile_<name>/ and reports back with
    `note_profile` (None: the capture could not start)."""
    with self._lock:
      return self._profile_queue.popleft() if self._profile_queue \
          else None

  def note_profile(self, name: str, path: Optional[str]):
    with self._lock:
      if name in self._captures:
        self._captures[name]['profile'] = path

  # --- the verdict ---

  def verdict(self, extra: Optional[Dict] = None) -> Dict:
    with self._lock:
      out = self._evaluator.verdict()
      out['captures'] = {n: dict(c) for n, c in self._captures.items()}
    if extra:
      out.update(extra)
    return out

  def finalize(self, path: Optional[str] = None,
               extra: Optional[Dict] = None) -> Dict:
    """A last observation, the queued captures' artifacts, and the
    atomic SLO_VERDICT.json write. Returns the verdict."""
    try:
      self.observe()
    except Exception:
      pass
    self.flush_captures()
    verdict = self.verdict(extra=extra)
    if path is None:
      path = os.path.join(self._logdir, 'SLO_VERDICT.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(verdict, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)
    return verdict


def _trace_slice(logdir: str, window_secs: float, out_path: str,
                 state: Dict) -> bool:
  """The violation window's hop-delta slice: trace_report.summarize over
  the records inside the last `window_secs`, written as JSON beside the
  other capture artifacts. scripts/ is imported lazily: an install
  without it skips the slice."""
  try:
    from scripts import trace_report
  except ImportError:
    return False
  now = time.time()
  records = [r for r in trace_report.load_traces(logdir)
             if r.get('t') is None or r['t'] >= now - window_secs]
  summary = trace_report.summarize(records)
  summary['slo_objective'] = dict(state)
  summary['window_secs'] = window_secs
  tmp = out_path + '.tmp'
  with open(tmp, 'w') as f:
    json.dump(summary, f, indent=2, default=str)
  os.replace(tmp, out_path)
  return True


def read_verdict(logdir: str) -> Optional[Dict]:
  """The run's SLO_VERDICT.json, or None."""
  try:
    with open(os.path.join(logdir, 'SLO_VERDICT.json')) as f:
      return json.load(f)
  except (OSError, ValueError):
    return None
