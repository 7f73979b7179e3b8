"""The self-healing controller, ported from scalable_agent_tpu/controller.py
under its names: the SLO engine's verdicts wired to bounded moves of the
fleet's knobs.

1. **A declarative policy table** (`Rule`): objective name -> actuator
   name, with a bounded step, a cool-down between moves and a hysteresis
   band. A rule triggers when its objective burns, or when its margin has
   thinned to `trigger_margin` (the leading edge, before a page objective
   burns), and reverts one step per cool-down only once the margin is
   back past `clear_margin` (>= trigger_margin by validation), so a
   metric hovering at its threshold cannot flap the knob.
   `DEFAULT_RULES` is the JAX package's table, literal for literal:
   raise `replay_k` when the env plane is the bound, flip admission
   block->shed under overload, stretch the remote publish cadence under
   transport pressure, grow or shrink the actor fleet and the pod.
   `--controller_policy` loads a JSON rule list instead; a typo'd rule
   fails at spin-up.

2. **Actuators** (`Actuator`): named, bounded, thread-safe seams that
   driver.train registers: `replay_k` (BatchPrefetcher.set_replay_k),
   `admission` (InferenceServer.set_admission), `publish_secs` (the
   loop's remote publish cadence cell), `fleet_size`
   (ActorFleet.set_target_size: growing unparks slots and rehabilitates
   quarantined ones on probation) and `pod_size` (POD_TARGET.json for
   the cluster's supervisor). A rule over an actuator this topology does
   not expose is dropped at construction with a log line.

3. **The loop** (`Controller`): its `controller` thread reads the
   engine's locked `control_snapshot()` (states and margins) every
   `interval_secs` and makes at most one bounded move per rule per
   cool-down. At most one engaged rule owns an actuator at a time (the
   first engaged, in table order), so two rules over one knob cannot
   see-saw it. Every move, applied or not, is a `controller_action`
   incident, a `controller/actions` (and `controller/reverts`) count, a
   row of CONTROLLER_LOG.json (at most `max_log_actions`, the rest
   counted), and, applied, a `health.note_external('controller_<actuator>')`
   entry, so drain manifests name what the controller did.

4. **observe** (the default) judges the whole table and logs every move
   it would make (`applied: false`) against a virtual actuator value, so
   the simulated escalate -> bound -> revert sequence is faithful, and
   touches nothing; `act` applies the moves.

`tick(now=)` reads no clock but `now` (the log's `wall_time` aside), so
a scripted trace repeats exactly. Standard library only (no torch).
"""

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from scalable_agent_tpu_torch import slo as slo_lib
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis.runtime import guarded_by, make_lock

log = logging.getLogger('scalable_agent_tpu_torch')

MODES = ('off', 'observe', 'act')

# The actuator names a policy table may reference: a rule over any
# other name is a typo (Rule.validate raises), while a known name this
# topology does not register is a topology gap, dropped with a log line
# at spin-up.
KNOWN_ACTUATORS = ('replay_k', 'admission', 'publish_secs',
                   'fleet_size', 'pod_size')

ACTUATOR_KINDS = ('int', 'float', 'enum')


class Actuator:
  """One bounded, thread-safe knob the controller may move.

  Args:
    name: registry name (one of KNOWN_ACTUATORS for the shipped
      rules; tests may register others).
    kind: 'int' | 'float' (numeric, stepped within [minimum, maximum])
      or 'enum' (moved to a rule's `to` value, one of `values`).
    get_fn / set_fn: the owner's thread-safe read/write seam. set_fn
      is only called in act mode; a raise is caught and recorded as an
      unapplied action, never propagated into the controller thread.
    minimum / maximum: hard clamp for numeric kinds (the bounded-move
      guarantee — the controller can NEVER push a knob outside the
      range the driver registered).
    values: legal states for enum kinds.
  """

  def __init__(self, name: str, kind: str, get_fn: Callable,
               set_fn: Callable, minimum: Optional[float] = None,
               maximum: Optional[float] = None,
               values: Optional[tuple] = None):
    if kind not in ACTUATOR_KINDS:
      raise ValueError(f'actuator {name!r}: kind must be one of '
                       f'{ACTUATOR_KINDS}, got {kind!r}')
    if kind == 'enum':
      if not values:
        raise ValueError(f'enum actuator {name!r} needs values')
    elif minimum is None or maximum is None or minimum > maximum:
      raise ValueError(f'numeric actuator {name!r} needs '
                       f'minimum <= maximum, got [{minimum}, '
                       f'{maximum}]')
    self.name = name
    self.kind = kind
    self.get_fn = get_fn
    self.set_fn = set_fn
    self.minimum = minimum
    self.maximum = maximum
    self.values = tuple(values) if values else ()

  def clamp(self, value):
    if self.kind == 'enum':
      return value
    value = min(max(value, self.minimum), self.maximum)
    return int(round(value)) if self.kind == 'int' else float(value)


@dataclasses.dataclass(frozen=True)
class Rule:
  """One policy-table row: objective → bounded actuator move.

  Args:
    objective: the SLO objective name watched (must exist in the
      engine's loaded set; unknown names are dropped with a warning —
      a custom --slo_spec legitimately renames objectives).
    actuator: the actuator moved (must be a KNOWN_ACTUATORS name).
    direction: 'up' | 'down' — which bound a numeric escalation steps
      toward. Ignored for enum actuators.
    step: numeric escalation step size (and the revert step back
      toward the baseline).
    to: enum escalation target (enum actuators only).
    revert_to: enum revert target; None = the value at first move.
    trigger_margin: escalate when the objective's margin (signed
      headroom; positive = inside the objective) is <= this, even
      before it burns — the leading-edge trigger that lets the
      controller keep a page objective from ever failing the verdict.
      None = escalate on burning only.
    clear_margin: revert only once state is OK and margin >= this.
      The [trigger_margin, clear_margin] gap IS the hysteresis band.
    cooldown_secs: minimum seconds between this rule's moves.
    description: one line for the log/docs.
  """
  objective: str
  actuator: str
  direction: str = 'up'
  step: float = 1.0
  to: Optional[str] = None
  revert_to: Optional[str] = None
  trigger_margin: Optional[float] = None
  clear_margin: float = 0.0
  cooldown_secs: float = 30.0
  description: str = ''

  def validate(self):
    if self.actuator not in KNOWN_ACTUATORS:
      raise ValueError(
          f'rule for {self.objective!r}: unknown actuator '
          f'{self.actuator!r} (known: {KNOWN_ACTUATORS})')
    if self.direction not in ('up', 'down'):
      raise ValueError(f'rule for {self.objective!r}: direction must '
                       f'be up|down, got {self.direction!r}')
    if self.step <= 0:
      raise ValueError(f'rule for {self.objective!r}: step must be '
                       f'> 0, got {self.step}')
    if self.cooldown_secs < 0:
      raise ValueError(f'rule for {self.objective!r}: cooldown_secs '
                       f'must be >= 0, got {self.cooldown_secs}')
    if (self.trigger_margin is not None
        and self.clear_margin < self.trigger_margin):
      raise ValueError(
          f'rule for {self.objective!r}: clear_margin '
          f'({self.clear_margin}) must be >= trigger_margin '
          f'({self.trigger_margin}) — the gap is the hysteresis band '
          'that keeps a hovering metric from flapping the knob')
    return self


# The shipped mapping, the JAX package's table literal for literal:
# every objective= names one of slo.DEFAULT_OBJECTIVES and every
# actuator= one of KNOWN_ACTUATORS. Cool-downs are deliberately long:
# production planes move in minutes; drills and tests pass their own
# table.
DEFAULT_RULES = (
    # Env plane is the bound (the learner mostly parked on the feed):
    # IMPACT says staleness tolerance rises under the clipped-target
    # surrogate — re-serve staged batches instead of idling
    # (arXiv 1912.00167).
    Rule(objective='learner_plane_utilization', actuator='replay_k',
         direction='up', step=1, cooldown_secs=120.0,
         clear_margin=0.2,
         description='learner starved by the env plane: raise '
                     'replay_k (IMPACT sample reuse)'),
    # Overload burn: unroll end-to-end latency past its objective
    # means admissions parked behind a saturated serving plane —
    # blocking converts overload into latency; shedding converts it
    # into counted, bounded rejections.
    Rule(objective='unroll_e2e_p99_ms', actuator='admission',
         to='shed', revert_to='block', cooldown_secs=120.0,
         clear_margin=10000.0,
         description='overload burn: flip admission block->shed'),
    # Transport pressure: ack service time climbing means the ingest/
    # publish path is contended — stretch the remote publish cadence
    # (each publish is a whole-tree device_get + fleet fan-out).
    Rule(objective='ingest_ack_p99_ms', actuator='publish_secs',
         direction='up', step=2.0, cooldown_secs=120.0,
         clear_margin=2000.0,
         description='transport pressure: stretch the remote publish '
                     'cadence'),
    # Thinning quorum: grow the fleet — unpark parked slots, then
    # rehabilitate quarantined ones through the probation ladder. The
    # trigger margin acts BEFORE the page objective burns.
    Rule(objective='fleet_healthy_fraction', actuator='fleet_size',
         direction='up', step=1, trigger_margin=0.25,
         clear_margin=0.5, cooldown_secs=60.0,
         description='thinning quorum: grow the fleet '
                     '(unpark/rehabilitate slots)'),
    # Dead env plane (producers parked on backpressure the whole
    # window): the learner is the bound and the offered load is pure
    # queueing — shed it by parking slots (PAL's shrink direction).
    Rule(objective='env_plane_utilization', actuator='fleet_size',
         direction='down', step=1, cooldown_secs=180.0,
         clear_margin=0.05,
         description='producers fully parked: shrink the fleet'),
    # Elastic pod membership: the pod-level analogues of
    # the two fleet_size rules. pod_size is DECLARATIVE — the
    # actuator publishes the desired host count to POD_TARGET.json
    # (process 0 owns it, per-actuator-ownership) and the cluster
    # supervisor reconciles actual hosts toward it; the learner
    # never spawns or kills hosts itself. Registered only when
    # --pod_max_hosts > 0, so these rules drop with a spin-up log
    # line on fixed-topology runs (the KNOWN-name topology-gap path).
    Rule(objective='fleet_healthy_fraction', actuator='pod_size',
         direction='up', step=1, trigger_margin=0.25,
         clear_margin=0.5, cooldown_secs=120.0,
         description='thinning pod: request a replacement actor host '
                     '(POD_TARGET.json; supervisor reconciles)'),
    Rule(objective='env_plane_utilization', actuator='pod_size',
         direction='down', step=1, cooldown_secs=300.0,
         clear_margin=0.05,
         description='producers fully parked: request a smaller pod '
                     '(PAL shrink direction, arXiv 2110.01101)'),
    # Serving-plane overload: the multi-tenant serving latency
    # objective burning means the shared inference step is
    # saturated — by local batcher traffic, routed batches, or
    # both. Same response as the unroll-latency rule and through the
    # SAME actuator (per-actuator ownership keeps the two rules from
    # fighting: whichever burns first holds the cooldown): shed
    # admissions instead of queueing them.
    Rule(objective='serving_latency_p99_ms', actuator='admission',
         to='shed', revert_to='block', cooldown_secs=120.0,
         clear_margin=10000.0,
         description='serving-plane overload: flip admission '
                     'block->shed'),
)


def load_rules(spec_path: str = '') -> List[Rule]:
  """The policy table: `spec_path` (a JSON list of Rule field dicts)
  when given, else DEFAULT_RULES. Raises on an unreadable/invalid
  spec — a typo'd policy must fail the run at spin-up, not silently
  control nothing (the --slo_spec rule)."""
  if spec_path:
    with open(spec_path) as f:
      raw = json.load(f)
    if not isinstance(raw, list) or not raw:
      raise ValueError(f'controller policy {spec_path!r} must be a '
                       'non-empty JSON list of rule dicts')
    rules = []
    for entry in raw:
      try:
        rules.append(Rule(**entry))
      except TypeError as e:
        raise ValueError(f'controller policy {spec_path!r}: bad rule '
                         f'entry {entry!r}: {e}') from e
  else:
    rules = list(DEFAULT_RULES)
  for rule in rules:
    rule.validate()
  return rules


class _RuleState:
  """Per-rule mutable controller state."""

  def __init__(self):
    self.engaged = False
    self.baseline = None        # actuator value at the first move
    self.virtual = None         # observe-mode simulated value
    self.last_action_time = float('-inf')
    self.escalations = 0
    self.reverts = 0


class Controller:
  """The verdict-to-actuation loop (module docstring).

  Args:
    engine: the SloEngine whose `control_snapshot()` supplies the
      burning set + margins (read under the engine's lock).
    rules: the policy table (load_rules()).
    actuators: the Actuator seams this run exposes; rules over
      actuators not in the list are dropped with a log line.
    logdir: where CONTROLLER_LOG.json lands.
    mode: 'observe' (dry-run; every move logged, nothing touched) or
      'act'.
    interval_secs: tick cadence of the controller thread; tick() is
      also directly callable (tests drive it with an injected clock —
      the loop is deterministic: no randomness, no hidden wall-clock
      reads beyond `now`).
    incidents / health: the EventLog + HealthMonitor emission seams
      (both optional; a missing seam just skips that emission).
    log_name: the action-log filename (multi-host runs suffix it).
  """

  # Lock discipline (analysis/concurrency.py checks it): the action log, the
  # per-actuator ownership table, and the drop counter mutate only
  # under _lock (tick/finalize hold it; the *_locked helpers run
  # inside). `_applied`/`_apply_errors` stay unannotated: counts()
  # documents its deliberate lock-free GIL-atomic reads.
  _actions: guarded_by('_lock')
  _owner: guarded_by('_lock')
  _dropped_actions: guarded_by('_lock')

  def __init__(self, engine, rules: List[Rule],
               actuators: List[Actuator], logdir: str,
               mode: str = 'observe', interval_secs: float = 5.0,
               incidents=None, health=None,
               log_name: str = 'CONTROLLER_LOG.json',
               max_log_actions: int = 2000):
    if mode not in ('observe', 'act'):
      raise ValueError(f"controller mode must be observe|act, got "
                       f'{mode!r} (off means: do not construct one)')
    self._engine = engine
    self._mode = mode
    self._logdir = logdir
    self._log_path = os.path.join(logdir, log_name)
    self._interval = max(float(interval_secs), 0.05)
    self._incidents = incidents
    self._health = health
    self._max_log_actions = int(max_log_actions)
    self._actuators: Dict[str, Actuator] = {a.name: a
                                            for a in actuators}
    objective_names = set(engine.control_snapshot())
    self._rules: List[Rule] = []
    for rule in rules:
      rule.validate()
      act = self._actuators.get(rule.actuator)
      if act is None:
        log.info('controller: dropping rule %s->%s (actuator not '
                 'exposed by this topology)', rule.objective,
                 rule.actuator)
        continue
      # Enum rules fail at SPIN-UP like every other policy typo: a
      # rule with no `to` would silently never fire, and an invalid
      # `to`/`revert_to` would burn an apply error on every cool-down.
      if act.kind == 'enum':
        if rule.to is None:
          raise ValueError(
              f'rule {rule.objective}->{rule.actuator}: enum '
              f'actuator needs a `to` target (one of {act.values})')
        for label, value in (('to', rule.to),
                             ('revert_to', rule.revert_to)):
          if value is not None and value not in act.values:
            raise ValueError(
                f'rule {rule.objective}->{rule.actuator}: {label}='
                f'{value!r} is not a legal state (one of '
                f'{act.values})')
      if rule.objective not in objective_names:
        log.warning('controller: dropping rule %s->%s (objective not '
                    'in the loaded SLO set)', rule.objective,
                    rule.actuator)
        continue
      self._rules.append(rule)
    self._state = [_RuleState() for _ in self._rules]
    # Per-actuator arbitration: at most ONE engaged rule owns a knob
    # at a time (first engaged wins, in table order) — two rules over
    # the same actuator (the shipped grow/shrink fleet_size pair)
    # must not see-saw it, each revert undoing the other's move.
    self._owner: Dict[str, _RuleState] = {}
    self._lock = make_lock('controller._lock')
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self._actions: List[Dict] = []
    self._dropped_actions = 0
    self._applied = 0
    self._apply_errors = 0
    # Registry view (literal names: the metric-name parity holds them). The
    # counters stay registered (cumulative, like slo/violations); the
    # fn-gauge closes over this per-run instance and is unregistered
    # at stop().
    self._m_actions = telemetry.counter('controller/actions')
    self._m_reverts = telemetry.counter('controller/reverts')
    self._g_engaged = telemetry.gauge(
        'controller/engaged', fn=lambda: self.engaged_rules())

  # --- lifecycle ---

  @property
  def mode(self) -> str:
    return self._mode

  def start(self):
    self._thread = threading.Thread(target=self._loop,
                                    name='controller', daemon=True)
    self._thread.start()

  def _loop(self):
    while not self._stop.wait(self._interval):
      try:
        self.tick()
      except Exception:  # pragma: no cover - must never kill the run
        log.exception('controller tick failed')

  def stop(self):
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
      self._thread = None
    telemetry.registry().unregister(self._g_engaged.name,
                                    self._g_engaged)

  # --- the loop body ---

  def _current(self, rule: Rule, rs: _RuleState, act: Actuator):
    """The decision-time actuator value: the real knob in act mode;
    the simulated one in observe mode (so a dry run logs the faithful
    escalate→bound→revert sequence instead of re-proposing the same
    first step forever)."""
    if self._mode == 'observe' and rs.virtual is not None:
      return rs.virtual
    try:
      return act.get_fn()
    except Exception:
      log.exception('controller: actuator %r get failed', act.name)
      return None

  def _escalated(self, rule: Rule, act: Actuator, cur):
    if act.kind == 'enum':
      return rule.to if cur != rule.to else None
    delta = rule.step if rule.direction == 'up' else -rule.step
    desired = act.clamp(cur + delta)
    return desired if desired != cur else None

  def _reverted(self, rule: Rule, act: Actuator, cur, baseline):
    if act.kind == 'enum':
      target = rule.revert_to if rule.revert_to is not None \
          else baseline
      return (target, True) if cur != target else (None, True)
    target = baseline if baseline is not None else cur
    if cur == target:
      return None, True
    step = rule.step if cur < target else -rule.step
    desired = act.clamp(cur + step)
    # Never overshoot the baseline on the way back.
    if (cur < target and desired > target) or \
       (cur > target and desired < target):
      desired = act.clamp(target)
    return desired, desired == act.clamp(target)

  def tick(self, now: Optional[float] = None) -> List[Dict]:
    """One control pass; returns the actions taken (tests drive this
    directly with an injected `now` — the pass is deterministic)."""
    now = time.time() if now is None else float(now)
    snapshot = self._engine.control_snapshot()
    taken: List[Dict] = []
    with self._lock:
      for rule, rs in zip(self._rules, self._state):
        entry = snapshot.get(rule.objective)
        if entry is None:
          continue
        state = entry.get('state')
        margin = entry.get('margin')
        if state in (slo_lib.NO_DATA, slo_lib.NO_BASELINE):
          continue  # blind is not a reason to move a knob
        act = self._actuators[rule.actuator]
        burning = state == slo_lib.BURNING
        pressured = (rule.trigger_margin is not None
                     and margin is not None
                     and margin <= rule.trigger_margin)
        if burning or pressured:
          owner = self._owner.get(rule.actuator)
          if owner is not None and owner is not rs:
            continue  # another rule holds this knob: hold, don't fight
          if now - rs.last_action_time < rule.cooldown_secs:
            continue  # hold: the last move gets its cool-down
          cur = self._current(rule, rs, act)
          if cur is None:
            continue
          desired = self._escalated(rule, act, cur)
          if desired is None:
            continue  # at the bound: holding is the action
          if not rs.engaged:
            rs.engaged = True
            rs.baseline = cur
            self._owner[rule.actuator] = rs
          rs.escalations += 1
          taken.append(self._do_action_locked(now, 'escalate', rule, rs,
                                       act, cur, desired, entry))
        elif rs.engaged:
          clear = (state == slo_lib.OK
                   and (margin is None
                        or margin >= rule.clear_margin))
          if not clear:
            continue  # hysteresis: recovered-but-thin holds the knob
          if now - rs.last_action_time < rule.cooldown_secs:
            continue
          cur = self._current(rule, rs, act)
          if cur is None:
            continue
          desired, done = self._reverted(rule, act, cur, rs.baseline)
          if desired is None:
            self._disengage_locked(rule, rs)
            continue
          rs.reverts += 1
          if done:
            self._disengage_locked(rule, rs)
          taken.append(self._do_action_locked(now, 'revert', rule, rs, act,
                                       cur, desired, entry))
    return taken

  def _disengage_locked(self, rule: Rule, rs: _RuleState):
    rs.engaged = False
    if self._owner.get(rule.actuator) is rs:
      del self._owner[rule.actuator]

  def _do_action_locked(self, now, kind, rule: Rule, rs: _RuleState,
                 act: Actuator, cur, desired, entry) -> Dict:
    """Apply (act mode) + record one move. Called with the lock held;
    the actuator set and the emissions are exception-guarded — a
    failing knob or a sick disk costs the action, never the thread."""
    applied = False
    error = None
    if self._mode == 'act':
      try:
        act.set_fn(desired)
        applied = True
        self._applied += 1
      except Exception as e:
        self._apply_errors += 1
        error = f'{type(e).__name__}: {e}'
        log.exception('controller: actuator %r set(%r) failed',
                      act.name, desired)
    rs.virtual = desired
    rs.last_action_time = now
    action = {
        'wall_time': round(now, 3),
        'kind': kind,
        'mode': self._mode,
        'objective': rule.objective,
        'actuator': act.name,
        'from': cur,
        'to': desired,
        'applied': applied,
        'state': entry.get('state'),
        'value': entry.get('value'),
        'margin': entry.get('margin'),
    }
    if error is not None:
      action['error'] = error
    if len(self._actions) < self._max_log_actions:
      self._actions.append(action)
    else:
      self._dropped_actions += 1  # no silent caps: counted + logged
    self._m_actions.inc()
    if kind == 'revert':
      self._m_reverts.inc()
    (log.warning if self._mode == 'act' else log.info)(
        'controller %s [%s]: %s %s: %s -> %s (objective %s state=%s '
        'margin=%s)', kind, self._mode,
        'APPLIED' if applied else 'dry-run', act.name, cur, desired,
        rule.objective, entry.get('state'), entry.get('margin'))
    try:
      if self._incidents is not None:
        # 'kind' is the EventLog's own field — the move's own kind
        # rides as 'action'.
        self._incidents.event('controller_action', **{
            ('action' if k == 'kind' else k): v
            for k, v in action.items() if k != 'wall_time'})
      if applied and self._health is not None:
        # The external-incident ledger: controller moves ride drain
        # manifests and halt bundles exactly like slo_<name> burns.
        self._health.note_external(f'controller_{act.name}')
      self._write_log_locked()
    except Exception:
      log.exception('controller action emission failed')
    return action

  # --- the log + counters surface ---

  def _write_log_locked(self):
    """Atomic CONTROLLER_LOG.json rewrite (tmp + rename, the verdict
    pattern): the log is either complete or the previous complete
    version — a postmortem never reads a half-written row."""
    payload = {
        'mode': self._mode,
        'rules': [dataclasses.asdict(r) for r in self._rules],
        'actions': self._actions,
        'dropped_actions': self._dropped_actions,
        'counts': self.counts(),
        'wall_time': round(time.time(), 3),
    }
    tmp = self._log_path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(payload, f, indent=2, default=str)
    os.replace(tmp, self._log_path)

  def engaged_rules(self) -> int:
    with self._lock:
      return sum(1 for rs in self._state if rs.engaged)

  def counts(self) -> Dict[str, int]:
    # Lock-free: every field is a GIL-atomic read of ints the locked
    # sections maintain; callers (summary block, log writer under the
    # lock) tolerate one-action staleness.
    escalations = sum(rs.escalations for rs in self._state)
    reverts = sum(rs.reverts for rs in self._state)
    return {
        'actions': escalations + reverts,
        'escalations': escalations,
        'reverts': reverts,
        'applied': self._applied,
        'apply_errors': self._apply_errors,
    }

  def actions(self) -> List[Dict]:
    with self._lock:
      return [dict(a) for a in self._actions]

  def finalize(self) -> Dict:
    """Final CONTROLLER_LOG.json write; returns the counts summary
    (driver's finally — written on every exit path, like the SLO
    verdict)."""
    with self._lock:
      try:
        self._write_log_locked()
      except Exception:
        log.exception('controller log finalize failed')
      return self.counts()


def read_log(logdir: str) -> Optional[Dict]:
  """The run's CONTROLLER_LOG.json, or None."""
  try:
    with open(os.path.join(logdir, 'CONTROLLER_LOG.json')) as f:
      return json.load(f)
  except (OSError, ValueError):
    return None
