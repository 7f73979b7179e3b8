"""The port's self-healing controller (scalable_agent_tpu_torch/controller.py)
against the JAX package's controller.py, and its wiring through the
port's driver.

The parity tests feed the same inputs to both packages: the policy table
and `load_rules` on the same JSON files; scripted `control_snapshot()`
sequences (fixed numbers and numpy seeds) through each package's
`Controller.tick(now=)` in observe and in act mode, holding every tick's
action rows, the knobs' writes, the incident and health-ledger records,
the counts and CONTROLLER_LOG.json equal (its top-level wall time
aside); `validate_controller` on a seeded grid of configs; the SLO
engine's `control_snapshot`/`burning`/`states` on the same scripted
registry snapshots; `evaluate`'s validation of the knobs JAX's
refuses (fault C5); and `train`'s and `evaluate`'s validation of the
declared topology (fault C6). The driver test runs the port's fleet on the CPU
with an acting controller under an always-burning objective.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from scalable_agent_tpu import controller as jax_ctl
from scalable_agent_tpu import slo as jax_slo
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.config import \
    validate_controller as jax_validate_controller
from scalable_agent_tpu_torch import controller as ctl
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import slo
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config, validate_controller

torch.set_num_threads(1)

_PACKAGES = {'jax': (jax_ctl, jax_slo), 'port': (ctl, slo)}


def _obj(state='ok', margin=None, value=None, severity='page', target=1.0,
         burns=0):
  return {'state': state, 'margin': margin, 'value': value,
          'severity': severity, 'target': target, 'burns': burns}


class _StubEngine:
  """A control_snapshot()-shaped stand-in the scripts drive."""

  def __init__(self, snapshot):
    self.snapshot = snapshot

  def control_snapshot(self):
    return {n: dict(e) for n, e in self.snapshot.items()}


class _Knob:
  """A recording actuator target; `broken` makes every set raise."""

  def __init__(self, value, broken=False):
    self.value = value
    self.broken = broken
    self.sets = []

  def get(self):
    return self.value

  def set(self, v):
    if self.broken:
      raise RuntimeError('knob fell off')
    self.sets.append(v)
    self.value = v


class _Recorder:
  """Both emission seams: the EventLog's `event` and the health
  monitor's `note_external`, recorded in call order."""

  def __init__(self):
    self.rows = []

  def event(self, kind, **fields):
    self.rows.append(['event', kind, fields])

  def note_external(self, kind, count=1):
    self.rows.append(['external', kind, count])


# --------------------------------------------------------------------
# The policy table.
# --------------------------------------------------------------------


def test_the_tables_and_names_are_jax_s():
  assert ctl.MODES == jax_ctl.MODES
  assert ctl.KNOWN_ACTUATORS == jax_ctl.KNOWN_ACTUATORS
  assert ctl.ACTUATOR_KINDS == jax_ctl.ACTUATOR_KINDS
  assert [dataclasses.asdict(r) for r in ctl.DEFAULT_RULES] == [
      dataclasses.asdict(r) for r in jax_ctl.DEFAULT_RULES]
  assert ([f.name for f in dataclasses.fields(ctl.Rule)] ==
          [f.name for f in dataclasses.fields(jax_ctl.Rule)])
  names = {o.name for o in slo.DEFAULT_OBJECTIVES}
  assert all(r.objective in names for r in ctl.DEFAULT_RULES)


_POLICIES = {
    'none': None,
    'good': [dict(objective='fleet_healthy_fraction', actuator='fleet_size',
                  direction='up', step=1, trigger_margin=0.1,
                  clear_margin=0.4, cooldown_secs=2.0),
             dict(objective='unroll_e2e_p99_ms', actuator='admission',
                  to='shed')],
    'unknown_actuator': [dict(objective='x', actuator='warp_drive')],
    'bad_direction': [dict(objective='x', actuator='replay_k',
                           direction='sideways')],
    'zero_step': [dict(objective='x', actuator='replay_k', step=0)],
    'negative_cooldown': [dict(objective='x', actuator='replay_k',
                               cooldown_secs=-1.0)],
    'band_inverted': [dict(objective='x', actuator='replay_k',
                           trigger_margin=0.5, clear_margin=0.1)],
    'unknown_field': [dict(objective='x', actuator='replay_k', stepp=2)],
    'not_a_list': {'not': 'a list'},
    'empty_list': [],
}


def _load(module, path):
  try:
    return [dataclasses.asdict(r) for r in module.load_rules(path)]
  except (ValueError, TypeError) as e:
    return (type(e).__name__, str(e).replace(path, '<path>'))


@pytest.mark.parametrize('name', sorted(_POLICIES))
def test_load_rules_gives_jax_s_rules_and_errors(tmp_path, name):
  path = ''
  if _POLICIES[name] is not None:
    path = str(tmp_path / 'policy.json')
    with open(path, 'w') as f:
      json.dump(_POLICIES[name], f)
  got, want = _load(ctl, path), _load(jax_ctl, path)
  assert got == want
  if name in ('none', 'good'):
    assert isinstance(got, list) and got
  else:
    assert isinstance(got, tuple)


_BAD_ACTUATORS = {
    'kind': dict(name='a', kind='bool'),
    'enum_without_values': dict(name='a', kind='enum'),
    'numeric_without_bounds': dict(name='a', kind='int', minimum=1),
    'inverted_bounds': dict(name='a', kind='float', minimum=2.0,
                            maximum=1.0),
}


@pytest.mark.parametrize('name', sorted(_BAD_ACTUATORS))
def test_bad_actuators_raise_jax_s_errors(name):
  messages = []
  for module in (ctl, jax_ctl):
    with pytest.raises(ValueError) as e:
      module.Actuator(get_fn=None, set_fn=None, **_BAD_ACTUATORS[name])
    messages.append(str(e.value))
  assert messages[0] == messages[1]


_SPINUP = {
    'enum_without_to': dict(objective='overload', actuator='admission'),
    'enum_bad_to': dict(objective='overload', actuator='admission',
                        to='shedd'),
    'enum_bad_revert_to': dict(objective='overload', actuator='admission',
                               to='shed', revert_to='blok'),
}


@pytest.mark.parametrize('name', sorted(_SPINUP))
def test_an_enum_rule_that_cannot_fire_fails_at_spin_up(tmp_path, name):
  messages = []
  for module, _ in _PACKAGES.values():
    knob = _Knob('block')
    with pytest.raises(ValueError) as e:
      module.Controller(
          _StubEngine({'overload': _obj()}), [module.Rule(**_SPINUP[name])],
          [module.Actuator('admission', kind='enum', get_fn=knob.get,
                           set_fn=knob.set, values=('block', 'shed',
                                                    'grow'))],
          str(tmp_path), mode='act')
    messages.append(str(e.value))
  assert messages[0] == messages[1]
  with pytest.raises(ValueError, match='off means'):
    ctl.Controller(_StubEngine({}), [], [], str(tmp_path), mode='off')


# --------------------------------------------------------------------
# Scripted traces through both controllers.
# --------------------------------------------------------------------

# A scenario: {'actuators': [spec], 'rules': [Rule kwargs], 'script':
# [(now, {objective: entry})], 'kw': Controller kwargs}. An actuator spec
# is Actuator kwargs plus 'init' (the knob's value) and 'broken'.


def _int_knob(name, init, lo, hi, broken=False):
  return dict(name=name, kind='int', init=init, minimum=lo, maximum=hi,
              broken=broken)


def _enum_knob(name, init):
  return dict(name=name, kind='enum', init=init,
              values=('block', 'shed', 'grow'))


_B = 'burning'


def _escalate_bound_hysteresis_revert():
  lag = lambda state, margin: {'lag': _obj(state, margin, value=2.0)}
  return dict(
      actuators=[_int_knob('replay_k', 1, 1, 3)],
      rules=[dict(objective='lag', actuator='replay_k', step=1,
                  cooldown_secs=10.0, clear_margin=0.5)],
      script=[(0.0, lag(_B, -1.0)),    # escalate 1 -> 2
              (5.0, lag(_B, -1.0)),    # hold: cool-down
              (10.0, lag(_B, -1.0)),   # escalate 2 -> 3
              (20.0, lag(_B, -1.0)),   # at the bound: hold
              (30.0, lag('ok', 0.2)),  # recovered but thin: hysteresis
              (40.0, lag('ok', 1.0)),  # revert 3 -> 2
              (45.0, lag('ok', 1.0)),  # hold: cool-down
              (50.0, lag('ok', 1.0)),  # revert 2 -> 1, disengage
              (60.0, lag('ok', 1.0))])  # nothing left to do


def _enum_to_and_from():
  over = lambda state, margin: {'overload': _obj(state, margin)}
  return dict(
      actuators=[_enum_knob('admission', 'block')],
      rules=[dict(objective='overload', actuator='admission', to='shed',
                  revert_to='block', cooldown_secs=5.0,
                  clear_margin=100.0)],
      script=[(0.0, over(_B, -3.0)), (6.0, over(_B, -3.0)),
              (12.0, over('ok', 50.0)), (18.0, over('ok', 200.0)),
              (24.0, over('ok', 200.0))])


def _enum_reverts_to_its_baseline():
  over = lambda state, margin: {'overload': _obj(state, margin)}
  return dict(
      actuators=[_enum_knob('admission', 'grow')],
      rules=[dict(objective='overload', actuator='admission', to='shed',
                  cooldown_secs=1.0)],
      script=[(0.0, over(_B, -1.0)), (2.0, over('ok', 1.0)),
              (4.0, over('ok', 1.0))])


def _margin_trigger():
  quorum = lambda margin: {'quorum': _obj('ok', margin, value=0.5)}
  return dict(
      actuators=[_int_knob('fleet_size', 4, 1, 8)],
      rules=[dict(objective='quorum', actuator='fleet_size', step=1,
                  trigger_margin=0.25, clear_margin=0.5, cooldown_secs=1.0)],
      script=[(0.0, quorum(0.6)),    # healthy: nothing
              (2.0, quorum(0.2)),    # thin, not burning: escalate 4 -> 5
              (4.0, quorum(0.3)),    # in the band: hold
              (6.0, quorum(0.1)),    # thin again: 5 -> 6
              (8.0, quorum(0.6)),    # clear: revert 6 -> 5
              (10.0, quorum(0.6))])  # revert 5 -> 4


def _no_data_holds():
  lag = lambda state, margin=None: {'lag': _obj(state, margin)}
  return dict(
      actuators=[_int_knob('replay_k', 1, 1, 4)],
      rules=[dict(objective='lag', actuator='replay_k', step=1,
                  cooldown_secs=0.0, clear_margin=0.0)],
      script=[(0.0, lag(_B, -1.0)),           # escalate
              (1.0, lag('no_data')),          # blind: hold
              (2.0, lag('no_baseline')),      # blind: hold
              (3.0, {}),                      # absent: hold
              (4.0, lag('ok', 0.5))])         # revert


def _shared_actuator():
  both = lambda q, p: {'quorum': _obj(*q), 'parked': _obj(*p)}
  return dict(
      actuators=[_int_knob('fleet_size', 4, 1, 8)],
      rules=[dict(objective='quorum', actuator='fleet_size', direction='up',
                  step=1, cooldown_secs=1.0, clear_margin=0.5),
             dict(objective='parked', actuator='fleet_size',
                  direction='down', step=1, cooldown_secs=1.0,
                  clear_margin=0.5)],
      script=([(t, both((_B, -1.0), (_B, -1.0))) for t in (0., 2., 4.)] +
              [(t, both(('ok', 0.9), (_B, -1.0))) for t in (6., 8., 10.)] +
              [(12.0, both(('ok', 0.9), ('ok', 0.9)))]))


def _failing_set():
  lag = {'lag': _obj(_B, -1.0)}
  return dict(
      actuators=[_int_knob('replay_k', 1, 1, 4, broken=True)],
      rules=[dict(objective='lag', actuator='replay_k', step=1,
                  cooldown_secs=0.0, clear_margin=0.0)],
      script=[(0.0, lag), (1.0, lag)])


def _float_bound():
  p = {'p': _obj(_B, -1.0)}
  return dict(
      actuators=[dict(name='publish_secs', kind='float', init=28.0,
                      minimum=2.0, maximum=30.0)],
      rules=[dict(objective='p', actuator='publish_secs', step=5.0,
                  cooldown_secs=0.0, clear_margin=0.0)],
      script=[(0.0, p), (1.0, p)])


def _log_bound():
  lag = lambda state, margin: {'lag': _obj(state, margin)}
  return dict(
      actuators=[_int_knob('replay_k', 1, 1, 2)],
      rules=[dict(objective='lag', actuator='replay_k', step=1,
                  cooldown_secs=0.0, clear_margin=0.0)],
      script=[(float(t), lag(_B, -1.0) if t % 2 == 0 else lag('ok', 1.0))
              for t in range(8)],
      kw=dict(max_log_actions=3))


def _seeded(seed):
  """A seeded random walk over four objectives and four rules on three
  actuators, two of the rules sharing one."""
  rng = np.random.default_rng(seed)
  names = ('lag', 'overload', 'quorum', 'parked')
  script, now = [], 0.0
  for _ in range(60):
    now += float(rng.integers(0, 6))
    snap = {}
    for name in names:
      state = str(rng.choice(['ok', 'ok', _B, 'no_data']))
      margin = (None if state == 'no_data'
                else round(float(rng.uniform(-1.0, 1.0)), 3))
      snap[name] = _obj(state, margin)
    script.append((now, snap))
  return dict(
      actuators=[_int_knob('replay_k', 1, 1, 4),
                 _enum_knob('admission', 'block'),
                 _int_knob('fleet_size', 6, 1, 8)],
      rules=[dict(objective='lag', actuator='replay_k', step=1,
                  cooldown_secs=5.0, clear_margin=0.3),
             dict(objective='overload', actuator='admission', to='shed',
                  revert_to='block', cooldown_secs=3.0, clear_margin=0.2),
             dict(objective='quorum', actuator='fleet_size', step=1,
                  trigger_margin=0.2, clear_margin=0.4, cooldown_secs=4.0),
             dict(objective='parked', actuator='fleet_size',
                  direction='down', step=1, cooldown_secs=4.0,
                  clear_margin=0.1)],
      script=script)


_TRACES = {
    'escalate_bound_hysteresis_revert': _escalate_bound_hysteresis_revert,
    'enum_to_and_from': _enum_to_and_from,
    'enum_reverts_to_its_baseline': _enum_reverts_to_its_baseline,
    'margin_trigger': _margin_trigger,
    'no_data_holds': _no_data_holds,
    'shared_actuator': _shared_actuator,
    'failing_set': _failing_set,
    'float_bound': _float_bound,
    'log_bound': _log_bound,
    'seeded_0': lambda: _seeded(0),
    'seeded_1': lambda: _seeded(1),
    'seeded_2': lambda: _seeded(2),
}


def _run_trace(module, scenario, mode, logdir):
  knobs, actuators = {}, []
  for spec in scenario['actuators']:
    spec = dict(spec)
    knob = knobs[spec['name']] = _Knob(spec.pop('init'),
                                       spec.pop('broken', False))
    actuators.append(module.Actuator(get_fn=knob.get, set_fn=knob.set,
                                     **spec))
  rules = [module.Rule(**r) for r in scenario['rules']]
  names = {r.objective for r in rules}
  engine = _StubEngine({n: _obj() for n in names})
  recorder = _Recorder()
  c = module.Controller(engine, rules, actuators, str(logdir), mode=mode,
                        interval_secs=60.0, incidents=recorder,
                        health=recorder, **scenario.get('kw', {}))
  ticks = []
  for now, snap in scenario['script']:
    engine.snapshot = snap
    ticks.append(c.tick(now=now))
  engaged = c.engaged_rules()
  counts = c.finalize()
  c.stop()
  log = module.read_log(str(logdir))
  log.pop('wall_time')
  return dict(ticks=ticks, engaged=engaged, counts=counts, log=log,
              actions=c.actions(), emitted=recorder.rows,
              sets={n: k.sets for n, k in knobs.items()},
              values={n: k.value for n, k in knobs.items()})


@pytest.mark.parametrize('mode', ['observe', 'act'])
@pytest.mark.parametrize('name', sorted(_TRACES))
def test_scripted_traces_match_jax_s_controller(tmp_path, name, mode):
  scenario = _TRACES[name]()
  (tmp_path / 'jax').mkdir()
  (tmp_path / 'port').mkdir()
  want = _run_trace(jax_ctl, scenario, mode, tmp_path / 'jax')
  got = _run_trace(ctl, scenario, mode, tmp_path / 'port')
  assert got == want
  # Twice through the port: the trace repeats exactly.
  (tmp_path / 'again').mkdir()
  assert _run_trace(ctl, scenario, mode, tmp_path / 'again') == got
  rows = [a for tick in got['ticks'] for a in tick]
  assert all(a['applied'] == (mode == 'act' and 'error' not in a)
             for a in rows)
  if mode == 'observe':
    assert not any(got['sets'].values())
    assert got['counts']['applied'] == 0
    assert not [r for r in got['emitted'] if r[0] == 'external']


def test_the_scenarios_cover_what_they_name(tmp_path):
  """The traces above move the knobs the way their names say (the
  parity test alone would pass two controllers that both did nothing)."""
  def act(name):
    path = tmp_path / name
    path.mkdir()
    return _run_trace(ctl, _TRACES[name](), 'act', path)

  kinds = lambda run: [(a['kind'], a['from'], a['to'])
                       for tick in run['ticks'] for a in tick]
  assert kinds(act('escalate_bound_hysteresis_revert')) == [
      ('escalate', 1, 2), ('escalate', 2, 3), ('revert', 3, 2),
      ('revert', 2, 1)]
  assert kinds(act('enum_to_and_from')) == [('escalate', 'block', 'shed'),
                                           ('revert', 'shed', 'block')]
  assert kinds(act('enum_reverts_to_its_baseline')) == [
      ('escalate', 'grow', 'shed'), ('revert', 'shed', 'grow')]
  margin = act('margin_trigger')
  assert kinds(margin) == [('escalate', 4, 5), ('escalate', 5, 6),
                           ('revert', 6, 5), ('revert', 5, 4)]
  assert margin['ticks'][1][0]['state'] == 'ok'  # before any burn
  assert kinds(act('no_data_holds')) == [('escalate', 1, 2),
                                        ('revert', 2, 1)]
  shared = act('shared_actuator')
  assert shared['sets']['fleet_size'] == [5, 6, 7, 6, 5, 4, 3, 4]
  failing = act('failing_set')
  assert failing['counts']['apply_errors'] == 2
  assert 'knob fell off' in failing['ticks'][0][0]['error']
  assert act('float_bound')['sets']['publish_secs'] == [30.0]
  bounded = act('log_bound')
  assert len(bounded['log']['actions']) == 3
  assert bounded['log']['dropped_actions'] == 5
  incidents = [r for r in shared['emitted'] if r[0] == 'event']
  assert {r[1] for r in incidents} == {'controller_action'}
  assert [r[1] for r in shared['emitted'] if r[0] == 'external'] == [
      'controller_fleet_size'] * 8


def test_the_thread_ticks_and_unregisters_its_gauge(tmp_path):
  engine = _StubEngine({'lag': _obj(_B, -1.0)})
  knob = _Knob(1)
  c = ctl.Controller(
      engine, [ctl.Rule(objective='lag', actuator='replay_k',
                        cooldown_secs=0.0)],
      [ctl.Actuator('replay_k', kind='int', get_fn=knob.get,
                    set_fn=knob.set, minimum=1, maximum=2)],
      str(tmp_path), mode='act', interval_secs=0.05)
  gauge = telemetry.registry().get('controller/engaged')
  c.start()
  deadline = threading.Event()
  for _ in range(100):
    if knob.value == 2:
      break
    deadline.wait(0.02)
  c.stop()
  assert knob.sets == [2]
  assert gauge is not None
  assert telemetry.registry().get('controller/engaged') is None
  assert not [t for t in threading.enumerate() if t.name == 'controller']


# --------------------------------------------------------------------
# validate_controller.
# --------------------------------------------------------------------

_GRID = dict(
    controller=['off', 'observe', 'act', 'auto'],
    controller_policy=['', 'policy.json'],
    controller_interval_secs=[-1.0, 0.0, 2.0],
    controller_replay_k_max=[0, 1, 4],
    controller_publish_secs_max=[0.0, 30.0],
    fleet_probation_secs=[-1.0, 30.0, 90.0],
    pod_max_hosts=[-1, 0, 2],
    remote_actor_port=[0, 5555],
    remote_heartbeat_secs=[0.0, 5.0],
    remote_conn_idle_timeout_secs=[0.0, 60.0],
    slo_engine=[True, False],
    surrogate=['vtrace', 'impact'],
)


def _validated(validate, config):
  try:
    return validate(config)
  except ValueError as e:
    return ('ValueError', str(e))


def test_validate_controller_matches_jax_s_on_a_seeded_grid():
  rng = np.random.default_rng(15)
  outcomes = set()
  for _ in range(300):
    kw = {k: v[int(rng.integers(len(v)))] for k, v in _GRID.items()}
    got = _validated(validate_controller, Config(**kw))
    want = _validated(jax_validate_controller, JaxConfig(**kw))
    assert got == want, kw
    outcomes.add(got[0] if isinstance(got, tuple) else len(got))
  # Errors, clean configs and configs with one and more warnings.
  assert {'ValueError', 0, 1, 2} <= outcomes
  assert validate_controller(Config()) == []


def test_the_controller_fields_reach_the_cli():
  from scalable_agent_tpu_torch import experiment
  args = vars(experiment._parser().parse_args(
      ['--controller=act', '--controller_policy=p.json',
       '--controller_interval_secs=0.5', '--controller_replay_k_max=2',
       '--controller_publish_secs_max=12', '--pod_max_hosts=3',
       '--compile_cache_dir=']))
  args.pop('device')
  config = Config(**args)
  assert (config.controller, config.controller_policy,
          config.controller_interval_secs, config.controller_replay_k_max,
          config.controller_publish_secs_max, config.pod_max_hosts,
          config.compile_cache_dir) == ('act', 'p.json', 0.5, 2, 12.0, 3, '')


# --------------------------------------------------------------------
# The SLO engine's read API.
# --------------------------------------------------------------------


class _ScriptedRegistry:
  def __init__(self):
    self.next = {}

  def snapshot(self):
    return dict(self.next)


def _registry_script(seed, n=40):
  """Snapshots of four metrics the default objectives judge: a value
  gauge (under its 0.05 floor for the first third, so it burns, then
  around it), a histogram, a counter that moves now and then, and a
  gauge that is sometimes absent or NaN."""
  rng = np.random.default_rng(seed)
  rollbacks, out = 0, []
  for i in range(n):
    rollbacks += int(rng.random() < 0.1)
    p99 = round(float(rng.uniform(0.0, 60000.0)), 3)
    snap = {
        'driver/learner_plane_utilization':
            round(float(rng.uniform(0.0, 0.04 if i < n // 3 else 0.1)), 4),
        'trace/e2e_ms': {'count': i + 1, 'sum': p99, 'max': p99,
                         'p50': p99 / 2, 'p99': p99},
        'health/rollbacks': rollbacks,
    }
    r = rng.random()
    if r < 0.7:
      snap['driver/fleet_healthy_fraction'] = round(float(rng.random()), 3)
    elif r < 0.85:
      snap['driver/fleet_healthy_fraction'] = float('nan')
    out.append((2.0 * i, snap))
  return out


@pytest.mark.parametrize('seed', [0, 1])
def test_control_snapshot_matches_jax_s_engine(tmp_path, seed):
  engines = {}
  for name, (_, slo_module) in _PACKAGES.items():
    registry = _ScriptedRegistry()
    engines[name] = (registry, slo_module.SloEngine(
        slo_module.load_objectives(fast_window_secs=6.0,
                                   slow_window_secs=20.0),
        str(tmp_path), registry=registry, capture=False))
  burned = set()
  try:
    for now, snap in _registry_script(seed):
      views = {}
      for name, (registry, engine) in engines.items():
        registry.next = snap
        newly = engine.observe(now=now)
        views[name] = (newly, engine.burning(), engine.control_snapshot(),
                       engine._evaluator.states())
      assert views['port'] == views['jax']
      assert views['port'][2] == views['port'][3]
      burned |= set(views['port'][1])
  finally:
    for _, engine in engines.values():
      engine.stop()
  assert {'learner_plane_utilization', 'rollbacks_zero'} <= burned


# --------------------------------------------------------------------
# Fault C5: evaluate validates every knob group, as JAX's does.
# --------------------------------------------------------------------


@pytest.mark.parametrize('knob', [
    dict(remote_heartbeat_secs=-1.0), dict(slo_fast_window_secs=0.0),
    dict(controller_interval_secs=-1.0)])
def test_evaluate_refuses_what_jax_s_evaluate_refuses(tmp_path, knob):
  from scalable_agent_tpu import driver as jax_driver
  base = dict(env_backend='bandit', height=24, width=32, torso='shallow',
              logdir=str(tmp_path))
  with pytest.raises(ValueError) as want:
    jax_driver.evaluate(JaxConfig(**base, **knob))
  with pytest.raises(ValueError) as got:
    driver.evaluate(Config(**base, **knob), device='cpu')
  assert str(got.value) == str(want.value)


# --------------------------------------------------------------------
# Fault C6: train and evaluate validate the declared topology first, as
# JAX's do.
# --------------------------------------------------------------------


_C6_KNOBS = [dict(num_processes=0), dict(tp_compute='bogus'),
             dict(coordinator_address='nohostport'),
             dict(sharding_rules='bogus')]


@pytest.mark.parametrize('entry', ['train', 'evaluate'])
@pytest.mark.parametrize('knob', _C6_KNOBS,
                         ids=[next(iter(k)) for k in _C6_KNOBS])
def test_train_and_evaluate_refuse_the_topology_jax_s_refuse(
    tmp_path, entry, knob):
  # ROADMAP C6's probe: a small bandit fleet plus one bad knob.
  from scalable_agent_tpu import driver as jax_driver
  base = dict(env_backend='bandit', height=24, width=32, torso='shallow',
              num_actors=2, batch_size=2, unroll_length=5,
              use_py_process=False, logdir=str(tmp_path))
  kwargs = {'max_steps': 0} if entry == 'train' else {}
  with pytest.raises(ValueError) as want:
    getattr(jax_driver, entry)(JaxConfig(**base, **knob), **kwargs)
  with pytest.raises(ValueError) as got:
    getattr(driver, entry)(Config(**base, **knob), device='cpu', **kwargs)
  assert str(got.value) == str(want.value)
  assert not list(tmp_path.iterdir())  # refused before writing anything


# --------------------------------------------------------------------
# The driver end to end.
# --------------------------------------------------------------------


def test_an_acting_controller_raises_replay_k_and_rides_the_manifest(
    tmp_path):
  # An objective that always burns: 3 fast-window samples come from the
  # summary block's observe each step (summary_secs=0) and the engine's
  # own thread.
  spec = [dict(name='always_burning', metric='driver/update_steps',
               comparison='<=', target=-1.0, severity='info',
               fast_window_secs=1.5, slow_window_secs=4.0)]
  policy = [dict(objective='always_burning', actuator='replay_k',
                 direction='up', step=1, cooldown_secs=0.2,
                 clear_margin=0.0)]
  (tmp_path / 'spec.json').write_text(json.dumps(spec))
  (tmp_path / 'policy.json').write_text(json.dumps(policy))
  cfg = Config(
      logdir=str(tmp_path), env_backend='bandit', num_actors=2,
      batch_size=2, unroll_length=5, num_action_repeats=1,
      episode_length=4, height=24, width=32, torso='shallow',
      use_py_process=False, use_instruction=False,
      total_environment_frames=10**9, inference_timeout_ms=5,
      checkpoint_secs=0, summary_secs=0, seed=5,
      controller='act', controller_policy=str(tmp_path / 'policy.json'),
      controller_interval_secs=0.1, controller_replay_k_max=2,
      slo_spec=str(tmp_path / 'spec.json'), slo_capture=False)
  drain = threading.Event()
  # The drain once the knob reached its cap (a timer bounds the run).
  timer = threading.Timer(30.0, drain.set)
  timer.start()

  def on_step(run, step, metrics):
    if run.prefetcher.replay_k == 2:
      drain.set()

  try:
    run = driver.train(cfg, stall_timeout_secs=30, drain_event=drain,
                       on_step=on_step, device='cpu')
  finally:
    timer.cancel()
  assert run.prefetcher.replay_k == 2
  assert run.controller is not None
  assert run.controller.counts()['applied'] >= 1
  log = ctl.read_log(str(tmp_path))
  assert log['mode'] == 'act'
  assert any(a['actuator'] == 'replay_k' and a['applied']
             for a in log['actions'])
  manifest = driver.read_resume_manifest(str(tmp_path))
  assert manifest['health']['external_incidents'].get(
      'controller_replay_k', 0) >= 1
  assert manifest['controller']['applied'] >= 1
  assert manifest['controller']['mode'] == 'act'
  with open(tmp_path / 'incidents.jsonl') as f:
    kinds = {json.loads(line)['kind'] for line in f if line.strip()}
  assert 'controller_action' in kinds
  with open(tmp_path / 'summaries.jsonl') as f:
    tags = {json.loads(line)['tag'] for line in f if line.strip()}
  assert {'controller_actions', 'controller_reverts', 'controller_engaged',
          'controller_replay_k', 'controller_publish_secs'} <= tags
  assert not [t for t in threading.enumerate() if t.name == 'controller']


def test_controller_off_runs_no_thread_and_writes_no_log(tmp_path):
  run = driver.train(
      Config(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
             batch_size=2, unroll_length=5, num_action_repeats=1,
             episode_length=4, height=24, width=32, torso='shallow',
             use_py_process=False, use_instruction=False,
             total_environment_frames=10**6, inference_timeout_ms=5,
             checkpoint_secs=0, summary_secs=0, seed=3, controller='off'),
      max_steps=2, device='cpu', stall_timeout_secs=60)
  assert run.controller is None
  assert ctl.read_log(str(tmp_path)) is None


def test_acting_pod_size_and_publish_secs_moves_on_a_learner_with_ingest(
    tmp_path):
  """The two actuators that need an ingest: `publish_secs` stretches the
  loop's publish cadence cell, and `pod_size` (rank 0, pod_max_hosts > 0)
  writes POD_TARGET.json atomically from the ingest's membership."""
  import socket
  spec = [dict(name='always_burning', metric='driver/update_steps',
               comparison='<=', target=-1.0, severity='info',
               fast_window_secs=1.5, slow_window_secs=4.0)]
  policy = [dict(objective='always_burning', actuator='pod_size',
                 direction='up', step=1, cooldown_secs=0.2),
            dict(objective='always_burning', actuator='publish_secs',
                 direction='up', step=2.0, cooldown_secs=0.2)]
  (tmp_path / 'spec.json').write_text(json.dumps(spec))
  (tmp_path / 'policy.json').write_text(json.dumps(policy))
  with socket.create_server(('127.0.0.1', 0)) as s:
    port = s.getsockname()[1]
  cfg = Config(
      logdir=str(tmp_path), env_backend='bandit', num_actors=2,
      batch_size=2, unroll_length=5, num_action_repeats=1,
      episode_length=4, height=24, width=32, torso='shallow',
      use_py_process=False, use_instruction=False,
      total_environment_frames=10**9, inference_timeout_ms=5,
      checkpoint_secs=0, summary_secs=0, seed=5, remote_actor_port=port,
      remote_actor_bind_host='127.0.0.1', remote_publish_secs=1.0,
      controller='act', controller_policy=str(tmp_path / 'policy.json'),
      controller_interval_secs=0.1, controller_publish_secs_max=3.0,
      pod_max_hosts=3, slo_spec=str(tmp_path / 'spec.json'),
      slo_capture=False)
  drain = threading.Event()
  timer = threading.Timer(30.0, drain.set)
  timer.start()

  def on_step(run, step, metrics):
    # pod_size 1 -> 2 -> 3 and publish_secs 1.0 -> 3.0: three moves.
    if run.controller is not None and run.controller.counts()['applied'] >= 3:
      drain.set()

  try:
    run = driver.train(cfg, stall_timeout_secs=30, drain_event=drain,
                       on_step=on_step, device='cpu')
  finally:
    timer.cancel()
  with open(tmp_path / 'POD_TARGET.json') as f:
    target = json.load(f)
  assert target['target_hosts'] == 3  # 1 (no live host) -> 2 -> 3, the cap
  assert target['live_hosts'] == 0 and target['membership'] == []
  moves = [(a['actuator'], a['from'], a['to'])
           for a in ctl.read_log(str(tmp_path))['actions'] if a['applied']]
  assert moves.count(('pod_size', 1, 2)) == 1
  assert ('pod_size', 2, 3) in moves
  assert ('publish_secs', 1.0, 3.0) in moves
  with open(tmp_path / 'summaries.jsonl') as f:
    cadence = [e['value'] for e in map(json.loads, f)
               if e['tag'] == 'controller_publish_secs']
  assert cadence[0] == 1.0 and cadence[-1] == 3.0
  assert run.health.external_incidents['controller_pod_size'] == 2
