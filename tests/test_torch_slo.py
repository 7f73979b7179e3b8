"""The port's SLO engine (scalable_agent_tpu_torch/slo.py) against the JAX
package's slo.py, and its wiring through the port's driver.

The parity tests feed the same snapshot sequences (made from fixed
numbers and numpy seeds) through JAX's and the port's `SloEvaluator` and
`SloEngine` and hold every step's newly-burning list, every objective's
judged state and the verdict equal (wall clocks aside). The defaults,
`load_objectives` on the same spec files, the baseline files and
`validate_slo` are held equal the same way. The driver tests run the
port's fleet on the CPU: a clean run's verdict has JAX's keys and judges
every default objective, a NaN burst burns `rollbacks_zero`, the
operator's `profile_dir` window writes a Chrome trace, and a page burn's
capture requested under a caller's torch.profiler takes the failure path
and leaves the caller's events whole.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from scalable_agent_tpu import slo as jax_slo
from scalable_agent_tpu import telemetry as jax_telemetry
from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.config import validate_slo as jax_validate_slo
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import slo
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config, validate_slo
from scalable_agent_tpu_torch.runtime import faults

torch.set_num_threads(1)

def _objective(module, **kw):
  base = dict(name='o', metric='t/m', comparison='<=', target=1.0,
              fast_window_secs=10.0, slow_window_secs=40.0)
  base.update(kw)
  return module.Objective(**base)


def _hist_snapshot(module, values):
  h = module.Histogram('t/h')
  for v in values:
    h.observe(v)
  return h.snapshot_value()


def _rng_values(seed, n, lo, hi):
  return np.random.RandomState(seed).uniform(lo, hi, n).round(3).tolist()


# Each scenario: (objective kwargs list, evaluator kwargs, samples), the
# samples a list of (dt, {metric: value or ('hist', values)}).
_SCENARIOS = {
    'value_multiwindow': (
        [dict()], dict(min_samples=3),
        [(0, {'t/m': 5.0}), (2, {'t/m': 5.0}), (4, {'t/m': 5.0}),
         (6, {'t/m': 0.5})] +
        [(20 + i, {'t/m': 9.0}) for i in range(3)]),
    'value_blip': (
        [dict()], dict(min_samples=3),
        [(i, {'t/m': v}) for i, v in enumerate([0.2, 0.3, 9.0, 0.2, 0.1])]),
    'slow_window_confirms': (
        [dict(fast_window_secs=3.0, slow_window_secs=30.0)],
        dict(min_samples=2),
        [(i, {'t/m': 0.1}) for i in range(8)] +
        [(i, {'t/m': 5.0}) for i in range(8, 22)]),
    'rate_counter': (
        [dict(name='crc', metric='ingest/wire_crc_rejected', kind='rate',
              comparison='==', target=0.0)], {},
        [(0, {'ingest/wire_crc_rejected': 0}),
         (1, {'ingest/wire_crc_rejected': 0}),
         (2, {'ingest/wire_crc_rejected': 2}),
         (30, {'ingest/wire_crc_rejected': 2}),
         (31, {'ingest/wire_crc_rejected': 2})]),
    'rate_per_second_floor': (
        [dict(name='fps', metric='driver/env_frames', kind='rate',
              comparison='>=', target=100.0)], {},
        [(0, {'driver/env_frames': 0}), (5, {'driver/env_frames': 2000}),
         (12, {'driver/env_frames': 2000}), (18, {'driver/env_frames': 2005})]
        + [(i, {'driver/env_frames': 2005 + i}) for i in (24, 30, 36, 42, 48)]),
    'missing_and_nan': (
        [dict(name='absent', metric='t/never'),
         dict(name='nan', metric='t/h', field='p99')], {},
        [(0, {'t/h': ('hist', [])}), (1, {'t/h': ('hist', [])})]),
    'histogram_field': (
        [dict(metric='t/h', field='p99', comparison='<=', target=4.0)],
        dict(min_samples=2),
        [(i, {'t/h': ('hist', [1, 1, 9, 9, 9, 9])}) for i in range(3)]),
    'baseline_relative': (
        [dict(name='fps_floor', metric='driver/env_frames', kind='rate',
              comparison='>=', target=0.5, baseline='fps')],
        dict(baseline={'fps': 100.0}),
        [(0, {'driver/env_frames': 0}), (1, {'driver/env_frames': 10})]),
    'no_baseline': (
        [dict(name='fps_floor', metric='driver/env_frames', kind='rate',
              comparison='>=', target=0.5, baseline='fps')], {},
        [(0, {'driver/env_frames': 0}), (1, {'driver/env_frames': 10})]),
    'info_never_fails': (
        [dict(name='advisory', severity='info')], dict(min_samples=2),
        [(i, {'t/m': 9.0}) for i in range(4)]),
    # A drawn gauge against two objectives over the same metric, and a
    # drawn counter, through the default windows.
    'drawn_mixed': (
        [dict(name='low', metric='t/x', comparison='<=', target=0.5,
              fast_window_secs=3.0, slow_window_secs=9.0),
         dict(name='high', metric='t/x', comparison='>=', target=0.5,
              fast_window_secs=3.0, slow_window_secs=9.0, severity='page'),
         dict(name='moves', metric='t/c', kind='rate', comparison='<=',
              target=2.0, fast_window_secs=4.0, slow_window_secs=12.0)],
        dict(min_samples=2),
        [(i, {'t/x': x, 't/c': float(c)}) for i, (x, c) in enumerate(zip(
            _rng_values(1, 40, 0.0, 1.0),
            np.cumsum(np.random.RandomState(2).randint(0, 6, 40))))]),
}


def _run_scenario(module, tele, name):
  objectives, kw, samples = _SCENARIOS[name]
  ev = module.SloEvaluator([_objective(module, **o) for o in objectives],
                           **kw)
  t0 = 1000.0
  trace = []
  for dt, metrics in samples:
    snap = {k: (_hist_snapshot(tele, v[1]) if isinstance(v, tuple) else v)
            for k, v in metrics.items()}
    trace.append((ev.observe(snap, now=t0 + dt), ev.burning(),
                  ev.verdict()['objectives']))
  verdict = ev.verdict()
  verdict.pop('wall_time')
  return trace, verdict


@pytest.mark.parametrize('name', sorted(_SCENARIOS))
def test_the_evaluator_judges_every_sequence_as_jax_does(name):
  ref_trace, ref_verdict = _run_scenario(jax_slo, jax_telemetry, name)
  trace, verdict = _run_scenario(slo, telemetry, name)
  assert len(trace) == len(ref_trace)
  for i, (got, ref) in enumerate(zip(trace, ref_trace)):
    assert got == ref, f'{name}: sample {i}'
  assert verdict == ref_verdict
  expected = {
      'value_multiwindow': (False, ['o']), 'value_blip': (True, []),
      'rate_counter': (False, ['crc']), 'no_baseline': (True, []),
      'baseline_relative': (False, ['fps_floor']),
      'info_never_fails': (True, []), 'missing_and_nan': (True, []),
  }.get(name)
  if expected is not None:
    assert (verdict['pass'], verdict['violations']) == expected


def test_the_default_objectives_are_jax_s():
  port = [dataclasses.asdict(o) for o in slo.DEFAULT_OBJECTIVES]
  ref = [dataclasses.asdict(o) for o in jax_slo.DEFAULT_OBJECTIVES]
  assert [(o['name'], o['metric'], o['target'], o['severity'])
          for o in port] == [(o['name'], o['metric'], o['target'],
                              o['severity']) for o in ref]
  assert port == ref
  assert slo.SEVERITIES == jax_slo.SEVERITIES
  assert [dataclasses.asdict(o) for o in slo.load_objectives(
      fast_window_secs=7.0, slow_window_secs=70.0)] == [
          dataclasses.asdict(o) for o in jax_slo.load_objectives(
              fast_window_secs=7.0, slow_window_secs=70.0)]


def test_load_objectives_reads_a_spec_file_as_jax_does(tmp_path):
  spec = [dict(name='lag', metric='trace/policy_lag', field='p99',
               comparison='<=', target=3.0, severity='page'),
          dict(name='crc', metric='ingest/wire_crc_rejected',
               kind='rate', comparison='==', target=0.0,
               fast_window_secs=5.0, slow_window_secs=9.0)]
  path = tmp_path / 'spec.json'
  path.write_text(json.dumps(spec))
  port = slo.load_objectives(str(path), fast_window_secs=11.0,
                             slow_window_secs=77.0)
  ref = jax_slo.load_objectives(str(path), fast_window_secs=11.0,
                                slow_window_secs=77.0)
  assert [dataclasses.asdict(o) for o in port] == [
      dataclasses.asdict(o) for o in ref]
  assert (port[0].fast_window_secs, port[1].fast_window_secs) == (11.0, 5.0)


@pytest.mark.parametrize('bad', [
    [dict(name='x', metric='t/m', comparison='<', target=1.0)],
    [dict(name='x', metric='t/m', comparison='<=', target=1.0,
          kind='delta')],
    [dict(name='x', metric='t/m', comparison='<=', target=1.0,
          severity='urgent')],
    [dict(name='x', metric='nometric', comparison='<=', target=1.0)],
    [dict(name='x', metric='t/m', comparison='<=', target=1.0,
          bogus_field=1)],
    [dict(name='x', metric='t/m', comparison='<=', target=1.0)] * 2,
    [],
])
def test_a_bad_spec_raises_in_both_packages(tmp_path, bad):
  path = tmp_path / 'spec.json'
  path.write_text(json.dumps(bad))
  for module in (jax_slo, slo):
    with pytest.raises(ValueError):
      module.load_objectives(str(path))


def test_the_baseline_files_read_and_update_alike(tmp_path):
  port_path, ref_path = str(tmp_path / 'port.json'), str(tmp_path / 'ref.json')
  for module, path in ((slo, port_path), (jax_slo, ref_path)):
    assert module.load_baseline(path) == {}
    assert module.load_baseline('') == {}
    module.update_baseline(path, {'fps': 123.0}, host='h1')
    module.update_baseline(path, {'fps': 456.0}, host='h2')
  for reader in (slo, jax_slo):
    for path in (port_path, ref_path):
      assert reader.load_baseline(path, host='h1')['fps'] == 123.0
      assert reader.load_baseline(path, host='h2')['fps'] == 456.0
      assert reader.load_baseline(path, host='h3') == {}
  strip = lambda t: {h: {k: v for k, v in e.items() if k != 'wall_time'}  # noqa: E731
                     for h, e in t.items()}
  assert strip(json.load(open(port_path))) == strip(json.load(open(ref_path)))
  bad = tmp_path / 'corrupt.json'
  bad.write_text('{not json')
  for module in (slo, jax_slo):
    with pytest.raises(ValueError, match='baseline'):
      module.load_baseline(str(bad))


@pytest.mark.parametrize('fields', [
    dict(), dict(slo_fast_window_secs=0.0), dict(slo_slow_window_secs=-1.0),
    dict(slo_capture_steps=0), dict(slo_interval_secs=-1.0),
    dict(slo_engine=False, slo_spec='x.json'),
    dict(slo_fast_window_secs=400.0),
    dict(slo_interval_secs=20.0), dict(telemetry_trace=False),
    dict(health_watchdog=False),
    dict(anakin_filler=True, slo_engine=False, surrogate='impact'),
])
def test_validate_slo_and_the_filler_warning_are_jax_s(fields):
  from scalable_agent_tpu.config import validate_runtime as jax_runtime
  from scalable_agent_tpu_torch.config import validate_runtime
  try:
    ref = jax_validate_slo(JaxConfig(**fields))
  except ValueError as e:
    with pytest.raises(ValueError, match=str(e).split(',')[0]):
      validate_slo(Config(**fields))
    return
  assert validate_slo(Config(**fields)) == ref
  assert validate_runtime(Config(**fields)) == jax_runtime(JaxConfig(**fields))


# --------------------------------------------------------------------
# The engine.
# --------------------------------------------------------------------


class _FakeWriter:
  def __init__(self):
    self.scalars = []

  def scalar(self, tag, value, step):
    self.scalars.append((tag, value, step))


class _FakeIncidents:
  def __init__(self):
    self.events = []

  def event(self, kind, step=None, **fields):
    self.events.append(dict(kind=kind, step=step, **fields))


def _engine_run(module, tele, tmp_path):
  """The JAX test's page-burn sequence through one package's engine:
  (incidents, scalars, profile requests, verdict, files written)."""
  reg = tele.MetricsRegistry()
  c = reg.counter('t/page')
  flight = tele.FlightRecorder()
  flight.record({'k': 'batch', 'step': 1})
  writer, incidents = _FakeWriter(), _FakeIncidents()

  def fake_slice(logdir, window, out_path, state):
    with open(out_path, 'w') as f:
      json.dump({'sliced': state['name']}, f)
    return True

  objective = _objective(module, name='page_o', metric='t/page',
                         severity='page', kind='rate', comparison='==',
                         target=0.0, fast_window_secs=30.0,
                         slow_window_secs=60.0)
  engine = module.SloEngine([objective], str(tmp_path), registry=reg,
                            writer=writer, incidents=incidents,
                            flight=flight, interval_secs=60.0,
                            trace_slice_fn=fake_slice)
  engine.start()
  try:
    c.inc(3)
    newly = [engine.observe(), engine.observe()]
    engine.flush_captures()
    requests = [engine.take_profile_request(), engine.take_profile_request()]
    engine.note_profile('page_o', 'profile-dir')
  finally:
    engine.stop()
  verdict = engine.finalize(extra={'clean_exit': True})
  on_disk = module.read_verdict(str(tmp_path))
  for v in (verdict, on_disk):
    v.pop('wall_time')
    v['captures']['page_o'].pop('wall_time')
    for o in v['objectives'].values():
      o.pop('last_burn_wall_time')
  rel = lambda p: os.path.relpath(p, str(tmp_path)) if p else p  # noqa: E731
  for v in (verdict, on_disk):
    cap = v['captures']['page_o']
    cap['flight'], cap['trace_slice'] = rel(cap['flight']), rel(
        cap['trace_slice'])
  events = []
  for e in incidents.events:
    e = dict(e)
    for key in ('flight', 'trace_slice'):
      if key in e:
        e[key] = rel(e[key])
    events.append(e)
  files = sorted(os.listdir(tmp_path / 'diagnostics'))
  return newly, events, writer.scalars, requests, verdict, on_disk, files


def test_the_engine_emits_captures_and_finalizes_as_jax_does(tmp_path):
  ref = _engine_run(jax_slo, jax_telemetry, tmp_path / 'jax')
  got = _engine_run(slo, telemetry, tmp_path / 'port')
  assert got == ref
  newly, events, scalars, requests, verdict, on_disk, files = got
  assert newly == [['page_o'], []]
  assert [e['kind'] for e in events] == ['slo_violation', 'slo_capture']
  assert [t for t, _, _ in scalars] == ['slo_violations']
  assert requests == ['page_o', None]
  assert verdict == on_disk and not verdict['pass']
  assert verdict['captures']['page_o']['profile'] == 'profile-dir'
  assert files == ['slo_flight_page_o.json', 'slo_trace_page_o.json']
  flight = json.load(open(tmp_path / 'port' / 'diagnostics' /
                          'slo_flight_page_o.json'))
  assert flight['records'][0]['step'] == 1


def test_the_engine_feeds_health_and_unregisters_its_gauge(tmp_path):
  from scalable_agent_tpu_torch import health as health_lib
  reg = telemetry.MetricsRegistry()
  c = reg.counter('t/page')
  monitor = health_lib.HealthMonitor()
  objective = _objective(slo, name='page_o', metric='t/page',
                         severity='page', kind='rate', comparison='==',
                         target=0.0)
  engine = slo.SloEngine([objective], str(tmp_path), registry=reg,
                         health=monitor, capture=False, interval_secs=60.0)
  assert telemetry.registry().get('slo/burning') is not None
  before = {t.ident for t in threading.enumerate()}
  engine.start()
  try:
    assert any(t.name == 'slo-engine' for t in threading.enumerate()
               if t.ident not in before)
    c.inc()
    assert engine.observe() == ['page_o']
    assert monitor.external_incidents == {'slo_page_o': 1}
    assert telemetry.registry().snapshot()['slo/burning'] == 1
  finally:
    engine.stop()
  assert telemetry.registry().get('slo/burning') is None
  assert not [t for t in threading.enumerate()
              if t.ident not in before and t.name == 'slo-engine']


# --------------------------------------------------------------------
# Through the driver.
# --------------------------------------------------------------------


def _config(tmp_path, **kw):
  """tests/test_torch_fleet.py's small config."""
  base = dict(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
              batch_size=2, unroll_length=5, num_action_repeats=1,
              episode_length=4, height=24, width=32, torso='shallow',
              use_py_process=False, use_instruction=False,
              total_environment_frames=10**6, inference_timeout_ms=5,
              checkpoint_secs=0, summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


def _slo_threads():
  return [t for t in threading.enumerate()
          if t.name == 'slo-engine' and t.is_alive()]


def test_a_clean_fleet_run_writes_jax_s_verdict(tmp_path):
  assert not _slo_threads()
  driver.train(_config(tmp_path), max_steps=4, device='cpu',
               stall_timeout_secs=60)
  verdict = slo.read_verdict(str(tmp_path))
  assert set(verdict) == {'pass', 'violations', 'wall_time', 'objectives',
                          'captures', 'clean_exit', 'update_steps'}
  assert verdict['pass'], verdict['violations']
  assert verdict['captures'] == {} and verdict['clean_exit'] is True
  assert verdict['update_steps'] == 4
  assert set(verdict['objectives']) == {
      o.name for o in jax_slo.DEFAULT_OBJECTIVES}
  keys = set(jax_slo.SloEvaluator(jax_slo.load_objectives()).verdict()[
      'objectives']['rollbacks_zero'])
  for name, e in verdict['objectives'].items():
    assert set(e) == keys, name
    assert (e['state'] in (slo.OK, slo.NO_DATA, slo.NO_BASELINE)
            or e['severity'] == 'info'), (name, e)
  assert not _slo_threads()


def test_the_engine_off_writes_no_verdict(tmp_path):
  driver.train(_config(tmp_path, slo_engine=False), max_steps=2,
               device='cpu', stall_timeout_secs=60)
  assert slo.read_verdict(str(tmp_path)) is None


def test_a_nan_burst_burns_rollbacks_zero(tmp_path):
  cfg = _config(tmp_path, health_rollback_after=2)
  faults.install(faults.FaultPlan.storm(seed=0, nan_burst_at=3,
                                        nan_burst_len=3))
  try:
    run = driver.train(cfg, max_steps=8, device='cpu', stall_timeout_secs=60)
  finally:
    faults.clear()
  assert run.health.stats()['rollbacks'] == 1
  verdict = slo.read_verdict(str(tmp_path))
  assert not verdict['pass']
  assert 'rollbacks_zero' in verdict['violations']
  assert verdict['objectives']['rollbacks_zero']['burns'] == 1
  assert run.health.external_incidents.get('slo_rollbacks_zero') == 1
  with open(tmp_path / 'incidents.jsonl') as f:
    burns = [e for e in map(json.loads, f) if e['kind'] == 'slo_violation']
  assert [e['objective'] for e in burns] == ['rollbacks_zero']
  assert not _slo_threads()


def test_the_anakin_runtime_writes_its_verdict(tmp_path):
  driver.train(_config(tmp_path, runtime='anakin', batch_size=4),
               max_steps=3, device='cpu')
  verdict = slo.read_verdict(str(tmp_path))
  assert verdict['runtime'] == 'anakin' and verdict['update_steps'] == 3
  assert verdict['pass'], verdict['violations']
  assert not _slo_threads()


def test_the_profile_dir_window_writes_a_trace(tmp_path):
  out = tmp_path / 'profile'
  driver.train(_config(tmp_path, profile_dir=str(out), profile_start_step=1,
                       profile_num_steps=2), max_steps=4, device='cpu',
               stall_timeout_secs=60)
  with open(out / 'trace.json') as f:
    trace = json.load(f)
  names = {e.get('name') for e in trace['traceEvents']}
  assert 'aten::addmm' in names or 'aten::linear' in names
  assert not driver.profiler_running()


def _page_spec(tmp_path):
  spec = [dict(name='impossible_floor', metric='driver/update_steps',
               comparison='>=', target=1e9, severity='page',
               fast_window_secs=1.0, slow_window_secs=4.0)]
  path = tmp_path / 'spec.json'
  path.write_text(json.dumps(spec))
  return str(path)


def _until_captured(logdir):
  """on_step: hold the loop until the engine thread queued the capture,
  so the next step's loop takes the request."""
  def on_step(run, steps_done, metrics):
    del run, metrics
    if steps_done == 3:
      diag = os.path.join(logdir, 'diagnostics')
      for _ in range(100):
        if os.path.exists(os.path.join(
            diag, 'slo_flight_impossible_floor.json')):
          break
        threading.Event().wait(0.05)
      threading.Event().wait(0.3)
  return on_step


@pytest.mark.parametrize('outer', [False, True])
def test_a_page_capture_never_collides_with_a_running_profiler(tmp_path,
                                                               outer):
  """A page burn's profiler capture: alone it traces the next
  slo_capture_steps steps into diagnostics/; under a caller's running
  torch.profiler it takes the failure path (profile None) and the
  caller's profile keeps every step's events."""
  cfg = _config(tmp_path, slo_spec=_page_spec(tmp_path),
                slo_interval_secs=0.25, slo_capture_steps=1)
  prof = None
  if outer:
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
  try:
    driver.train(cfg, max_steps=6, device='cpu', stall_timeout_secs=60,
                 on_step=_until_captured(str(tmp_path)))
  finally:
    if prof is not None:
      prof.stop()
  verdict = slo.read_verdict(str(tmp_path))
  assert verdict['violations'] == ['impossible_floor']
  capture = verdict['captures']['impossible_floor']
  assert capture['flight'] and os.path.exists(capture['flight'])
  profile_dir = os.path.join(str(tmp_path), 'diagnostics',
                             'slo_profile_impossible_floor')
  if outer:
    assert capture['profile'] is None
    assert not os.path.exists(os.path.join(profile_dir, 'trace.json'))
    # The caller's session saw the whole run: the learner's optimizer
    # ran in each of the 6 steps.
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get('aten::addmm', 0) >= 6
  else:
    assert capture['profile'] == profile_dir
    assert os.path.exists(os.path.join(profile_dir, 'trace.json'))
  assert not driver.profiler_running()
  assert not _slo_threads()
