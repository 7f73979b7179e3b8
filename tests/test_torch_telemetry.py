"""The port's telemetry plane (scalable_agent_tpu_torch/telemetry.py and
its wiring) against the JAX package's, on the CPU: the transport-free
cases of tests/test_telemetry.py, run through the port, and the same
inputs through both packages.

- The registry and the histogram: the same observation sequence (numpy
  seeds) into both packages' Counter / Gauge / Histogram /
  MetricsRegistry gives equal snapshots: counts exact, sums and
  percentiles to 1e-12.
- The tracer: the same stage / serve / step / publish / install event
  sequence into both PipelineTracers writes equal traces.jsonl records
  once the wall times ('t', 't_seen' and every hop's time) are masked.
- A tiny CPU fleet (2 actors, T=5, the shallow agent) with tracing on
  writes one batch record per learner step, every span stamped done <=
  staged <= serve <= step in HOP_ORDER, and no untagged unroll; the
  port's trace_report summarises the port's file as it is (and as the
  JAX package's scripts/trace_report.py does).
- The halt bundle carries the flight dump; closed components unregister
  their gauges; the drain manifest holds the registry's snapshot.
- Name parity: the literal names the two packages register through
  `telemetry.counter/gauge/histogram` (and the bare calls inside
  telemetry.py and analysis/runtime.py) are equal, the routing, SLO and
  controller modules' names included; every ingest/* name of JAX's
  runtime/remote.py, and the driver's `driver/remote_live_hosts`, is the
  port's too.
"""

import ast
import json
import math
import os
import pathlib
import re
import threading
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu import observability as jax_observability
from scalable_agent_tpu import telemetry as jax_telemetry
from scalable_agent_tpu_torch import checkpoint as checkpoint_lib
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import health as health_lib
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.scripts import trace_report
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)
from scripts import trace_report as jax_trace_report

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BOTH = [pytest.param(jax_telemetry, id='jax'),
        pytest.param(telemetry, id='port')]
TIGHT = 1e-12


@pytest.fixture(autouse=True)
def _no_leftover_tracer_or_plan():
  yield
  telemetry.set_tracer(None)
  faults.clear()


def _tiny_unroll(seed=0, t1=3, num_actions=3):
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.int32(0),
      agent_state=(np.zeros((1, 4), np.float32),
                   np.ones((1, 4), np.float32)),
      env_outputs=StepOutput(
          reward=rng.randn(t1).astype(np.float32),
          info=StepOutputInfo(np.zeros(t1, np.float32),
                              np.zeros(t1, np.int32)),
          done=np.zeros(t1, bool),
          observation=(
              rng.randint(0, 255, (t1, 4, 6, 3)).astype(np.uint8),
              np.zeros((t1, 5), np.int32))),
      agent_outputs=AgentOutput(
          action=rng.randint(0, num_actions, t1).astype(np.int32),
          policy_logits=rng.randn(t1, num_actions).astype(np.float32),
          baseline=rng.randn(t1).astype(np.float32)))


def _read_jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def _close(a, b):
  """Snapshot values equal: ints exact, floats to TIGHT, NaN to NaN."""
  if isinstance(a, dict):
    return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
  if isinstance(a, float) or isinstance(b, float):
    if math.isnan(a) or math.isnan(b):
      return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= TIGHT * max(1.0, abs(b))
  return a == b


# --------------------------------------------------------------------
# The registry: parity with JAX on the same observation sequence.
# --------------------------------------------------------------------


def _drive_registry(module, seed):
  """A seeded sequence of counter increments, gauge sets, lazy gauges
  and histogram observations (a window of 64 over 200 samples, so the
  bounded reservoir drops its oldest), into a fresh registry."""
  rng = np.random.RandomState(seed)
  reg = module.MetricsRegistry()
  c = reg.counter('t/c')
  g = reg.gauge('t/g')
  backing = {'n': 0}
  reg.gauge('t/lazy', fn=lambda: backing['n'])
  reg.gauge('t/boom', fn=lambda: 1 / 0)
  h = reg.histogram('t/h', maxlen=64)
  reg.histogram('t/empty')
  for value in rng.lognormal(size=200):
    c.inc(int(rng.randint(1, 5)))
    g.set(float(rng.randn()))
    backing['n'] += 1
    h.observe(value)
  return reg.snapshot(), h.percentiles(0.1, 0.5, 0.9, 0.99), h.count


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_registry_snapshots_match_jax(seed):
  want, want_q, want_n = _drive_registry(jax_telemetry, seed)
  got, got_q, got_n = _drive_registry(telemetry, seed)
  assert got.keys() == want.keys()
  assert _close(got, want), (got, want)
  assert got['t/h']['count'] == want['t/h']['count'] == 200
  assert got_n == want_n
  np.testing.assert_allclose(got_q, want_q, rtol=TIGHT, atol=0)
  assert math.isnan(got['t/boom']) and math.isnan(got['t/empty']['p50'])


@pytest.mark.parametrize('module', BOTH)
def test_registry_counter_gauge_histogram_snapshot(module):
  reg = module.MetricsRegistry()
  c = reg.counter('t/c')
  c.inc()
  c.inc(4)
  reg.gauge('t/g').set(2.5)
  backing = {'n': 7}
  reg.gauge('t/lazy', fn=lambda: backing['n'])
  h = reg.histogram('t/h')
  for v in (1.0, 2.0, 3.0):
    h.observe(v)
  snap = reg.snapshot()
  assert (snap['t/c'], snap['t/g'], snap['t/lazy']) == (5, 2.5, 7)
  assert snap['t/h']['count'] == 3 and snap['t/h']['p50'] == 2.0
  backing['n'] = 9  # lazy gauges read live values
  assert reg.snapshot()['t/lazy'] == 9


@pytest.mark.parametrize('module', BOTH)
def test_registry_replaces_by_name_and_unregisters_by_identity(module):
  reg = module.MetricsRegistry()
  old = reg.counter('t/c')
  old.inc(10)
  new = reg.counter('t/c')  # a new incarnation
  new.inc(1)
  assert reg.snapshot()['t/c'] == 1
  reg.unregister('t/c', old)  # the old one's close: a no-op
  assert reg.get('t/c') is new
  reg.unregister('t/c', new)
  assert reg.get('t/c') is None and reg.names() == []


def test_latency_reservoir_matches_jax():
  rng = np.random.RandomState(5)
  want = jax_observability.LatencyReservoir(maxlen=32)
  got = observability.LatencyReservoir(maxlen=32)
  assert math.isnan(got.percentile_ms(0.99)[0])
  for seconds in rng.exponential(0.01, size=100):
    want.record(seconds)
    got.record(seconds)
  assert got.count == want.count == 100
  np.testing.assert_allclose(got.percentiles(0.5, 0.99),
                             want.percentiles(0.5, 0.99), rtol=TIGHT)
  assert got.percentile_ms(0.5, 0.99) == want.percentile_ms(0.5, 0.99)


# --------------------------------------------------------------------
# Trace contexts, the sidecar, the flight recorder.
# --------------------------------------------------------------------


@pytest.mark.parametrize('module', BOTH)
def test_make_trace_and_stamp(module):
  tr = module.make_trace('a-0', 3, epoch=7, behavior_version=2)
  module.stamp(tr, module.HOP_DONE, t=1.0)
  module.stamp(tr, module.HOP_SEND, t=2.0)
  assert tr == {'a': 'a-0', 's': 3, 'e': 7, 'bv': 2,
                'h': [['done', 1.0], ['send', 2.0]]}
  assert module.stamp(None, module.HOP_WIRE) is None
  # A malformed context gets a fresh stamp list, never a raise.
  bad = {'a': 'x', 'h': 'garbage'}
  module.stamp(bad, module.HOP_WIRE, t=3.0)
  assert bad['h'] == [['wire', 3.0]]


def test_hop_order_matches_jax_and_trace_report():
  assert telemetry.HOP_ORDER == jax_telemetry.HOP_ORDER
  assert trace_report.HOP_ORDER is telemetry.HOP_ORDER
  assert tuple(jax_trace_report.HOP_ORDER) == telemetry.HOP_ORDER


@pytest.mark.parametrize('module', BOTH)
def test_tag_store_identity_keyed_and_bounded(module):
  store = module._TagStore(capacity=2)
  a, b, c = _tiny_unroll(1), _tiny_unroll(2), _tiny_unroll(3)
  store.tag(a, {'a': 'x'})
  store.tag(b, {'a': 'y'})
  store.tag(c, {'a': 'z'})  # evicts the oldest (a)
  assert store.pop(a) is None and store.evicted == 1
  assert store.pop(b) == {'a': 'y'}
  assert store.pop(b) is None  # popped once


@pytest.mark.parametrize('module', BOTH)
def test_flight_recorder_ring_and_registry_snapshots(module, tmp_path):
  flight = module.FlightRecorder(capacity=8, snapshots=2)
  for i in range(20):
    flight.record({'k': 'batch', 'step': i})
  for a in (1, 2, 3):
    flight.note_registry({'a': a})
  dump = flight.dump()
  assert [r['step'] for r in dump['records']] == list(range(12, 20))
  assert [s['metrics']['a'] for s in dump['registry_snapshots']] == [2, 3]
  with open(flight.write(str(tmp_path / 'flight.json'))) as f:
    assert json.load(f)['records'][-1]['step'] == 19


# --------------------------------------------------------------------
# The tracer: parity with JAX on one event sequence.
# --------------------------------------------------------------------


def _masked(record):
  """A traces.jsonl record with its wall times masked."""
  out = {k: v for k, v in record.items() if k not in ('t', 't_seen')}
  if 'spans' in out:
    out['spans'] = [dict(s, h=[h for h, _ in s['h']])
                    for s in out['spans']]
  return out


def _drive_tracer(module, logdir, seed):
  """A seeded sequence of publishes, local and remote unrolls (the
  remote ones with a commit-time version clock 'cv'), untagged and
  replayed slots, stages, serves, steps and an install."""
  rng = np.random.RandomState(seed)
  tracer = module.PipelineTracer(logdir, epoch=3)
  unrolls = [_tiny_unroll(i) for i in range(12)]
  try:
    seq = 0
    for step in range(1, 5):
      if rng.rand() < 0.7:
        tracer.on_publish(100 + step,
                          remote_version=step if step % 2 else None)
      batch = []
      for _ in range(int(rng.randint(1, 4))):
        u = unrolls[seq]
        seq += 1
        batch.append(u)
        if rng.rand() < 0.15:
          module.pop_unroll(u)  # never tagged
          continue
        tr = module.make_trace(f'a{seq % 3}', seq, epoch=3,
                               behavior_version=int(rng.randint(0, 3)))
        if rng.rand() < 0.4:
          tr['cv'] = int(rng.randint(3, 6))
        module.stamp(tr, module.HOP_DONE)
        tracer.tag(u, tr)
      n_fresh = len(batch)
      batch.append(unrolls[0])  # a replayed slot: never popped
      tracer.on_batch(batch, n_fresh)
      tracer.on_serve()
      tracer.on_step(step)
    tracer.on_install('a1', 3, 1234.5)
    return _read_jsonl(tracer.path), tracer.stats(), tracer.span_percentiles()
  finally:
    tracer.close()


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_tracer_records_match_jax(seed, tmp_path):
  want, want_stats, want_q = _drive_tracer(jax_telemetry,
                                           str(tmp_path / 'jax'), seed)
  got, got_stats, got_q = _drive_tracer(telemetry, str(tmp_path / 'port'),
                                        seed)
  assert [_masked(r) for r in got] == [_masked(r) for r in want]
  for key in ('batches', 'unrolls', 'untagged_unrolls', 'param_installs',
              'dropped_records', 'dropped_writes'):
    assert got_stats[key] == want_stats[key], key
  assert _close(got_q['policy_lag_p50'], want_q['policy_lag_p50'])
  assert _close(got_q['policy_lag_p99'], want_q['policy_lag_p99'])
  for r in got:
    if r['k'] == 'batch':
      for span in r['spans']:
        times = [t for _, t in span['h']]
        assert times == sorted(times)


def test_tracer_completes_spans_and_batch_records(tmp_path):
  tracer = telemetry.PipelineTracer(str(tmp_path))
  try:
    tracer.on_publish(10)  # local publish clock -> 1
    u1, u2 = _tiny_unroll(1), _tiny_unroll(2)
    for i, u in enumerate((u1, u2)):
      tr = telemetry.make_trace('local-0', i, behavior_version=0)
      telemetry.stamp(tr, telemetry.HOP_DONE)
      tracer.tag(u, tr)
    tracer.on_batch([u1, u2], n_fresh=2)
    tracer.on_serve()
    tracer.on_step(5)
    records = _read_jsonl(tracer.path)
  finally:
    tracer.close()
  assert [r['k'] for r in records] == ['publish', 'batch']
  batch = records[-1]
  assert batch['step'] == 5 and batch['n_fresh'] == 2
  assert batch['lag'] == [1, 1]  # publish count 1 - behaviour version 0
  for span in batch['spans']:
    assert [h[0] for h in span['h']] == ['done', 'staged', 'serve', 'step']
  assert tracer.stats()['batches'] == 1 and tracer.stats()['unrolls'] == 2


def test_tracer_remote_clock_uses_commit_version(tmp_path):
  tracer = telemetry.PipelineTracer(str(tmp_path))
  try:
    u = _tiny_unroll(1)
    tr = telemetry.make_trace('r0', 0, behavior_version=4)
    tr['cv'] = 9  # what an ingest worker stamps at commit
    tracer.tag(u, tr)
    tracer.on_batch([u], n_fresh=1)
    tracer.on_serve()
    tracer.on_step(1)
    assert _read_jsonl(tracer.path)[-1]['lag'] == [5]
  finally:
    tracer.close()


def test_prefetcher_completes_spans_through_the_port_feed(tmp_path):
  tracer = telemetry.PipelineTracer(str(tmp_path))
  telemetry.set_tracer(tracer)
  buffer = ring_buffer.TrajectoryBuffer(8)
  prefetcher = None
  try:
    for i in range(4):
      u = _tiny_unroll(i)
      tr = telemetry.begin_unroll_trace('local-0', i)
      assert tr is not None  # a tracer is installed: tracing is on
      telemetry.stamp(tr, telemetry.HOP_DONE)
      telemetry.tag_unroll(u, tr)
      buffer.put(u)
    prefetcher = ring_buffer.BatchPrefetcher(buffer, 4,
                                             place_fn=lambda b: b)
    prefetcher.get(timeout=10)
    tracer.on_step(1)
    batch = [r for r in _read_jsonl(tracer.path) if r['k'] == 'batch'][-1]
    assert len(batch['spans']) == 4
    for span in batch['spans']:
      assert [h[0] for h in span['h']] == ['done', 'staged', 'serve',
                                           'step']
    assert batch['lag'] == [0, 0, 0, 0]  # the tracer's publish clock
  finally:
    if prefetcher is not None:
      prefetcher.close()
    telemetry.set_tracer(None)
    tracer.close()
    buffer.close()
  assert telemetry.begin_unroll_trace('local-0', 9) is None  # off again


# --------------------------------------------------------------------
# The plane's wiring through the port.
# --------------------------------------------------------------------


def _config(tmp_path, **kw):
  """tests/test_torch_fleet.py's small config."""
  base = dict(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
              batch_size=2, unroll_length=5, num_action_repeats=1,
              episode_length=4, height=24, width=32, torso='shallow',
              use_py_process=False, use_instruction=False,
              total_environment_frames=10**6, inference_timeout_ms=5,
              summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


@pytest.fixture(scope='module')
def traced_fleet(tmp_path_factory):
  """One tiny traced fleet run (4 learner steps, publishing every
  step), its snapshot of the registry taken inside the last step."""
  logdir = tmp_path_factory.mktemp('traced_fleet')
  seen = {}

  def on_step(run, step, metrics):
    seen['snapshot'] = telemetry.registry().snapshot()

  cfg = _config(logdir, publish_params_every=1)
  run = driver.train(cfg, max_steps=4, device='cpu', stall_timeout_secs=60,
                     on_step=on_step)
  return run, str(logdir), seen['snapshot']


def test_a_traced_fleet_writes_one_batch_record_per_step(traced_fleet):
  run, logdir, snapshot = traced_fleet
  records = _read_jsonl(os.path.join(logdir, 'traces.jsonl'))
  batches = [r for r in records if r['k'] == 'batch']
  assert [r['step'] for r in batches] == [1, 2, 3, 4]
  assert [r['v'] for r in records if r['k'] == 'publish'] == [1, 2, 3, 4]
  stats = run.stats['trace']
  assert stats['batches'] == 4 and stats['untagged_unrolls'] == 0
  assert stats['dropped_records'] == 0
  order = list(telemetry.HOP_ORDER)
  for batch in batches:
    assert batch['n_fresh'] == 2 and len(batch['spans']) == 2
    # One lag entry per unroll with a known behaviour version.
    assert len(batch['lag']) == sum('bv' in s for s in batch['spans']) == 2
    for span in batch['spans']:
      hops = [h for h, _ in span['h']]
      assert hops == ['done', 'staged', 'serve', 'step']
      assert [order.index(h) for h in hops] == sorted(
          order.index(h) for h in hops)
      times = [t for _, t in span['h']]
      assert times == sorted(times)
  # The registry inside the run: the tracer's counters and the driver's
  # clocks; after it, the per-run gauges are gone.
  assert snapshot['trace/batches'] >= 3
  assert snapshot['driver/update_steps'] == 4
  assert snapshot['driver/env_frames'] == 4 * run.config.frames_per_step
  assert snapshot['learner/frames_per_step'] == run.config.frames_per_step
  assert {'buffer/occupancy', 'staging/serves', 'checkpoint/save_errors',
          'serving/latency_ms', 'health/rollbacks'} <= set(snapshot)
  registry = telemetry.registry()
  for name in ('driver/update_steps', 'staging/serves', 'buffer/occupancy',
               'trace/flight_records', 'checkpoint/save_errors'):
    assert registry.get(name) is None, name
  assert telemetry.get_tracer() is None


def test_the_traced_fleet_summaries_carry_the_span_scalars(traced_fleet):
  _, logdir, _ = traced_fleet
  tags = {e['tag'] for e in _read_jsonl(os.path.join(logdir,
                                                     'summaries.jsonl'))}
  assert {'policy_lag_p50', 'policy_lag_p99', 'unroll_e2e_p50_ms',
          'unroll_e2e_p99_ms', 'trace_untagged_unrolls',
          'trace_flight_records', 'dropped_writes',
          'env_plane_utilization', 'learner_plane_utilization'} <= tags


def test_trace_report_reads_the_port_traces(traced_fleet, capsys):
  _, logdir, _ = traced_fleet
  summary = trace_report.summarize(trace_report.load_traces(logdir))
  assert summary['batches'] == 4 and summary['unrolls'] == 8
  hops = {row['hop'] for row in summary['hops']}
  assert {'done->staged', 'staged->serve', 'serve->step'} <= hops
  assert sum(summary['policy_lag']['histogram'].values()) == 8
  # NaN-aware and exact: the JSON texts (floats by repr) are equal.
  assert json.dumps(summary, sort_keys=True) == json.dumps(
      jax_trace_report.summarize(jax_trace_report.load_traces(logdir)),
      sort_keys=True)
  assert trace_report.main([logdir]) == 0
  assert 'policy lag' in capsys.readouterr().out


def test_tracing_off_writes_no_traces(tmp_path):
  run = driver.train(_config(tmp_path, telemetry_trace=False), max_steps=2,
                     device='cpu', stall_timeout_secs=60)
  assert run.tracer is None and 'trace' not in run.stats
  assert not os.path.exists(tmp_path / 'traces.jsonl')


def test_halt_bundle_carries_the_flight_dump(tmp_path):
  monitor = health_lib.HealthMonitor()
  flight = telemetry.FlightRecorder()
  flight.record({'k': 'batch', 'step': 7, 'lag': [2]})
  flight.note_registry({'buffer/occupancy': 5})
  path = monitor.write_halt_bundle(str(tmp_path), None, step=7,
                                   reason='test', flight=flight.dump())
  with open(path) as f:
    bundle = json.load(f)
  assert bundle['flight']['records'][0]['step'] == 7
  assert bundle['flight']['registry_snapshots'][0]['metrics'] == {
      'buffer/occupancy': 5}


def test_health_counters_reach_the_registry():
  monitor = health_lib.HealthMonitor()
  monitor.observe_values(1, {'step_ok': 0.0})
  snap = telemetry.registry().snapshot()
  assert snap['health/skipped_steps'] == 1
  assert snap['health/flagged_steps'] == 1


def test_dropped_writes_count_post_close_writes(tmp_path):
  before = telemetry.dropped_writes_total()
  writer = observability.EventLog(str(tmp_path))
  writer.close()
  writer.event('late')
  assert writer.dropped_writes == 1
  assert telemetry.dropped_writes_total() == before + 1


def test_closed_components_unregister_their_gauges(tmp_path):
  reg = telemetry.registry()
  tier = ring_buffer.ReplayTier(4)
  buffer = ring_buffer.TrajectoryBuffer(4, replay=tier, replay_ratio=0.5)
  assert reg.get('buffer/occupancy') is not None
  assert reg.get('replay/occupancy') is tier._gauges[0]
  buffer2 = ring_buffer.TrajectoryBuffer(4)  # replaces the buffer names
  buffer.close()  # the older one: must not evict buffer2's gauges
  assert reg.get('buffer/occupancy') is buffer2._gauges[0]
  assert reg.get('replay/occupancy') is None
  prefetcher = ring_buffer.BatchPrefetcher(buffer2, 2)
  assert reg.get('staging/serves') is prefetcher._gauges[2]
  prefetcher.close()  # closes buffer2 too
  assert reg.get('staging/serves') is None
  assert reg.get('buffer/occupancy') is None
  ckpt = checkpoint_lib.Checkpointer(str(tmp_path / 'ckpt'))
  ckpt.save_errors = 2
  assert reg.snapshot()['checkpoint/save_errors'] == 2
  ckpt.close()
  assert reg.get('checkpoint/save_errors') is None
  tracer = telemetry.PipelineTracer(str(tmp_path))
  tracer.flight.record({'k': 'batch'})
  assert reg.snapshot()['trace/flight_records'] == 1
  tracer.close()
  assert reg.get('trace/flight_records') is None


def test_the_filler_counts_its_updates_and_unregisters(tmp_path):
  from scalable_agent_tpu_torch.parallel import anakin
  cfg = _config(tmp_path, anakin_filler=True, surrogate='impact',
                filler_batch_size=2, filler_unroll_length=3)
  agent = ImpalaAgent(3, (24, 32, 3), torso='shallow')
  filler = anakin.HybridFiller(agent, cfg, 3, 'cpu')
  state = learner.make_train_state(agent, cfg)
  filler.fill_one(state)
  assert telemetry.registry().snapshot()['driver/filler_updates'] == 1
  filler.close()
  assert telemetry.registry().get('driver/filler_updates') is None


def test_the_drain_manifest_holds_the_registry_snapshot(tmp_path):
  faults.install(faults.FaultPlan.storm(seed=0, preempt_at=2))
  driver.train(_config(tmp_path, checkpoint_secs=0), max_steps=6,
               device='cpu', stall_timeout_secs=60)
  with open(tmp_path / driver.RESUME_MANIFEST) as f:
    manifest = json.load(f)
  metrics = manifest['metrics']
  for prefix in ('buffer/', 'staging/', 'checkpoint/', 'driver/'):
    assert any(k.startswith(prefix) for k in metrics), prefix
  assert metrics['driver/update_steps'] == manifest['update_steps']
  # The SLO engine's verdict so far, with JAX's keys, and the
  # controller's counts block (observe mode by default: nothing applied).
  assert set(manifest['slo']) == {'pass', 'violations', 'wall_time',
                                  'objectives', 'captures'}
  assert set(manifest['controller']) == {'actions', 'escalations', 'reverts',
                                         'applied', 'apply_errors', 'mode'}
  assert manifest['controller']['mode'] == 'observe'
  assert manifest['controller']['applied'] == 0


# --------------------------------------------------------------------
# Name parity.
# --------------------------------------------------------------------

_METRIC = re.compile(r'[a-z0-9_]+(?:/[a-z0-9_]+)+')
# Registered only by a module the port has not yet: none since the
# controller landed, so every JAX name is held.
_REMOTE_ONLY = ()


def _registered_names(package, exclude=()):
  """{name: path} of every literal registration in `package`: calls of
  telemetry.counter/gauge/histogram (any receiver named telemetry or
  _telemetry), and the bare counter/gauge/histogram calls inside
  telemetry.py and analysis/runtime.py."""
  out = {}
  root = REPO / package
  for path in sorted(root.rglob('*.py')):
    rel = str(path.relative_to(root))
    if rel in exclude:
      continue
    bare_ok = rel in ('telemetry.py', os.path.join('analysis', 'runtime.py'))
    for node in ast.walk(ast.parse(path.read_text())):
      if not isinstance(node, ast.Call) or not node.args:
        continue
      fn = node.func
      if isinstance(fn, ast.Name):
        if not bare_ok or fn.id not in ('counter', 'gauge', 'histogram'):
          continue
      elif isinstance(fn, ast.Attribute):
        if fn.attr not in ('counter', 'gauge', 'histogram') or not (
            isinstance(fn.value, ast.Name)
            and fn.value.id in ('telemetry', '_telemetry')):
          continue
      else:
        continue
      arg = node.args[0]
      if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
          and _METRIC.fullmatch(arg.value)):
        out.setdefault(arg.value, rel)
  return out


def test_the_port_registers_every_jax_name_outside_the_remote_planes():
  jax_all = _registered_names('scalable_agent_tpu')
  jax_names = set(_registered_names('scalable_agent_tpu',
                                    exclude=_REMOTE_ONLY))
  remote_only = set(jax_all) - jax_names
  assert not remote_only
  assert {'controller/actions', 'controller/reverts',
          'controller/engaged'} <= jax_names
  assert {'serving/route_ms', 'serving/route_errors',
          'serving/route_failovers', 'serving/route_replicas',
          'slo/violations', 'slo/burning'} <= jax_names
  port_names = set(_registered_names('scalable_agent_tpu_torch'))
  jax_remote = {n for n, path in jax_all.items()
                if path == os.path.join('runtime', 'remote.py')}
  assert jax_remote and all(n.split('/')[0] in ('ingest', 'remote')
                            for n in jax_remote)
  assert jax_remote <= port_names
  assert 'driver/remote_live_hosts' in port_names
  assert port_names == jax_names, (sorted(jax_names - port_names),
                                   sorted(port_names - jax_names))
  assert len(port_names) >= 55
  assert {'trace/batches', 'curriculum/entropy', 'population/best_return',
          'analysis/lock_cycles', 'driver/filler_updates'} <= port_names
