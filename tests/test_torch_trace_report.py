"""The port's trace report (scalable_agent_tpu_torch/scripts/
trace_report.py) against the JAX package's scripts/trace_report.py.

Inputs: run directories made from numpy seeds with two trace streams
(`traces.jsonl`, `traces_p1.jsonl`) of publish, install and batch
records (spans over random hop subsets, resent hops, clock-skewed and
malformed stamps), a truncated last line, and two incident streams; and
the port's own traced fleet (tests/test_torch_telemetry.py's
`traced_fleet`). Through both tools: `summarize` gives equal data (the
JSON texts equal, so floats exact and NaN for NaN), `render` equal text,
`main([logdir, '--json', out])` exit 0, equal text and equal JSON files;
an empty directory exits 1 in both.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.scripts import trace_report
from scripts import trace_report as jax_trace_report
from test_torch_telemetry import traced_fleet  # noqa: F401 (a fixture)

BOTH = {'jax': jax_trace_report, 'port': trace_report}
SEEDS = (0, 1, 2)
INCIDENT_KINDS = ('rollback', 'partition', 'reattach', 'slo_violation')


def _span(rng, actor, t):
  """One unroll's span: a random subset of the hops in pipeline order
  (at least two), sometimes a resent hop, a skewed stamp or a malformed
  entry."""
  keep = sorted(rng.choice(len(telemetry.HOP_ORDER),
                           size=rng.randint(2, len(telemetry.HOP_ORDER) + 1),
                           replace=False))
  hops = []
  for i in keep:
    t += float(rng.exponential(0.02))
    hops.append([telemetry.HOP_ORDER[i], t])
  roll = rng.uniform()
  if roll < 0.15:  # a resend re-stamps a hop later: the first one counts
    hops.append([hops[0][0], t + 0.5])
  elif roll < 0.3:  # another host's clock behind this one's
    hops[-1][1] = hops[0][1] - float(rng.uniform(0.001, 0.01))
  elif roll < 0.4:
    hops.insert(rng.randint(len(hops)), ['wire'])
  elif roll < 0.45:
    hops.append(['commit', 'not-a-time'])
  span = {'a': actor, 's': int(rng.randint(100)), 'h': hops}
  if rng.uniform() < 0.8:
    span['bv'] = int(rng.randint(10))
  return span


def write_run(logdir, seed):
  """A run directory of traces and incidents made from `seed`."""
  rng = np.random.RandomState(seed)
  t = 1.7e9 + float(rng.uniform(0, 1000))
  streams = {'traces.jsonl': [], 'traces_p1.jsonl': []}
  incidents = {'incidents.jsonl': [], 'incidents_p1.jsonl': []}
  version = 0
  for step in range(1, 25):
    stream = 'traces.jsonl' if rng.uniform() < 0.6 else 'traces_p1.jsonl'
    t += float(rng.uniform(0.05, 0.9))
    if rng.uniform() < 0.5:
      version += 1
      publish = {'k': 'publish', 'v': step, 't': t}
      if rng.uniform() < 0.5:
        publish['rv'] = version
      streams[stream].append(publish)
      for a in range(rng.randint(0, 3)):
        streams[stream].append({
            'k': 'install', 'v': int(version - rng.randint(0, 2)),
            't': t + float(rng.uniform(-0.05, 0.4)), 'a': f'host-{a}'})
    spans = [_span(rng, f'actor-{rng.randint(6)}', t - 0.5)
             for _ in range(rng.randint(0, 5))]
    batch = {'k': 'batch', 'step': step, 't': t, 'pv': version,
             'n_fresh': len(spans),
             'lag': [int(version - s['bv']) for s in spans if 'bv' in s],
             'spans': spans}
    streams[stream].append(batch)
    if rng.uniform() < 0.25:
      name = 'incidents.jsonl' if rng.uniform() < 0.7 else 'incidents_p1.jsonl'
      incidents[name].append({
          'wall_time': t + float(rng.uniform(0, 0.3)),
          'kind': INCIDENT_KINDS[rng.randint(len(INCIDENT_KINDS))],
          'step': step})
  os.makedirs(logdir, exist_ok=True)
  for name, records in {**streams, **incidents}.items():
    with open(os.path.join(logdir, name), 'w') as f:
      for record in records:
        f.write(json.dumps(record) + '\n')
      f.write('\n')
  # A crashed writer's truncated last line.
  with open(os.path.join(logdir, 'traces_p1.jsonl'), 'a') as f:
    f.write('{"k": "batch", "step": 99, "sp')
  with open(os.path.join(logdir, 'incidents.jsonl'), 'a') as f:
    f.write('{"wall_time": 1')
  return logdir


def _summaries(logdir):
  return {name: tool.summarize(tool.load_traces(logdir),
                               tool.load_incidents(logdir))
          for name, tool in BOTH.items()}


def _run_main(tool, argv):
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = tool.main(argv)
  return rc, out.getvalue(), err.getvalue()


@pytest.fixture(params=SEEDS, ids=[f'seed{s}' for s in SEEDS])
def seeded_run(request, tmp_path):
  return write_run(str(tmp_path / 'run'), request.param)


def test_the_seeded_runs_exercise_every_record_kind(seeded_run):
  summary = trace_report.summarize(trace_report.load_traces(seeded_run),
                                   trace_report.load_incidents(seeded_run))
  assert summary['batches'] == 24  # the truncated 25th skipped
  assert summary['unrolls'] and summary['hops'] and summary['incidents']
  assert summary['policy_lag']['histogram']
  assert summary['publish_to_install_secs']['count']


def test_summarize_equals_jax_s(seeded_run):
  summaries = _summaries(seeded_run)
  # The JSON texts: floats by repr (exact), NaN equal to NaN.
  assert json.dumps(summaries['port'], sort_keys=True) == json.dumps(
      summaries['jax'], sort_keys=True)


def test_render_equals_jax_s(seeded_run):
  summaries = _summaries(seeded_run)
  assert trace_report.render(summaries['port']) == jax_trace_report.render(
      summaries['jax'])


def test_the_cli_with_json_equals_jax_s(seeded_run, tmp_path):
  results = {}
  for name, tool in BOTH.items():
    out = tmp_path / name / 'summary.json'
    out.parent.mkdir()
    rc, text, err = _run_main(tool, [seeded_run, '--json', str(out)])
    results[name] = (rc, text.replace(str(out), 'OUT'), err, out.read_text())
  assert results['port'] == results['jax']
  assert results['port'][0] == 0 and 'policy lag' in results['port'][1]


def test_span_hop_deltas_equal_jax_s():
  rng = np.random.RandomState(7)
  for _ in range(200):
    span = _span(rng, 'a', float(rng.uniform(0, 1e9)))
    assert trace_report.span_hop_deltas(span) == \
        jax_trace_report.span_hop_deltas(span)
  for span in ({}, {'h': None}, {'h': [['done', 1.0]]}, {'h': [[1, 2, 3]]}):
    assert trace_report.span_hop_deltas(span) == \
        jax_trace_report.span_hop_deltas(span)


def test_an_empty_logdir_exits_1_in_both(tmp_path):
  results = {name: _run_main(tool, [str(tmp_path)])
             for name, tool in BOTH.items()}
  assert results['port'] == results['jax']
  assert results['port'][0] == 1 and 'telemetry_trace' in results['port'][2]


def test_the_port_traced_fleet_reads_as_in_jax(traced_fleet, tmp_path):  # noqa: F811
  _, logdir, _ = traced_fleet
  summaries = _summaries(logdir)
  assert summaries['port']['batches'] == 4
  assert json.dumps(summaries['port'], sort_keys=True) == json.dumps(
      summaries['jax'], sort_keys=True)
  assert trace_report.render(summaries['port']) == jax_trace_report.render(
      summaries['jax'])
  results = {}
  for name, tool in BOTH.items():
    out = tmp_path / f'{name}.json'
    rc, text, _ = _run_main(tool, [logdir, '--json', str(out)])
    results[name] = (rc, text.replace(str(out), 'OUT'), out.read_text())
  assert results['port'] == results['jax'] and results['port'][0] == 0
