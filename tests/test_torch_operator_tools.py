"""The port's operator tools (scalable_agent_tpu_torch/scripts/
slo_report.py and fleet_stats.py) against the JAX package's
scripts/slo_report.py and scripts/fleet_stats.py.

slo_report: the same passing, failing and missing verdicts through both
tools give the same exit codes (0, 1, 2) and the same report (its table
and its JSON); `--update-fps-baseline` records the same frames/s.
fleet_stats: the same scripted `fetch_stats` reply renders the same text
and JSON through both, an unreachable learner exits 1 in both, and the
port's tool against a live ingest on the CPU prints what `fetch_stats`
returns.
"""

import contextlib
import importlib.util
import io
import json
import math
import os

import numpy as np
import pytest

from scalable_agent_tpu_torch.runtime import remote
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.scripts import fleet_stats
from scalable_agent_tpu_torch.scripts import slo_report

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
  spec = importlib.util.spec_from_file_location(
      f'jax_{name}', os.path.join(REPO_ROOT, 'scripts', f'{name}.py'))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


_JAX = {'slo_report': _jax_script('slo_report'),
        'fleet_stats': _jax_script('fleet_stats')}
_PORT = {'slo_report': slo_report, 'fleet_stats': fleet_stats}


def _run(main, argv):
  out, err = io.StringIO(), io.StringIO()
  with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
    rc = main(argv)
  return rc, out.getvalue(), err.getvalue()


def _objective(state, value, target, burns=0):
  return {'severity': 'ticket', 'state': state, 'value': value,
          'target': target, 'margin': value - target, 'burns': burns,
          'metric': 'health/rollbacks'}


_VERDICTS = {
    'passing': {
        'pass': True, 'violations': [], 'captures': {},
        'objectives': {'rollbacks_zero': _objective('ok', 0.0, 0.0),
                       'fps_floor': _objective('no_baseline', float('nan'),
                                               0.5)}},
    'failing': {
        'pass': False, 'violations': ['rollbacks_zero'],
        'captures': {'rollbacks_zero': {'flight': 'diagnostics/f.json',
                                        'trace_slice': None,
                                        'profile': 'diagnostics/p'}},
        'objectives': {'rollbacks_zero': _objective('violated', 2.0, 0.0,
                                                    burns=1),
                       'fps_floor': _objective('ok', 900.0, 0.5)}},
    'missing': None,
}


@pytest.mark.parametrize('case', sorted(_VERDICTS))
def test_slo_report_exits_as_jax_s_does(tmp_path, case):
  results = {}
  for name, tools in (('jax', _JAX), ('port', _PORT)):
    logdir = tmp_path / name
    logdir.mkdir()
    if _VERDICTS[case] is not None:
      (logdir / 'SLO_VERDICT.json').write_text(json.dumps(_VERDICTS[case]))
    with open(logdir / 'summaries.jsonl', 'w') as f:
      for step, fps in enumerate([10.0, 200.0, 400.0, 300.0, 350.0]):
        f.write(json.dumps({'step': step, 'tag': 'env_frames_per_sec',
                            'value': fps}) + '\n')
    report, baseline = logdir / 'report.json', logdir / 'baseline.json'
    rc, out, err = _run(tools['slo_report'].main, [
        str(logdir), '--json', str(report), '--update-fps-baseline',
        str(baseline)])
    results[name] = dict(
        rc=rc, table=out.split('\n\n')[0], err=err.replace(str(logdir), '<>'),
        report=(json.loads(report.read_text()) if report.exists() else None),
        baseline=(json.loads(baseline.read_text()) if baseline.exists()
                  else None))
    for entry in (results[name]['baseline'] or {}).values():
      entry.pop('wall_time')  # when it was recorded
    if results[name]['report'] is not None:
      results[name]['report']['logdir'] = '<>'
      results[name]['report']['fps_baseline']['path'] = '<>'
  assert results['port'] == results['jax']
  assert results['port']['rc'] == {'passing': 0, 'failing': 1,
                                   'missing': 2}[case]
  if case != 'missing':
    assert list(results['port']['baseline'].values()) == [{'fps': 350.0}]


_STATS = {
    'registry': {
        'ingest/unrolls': 12, 'ingest/quarantined': 0,
        'driver/env_plane_utilization': 0.12345678,
        'serving/shadow_divergence': float('nan'),
        'ingest/ack_ms': {'count': 12, 'p50': 0.81, 'p99': 2.5, 'max': 3.0},
        'trace/policy_lag': {'count': 0, 'p50': float('nan'),
                             'p99': float('nan'), 'max': None}},
    'ingest': {'unrolls': 12, 'connections': 2, 'ack_p50_ms': 0.81,
               'wedged_thread_names': [], 'session_epoch': 7,
               'per_host': {'host0': 8, 'host1': 4}},
}


@pytest.mark.parametrize('argv', [[], ['--json'], ['--filter', 'ingest']])
def test_fleet_stats_prints_a_reply_as_jax_s_does(monkeypatch, argv):
  outputs = {}
  for name, tools in (('jax', _JAX), ('port', _PORT)):
    calls = []

    def fetch(address, connect_timeout_secs=10.0, calls=calls):
      calls.append((address, connect_timeout_secs))
      return _STATS

    monkeypatch.setattr(tools['fleet_stats'], 'fetch', fetch)
    outputs[name] = _run(tools['fleet_stats'].main,
                         ['127.0.0.1:1'] + argv), calls
  assert outputs['port'] == outputs['jax']
  (rc, out, _), calls = outputs['port']
  assert rc == 0 and calls == [('127.0.0.1:1', 10.0)]
  if argv == ['--json']:
    assert json.loads(out)['ingest'] == _STATS['ingest']
  else:
    assert '== ingest server ==' in out and 'ingest/ack_ms' in out


def test_fleet_stats_exits_1_when_the_learner_is_unreachable(monkeypatch):
  for tools in (_JAX, _PORT):
    def fetch(address, connect_timeout_secs=10.0):
      raise ConnectionRefusedError('refused')
    monkeypatch.setattr(tools['fleet_stats'], 'fetch', fetch)
    rc, out, err = _run(tools['fleet_stats'].main, ['127.0.0.1:1'])
    assert (rc, out) == (1, '') and 'refused' in err


def test_fleet_stats_reads_a_live_ingest():
  buffer = ring_buffer.TrajectoryBuffer(2)
  server = remote.TrajectoryIngestServer(buffer, {'w': np.zeros(1)},
                                         host='127.0.0.1')
  try:
    address = f'127.0.0.1:{server.port}'
    rc, out, _ = _run(fleet_stats.main, [address, '--json'])
    client = remote.RemoteActorClient(address, connect_timeout_secs=10)
    try:
      want = client.fetch_stats()
    finally:
      client.close()
    got = json.loads(out)
    assert rc == 0
    assert set(got['registry']) == set(want['registry'])
    assert set(got['ingest']) == set(want['ingest'])
    assert got['ingest']['hosts_joined'] == 0  # no hello, no host
    for key in ('unrolls', 'rejected', 'conns_reaped'):
      assert got['ingest'][key] == want['ingest'][key] == 0
    assert math.isnan(got['ingest']['ack_p50_ms'])
  finally:
    server.close()
    buffer.close()
