"""The port's drills (scalable_agent_tpu_torch/scripts/chaos.py) on the
CPU, against the JAX package's (the root scripts/chaos.py).

Tier-1: the port's fault storm at smoke size, seed 1, as a process
(`python -m scalable_agent_tpu_torch.scripts.chaos --device=cpu`): its
errors are none, its fault plan's per-site `scheduled` counts and the
`fired` counts of the sites its step budget always reaches equal JAX's
storm's on the same seed (literals below, from a run of JAX's storm:
the two-package run is slow), its incident kinds are JAX's (but the
port's own `actors_respawned`), and its SLO verdict names the two
violations JAX's storm asserts. Neither drill module imports JAX.

Slow (`@pytest.mark.slow`): the other six storms' port smoke (`all`,
`elastic`, `routed`), and for every storm a two-package comparison on
seed 1 (both storms as processes, one after the other): both without
errors; the violations JAX's storm asserts present (or absent) in both
verdicts; equal incident-kind sets, per-site scheduled counts and
always-reached fired counts, health rollbacks, and the storm's own
figures named in `_COMPARED`.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULE = 'scalable_agent_tpu_torch.scripts.chaos'
STORM_TIMEOUT_SECS = 600

# The port's own incident kinds (driver.train's actors_respawned and
# fault_slow_learner: JAX logs respawns and stalls only).
PORT_ONLY_INCIDENTS = {'actors_respawned', 'fault_slow_learner'}

# JAX's fault storm, CHAOS_SMOKE=1 CHAOS_STORM=fault, seed 1, on the CPU:
# its fault plan's scheduled counts (sites not listed: 0), the fired
# counts of the sites its 30 steps always reach, its incident kinds and
# its verdict's violations.
JAX_FAULT_SCHEDULED = {'checkpoint_save': 1, 'env_step': 2, 'nan_burst': 5}
JAX_FAULT_FIRED = {'checkpoint_save': 1, 'env_step': 2, 'nan_burst': 5}
JAX_FAULT_INCIDENTS = {'fault_nan_burst', 'health_bad_burst_start',
                       'health_recovered', 'host_joined', 'host_left',
                       'rollback', 'slo_violation'}
JAX_FAULT_VIOLATIONS = {'ingest_quarantine_zero', 'rollbacks_zero'}


def _run_port(storm, out_path, seed=1):
  env = dict(os.environ, CHAOS_SMOKE='1', CHAOS_STORM=storm,
             CHAOS_SEED=str(seed), CHAOS_OUT=str(out_path))
  return subprocess.Popen(
      [sys.executable, '-m', PORT_MODULE, '--device=cpu'], cwd=REPO,
      env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _run_jax(storm, out_path, seed=1):
  # The script's own device count: the tests' 8 virtual devices (conftest)
  # would keep its corruption storm's batch of 2 off the 2-replica mesh.
  env = dict(os.environ, CHAOS_SMOKE='1', CHAOS_STORM=storm,
             CHAOS_SEED=str(seed), CHAOS_OUT=str(out_path),
             JAX_PLATFORMS='cpu')
  env.pop('XLA_FLAGS', None)
  return subprocess.Popen(
      [sys.executable, os.path.join(REPO, 'scripts', 'chaos.py')],
      cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True)


def _finish(proc, out_path):
  try:
    out = proc.communicate(timeout=STORM_TIMEOUT_SECS)[0]
  except subprocess.TimeoutExpired:
    proc.kill()
    out = proc.communicate()[0]
    pytest.fail(f'storm still running after {STORM_TIMEOUT_SECS} s: '
                f'{out[-2000:]}')
  assert os.path.exists(out_path), out[-3000:]
  with open(out_path) as f:
    return json.load(f), proc.returncode, out


def _sites(plan, key):
  return {site: v[key] for site, v in (plan or {}).items() if v[key]}


def test_the_port_s_fault_storm_matches_jax_s(tmp_path):
  out_path = tmp_path / 'fault.json'
  result, rc, out = _finish(_run_port('fault', out_path), out_path)
  assert result['slo_violations'] == [], out[-3000:]
  assert rc == 0 and result['ok']
  assert result['device'] == 'cpu' and result['crash'] is None
  plan = result['fault_plan']
  assert _sites(plan, 'scheduled') == JAX_FAULT_SCHEDULED
  assert {s: plan[s]['fired'] for s in JAX_FAULT_FIRED} == JAX_FAULT_FIRED
  assert set(result['incident_kinds']) - PORT_ONLY_INCIDENTS == \
      JAX_FAULT_INCIDENTS
  assert JAX_FAULT_VIOLATIONS <= set(result['slo_verdict']['violations'])
  assert result['health']['rollbacks'] >= 1
  assert result['ingest']['quarantined'] >= 1
  assert result['lock_order'] == {'armed': True, 'cycles': 0}
  assert result['time_to_recover_secs'] <= 60.0
  assert '"chaos_ok": true' in out


def test_the_drills_import_no_jax():
  script = ('import sys\n'
            'import scalable_agent_tpu_torch.scripts.chaos\n'
            'import scalable_agent_tpu_torch.scripts.soak\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "optax", "ml_dtypes", '
            '"scalable_agent_tpu"))\n'
            'assert not bad, bad\n')
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr


def test_the_port_s_chaos_refuses_a_missing_card(tmp_path):
  """--device defaults to cuda: on a host without it the script raises
  before any storm runs, and writes no record."""
  env = dict(os.environ, CHAOS_SMOKE='1', CHAOS_STORM='fault',
             CHAOS_OUT=str(tmp_path / 'out.json'))
  proc = subprocess.run([sys.executable, '-m', PORT_MODULE], cwd=REPO,
                        env=env, capture_output=True, text=True,
                        timeout=120)
  assert proc.returncode != 0
  assert 'torch.cuda.is_available() is False' in proc.stderr
  assert not (tmp_path / 'out.json').exists()


# --- slow: the other storms, and the two-package comparison of each -----


def _violations(result):
  return set((result.get('slo_verdict') or {}).get('violations') or [])


def _compare_fault(jax, port):
  for result in (jax, port):
    assert JAX_FAULT_VIOLATIONS <= _violations(result)
    assert result['lock_order']['cycles'] == 0
  assert port['health']['rollbacks'] == jax['health']['rollbacks']
  assert (set(port['incident_kinds']) - PORT_ONLY_INCIDENTS ==
          set(jax['incident_kinds']))
  assert port['device_update_steps'] == jax['device_update_steps']


# The SLO engine's own records in a storm that judges no verdict: the
# default objectives' latency burns follow the host's load (JAX's
# overload storm, seed 1, burned one in 2 of 4 runs here).
VERDICT_INCIDENTS = {'slo_violation', 'slo_capture'}


def _compare_overload(jax, port):
  jax, port = jax['overload'], port['overload']
  assert (set(port['incident_kinds']) - PORT_ONLY_INCIDENTS -
          VERDICT_INCIDENTS == set(jax['incident_kinds']) -
          VERDICT_INCIDENTS)
  for key in ('slots_quarantined', 'fleet_size', 'slots'):
    assert port[key] == jax[key], key
  # The SIGTERM lands on a wall clock: the steps before it are each
  # run's own; the resume's 3 are not.
  for result in (jax, port):
    assert result['final_update_steps'] == \
        result['device_update_steps'] + 3


def _compare_partition(jax, port):
  jax, port = jax['partition'], port['partition']
  for result in (jax, port):
    assert 'conns_reaped_zero' in _violations(result)
    assert 'stale_epoch_zero' not in _violations(result)
    assert result['learner1_returncode'] == -9
    assert result['learner2']['ingest']['stale_epoch_rejected'] == 0
  assert port['restored_step'] <= port['crash_at']
  assert port['learner2']['final_steps'] - port['restored_step'] == \
      jax['learner2']['final_steps'] - jax['restored_step']


def _compare_corruption(jax, port):
  jax, port = jax['corruption'], port['corruption']
  for result in (jax, port):
    assert {'wire_crc_rejected_zero', 'sdc_mismatch_zero'} <= \
        _violations(result)
    assert 'ingest_quarantine_zero' not in _violations(result)
    assert result['ingest']['wire_crc_rejected'] == 2  # the flips
    assert result['ingest']['publish_digest_rejected'] >= 1
  assert port['health']['rollbacks'] == jax['health']['rollbacks']
  assert port['health']['sdc_mismatches'] == jax['health']['sdc_mismatches']
  for site in ('publish_corrupt', 'replica_divergence'):
    assert port['fault_plan'][site]['scheduled'] == \
        jax['fault_plan'][site]['scheduled']
  assert port['fault_plan']['replica_divergence']['fired'] == \
      jax['fault_plan']['replica_divergence']['fired']
  assert _sites(port['child_plan'], 'scheduled') == \
      _sites(jax['child_plan'], 'scheduled')
  assert port['restored_step'] < port['rotted_step']


def _compare_controller(jax, port):
  jax, port = jax['controller'], port['controller']
  for result in (jax, port):
    assert result['act']['slo_verdict']['pass']
    assert 'fleet_healthy_fraction' in result['observe'][
        'slo_verdict']['violations']
  for mode in ('act', 'observe'):
    for key in ('slots_quarantined', 'slots_rehabilitated', 'admission'):
      assert port[mode][key] == jax[mode][key], (mode, key)
  kinds = lambda r: {(a['kind'], a['actuator'])  # noqa: E731
                     for a in r['act']['actions']}
  assert kinds(port) == kinds(jax)


def _compare_elastic(jax, port):
  jax, port = jax['elastic'], port['elastic']
  for result in (jax, port):
    assert result['slo_verdict']['pass']
    assert 'lost' in result['host_left_reasons']
    assert result['stale_epoch_rejected'] == 0
  # One pod_size move, at the kill (C12: the port moved at start-up too).
  assert port['controller_counts'] == jax['controller_counts']
  assert port['pod_target']['target_hosts'] == \
      jax['pod_target']['target_hosts']
  events = lambda r: [t['event'] for t in r['timeline']]  # noqa: E731
  assert events(port) == events(jax)


def _compare_routed(jax, port):
  jax, port = jax['routed'], port['routed']
  for result in (jax, port):
    assert result['slo_verdict']['pass']
    assert result['starvation'] == 0
    assert result['router']['route_failovers'] >= 1
    assert result['served']['post_kill'] > 0


_COMPARED = {'fault': _compare_fault, 'overload': _compare_overload,
             'partition': _compare_partition,
             'corruption': _compare_corruption,
             'controller': _compare_controller,
             'elastic': _compare_elastic, 'routed': _compare_routed}


@pytest.mark.slow
@pytest.mark.parametrize('storm', ['all', 'elastic', 'routed'])
def test_the_port_s_other_storms_pass_at_smoke_size(tmp_path, storm):
  """`all` runs overload, partition, controller and corruption (in a
  process of its own) after fault; elastic and routed run by name."""
  out_path = tmp_path / 'out.json'
  result, rc, out = _finish(_run_port(storm, out_path), out_path)
  assert result['slo_violations'] == [], out[-3000:]
  assert rc == 0 and result['ok']
  if storm == 'all':
    assert {'overload', 'partition', 'controller', 'corruption'} <= \
        set(result)
    assert result['corruption']['ranks'] == 2


@pytest.mark.slow
@pytest.mark.parametrize('storm', sorted(_COMPARED))
def test_each_storm_matches_jax_s_on_one_seed(tmp_path, storm):
  paths = {name: tmp_path / f'{name}.json' for name in ('jax', 'port')}
  results = {}
  # One after the other: a storm's timing objectives judge its host's load.
  for name, run in (('jax', _run_jax), ('port', _run_port)):
    result, rc, out = _finish(run(storm, paths[name]), paths[name])
    assert result['slo_violations'] == [], (name, out[-3000:])
    assert rc == 0, (name, out[-3000:])
    results[name] = result
  _COMPARED[storm](results['jax'], results['port'])
