"""The drills: scripted fault storms against the port's full pipeline.

  python -m scalable_agent_tpu_torch.scripts.chaos               # card
  python -m scalable_agent_tpu_torch.scripts.chaos --device=cpu  # CPU
  CHAOS_SMOKE=1 CHAOS_STORM=fault python -m ...scripts.chaos --device=cpu

The port's counterpart of the root `scripts/chaos.py`: the same seven
storms, with the same fault plans, seeds, step budgets, assertions and
bounds, driving `driver.train` (and its learner, ingest, actor-host,
replica and rank children) on `--device` (default cuda, which raises
without CUDA; `cpu` for the tests). Each storm returns (results, errors);
an empty error list is a pass.

  fault       (`run_storm`) env hang and env raise, socket garbage from
              an actor-host child, a NaN burst and an interrupted save,
              with the lock-order checker armed: zero learner crashes,
              >= 1 rollback, a complete step counter, time-to-recover
              within 60 s, the garbage connection quarantined while
              remote unrolls flow, zero lock-order cycles, and an SLO
              verdict naming ingest_quarantine_zero and rollbacks_zero.
  overload    (`run_overload_storm`) the fleet at 2x the state arena
              under shed admission, a slow-learner burst, a real SIGTERM
              once the slotless actors are quarantined: bounded sheds and
              buffer occupancy, a verified drain checkpoint and manifest
              within 20 s (+10 s grace), and a resume whose step sequence
              is contiguous.
  partition   (`run_partition_storm`) the learner as a child under
              conn_delay and conn_partition on its actor host, SIGKILLed
              by learner_crash and restarted on the same port: the host
              reattaches within 45 s, a harness half-open peer is reaped
              within the idle timeout + 6 s, zero stale-epoch unrolls,
              zero wedged or unjoined threads.
  corruption  (`run_corruption_storm`) 2 gloo ranks sharing one device
              (the SDC sentinel runs over a group), rank 0's ingest fed
              by an actor host under wire_bitflip and publish_corrupt,
              replica_divergence on both ranks; then the newest step is
              bit-rotted and a resume must restore the step before it.
  controller  (`run_controller_storm`) a surge of flaky slots through
              `fleet_factory`: acting, the controller keeps the verdict
              green and reverts its moves; observing, the quorum burns.
  elastic     (`run_elastic_storm`) a learner fed by two actor hosts,
              one SIGKILLed: host_left(lost), POD_TARGET.json from the
              pod_size actuator, a replacement that joins.
  routed      (`run_routed_storm`) two replica children behind a
              ServingRouter, one SIGKILLed, then (full run) a drain.

CHAOS_STORM picks one (default `all`: fault, overload, partition,
controller, and corruption in a process of its own; elastic and routed
run only by name). CHAOS_SMOKE=1 cuts the step budgets, CHAOS_SEED
(default 1) perturbs the garbage bytes, CHAOS_OUT (default
CHAOS_TORCH.json at the repo root, git-ignored) takes the record. The
last line printed is a JSON summary with `chaos_ok`; the exit code is 1
when any storm failed.

Every child gets `--device` too. A child asked for CUDA on a host
without it raises, and the storm counts that as a failure, never as a
fall back to the CPU.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from scalable_agent_tpu_torch.scripts import trace_report

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMOKE = bool(os.environ.get('CHAOS_SMOKE'))
SEED = int(os.environ.get('CHAOS_SEED', '1'))
OUT_PATH = os.environ.get('CHAOS_OUT',
                          os.path.join(REPO, 'CHAOS_TORCH.json'))

# What a child prints when it was asked for CUDA on a host without it
# (driver.resolve_device's message).
_NO_CUDA = 'torch.cuda.is_available() is False'


def _free_port() -> int:
  with socket.create_server(('127.0.0.1', 0)) as s:
    return s.getsockname()[1]


def _read_jsonl(path):
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def _child_env(plan_json: Optional[str] = None):
  from scalable_agent_tpu_torch.runtime import faults as faults_lib
  env = dict(os.environ)
  env.pop(faults_lib.PLAN_ENV_VAR, None)
  existing = env.get('PYTHONPATH', '')
  env['PYTHONPATH'] = REPO + os.pathsep + existing if existing else REPO
  if plan_json:
    env[faults_lib.PLAN_ENV_VAR] = plan_json
  return env


def _device_errors(who: str, out: str) -> List[str]:
  """A child that could not have the device it was asked for failed."""
  if _NO_CUDA in (out or ''):
    return [f'{who} was asked for CUDA and has none (no CPU fallback)']
  return []


def _spawn_actor_child(address, overrides, plan_json, device):
  """The remote-actor role (runtime/remote.run_remote_actor) as a child
  process on `device`, with its own transport-fault plan shipped in
  SA_FAULT_PLAN (plans are process-local). It prints 'CHILD_READY' once
  its device is up, before it dials the learner."""
  body = (
      'import json, sys\n'
      'import torch\n'
      'from scalable_agent_tpu_torch import driver\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.runtime import faults, remote\n'
      'faults.install_from_env()\n'
      'torch.zeros(1, device=driver.resolve_device(sys.argv[3]))\n'
      'print("CHILD_READY", flush=True)\n'
      'cfg = Config(**json.loads(sys.argv[2]))\n'
      'sent = remote.run_remote_actor(cfg, sys.argv[1], task=0,\n'
      '                               device=sys.argv[3])\n'
      'print("CHILD_OK", sent, flush=True)\n')
  return subprocess.Popen(
      [sys.executable, '-c', body, address, json.dumps(overrides),
       str(device)],
      cwd=REPO, env=_child_env(plan_json), stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True)


class _Lines:
  """A child's output lines, read by a thread as they come."""

  def __init__(self, proc):
    self.lines = []
    self._thread = threading.Thread(target=self._read, args=(proc,),
                                    daemon=True)
    self._thread.start()

  def _read(self, proc):
    for line in proc.stdout:
      self.lines.append(line)

  def wait_for(self, proc, prefix: str, timeout: float) -> bool:
    """Whether a line starting with `prefix` came within `timeout`."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      if any(line.startswith(prefix) for line in list(self.lines)):
        return True
      if proc.poll() is not None:
        self._thread.join(timeout=5.0)
        return any(line.startswith(prefix) for line in self.lines)
      time.sleep(0.1)
    return False

  def text(self) -> str:
    self._thread.join(timeout=5.0)
    return ''.join(self.lines)


# How long the fault storm waits for its actor child's device before the
# learner starts (see run_storm).
CHILD_READY_TIMEOUT_SECS = 120.0


def _base_kwargs(logdir, seed, **kw):
  """The drills' shared CPU-sized learner: the bandit task, the shallow
  torso at 24x32, thread-hosted envs."""
  return dict(logdir=logdir, env_backend='bandit', batch_size=2,
              unroll_length=5, num_action_repeats=1, episode_length=4,
              height=24, width=32, torso='shallow', use_py_process=False,
              use_instruction=False, total_environment_frames=10 ** 9,
              inference_timeout_ms=5, seed=seed, **kw)


def _time_to_recover(incidents):
  """First bad step -> first healthy step, from the incident stream (a
  rollback mid-burst does not restart the clock)."""
  ttr = t_bad = None
  for ev in incidents:
    if ev['kind'] == 'health_bad_burst_start' and t_bad is None:
      t_bad = ev['wall_time']
    if (ev['kind'] == 'health_recovered' and ttr is None
        and t_bad is not None):
      ttr = round(ev['wall_time'] - t_bad, 3)
  return ttr


def run_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
              device='cuda'):
  """The fault storm; returns (results, errors)."""
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch.analysis import runtime as lock_check
  from scalable_agent_tpu_torch.config import Config
  from scalable_agent_tpu_torch.runtime import faults as faults_lib

  max_steps = 30 if smoke else 80
  burst_len = 5
  cfg_kwargs = _base_kwargs(
      logdir, seed,
      num_actors=2,
      checkpoint_secs=0,        # a save every window: the burst always
                                # has a rollback target
      summary_secs=0,
      remote_actor_port=_free_port(),
      actor_reconnect_secs=120.0,
      health_rollback_after=3,  # K: the burst (5) must cross it
      health_min_window=8,
      # The storm doubles as a race hunt: every lock the threaded planes
      # take under fault pressure feeds the acquisition graph.
      lock_order_check=True)
  cfg = Config(**cfg_kwargs)

  # Learner side: env faults early (respawns), the NaN burst mid-run
  # (after checkpoints exist), one interrupted save after it.
  plan = faults_lib.FaultPlan.storm(
      seed,
      env_raise_at=40,
      env_hang_at=200,
      env_hang_secs=8.0,        # > the stall timeout: must respawn
      nan_burst_at=10, nan_burst_len=burst_len,
      checkpoint_interrupt_at=16)
  # Child side: transport damage on the unroll pump (garbage -> the
  # learner quarantines; truncate/drop -> reconnect with backoff).
  child_plan = faults_lib.FaultPlan(
      [faults_lib.Fault('transport_send', 4, 'garbage'),
       faults_lib.Fault('transport_send', 9, 'truncate'),
       faults_lib.Fault('transport_send', 14, 'drop')],
      seed=seed)

  child_overrides = {k: v for k, v in cfg_kwargs.items()
                     if k not in ('logdir', 'remote_actor_port')}
  child_overrides['logdir'] = logdir + '/actor_child'
  child = _spawn_actor_child(
      f'127.0.0.1:{cfg.remote_actor_port}', child_overrides,
      child_plan.to_json(), device)
  child_lines = _Lines(child)
  # The learner starts once the child's device is up. JAX's learner
  # spends its first seconds compiling, while its child connects; the
  # port's 30 steps take about as long as a child's start on the card, so
  # unawaited, the child would connect after the run.
  child_ready = child_lines.wait_for(child, 'CHILD_READY',
                                     CHILD_READY_TIMEOUT_SECS)

  faults_lib.install(plan)
  t0 = time.monotonic()
  crash = None
  run = None
  try:
    run = driver.train(cfg, max_steps=max_steps, stall_timeout_secs=5.0,
                       device=device)
  except Exception as e:  # SLO: zero learner crashes
    crash = f'{type(e).__name__}: {e}'
  finally:
    faults_lib.clear()
  wall_secs = time.monotonic() - t0
  child.terminate()
  try:
    child.wait(timeout=20)
  except subprocess.TimeoutExpired:
    child.kill()
    child.wait()
  child_out = child_lines.text()

  summaries = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
  incidents = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
  tags = {e['tag'] for e in summaries if 'tag' in e}

  errors = _device_errors('the actor child', child_out)
  if not child_ready:
    errors.append('the actor child never reported its device ready')
  results = {
      'smoke': smoke,
      'seed': seed,
      'device': str(device),
      'max_steps': max_steps,
      'wall_secs': round(wall_secs, 2),
      'crash': crash,
      'fault_plan': plan.stats(),
      'child_tail': child_out[-600:] if child_out else '',
  }
  if crash is not None:
    errors.append(f'learner crashed: {crash}')
    return results, errors

  health = run.health
  ing = run.ingest.stats() if run.ingest is not None else {}
  # train() has stopped the fleet: keep its cumulative counters only.
  fleet_raw = run.fleet.stats()
  fleet_stats = {k: fleet_raw[k] for k in ('respawns', 'unrolls')}

  # --- SLO: a complete step counter (skipped steps consumed their
  # batches too), and summary steps that never decrease.
  device_steps = int(run.state.update_steps)
  if device_steps != max_steps:
    errors.append(f'frame counter not monotone/complete: device '
                  f'update_steps={device_steps}, expected {max_steps}')
  steps_seq = [e['step'] for e in summaries if 'step' in e]
  if any(b < a for a, b in zip(steps_seq, steps_seq[1:])):
    errors.append('summary step sequence decreased')

  # --- SLO: the watchdog skipped the burst and rolled back at least once.
  hs = health.stats()
  if hs['skipped_steps'] < burst_len:
    errors.append(f"skipped_steps={hs['skipped_steps']} < burst "
                  f'{burst_len}')
  if hs['rollbacks'] < 1:
    errors.append('no automatic checkpoint rollback happened')

  # --- SLO: bounded time-to-recover.
  ttr = _time_to_recover(incidents)
  recover_slo = 60.0
  if ttr is None:
    errors.append('no health_recovered incident (burst never ended?)')
  elif ttr > recover_slo:
    errors.append(f'time-to-recover {ttr}s > SLO {recover_slo}s')

  # --- SLO: the garbage connection was quarantined and the rollback
  # happened, as the shipped objectives judge them; remote unrolls kept
  # flowing.
  verdict = slo_lib.read_verdict(logdir)
  if verdict is None:
    errors.append('no SLO_VERDICT.json from the fault storm '
                  '(slo_engine is default-on)')
  else:
    violated = set(verdict.get('violations') or [])
    results['slo_verdict'] = {'pass': verdict.get('pass'),
                              'violations': sorted(violated)}
    if 'ingest_quarantine_zero' not in violated:
      errors.append('SLO objective ingest_quarantine_zero not '
                    'violated despite the garbage connection')
    if 'rollbacks_zero' not in violated:
      errors.append('SLO objective rollbacks_zero not violated '
                    'despite the NaN-burst rollback')
  if ing.get('unrolls', 0) < 1:
    errors.append('no remote unrolls landed')

  # --- SLO: the interrupted save was recorded without killing the run;
  # the counters reached the summaries.
  if run.checkpointer.save_errors < 1:
    errors.append('interrupted save not recorded in save_errors')
  for tag in ('skipped_steps', 'rollbacks', 'quarantined',
              'fleet_healthy_fraction'):
    if tag not in tags:
      errors.append(f'summary tag {tag!r} missing')

  # --- SLO: zero lock-order inversions over the armed storm, on both
  # surfaces (the checker's count and the durable incident).
  cycles = lock_check.cycles_detected()
  results['lock_order'] = {'armed': lock_check.is_armed(),
                           'cycles': cycles}
  if not lock_check.is_armed():
    errors.append('lock-order detection was not armed for the storm')
  if cycles:
    errors.append(f'{cycles} lock-order inversion(s) detected: '
                  f'{lock_check.cycle_reports()}')
  inversion_incidents = [e for e in incidents
                         if e['kind'] == 'lock_order_inversion']
  if inversion_incidents:
    errors.append(f'lock_order_inversion incidents in the stream: '
                  f'{inversion_incidents}')

  results.update({
      'health': hs,
      'ingest': {k: ing.get(k) for k in
                 ('unrolls', 'quarantined', 'rejected', 'connections')},
      'fleet': fleet_stats,
      'checkpoint': {'save_errors': run.checkpointer.save_errors,
                     'restore_fallbacks':
                         run.checkpointer.restore_fallbacks,
                     'last_good_step':
                         run.checkpointer.last_good_step()},
      'device_update_steps': device_steps,
      'time_to_recover_secs': ttr,
      'incident_kinds': sorted({e['kind'] for e in incidents}),
  })
  return results, errors


def run_overload_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                       device='cuda'):
  """The actor-plane overload and preemption drill; returns (results,
  errors). The fleet at 2x the slot arena under shed admission, a
  slow-learner burst, a real SIGTERM, the drain, the resume."""
  import signal
  import threading

  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch.config import Config
  from scalable_agent_tpu_torch.runtime import faults as faults_lib

  slots = 2
  fleet_size = 2 * slots                  # 2x slot pressure
  resume_steps = 3
  sigterm_after = 8.0 if smoke else 18.0  # the storm's least wall time
  sigterm_deadline = 90.0                 # hard fallback
  drain_budget = 20.0
  cfg_kwargs = _base_kwargs(
      logdir, seed,
      num_actors=fleet_size,
      inference_state_cache=True,         # the slot arena under test
      inference_state_slots=slots,
      inference_admission='shed',
      inference_admission_timeout_secs=0.3,
      fleet_quarantine_after=2,
      preempt_drain_timeout_secs=drain_budget,
      checkpoint_secs=0,
      summary_secs=0)
  cfg = Config(**cfg_kwargs)

  # The slow-learner burst early: the buffer must fill and backpressure
  # engage.
  plan = faults_lib.FaultPlan.storm(
      seed, slow_learner_at=4, slow_learner_len=3,
      slow_learner_secs=0.3 if smoke else 0.6)

  # The real preemption path: SIGTERM from a watcher thread, the handler
  # sets the drain event (the CLI's wiring). The trigger waits for the
  # quarantine ledger (the slotless actors must have spent their respawn
  # budget, paced by jittered backoff), at least `sigterm_after`, with a
  # hard deadline so a quarantine regression is an error, not a hang.
  expected_quarantined = fleet_size - slots
  drain_event = threading.Event()
  old_handler = signal.signal(signal.SIGTERM,
                              lambda s, f: drain_event.set())
  watcher_stop = threading.Event()
  sigterm_wall = [None]

  def _quarantined_count():
    try:
      events = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
    except ValueError:
      return 0  # a line half written mid-poll: the next tick retries
    counts = [int(e.get('count', 0)) for e in events
              if e.get('kind') == 'actor_slots_quarantined']
    return max(counts, default=0)

  def _sigterm_when_quarantined(t_start):
    deadline = t_start + sigterm_deadline
    while not watcher_stop.is_set():
      now = time.monotonic()
      if now >= deadline:
        break
      if (now - t_start >= sigterm_after and
          _quarantined_count() >= expected_quarantined):
        break
      watcher_stop.wait(0.25)
    if not watcher_stop.is_set():
      sigterm_wall[0] = round(time.monotonic() - t_start, 2)
      os.kill(os.getpid(), signal.SIGTERM)

  faults_lib.install(plan)
  t0 = time.monotonic()
  watcher = threading.Thread(target=_sigterm_when_quarantined,
                             args=(t0,), daemon=True)
  crash = None
  run = None
  try:
    watcher.start()
    run = driver.train(cfg, stall_timeout_secs=5.0, drain_event=drain_event,
                       device=device)
  except Exception as e:  # SLO: zero learner crashes at 2x load
    crash = f'{type(e).__name__}: {e}'
  finally:
    faults_lib.clear()
    watcher_stop.set()
    watcher.join(timeout=5.0)
    signal.signal(signal.SIGTERM, old_handler)
  wall_secs = time.monotonic() - t0

  errors = []
  results = {
      'smoke': smoke,
      'seed': seed,
      'device': str(device),
      'slots': slots,
      'fleet_size': fleet_size,
      'sigterm_min_secs': sigterm_after,
      'sigterm_trigger': 'quarantine_ledger',
      'sigterm_wall_secs': sigterm_wall[0],
      'wall_secs': round(wall_secs, 2),
      'crash': crash,
      'fault_plan': plan.stats(),
  }
  if crash is not None:
    errors.append(f'learner crashed under overload: {crash}')
    return results, errors

  # --- SLO: sheds counted, their fraction bounded, the slotless slots
  # quarantined instead of shedding forever.
  snap = run.server.stats()
  fleet_stats = run.fleet.stats()
  sheds = snap['sheds']
  acquires = snap['acquires']
  shed_fraction = sheds / acquires if acquires else 0.0
  if sheds < 1:
    errors.append('no sheds despite fleet at 2x slot capacity')
  if shed_fraction > 0.9:
    errors.append(f'shed fraction {shed_fraction:.2f} > 0.9 — '
                  'admission never converged')
  if fleet_stats['slots_quarantined'] != fleet_size - slots:
    errors.append(
        f"slots_quarantined={fleet_stats['slots_quarantined']}, "
        f'expected {fleet_size - slots} (the slotless actors must '
        'give up, not retry forever)')

  # --- SLO: bounded buffer occupancy under the slow-learner burst.
  buf_stats = run.prefetcher._buffer.stats() if hasattr(
      run.prefetcher, '_buffer') else None
  capacity = max(cfg.queue_capacity_batches * cfg.batch_size,
                 cfg.batch_size)
  if buf_stats is not None:
    bound = capacity + cfg.batch_size - 1  # get_batch's push-back bound
    if buf_stats['high_water'] > bound:
      errors.append(f"buffer high_water {buf_stats['high_water']} > "
                    f'bound {bound} — occupancy not bounded')
    if buf_stats['put_waits'] < 1:
      errors.append('no producer put ever blocked — the slow-learner '
                    'burst exercised no backpressure')

  # --- SLO: the drain landed a verified checkpoint and a manifest within
  # the budget.
  manifest = driver.read_resume_manifest(logdir)
  device_steps = int(run.state.update_steps)
  if manifest is None:
    errors.append('no resume_manifest.json after the SIGTERM drain')
  else:
    if manifest['update_steps'] != device_steps:
      errors.append(f"manifest update_steps {manifest['update_steps']}"
                    f' != device {device_steps}')
    if not manifest['checkpoint_verified']:
      errors.append('drain checkpoint not verified '
                    f"(checkpoint_step={manifest['checkpoint_step']})")
    if manifest['drain_latency_secs'] > drain_budget + 10.0:
      errors.append(f"drain latency {manifest['drain_latency_secs']}s "
                    f'> budget {drain_budget}s (+10s grace)')
    results['drain_latency_secs'] = manifest['drain_latency_secs']

  # --- SLO: the resume from the manifest; the parity gate: the combined
  # step sequence is contiguous across the preemption.
  resume_crash = None
  run2 = None
  try:
    run2 = driver.train(cfg, max_steps=resume_steps, stall_timeout_secs=5.0,
                        device=device)
  except Exception as e:
    resume_crash = f'{type(e).__name__}: {e}'
  if resume_crash is not None:
    errors.append(f'resume from manifest crashed: {resume_crash}')
    final_steps = None
  else:
    final_steps = int(run2.state.update_steps)
    if final_steps != device_steps + resume_steps:
      errors.append(f'resume step accounting broken: {final_steps} != '
                    f'{device_steps} + {resume_steps}')
    if driver.read_resume_manifest(logdir) is not None:
      errors.append('resume manifest not consumed by the resuming run')
  summaries = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
  frame_steps = [e['step'] for e in summaries
                 if e.get('tag') == 'env_frames_per_sec']
  if final_steps is not None and frame_steps != list(
      range(1, final_steps + 1)):
    errors.append('parity gate: combined step sequence is not the '
                  f'contiguous 1..{final_steps} (got {frame_steps})')

  # --- SLO: the counters reached the summary and incident streams.
  tags = {e['tag'] for e in summaries if 'tag' in e}
  for tag in ('inference_sheds', 'slots_quarantined',
              'buffer_high_water', 'drain_latency_secs'):
    if tag not in tags:
      errors.append(f'summary tag {tag!r} missing')
  incidents = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
  kinds = {e['kind'] for e in incidents}
  for kind in ('preempt_drain_start', 'preempt_drain_complete',
               'actor_slots_quarantined'):
    if kind not in kinds:
      errors.append(f'incident kind {kind!r} missing')

  results.update({
      'inference': {k: snap[k] for k in
                    ('acquires', 'sheds', 'admission_waits',
                     'admission_timeouts', 'waitlist_depth')},
      'shed_fraction': round(shed_fraction, 3),
      'slots_quarantined': fleet_stats['slots_quarantined'],
      'buffer': buf_stats,
      'device_update_steps': device_steps,
      'final_update_steps': final_steps,
      'incident_kinds': sorted(kinds),
  })
  return results, errors


# A child's `on_step` that makes each learner step take at least `pace`
# seconds (the child's last argument); 0 leaves the steps as they are.
_PACED_ON_STEP = (
    'import time\n'
    'pace = float(sys.argv[-1])\n'
    'last = [time.monotonic()]\n'
    'def on_step(run, steps_done, metrics):\n'
    '  time.sleep(max(0.0, pace - (time.monotonic() - last[0])))\n'
    '  last[0] = time.monotonic()\n')

# The port's learner steps at the drills' size are far quicker than
# JAX's on a CPU, and two bounds of the drills wait on a clock that a
# quick run outlives: a page burn's profiler request is queued by the
# SLO engine's thread one tick (1 s here) after the burn, and the
# partition storm's half-open probe is reaped after the 2 s idle window.
# The corruption storm's ranks and the partition storm's restarted
# learner pace their steps so, or the run ends before either lands.
CORRUPTION_STEP_PACE_SECS = 0.4
RESTART_STEP_PACE_SECS = 1.0

_INGEST_KEYS = ('unrolls', 'conns_reaped', 'heartbeat_misses',
                'stale_epoch_rejected', 'reattached', 'reconnected',
                'reattach_latency_secs', 'ingest_threads_wedged',
                'unjoined_threads', 'param_subs_dropped', 'quarantined')


def _spawn_learner_child(overrides, max_steps, plan_json, device,
                         pace_secs=0.0):
  """driver.train as a child process, the only way a hard kill
  (learner_crash -> SIGKILL) can be injected and survived. A clean end
  prints 'LEARNER_OK <json>': the final step, LAST_GOOD and the ingest's
  liveness and restart counters (read after the close). Each learner
  step takes at least `pace_secs`."""
  body = (
      'import json, sys\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.runtime import faults\n'
      'faults.install_from_env()\n'
      'from scalable_agent_tpu_torch import driver\n'
      + _PACED_ON_STEP +
      'cfg = Config(**json.loads(sys.argv[1]))\n'
      'run = driver.train(cfg, max_steps=int(sys.argv[2]),\n'
      '                   stall_timeout_secs=10.0, device=sys.argv[3],\n'
      '                   on_step=on_step)\n'
      'ing = run.ingest.stats()\n'
      f'keys = {_INGEST_KEYS!r}\n'
      'out = {"final_steps": int(run.state.update_steps),\n'
      '       "last_good": run.checkpointer.last_good_step(),\n'
      '       "ingest": {k: ing[k] for k in keys}}\n'
      'print("LEARNER_OK " + json.dumps(out), flush=True)\n')
  return subprocess.Popen(
      [sys.executable, '-c', body, json.dumps(overrides), str(max_steps),
       str(device), str(pace_secs)],
      cwd=REPO, env=_child_env(plan_json), stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True)


def run_partition_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                        device='cuda'):
  """The transport partition and hard-crash drill; returns (results,
  errors). The learner as a child that can be SIGKILLed, its actor host
  under partition and delay faults, a harness half-open socket, the
  restart and the reattach."""
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch.runtime import faults as faults_lib
  from scalable_agent_tpu_torch.runtime import remote as remote_lib

  port = _free_port()
  crash_at = 6 if smoke else 10        # consumed batches before kill -9
  resume_steps = 5 if smoke else 10    # learner #2's budget
  idle_timeout = 2.0
  reattach_slo = 45.0
  reap_slo = idle_timeout + 6.0        # idle window + poll/sched grace
  cfg_kwargs = _base_kwargs(
      logdir, seed,
      num_actors=0,                    # remote-fed only: the wire is the
                                       # feed under test
      checkpoint_secs=0,               # LAST_GOOD trails the crash point
      summary_secs=0,
      remote_actor_port=port,
      remote_heartbeat_secs=0.5,
      remote_conn_idle_timeout_secs=idle_timeout,
      actor_reconnect_secs=240.0)      # must cover the restart gap

  learner_plan = faults_lib.FaultPlan.storm(
      seed, learner_crash_at=crash_at)
  # Actor side: latency early, then a blackhole longer than the idle
  # window (the learner must reap the silent connection; the client
  # finds the reaped socket when the partition heals and reconnects).
  # Indices count _rpc events (handshake, unrolls, pings).
  actor_plan = faults_lib.FaultPlan.storm(
      seed, conn_delay=[3, 5], conn_delay_secs=0.15,
      conn_partition_at=8,
      conn_partition_secs=idle_timeout + 2.0)

  child_overrides = {k: v for k, v in cfg_kwargs.items()
                     if k not in ('logdir', 'remote_actor_port')}
  child_overrides.update(logdir=logdir + '/actor_child', num_actors=2)
  learner_overrides = dict(cfg_kwargs)

  actor = _spawn_actor_child(f'127.0.0.1:{port}', child_overrides,
                             actor_plan.to_json(), device)
  t0 = time.monotonic()
  errors = []
  results = {
      'smoke': smoke,
      'seed': seed,
      'device': str(device),
      'crash_at': crash_at,
      'resume_steps': resume_steps,
      'fault_plan': learner_plan.stats(),
  }
  learner2_out = ''
  actor_out = ''
  try:
    # --- Phase 1: learner #1 trains on the remote feed under the
    # delay/partition faults until the scheduled kill -9.
    learner1 = _spawn_learner_child(learner_overrides, max_steps=200,
                                    plan_json=learner_plan.to_json(),
                                    device=device)
    try:
      out1, _ = learner1.communicate(timeout=60 if smoke else 120)
    except subprocess.TimeoutExpired:
      learner1.kill()
      out1 = learner1.communicate()[0]
      errors.append('learner #1 never hit its scheduled kill -9')
    errors += _device_errors('learner #1', out1)
    results['learner1_returncode'] = learner1.returncode
    results['learner1_tail'] = (out1 or '')[-600:]
    if learner1.returncode != -9:
      errors.append(
          f'learner #1 exited {learner1.returncode}, expected SIGKILL '
          '(-9) from the learner_crash fault')
    if 'LEARNER_OK' in (out1 or ''):
      errors.append('learner #1 finished cleanly — the hard-kill '
                    'never fired')

    # --- Phase 2: the learner restarts on the same logdir and port; the
    # actor child, inside its reconnect window, must reattach.
    learner2 = _spawn_learner_child(learner_overrides,
                                    max_steps=resume_steps, plan_json='',
                                    device=device,
                                    pace_secs=RESTART_STEP_PACE_SECS)
    # Meanwhile a harness-owned half-open peer (a partial frame, then
    # silence): the reaper closes it, so the probe's recv returns.
    half_open_reaped_secs = None
    try:
      deadline = time.monotonic() + (90 if smoke else 150)
      probe = None
      probe_t0 = None
      while learner2.poll() is None and time.monotonic() < deadline:
        if probe is None:
          try:
            probe = socket.create_connection(('127.0.0.1', port),
                                             timeout=2.0)
            probe.sendall(remote_lib._LEN.pack(1000) + b'\x00'
                          + b'half-open partial frame')
            probe.settimeout(max(reap_slo, 5.0))
            probe_t0 = time.monotonic()
          except OSError:
            probe = None
            time.sleep(0.5)
            continue
        if half_open_reaped_secs is None:
          try:
            if probe.recv(1) == b'':
              half_open_reaped_secs = time.monotonic() - probe_t0
          except socket.timeout:
            pass
          except OSError:
            half_open_reaped_secs = time.monotonic() - probe_t0
        else:
          time.sleep(0.2)
      try:
        learner2_out, _ = learner2.communicate(timeout=60)
      except subprocess.TimeoutExpired:
        learner2.kill()
        learner2_out = learner2.communicate()[0]
        errors.append('learner #2 (restart) hung')
      if probe is not None:
        probe.close()
    finally:
      if learner2.poll() is None:
        learner2.kill()
        learner2.communicate()
    errors += _device_errors('learner #2', learner2_out)
    results['learner2_tail'] = (learner2_out or '')[-600:]
    results['half_open_reaped_secs'] = (
        round(half_open_reaped_secs, 2)
        if half_open_reaped_secs is not None else None)

    # --- The actor child: the final graceful close's 'bye' ends it.
    try:
      actor_out, _ = actor.communicate(timeout=30)
    except subprocess.TimeoutExpired:
      actor.terminate()
      try:
        actor_out, _ = actor.communicate(timeout=10)
      except subprocess.TimeoutExpired:
        actor.kill()
        actor_out = actor.communicate()[0]
      errors.append('actor child did not exit on the learner\'s '
                    'final bye (possible deadlocked pump)')
    results['actor_tail'] = (actor_out or '')[-600:]
    errors += _device_errors('the actor child', actor_out)
    if 'CHILD_OK' not in (actor_out or ''):
      errors.append('actor child did not report CHILD_OK')
  finally:
    if actor.poll() is None:
      actor.kill()
      actor.communicate()

  # --- SLOs from learner #2's report.
  report = None
  for line in (learner2_out or '').splitlines():
    if line.startswith('LEARNER_OK '):
      report = json.loads(line[len('LEARNER_OK '):])
  if report is None:
    errors.append('learner #2 produced no LEARNER_OK report')
    results['wall_secs'] = round(time.monotonic() - t0, 2)
    return results, errors
  ing = report['ingest']
  restored = report['final_steps'] - resume_steps
  results.update({
      'learner2': report,
      'restored_step': restored,
  })
  # The restore came from the LAST_GOOD ladder, short of the crash point,
  # and the resumed run trained its full budget on top.
  if not 1 <= restored <= crash_at:
    errors.append(f'restored step {restored} outside [1, {crash_at}] '
                  '— restore-from-LAST_GOOD broken')
  if report['last_good'] != report['final_steps']:
    errors.append(
        f"learner #2's final save not LAST_GOOD: {report['last_good']}"
        f" != {report['final_steps']}")
  # The reattach: counted, timed, bounded.
  if ing['reattached'] < 1:
    errors.append('actor child never counted as reattached (no '
                  'cross-epoch hello at learner #2)')
  elif ing['reattach_latency_secs'] > reattach_slo:
    errors.append(f"fleet re-attach took {ing['reattach_latency_secs']}"
                  f's > SLO {reattach_slo}s')
  if ing['unrolls'] < resume_steps * cfg_kwargs['batch_size']:
    errors.append(f"learner #2 ingested only {ing['unrolls']} unrolls "
                  f'for {resume_steps} steps — the re-attached fleet '
                  'did not feed it')
  # Zero stale-incarnation unrolls crossed the restart.
  if ing['stale_epoch_rejected'] != 0:
    errors.append(f"stale_epoch_rejected={ing['stale_epoch_rejected']}"
                  ' != 0 across the restart')
  # The half-open peer was reaped within budget.
  if half_open_reaped_secs is None:
    errors.append('harness half-open connection never reaped')
  elif half_open_reaped_secs > reap_slo:
    errors.append(f'half-open reap took {half_open_reaped_secs:.1f}s '
                  f'> budget {reap_slo}s')
  if ing['conns_reaped'] < 1:
    errors.append('learner #2 counted no reaped connections')
  # Zero wedged or leaked threads at exit.
  if ing['ingest_threads_wedged'] != 0:
    errors.append(f"ingest_threads_wedged="
                  f"{ing['ingest_threads_wedged']} != 0 at exit")
  if ing['unjoined_threads'] != 0:
    errors.append(f"unjoined_threads={ing['unjoined_threads']} != 0 "
                  'at close')

  # Each incarnation's summary steps never decrease; the one allowed dip
  # is the crash-replay boundary.
  summaries = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
  steps_seq = [e['step'] for e in summaries if 'step' in e]
  dips = sum(1 for a, b in zip(steps_seq, steps_seq[1:]) if b < a)
  if dips > 1:
    errors.append(f'summary step sequence dipped {dips} times — only '
                  'the crash-replay boundary may dip once')
  tags = {e['tag'] for e in summaries if 'tag' in e}
  for tag in ('remote_conns_reaped', 'remote_heartbeat_misses',
              'param_subs_dropped', 'ingest_threads_wedged',
              'remote_reattached', 'remote_reattach_latency_secs',
              'remote_stale_epoch_rejected'):
    if tag not in tags:
      errors.append(f'summary tag {tag!r} missing')

  # Learner #2 judged itself under the shipped objectives: the half-open
  # peer it reaped burns conns_reaped_zero; the reattach was a clean
  # re-handshake, so stale_epoch_zero holds.
  verdict = slo_lib.read_verdict(logdir)
  if verdict is None:
    errors.append('learner #2 wrote no SLO_VERDICT.json')
  else:
    violated = set(verdict.get('violations') or [])
    results['slo_verdict'] = {'pass': verdict.get('pass'),
                              'violations': sorted(violated)}
    if 'conns_reaped_zero' not in violated:
      errors.append('SLO objective conns_reaped_zero not violated '
                    'despite the reaped half-open peer')
    if 'stale_epoch_zero' in violated:
      errors.append('SLO objective stale_epoch_zero violated — '
                    'stale-incarnation unrolls crossed the restart')

  # The trace plane across both incarnations: batch records, and the
  # remote hops' spans.
  try:
    trace_summary = trace_report.summarize(
        trace_report.load_traces(logdir),
        trace_report.load_incidents(logdir))
    results['trace'] = {
        'batches': trace_summary['batches'],
        'unrolls': trace_summary['unrolls'],
        'hops': [row['hop'] for row in trace_summary['hops']],
        'policy_lag_p99': trace_summary['policy_lag']['p99'],
        'timeline_seconds': len(trace_summary['timeline']),
    }
    if trace_summary['batches'] == 0:
      errors.append('telemetry: zero trace batch records across the '
                    'partition storm (tracing is default-on)')
    hop_set = set(results['trace']['hops'])
    for hop in ('send->wire', 'wire->commit', 'serve->step'):
      if hop not in hop_set:
        errors.append(f'telemetry: remote hop {hop!r} missing from '
                      'the storm trace — spans not crossing the wire')
  except Exception as e:  # diagnostics only
    errors.append(f'trace report over the storm logdir failed: {e!r}')

  results['wall_secs'] = round(time.monotonic() - t0, 2)
  return results, errors


def _corruption_rank_body():
  """What each of the corruption storm's two ranks runs: join the gloo
  group, train, write its report as JSON. argv: rank, world, group port,
  config JSON, the learner's fault plan JSON ('' for none), max_steps,
  device, report path, the least seconds per learner step."""
  return (
      'import json, sys\n'
      'import torch\n'
      'torch.set_num_threads(1)\n'
      'from scalable_agent_tpu_torch import driver\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.parallel import distributed\n'
      'from scalable_agent_tpu_torch.runtime import faults\n'
      'rank, world, port = (int(a) for a in sys.argv[1:4])\n'
      'cfg = Config(**json.loads(sys.argv[4]),\n'
      '             coordinator_address=f"localhost:{port}",\n'
      '             num_processes=world, process_id=rank)\n'
      'device = sys.argv[7]\n'
      'distributed.maybe_initialize(cfg, backend="gloo", device=device,\n'
      '                             timeout_secs=120)\n'
      'if sys.argv[5]:\n'
      '  faults.install(faults.FaultPlan.from_json(sys.argv[5]))\n'
      + _PACED_ON_STEP +
      'report = {}\n'
      'try:\n'
      '  run = driver.train(cfg, max_steps=int(sys.argv[6]),\n'
      '                     stall_timeout_secs=10.0, device=device,\n'
      '                     on_step=on_step)\n'
      '  report = {\n'
      '      "update_steps": int(run.state.update_steps),\n'
      '      "device": str(next(iter(run.state.params.values())).device),\n'
      '      "health": run.health.stats(),\n'
      '      "ingest": run.ingest.stats() if run.ingest else None,\n'
      '      "last_good": run.checkpointer.last_good_step(),\n'
      '      "digest_fallbacks": run.checkpointer.digest_fallbacks,\n'
      '      "sdc_armed": run.mesh is not None,\n'
      '      "fault_plan": faults.active().stats() if faults.active()\n'
      '                    else None}\n'
      'except Exception as e:\n'
      '  report = {"crash": f"{type(e).__name__}: {e}"}\n'
      'finally:\n'
      '  faults.clear()\n'
      '  with open(sys.argv[8], "w") as f:\n'
      '    json.dump(report, f, default=str)\n'
      '  distributed.shutdown(wait=False)\n')


def _run_ranks(cfg_kwargs, plans, max_steps, device, outdir, tag,
               timeout=300):
  """The two gloo ranks of one corruption-storm phase, sharing `device`
  (a bare 'cuda' is card 0 for both: NCCL refuses two ranks on one
  card, gloo does not). `cfg_kwargs` is a per-rank list. Returns the
  ranks' reports (a crash or a missing report is one)."""
  if str(device) == 'cuda':
    device = 'cuda:0'
  port = _free_port()
  procs = []
  paths = []
  for rank in range(2):
    path = os.path.join(outdir, f'{tag}_rank{rank}.json')
    paths.append(path)
    procs.append(subprocess.Popen(
        [sys.executable, '-c', _corruption_rank_body(), str(rank), '2',
         str(port), json.dumps(cfg_kwargs[rank]), plans[rank],
         str(max_steps), str(device), path,
         str(CORRUPTION_STEP_PACE_SECS)],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
  outs = []
  deadline = time.monotonic() + timeout
  for proc in procs:
    try:
      outs.append(proc.communicate(
          timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
      proc.kill()
      outs.append(proc.communicate()[0] + '\n(killed: phase timeout)')
  reports = []
  for rank, (proc, path, out) in enumerate(zip(procs, paths, outs)):
    with open(os.path.join(outdir, f'{tag}_rank{rank}.log'), 'w') as f:
      f.write(out or '')
    try:
      with open(path) as f:
        report = json.load(f)
    except (OSError, ValueError):
      report = {'crash': f'rank {rank} exited {proc.returncode} with no '
                         f'report: {(out or "")[-600:]}'}
    if _NO_CUDA in (out or ''):
      report['crash'] = f'rank {rank} was asked for CUDA and has none'
    report['tail'] = (out or '')[-400:]
    reports.append(report)
  return reports


def run_corruption_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                         device='cuda'):
  """The data-plane integrity drill; returns (results, errors). Phase 1:
  two gloo ranks (the SDC sentinel cross-checks the data replicas, one
  per rank), each fed by its own actor-host child (every rank with a
  remote_actor_port binds its own ingest): rank 0's under wire_bitflip
  and publish_corrupt, and replica_divergence on both ranks. Phase 2:
  the newest committed step is bit-rotted on disk; the resuming group
  must refuse it on digests and restore the verified step before it."""
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch.runtime import faults as faults_lib

  errors = []
  results = {'smoke': smoke, 'seed': seed, 'device': str(device),
             'ranks': 2}
  ports = [_free_port(), _free_port()]
  phase1_steps = 14 if smoke else 30
  resume_steps = 3
  sdc_burst = 3                 # == health_rollback_after: one rollback
  sdc_at = 6                    # after checkpoints exist
  bitflips = [4, 9]             # the 5th and 10th unroll sends
  recover_slo = 60.0            # detection -> healthy, seconds
  cfg_kwargs = _base_kwargs(
      logdir, seed,
      num_actors=0,             # remote-fed: the wire is the feed
      checkpoint_secs=0,        # a save every window: LAST_GOOD fresh
      summary_secs=0,
      remote_heartbeat_secs=0.5,
      remote_conn_idle_timeout_secs=10.0,
      remote_publish_secs=0.1,  # publishes flow: the corrupt-blob leg
      actor_reconnect_secs=120.0,
      health_rollback_after=sdc_burst,
      health_min_window=4,
      # Under a group the save decision is rank 0's, taken every
      # checkpoint_check_every_steps: every step here, as JAX's one
      # process saves every window, so the burst has a rollback target.
      checkpoint_check_every_steps=1)
  # Each rank binds its own ingest. Rank 1 takes no SLO captures: both
  # ranks' engines burn the same objectives, and their captures would
  # write the same files under the shared logdir's diagnostics/ (JAX's
  # one process takes one set).
  rank_kwargs = [dict(cfg_kwargs, remote_actor_port=ports[0]),
                 dict(cfg_kwargs, remote_actor_port=ports[1],
                      slo_capture=False)]

  # Rank 0: blobs 2..7 ship with a post-digest bit flip (a run, so the
  # child's refetch meets a corrupt one before a clean publish supersedes
  # it). Both ranks: the SDC probe perturbs one replica's fingerprint
  # lane for `sdc_burst` health checks from step sdc_at + 1.
  learner_plan = faults_lib.FaultPlan.storm(
      seed, publish_corrupt_at=2, publish_corrupt_len=6,
      replica_divergence_at=sdc_at, replica_divergence_len=sdc_burst)
  rank1_plan = faults_lib.FaultPlan.storm(
      seed, replica_divergence_at=sdc_at, replica_divergence_len=sdc_burst)
  # Rank 0's child: single-bit flips that still parse, made after the
  # CRC trailer: the ('corrupt', crc) reply and a re-send, not the
  # quarantine.
  child_plan = faults_lib.FaultPlan(
      [faults_lib.Fault('wire_bitflip', i, 'flip') for i in bitflips],
      seed=seed)

  child_overrides = {k: v for k, v in cfg_kwargs.items() if k != 'logdir'}
  children = [
      _spawn_actor_child(
          f'127.0.0.1:{ports[r]}',
          dict(child_overrides, logdir=f'{logdir}/actor_child{r}',
               num_actors=2),
          child_plan.to_json() if r == 0 else None, device)
      for r in range(2)]

  t0 = time.monotonic()
  reports = _run_ranks(rank_kwargs,
                       [learner_plan.to_json(), rank1_plan.to_json()],
                       phase1_steps, device, logdir, 'phase1')
  child_outs = []
  for r, child in enumerate(children):
    try:
      child_outs.append(child.communicate(timeout=60)[0] or '')
    except subprocess.TimeoutExpired:
      child.kill()
      child_outs.append(child.communicate()[0] or '')
      errors.append(f'actor child {r} did not exit on the final bye')
    errors += _device_errors(f'actor child {r}', child_outs[-1])
  child_out = child_outs[0]
  results.update({
      'phase1_steps': phase1_steps,
      'fault_plan': reports[0].get('fault_plan'),
      'rank1_fault_plan': reports[1].get('fault_plan'),
      'child_plan': child_plan.stats(),
      'child_tail': child_out[-800:],
  })
  crashed = [f"rank {r}: {rep['crash']}" for r, rep in enumerate(reports)
             if 'crash' in rep]
  if crashed:
    errors.append(f'learner crashed under corruption: {crashed}')
    results['rank_tails'] = [rep.get('tail') for rep in reports]
    return results, errors

  rep = reports[0]
  ing = rep['ingest']
  hs = rep['health']
  device_steps = rep['update_steps']
  results.update({
      'ingest': {k: ing.get(k) for k in
                 ('unrolls', 'wire_crc_rejected',
                  'publish_digest_rejected', 'quarantined',
                  'discarded_frames', 'discarded_bytes')},
      'health': hs,
      'rank1_health': reports[1]['health'],
      'device_update_steps': device_steps,
      'rank_devices': [r['device'] for r in reports],
  })
  if not all(r['sdc_armed'] for r in reports):
    errors.append('the ranks trained without a mesh: no SDC sentinel')

  # --- SLO: zero corrupt unrolls committed: every scheduled flip was
  # refused before the buffer put, and re-sent clean (the group trained
  # its full budget).
  if ing.get('wire_crc_rejected', 0) != len(bitflips):
    errors.append(f"wire_crc_rejected={ing.get('wire_crc_rejected')}"
                  f' != scheduled bit flips {len(bitflips)}')
  if any(r['update_steps'] != phase1_steps for r in reports):
    errors.append(f'learner trained {[r["update_steps"] for r in reports]}'
                  f' steps, expected {phase1_steps} — the re-sent unrolls '
                  'did not land')
  if 'self-quarantin' in child_out.lower():
    errors.append('actor child self-quarantined — a re-sent unroll '
                  'failed its CRC twice (injection leaked into the '
                  'retry?)')
  for r, out in enumerate(child_outs):
    if 'CHILD_OK' not in out:
      errors.append(f'actor child {r} did not report CHILD_OK')

  # --- SLO: zero corrupt publishes installed: the client refused the
  # digest-mismatched blob (reported back on its retry fetch), kept
  # feeding, and refetched a clean one.
  if ing.get('publish_digest_rejected', 0) < 1:
    errors.append('no publish_digest_rejected recorded — the corrupt '
                  'blob was never refused (or never fetched)')
  if 'digest_rejections=0' in child_out:
    errors.append('child INTEGRITY_REPORT shows zero digest '
                  'rejections')

  # --- SLO: the divergent replica was detected, escalated and rolled
  # back within budget, on every rank.
  for r, report in enumerate(reports):
    if report['health'].get('sdc_mismatches', 0) < sdc_burst:
      errors.append(f"rank {r}: sdc_mismatches="
                    f"{report['health'].get('sdc_mismatches')} < burst "
                    f'{sdc_burst}')
    if report['health'].get('rollbacks', 0) < 1:
      errors.append(f'rank {r}: no rollback despite the SDC burst '
                    'crossing K')
  incidents = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
  kinds = {e['kind'] for e in incidents}
  for kind in ('fault_replica_divergence', 'sdc_replica_mismatch',
               'rollback'):
    if kind not in kinds:
      errors.append(f'incident kind {kind!r} missing')
  ttr = _time_to_recover(incidents)
  if ttr is None:
    errors.append('no health_recovered after the SDC burst')
  elif ttr > recover_slo:
    errors.append(f'SDC time-to-recover {ttr}s > SLO {recover_slo}s')
  results['time_to_recover_secs'] = ttr

  # --- SLO: the integrity counters reach summaries.jsonl.
  summaries = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
  tags = {e['tag'] for e in summaries if 'tag' in e}
  for tag in ('wire_crc_rejected', 'publish_digest_rejected',
              'sdc_replica_mismatches', 'ckpt_digest_fallbacks'):
    if tag not in tags:
      errors.append(f'summary tag {tag!r} missing')

  # --- The shipped objectives judge the storm: a failing verdict naming
  # the damage, the benign path clean (a parseable flip takes the
  # corrupt reply, never the quarantine), and each page burn's captures.
  # Read before phase 2, whose run writes its own verdict.
  verdict = slo_lib.read_verdict(logdir)
  if verdict is None:
    errors.append('phase 1 wrote no SLO_VERDICT.json (slo_engine is '
                  'default-on)')
  else:
    results['slo_verdict'] = {
        'pass': verdict.get('pass'),
        'violations': verdict.get('violations'),
        'captures': sorted((verdict.get('captures') or {})),
    }
    if verdict.get('pass'):
      errors.append('SLO verdict PASSED a corruption storm — the '
                    'default objective set judged injected damage '
                    'as healthy')
    violated = set(verdict.get('violations') or [])
    for objective in ('wire_crc_rejected_zero', 'sdc_mismatch_zero'):
      if objective not in violated:
        errors.append(f'SLO objective {objective!r} not violated '
                      'despite the injected damage')
    if 'ingest_quarantine_zero' in violated:
      errors.append('ingest_quarantine_zero violated — a parseable '
                    'bit flip must take the benign corrupt path, '
                    'not the quarantine')
    captures = verdict.get('captures') or {}
    for objective in ('wire_crc_rejected_zero', 'sdc_mismatch_zero'):
      cap = captures.get(objective)
      if cap is None:
        errors.append(f'no triggered capture for page objective '
                      f'{objective!r}')
        continue
      for kind in ('flight', 'trace_slice', 'profile'):
        path = cap.get(kind)
        if not path or not os.path.exists(path):
          errors.append(f'capture artifact {kind!r} for '
                        f'{objective!r} missing ({path!r})')
      prof = cap.get('profile')
      if prof and os.path.isdir(prof) and not any(os.scandir(prof)):
        errors.append(f'profiler capture dir for {objective!r} is '
                      'empty — the profiler never wrote a trace')
    if 'slo_violation' not in kinds:
      errors.append('no slo_violation incident recorded')

  # --- Phase 2: bit-rot the newest committed step (it carries LAST_GOOD:
  # only the digest ladder can refuse it), then resume: training comes
  # back from the verified step before it.
  rotted_step = rep['last_good']
  if rotted_step is None:
    errors.append('phase 1 left no LAST_GOOD step to rot')
    return results, errors
  faults_lib.bitrot_checkpoint_step(
      os.path.join(logdir, 'checkpoints'), rotted_step, seed=seed)
  resume_kwargs = dict(cfg_kwargs, num_actors=2, remote_actor_port=0)
  reports2 = _run_ranks([resume_kwargs, resume_kwargs], ['', ''],
                        resume_steps, device, logdir, 'phase2')
  crashed = [f"rank {r}: {rep2['crash']}" for r, rep2 in enumerate(reports2)
             if 'crash' in rep2]
  if crashed:
    errors.append(f'resume past the bit-rotted step crashed: {crashed}')
  else:
    final_steps = reports2[0]['update_steps']
    restored = final_steps - resume_steps
    results.update({
        'rotted_step': rotted_step,
        'restored_step': restored,
        'digest_fallbacks': reports2[0]['digest_fallbacks'],
    })
    if reports2[0]['digest_fallbacks'] < 1:
      errors.append('resume recorded no digest fallback — the '
                    'bit-rotted step was restored as if clean')
    if not 0 <= restored < rotted_step:
      errors.append(f'resume restored step {restored}, expected a '
                    f'verified step BELOW the rotted {rotted_step}')
  results['wall_secs'] = round(time.monotonic() - t0, 2)
  return results, errors


def _run_controller_phase(logdir, mode, spec_path, policy_path, smoke, seed,
                          max_seconds, device):
  """One controller-storm run (mode 'act' or 'observe'): a fleet of 4
  starts with 2 slots parked; a watcher doubles the offered load mid-run
  by unparking them, and their first spawn is a scripted env flake, so
  both new slots quarantine and only a rehabilitation can reclaim them.
  Returns (results, errors)."""
  import threading

  from scalable_agent_tpu_torch import controller as controller_lib
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch.config import Config

  fleet_size = 4
  initial_size = 2
  surge_warm_secs = 3.0
  cfg = Config(**_base_kwargs(
      logdir, seed,
      num_actors=fleet_size,
      checkpoint_secs=0,
      summary_secs=0,
      # The surge slots give up fast (the first respawn is the scripted
      # flake; the second attempt quarantines), so the controller's
      # rehabilitation is the only way back.
      fleet_quarantine_after=1,
      fleet_probation_secs=0.2,
      controller=mode,
      controller_policy=policy_path,
      controller_interval_secs=0.25,
      slo_spec=spec_path,
      slo_capture=False))       # the verdict is the record here

  fleet_holder = []
  flakes = {i: 1 for i in range(initial_size, fleet_size)}

  def fleet_factory(cfg2, policy, buffer, levels, initial_state_fn):
    fleet = driver.make_fleet(cfg2, policy, buffer, levels,
                              initial_state_fn)
    orig_make = fleet._make_actor

    def flaky_make(i):
      if flakes.get(i, 0) > 0:
        flakes[i] -= 1
        raise RuntimeError(f'storm surge: scripted env flake on '
                           f'slot {i}')
      return orig_make(i)

    fleet._make_actor = flaky_make
    fleet.set_target_size(initial_size)  # spin up at half load
    fleet_holder.append(fleet)
    return fleet

  watcher_stop = threading.Event()
  surge_wall = [None]

  def _surge(t_start):
    # Real training traffic first (the first summary row), so the slow
    # burn window holds healthy samples before the surge.
    deadline = t_start + 60.0
    while not watcher_stop.is_set() and time.monotonic() < deadline:
      try:
        rows = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
      except ValueError:
        rows = []
      if fleet_holder and any(r.get('tag') == 'env_frames_per_sec'
                              for r in rows):
        break
      watcher_stop.wait(0.2)
    if watcher_stop.is_set() or not fleet_holder:
      return
    watcher_stop.wait(surge_warm_secs)
    if watcher_stop.is_set():
      return
    surge_wall[0] = round(time.monotonic() - t_start, 2)
    fleet_holder[0].set_target_size(fleet_size)

  t0 = time.monotonic()
  watcher = threading.Thread(target=_surge, args=(t0,), daemon=True)
  crash = None
  run = None
  try:
    watcher.start()
    run = driver.train(cfg, max_seconds=max_seconds, stall_timeout_secs=5.0,
                       fleet_factory=fleet_factory, device=device)
  except Exception as e:  # SLO: zero learner crashes
    crash = f'{type(e).__name__}: {e}'
  finally:
    watcher_stop.set()
    watcher.join(timeout=5.0)

  errors = []
  results = {
      'mode': mode,
      'fleet_size': fleet_size,
      'initial_size': initial_size,
      'surge_wall_secs': surge_wall[0],
      'wall_secs': round(time.monotonic() - t0, 2),
      'crash': crash,
  }
  if crash is not None:
    errors.append(f'[{mode}] learner crashed under the load surge: '
                  f'{crash}')
    return results, errors
  if surge_wall[0] is None:
    errors.append(f'[{mode}] the load surge never fired (no training '
                  'traffic within 60s?)')
    return results, errors

  verdict = slo_lib.read_verdict(logdir)
  clog = controller_lib.read_log(logdir)
  fleet_stats = run.fleet.stats()
  results.update({
      'slo_verdict': None if verdict is None else {
          'pass': verdict.get('pass'),
          'violations': verdict.get('violations')},
      'controller_counts': None if clog is None else clog['counts'],
      'slots_quarantined': fleet_stats['slots_quarantined'],
      'slots_rehabilitated': fleet_stats['slots_rehabilitated'],
      'admission': run.server.admission,
  })
  if verdict is None:
    errors.append(f'[{mode}] no SLO_VERDICT.json')
    return results, errors
  if clog is None:
    errors.append(f'[{mode}] no CONTROLLER_LOG.json')
    return results, errors
  actions = clog.get('actions') or []
  escalations = [a for a in actions if a['kind'] == 'escalate']
  reverts = [a for a in actions if a['kind'] == 'revert']
  results['actions'] = [
      {k: a.get(k) for k in ('kind', 'actuator', 'from', 'to',
                             'applied')} for a in actions]

  if mode == 'act':
    # --- The headline: the verdict stays green with no human turning a
    # knob; the quorum's margin triggered the controller before it burned.
    if not verdict.get('pass'):
      errors.append(f"[act] SLO verdict FAILED despite the "
                    f"controller: {verdict.get('violations')}")
    quorum = (verdict.get('objectives') or {}).get(
        'fleet_healthy_fraction') or {}
    if quorum.get('burns', 0) != 0:
      errors.append(f"[act] fleet_healthy_fraction burned "
                    f"{quorum.get('burns')}x — the controller acted "
                    'too late (the storm gives it the slow-window '
                    'confirmation as its reaction budget)')
    # --- The escalations and the later reverts, all applied.
    if len(escalations) < 2:
      errors.append(f'[act] expected >= 2 escalations (admission + '
                    f'fleet grow), got {len(escalations)}')
    if len(reverts) < 2:
      errors.append(f'[act] expected >= 2 reverts, got '
                    f'{len(reverts)}')
    if not all(a['applied'] for a in actions):
      errors.append('[act] an action failed to apply: '
                    f'{[a for a in actions if not a["applied"]]}')
    if escalations and reverts:
      if min(a['wall_time'] for a in reverts) <= \
         min(a['wall_time'] for a in escalations):
        errors.append('[act] a revert preceded the first escalation')
    grew = [a for a in escalations if a['actuator'] == 'fleet_size']
    if not grew:
      errors.append('[act] no fleet_size escalation — the '
                    'quarantined surge slots were never reclaimed')
    # --- The grow move reclaimed the quarantined slots through
    # probation, and the reverts put every knob back.
    if fleet_stats['slots_rehabilitated'] != fleet_size - initial_size:
      errors.append(
          f"[act] slots_rehabilitated="
          f"{fleet_stats['slots_rehabilitated']}, expected "
          f'{fleet_size - initial_size}')
    if fleet_stats['slots_quarantined'] != 0:
      errors.append(f"[act] slots_quarantined="
                    f"{fleet_stats['slots_quarantined']} at exit — "
                    'rehabilitation did not reclaim the surge slots')
    if run.server.admission != 'block':
      errors.append(f'[act] admission not reverted to block '
                    f'(got {run.server.admission!r})')
    # --- The audit trail: incidents and summary scalars.
    incidents = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
    kinds = {e['kind'] for e in incidents}
    if 'controller_action' not in kinds:
      errors.append('[act] no controller_action incident recorded')
    summaries = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
    tags = {e['tag'] for e in summaries if 'tag' in e}
    for tag in ('controller_actions', 'controller_reverts'):
      if tag not in tags:
        errors.append(f'[act] summary tag {tag!r} missing')
  else:
    # --- The dry run records the violation the acting run avoided: the
    # same surge, nothing applied, the quorum burns; the intended moves
    # are logged unapplied.
    if verdict.get('pass'):
      errors.append('[observe] SLO verdict PASSED — the surge did '
                    'not produce the violation the actuated run is '
                    'credited with avoiding')
    if 'fleet_healthy_fraction' not in (
        verdict.get('violations') or []):
      errors.append('[observe] fleet_healthy_fraction not among the '
                    f"violations: {verdict.get('violations')}")
    if not actions:
      errors.append('[observe] the dry-run controller logged no '
                    'intended actions')
    if any(a['applied'] for a in actions):
      errors.append('[observe] an observe-mode action was APPLIED: '
                    f'{[a for a in actions if a["applied"]]}')
    if fleet_stats['slots_rehabilitated'] != 0:
      errors.append('[observe] slots were rehabilitated in observe '
                    'mode')
    if fleet_stats['slots_quarantined'] != fleet_size - initial_size:
      errors.append(
          f"[observe] slots_quarantined="
          f"{fleet_stats['slots_quarantined']}, expected the surge's "
          f'{fleet_size - initial_size} to stay quarantined')
  return results, errors


def run_controller_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                         device='cuda'):
  """The self-healing control-plane drill; returns (results, errors).
  Two phases on sibling logdirs: acting (the verdict stays green, the
  log shows the escalations and the later reverts, the surge slots are
  rehabilitated) and observing (the same storm fails the quorum)."""
  # The storm's objectives: the shipped fleet_healthy_fraction with this
  # 4-slot fleet's quorum floor (the --slo_spec mechanism), and the
  # rollbacks pin. The fast window catches the surge in ~1.5 s; the slow
  # window confirms only after seconds of sustained violation, which is
  # the controller's reaction budget.
  spec = [
      # Target 0.7 on 4 slots: the quorum steps 0.5 (surge) -> 0.75 (one
      # rehabilitated) -> 1.0; the trigger band must cover 0.75, or the
      # escalation wedges inside the hysteresis band.
      dict(name='fleet_healthy_fraction',
           metric='driver/fleet_healthy_fraction',
           comparison='>=', target=0.7, severity='page',
           fast_window_secs=1.5, slow_window_secs=30.0,
           description='storm-tightened fleet quorum'),
      dict(name='rollbacks_zero', metric='health/rollbacks',
           kind='rate', comparison='==', target=0.0,
           severity='ticket', fast_window_secs=1.5,
           slow_window_secs=30.0,
           description='no rollbacks under the surge'),
  ]
  policy = [
      dict(objective='fleet_healthy_fraction', actuator='admission',
           to='shed', revert_to='block', trigger_margin=0.1,
           clear_margin=0.25, cooldown_secs=1.0,
           description='quorum thinning under surge: stop parking '
                       'admissions'),
      dict(objective='fleet_healthy_fraction', actuator='fleet_size',
           direction='up', step=1, trigger_margin=0.1,
           clear_margin=0.25, cooldown_secs=0.4,
           description='quorum thinning: grow the fleet '
                       '(rehabilitate quarantined slots)'),
  ]
  os.makedirs(logdir, exist_ok=True)
  spec_path = os.path.join(logdir, 'storm_slo_spec.json')
  policy_path = os.path.join(logdir, 'storm_controller_policy.json')
  with open(spec_path, 'w') as f:
    json.dump(spec, f, indent=2)
  with open(policy_path, 'w') as f:
    json.dump(policy, f, indent=2)

  t0 = time.monotonic()
  errors = []
  results = {'smoke': smoke, 'seed': seed, 'device': str(device)}
  act_dir = os.path.join(logdir, 'act')
  obs_dir = os.path.join(logdir, 'observe')
  os.makedirs(act_dir)
  os.makedirs(obs_dir)
  results['act'], act_errors = _run_controller_phase(
      act_dir, 'act', spec_path, policy_path, smoke, seed,
      max_seconds=14.0 if smoke else 22.0, device=device)
  errors += act_errors
  results['observe'], obs_errors = _run_controller_phase(
      obs_dir, 'observe', spec_path, policy_path, smoke, seed,
      max_seconds=12.0 if smoke else 18.0, device=device)
  errors += obs_errors
  results['wall_secs'] = round(time.monotonic() - t0, 2)
  return results, errors


def run_elastic_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                      device='cuda'):
  """The elastic pod-membership drill; returns (results, errors).

  A one-process learner with no local actors trains from two actor
  hosts. Mid-run the harness SIGKILLs one: the ledger records
  host_left(lost), the pod-hosts margin thins without burning, the
  controller's pod_size actuator raises the declared target
  (POD_TARGET.json), and the harness's grow-only supervisor (a cluster
  manager's role) spawns the replacement, which joins a live learner.
  The full run adds a SIGTERM drain (host_left reason 'drain') and heals
  again."""
  import signal as signal_lib
  import threading

  from scalable_agent_tpu_torch import controller as controller_lib
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch.config import Config
  from scalable_agent_tpu_torch.runtime import faults as faults_lib

  port = _free_port()
  # The pod-hosts objective: a fractional target, so the margin is never
  # zero at quorum (2 hosts: +0.5, 1 host: -0.5); a slow window long
  # enough that the healthy warm-up outweighs the dip.
  spec = [
      dict(name='pod_hosts', metric='driver/remote_live_hosts',
           comparison='>=', target=1.5, severity='page',
           fast_window_secs=2.0, slow_window_secs=90.0,
           description='elastic drill: the pod must hold 2 actor '
                       'hosts'),
  ]
  # clear_margin 10 is out of reach (pod_max_hosts bounds the gauge): the
  # grow is never reverted; the supervisor is grow-only by design.
  policy = [
      dict(objective='pod_hosts', actuator='pod_size',
           direction='up', step=1, trigger_margin=0.25,
           clear_margin=10.0, cooldown_secs=15.0,
           description='a host left: raise the declared pod target '
                       'so the cluster supervisor replaces it'),
  ]
  os.makedirs(logdir, exist_ok=True)
  spec_path = os.path.join(logdir, 'elastic_slo_spec.json')
  policy_path = os.path.join(logdir, 'elastic_policy.json')
  with open(spec_path, 'w') as f:
    json.dump(spec, f, indent=2)
  with open(policy_path, 'w') as f:
    json.dump(policy, f, indent=2)

  cfg_kwargs = _base_kwargs(
      logdir, seed,
      num_actors=0,             # every row arrives over TCP
      checkpoint_secs=0,
      summary_secs=0,
      remote_actor_port=port,
      # A SIGKILLed host is reaped in seconds, yet the window covers a
      # fresh host's start-up silence (before its ping thread is up).
      remote_heartbeat_secs=0.5,
      remote_conn_idle_timeout_secs=8.0,
      controller='act',
      controller_policy=policy_path,
      controller_interval_secs=0.25,
      pod_max_hosts=3,
      slo_spec=spec_path,
      slo_capture=False)
  cfg = Config(**cfg_kwargs)

  child_overrides = {k: v for k, v in cfg_kwargs.items()
                     if k in ('env_backend', 'batch_size',
                              'unroll_length', 'num_action_repeats',
                              'episode_length', 'height', 'width',
                              'torso', 'use_py_process',
                              'use_instruction',
                              'total_environment_frames',
                              'inference_timeout_ms', 'seed')}
  child_overrides['num_actors'] = 2
  no_faults = faults_lib.FaultPlan([], seed=seed).to_json()

  def _spawn_host(idx):
    ov = dict(child_overrides, logdir=os.path.join(logdir, f'host{idx}'))
    return _spawn_actor_child(f'127.0.0.1:{port}', ov, no_faults, device)

  children = {0: _spawn_host(0), 1: _spawn_host(1)}
  next_idx = [2]
  stop = threading.Event()
  timeline = []           # the supervisor's own audit trail

  # Burn math (slow window 90 s, a burn needs half its samples bad): a
  # dip lasts the reap (8 s) + the controller (<1 s) + a replacement's
  # spawn to handshake, so each dip starts after > 17 s of healthy
  # samples.
  warm_secs = 22.0
  heal_wait_secs = 25.0
  max_seconds = 95.0 if smoke else 140.0
  pod_path = os.path.join(logdir, 'POD_TARGET.json')

  def _live_rows():
    rows = _read_jsonl(os.path.join(logdir, 'summaries.jsonl'))
    return [r['value'] for r in rows
            if r.get('tag') == 'remote_live_hosts']

  def _alive():
    return [i for i, p in children.items() if p.poll() is None]

  def _wait_live(n, deadline):
    while not stop.is_set() and time.monotonic() < deadline:
      vals = _live_rows()
      if vals and vals[-1] >= n:
        return True
      stop.wait(0.3)
    return False

  def _reconcile_until_live(n, deadline):
    """The grow-only supervisor: spawn a replacement whenever the
    declared target exceeds the live pod, until the gauge has dipped
    below `n` and recovered (a reading of n before the dip does not
    count: the reap takes seconds)."""
    start = len(_live_rows())
    while not stop.is_set() and time.monotonic() < deadline:
      try:
        with open(pod_path) as f:
          target = int(json.load(f)['target_hosts'])
      except (OSError, ValueError, KeyError):
        target = None
      if (target is not None and target > len(_alive())
          and next_idx[0] < 5):
        idx = next_idx[0]
        next_idx[0] += 1
        children[idx] = _spawn_host(idx)
        timeline.append(
            {'event': 'replacement_spawned', 'host': idx,
             'target': target,
             'wall': round(time.monotonic() - t0, 2)})
      since = _live_rows()[start:]
      dip = next((i for i, v in enumerate(since) if v < n), None)
      if dip is not None and any(v >= n for v in since[dip:]):
        return True
      stop.wait(0.3)
    return False

  def _harness(t0):
    deadline = t0 + max_seconds - 10.0
    if not _wait_live(2, deadline):
      timeline.append({'event': 'no_initial_quorum'})
      return
    timeline.append({'event': 'quorum', 'wall': round(
        time.monotonic() - t0, 2)})
    # The healthy warm-up: the slow window holds more good samples than
    # the coming dip adds bad ones.
    if stop.wait(warm_secs):
      return
    victim = children[0]
    victim.kill()                       # SIGKILL: no goodbye
    timeline.append({'event': 'sigkill', 'host': 0,
                     'wall': round(time.monotonic() - t0, 2)})
    if not _reconcile_until_live(2, deadline):
      timeline.append({'event': 'no_heal_after_kill'})
      return
    timeline.append({'event': 'healed', 'wall': round(
        time.monotonic() - t0, 2)})
    if smoke:
      return
    # Cycle 2, the deliberate exit: the window refills, then a host
    # drains on SIGTERM (the quiesce ends in the 'leave' announcement).
    if stop.wait(heal_wait_secs):
      return
    drain_idx = next(i for i in sorted(_alive()) if i != 0)
    children[drain_idx].send_signal(signal_lib.SIGTERM)
    timeline.append({'event': 'sigterm_drain', 'host': drain_idx,
                     'wall': round(time.monotonic() - t0, 2)})
    if _reconcile_until_live(2, deadline):
      timeline.append({'event': 'healed_after_drain', 'wall': round(
          time.monotonic() - t0, 2)})
    else:
      timeline.append({'event': 'no_heal_after_drain'})

  t0 = time.monotonic()
  harness = threading.Thread(target=_harness, args=(t0,), daemon=True)
  crash = None
  run = None
  outs = {}
  try:
    harness.start()
    run = driver.train(cfg, max_seconds=max_seconds, stall_timeout_secs=30.0,
                       device=device)
  except Exception as e:  # SLO: zero learner crashes
    crash = f'{type(e).__name__}: {e}'
  finally:
    stop.set()
    harness.join(timeout=10.0)
    for p in children.values():
      if p.poll() is None:
        p.terminate()
    for i, p in children.items():
      try:
        outs[i] = p.communicate(timeout=20)[0] or ''
      except subprocess.TimeoutExpired:
        p.kill()
        outs[i] = p.communicate()[0] or ''

  errors = []
  for i, out in sorted(outs.items()):
    errors += _device_errors(f'actor host {i}', out)
  events = {t['event'] for t in timeline}
  results = {
      'smoke': smoke,
      'device': str(device),
      'wall_secs': round(time.monotonic() - t0, 2),
      'crash': crash,
      'timeline': timeline,
  }
  if crash is not None:
    errors.append(f'learner crashed during the elastic drill: {crash}')
    return results, errors
  if 'sigkill' not in events:
    errors.append(f'the harness never reached the SIGKILL ({timeline})')
    return results, errors

  ing = run.ingest.stats()
  verdict = slo_lib.read_verdict(logdir)
  clog = controller_lib.read_log(logdir)
  incidents = _read_jsonl(os.path.join(logdir, 'incidents.jsonl'))
  left = [e for e in incidents if e['kind'] == 'host_left']
  joined = [e for e in incidents if e['kind'] == 'host_joined']
  results.update({
      'slo_verdict': None if verdict is None else {
          'pass': verdict.get('pass'),
          'violations': verdict.get('violations')},
      'controller_counts': None if clog is None else clog['counts'],
      'hosts_joined': ing.get('hosts_joined'),
      'hosts_left': ing.get('hosts_left'),
      'live_hosts_at_exit': ing.get('live_hosts'),
      'stale_epoch_rejected': ing.get('stale_epoch_rejected'),
      'host_left_reasons': sorted({e.get('reason') for e in left}),
  })

  # --- The headline: a host died, the replacement joined, the verdict
  # stayed green with no human turning a knob.
  if 'healed' not in events:
    errors.append(f'the pod never healed after the SIGKILL: {timeline}')
  if verdict is None:
    errors.append('no SLO_VERDICT.json')
  else:
    if not verdict.get('pass'):
      errors.append(f"SLO verdict FAILED: {verdict.get('violations')}")
    pod = (verdict.get('objectives') or {}).get('pod_hosts') or {}
    if pod.get('burns', 0) != 0:
      errors.append(f"pod_hosts burned {pod.get('burns')}x — the "
                    'pod was down a host longer than the healthy '
                    'warm-up covered')
  # --- The controller moved the pod_size actuator, applied.
  if clog is None:
    errors.append('no CONTROLLER_LOG.json')
  else:
    pod_moves = [a for a in (clog.get('actions') or [])
                 if a['actuator'] == 'pod_size' and a['applied']]
    if not pod_moves:
      errors.append('the controller never applied a pod_size move')
  if not os.path.exists(pod_path):
    errors.append('no POD_TARGET.json — the actuator never declared '
                  'a target')
  else:
    with open(pod_path) as f:
      pod_target = json.load(f)
    results['pod_target'] = pod_target
    if pod_target.get('target_hosts', 0) < 2:
      errors.append(f'POD_TARGET.json target_hosts='
                    f"{pod_target.get('target_hosts')} < 2")
  if 'replacement_spawned' not in events:
    errors.append('the supervisor never spawned a replacement host')
  # --- The membership ledger's durable trail.
  if not any(e.get('reason') == 'lost' for e in left):
    errors.append(f'no host_left(lost) incident: {left}')
  if len(joined) < 3:
    errors.append(f'expected >= 3 host_joined incidents (2 initial + '
                  f'replacement), got {len(joined)}')
  if not smoke:
    if 'healed_after_drain' not in events:
      errors.append(f'the pod never healed after the drain: '
                    f'{timeline}')
    if not any(e.get('reason') == 'drain' for e in left):
      errors.append(f"no host_left(drain) incident — the SIGTERM'd "
                    f'host left without its leave announcement: '
                    f'{left}')
  # --- No epoch confusion: joins are fresh hellos.
  if ing.get('stale_epoch_rejected', 0) != 0:
    errors.append(f"stale_epoch_rejected="
                  f"{ing.get('stale_epoch_rejected')} during a "
                  'membership-only drill')
  return results, errors


def _spawn_replica_child(overrides, port, device):
  """A serving replica as a child process on `device`: an ingest
  listener with an InferenceServer attached to its 'infer' kind (the
  learner host's role without the train loop). Prints 'REPLICA_READY
  <json>' (its port and the core state's widths) once serving; SIGTERM
  raises its drain notice and it exits ~6 s later."""
  body = (
      'import json, os, signal, sys, threading, time\n'
      'import torch\n'
      'from scalable_agent_tpu_torch import driver\n'
      'from scalable_agent_tpu_torch.config import Config\n'
      'from scalable_agent_tpu_torch.models import init_params\n'
      'from scalable_agent_tpu_torch.runtime import remote, ring_buffer\n'
      'from scalable_agent_tpu_torch.runtime.inference import '
      'InferenceServer\n'
      'cfg = Config(**json.loads(sys.argv[1]))\n'
      'device = driver.resolve_device(sys.argv[3])\n'
      'num_actions = 9\n'
      'agent = driver.build_agent(cfg, num_actions)\n'
      'params = init_params(agent, torch.Generator().manual_seed(0))\n'
      'server = InferenceServer(\n'
      '    agent, {n: v.to(device) for n, v in params.items()}, cfg,\n'
      '    seed=7, fleet_size=1, pad_batch_to=1, device=device)\n'
      'server.update_params(params, version=1)\n'
      'ingest = remote.TrajectoryIngestServer(\n'
      '    ring_buffer.TrajectoryBuffer(2), driver.host_params(params),\n'
      "    host='127.0.0.1', port=int(sys.argv[2]),\n"
      '    contract=remote.trajectory_contract(cfg, agent, num_actions),\n'
      '    wire_dtype=cfg.resolved_wire_dtype)\n'
      'ingest.attach_serving(server.serve_remote)\n'
      'core = [agent.hidden_size, agent.hidden_size]\n'
      "print('REPLICA_READY ' + json.dumps(\n"
      "    {'port': ingest.port, 'core': core}), flush=True)\n"
      'def _term(signum, frame):\n'
      '  ingest.set_draining()\n'
      '  threading.Timer(6.0, lambda: os._exit(0)).start()\n'
      'signal.signal(signal.SIGTERM, _term)\n'
      'while True:\n'
      '  time.sleep(0.5)\n')
  return subprocess.Popen(
      [sys.executable, '-c', body, json.dumps(overrides), str(port),
       str(device)],
      cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True)


def run_routed_storm(logdir: str, smoke: bool = SMOKE, seed: int = SEED,
                     device='cuda'):
  """The routed-serving drill; returns (results, errors).

  Two serving replicas (real sockets), one actor-side ServingRouter
  pumping inference batches through them. Mid-run one replica is
  SIGKILLed: the router fails the request over and puts it on
  probation, every later batch is served (zero NoReplicasAvailable),
  and the routed-latency objective, judged by the evaluator production
  uses, never burns. The full run adds the drain handoff: a replacement
  joins, the survivor is SIGTERMed, and its 'draining' notice takes it
  out of the rotation before it exits."""
  import signal as signal_lib
  import threading

  import numpy as np

  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch import telemetry
  from scalable_agent_tpu_torch.config import Config
  from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN
  from scalable_agent_tpu_torch.runtime import remote
  from scalable_agent_tpu_torch.runtime import routing

  os.makedirs(logdir, exist_ok=True)
  cfg_kwargs = dict(
      height=24, width=32, torso='shallow', use_instruction=False,
      inference_min_batch=0, inference_max_batch=8,
      inference_timeout_ms=5, inference_state_cache=False,
      unroll_length=5, batch_size=2, seed=seed)
  cfg = Config(**cfg_kwargs)
  num_actions = 9
  agent = driver.build_agent(cfg, num_actions)
  contract = remote.trajectory_contract(cfg, agent, num_actions)

  ports = [_free_port(), _free_port()]
  children = {i: _spawn_replica_child(cfg_kwargs, p, device)
              for i, p in enumerate(ports)}
  sinks = {i: [] for i in children}

  def _tail(proc, sink):
    for line in proc.stdout:
      sink.append(line)

  def _watch(idx):
    threading.Thread(target=_tail, args=(children[idx], sinks[idx]),
                     daemon=True).start()

  for i in children:
    _watch(i)

  def _ready_info(idx, deadline):
    while time.monotonic() < deadline:
      for line in list(sinks[idx]):
        if line.startswith('REPLICA_READY '):
          return json.loads(line[len('REPLICA_READY '):])
      if children[idx].poll() is not None:
        return None
      time.sleep(0.2)
    return None

  t0 = time.monotonic()
  errors = []
  timeline = []
  results = {'smoke': smoke, 'device': str(device), 'timeline': timeline}
  router = None
  try:
    # A replica's start-up is a process's imports and its first forward.
    deadline = time.monotonic() + 180.0
    infos = {i: _ready_info(i, deadline) for i in children}
    if any(v is None for v in infos.values()):
      dead = [i for i, v in infos.items() if v is None]
      errors.append(
          f'replica(s) {dead} never became ready: '
          + ' | '.join(''.join(sinks[i])[-500:] for i in dead))
      return results, errors
    core = infos[0]['core']
    addrs = {i: f"127.0.0.1:{infos[i]['port']}" for i in infos}
    timeline.append({'event': 'replicas_ready',
                     'wall': round(time.monotonic() - t0, 2)})

    # A short dial timeout: redials of a SIGKILLed replica after its
    # probation fail fast (refused), not inside the router's io lock.
    def connect_fn(addr):
      return routing.connect_serving(addr, contract,
                                     connect_timeout_secs=1.5)

    router = routing.ServingRouter(list(addrs.values()), connect_fn,
                                   probation_secs=3.0)
    rng = np.random.RandomState(seed)
    b = 2
    payload = {
        'prev_action': np.zeros((b,), np.int32),
        'reward': np.zeros((b,), np.float32),
        'done': np.zeros((b,), np.bool_),
        'frame': rng.randint(0, 255,
                             (b, 24, 32, 3)).astype(np.uint8),
        'instr': np.zeros((b, MAX_INSTRUCTION_LEN), np.int32),
        'core_c': np.zeros((b, core[0]), np.float32),
        'core_h': np.zeros((b, core[1]), np.float32),
    }

    # The warm-up: every replica serves once (its first call's set-up
    # lands here, off the judged window).
    warm_deadline = time.monotonic() + 120.0
    while time.monotonic() < warm_deadline:
      router.infer(payload)
      serves = {r['address']: r['serves']
                for r in router.stats()['replicas']}
      if all(v > 0 for v in serves.values()):
        break
    else:
      errors.append(f'warm-up starved a replica: {router.stats()}')
      return results, errors
    timeline.append({'event': 'warm',
                     'wall': round(time.monotonic() - t0, 2)})

    # The judged pump: the actor side's routed-latency objective over
    # this process's registry.
    objective = slo_lib.Objective(
        name='routed_latency_p99_ms', metric='serving/route_ms',
        field='p99', comparison='<=', target=5000.0,
        severity='ticket', fast_window_secs=2.0,
        slow_window_secs=30.0,
        description='actor-side routed inference latency p99 (ms)')
    evaluator = slo_lib.SloEvaluator([objective])
    served = {'pre_kill': 0, 'post_kill': 0, 'post_drain': 0}
    phase = ['pre_kill']
    last_obs = [0.0]
    starvation = [0]

    def _pump(secs):
      end = time.monotonic() + secs
      while time.monotonic() < end:
        try:
          router.infer(payload)
          served[phase[0]] += 1
        except routing.NoReplicasAvailable:
          starvation[0] += 1
        now = time.time()
        if now - last_obs[0] >= 0.25:
          last_obs[0] = now
          evaluator.observe(telemetry.registry().snapshot(), now)
        time.sleep(0.02)

    _pump(4.0)
    victim = children[0]
    victim.kill()                      # SIGKILL: no draining notice
    timeline.append({'event': 'sigkill', 'replica': addrs[0],
                     'wall': round(time.monotonic() - t0, 2)})
    phase[0] = 'post_kill'
    _pump(8.0)

    if not smoke:
      # The drain handoff: a replacement joins, the survivor drains out.
      new_port = _free_port()
      children[2] = _spawn_replica_child(cfg_kwargs, new_port, device)
      sinks[2] = []
      _watch(2)
      info = _ready_info(2, time.monotonic() + 180.0)
      if info is None:
        errors.append('replacement replica never became ready')
        return results, errors
      addrs[2] = f"127.0.0.1:{info['port']}"
      router.add_replica(addrs[2])
      timeline.append({'event': 'replacement_joined',
                       'wall': round(time.monotonic() - t0, 2)})
      children[1].send_signal(signal_lib.SIGTERM)
      timeline.append({'event': 'sigterm_drain', 'replica': addrs[1],
                       'wall': round(time.monotonic() - t0, 2)})
      phase[0] = 'post_drain'
      _pump(8.0)

    rstats = router.stats()
    verdict = evaluator.verdict()
    with open(os.path.join(logdir, 'SLO_VERDICT.json'), 'w') as f:
      json.dump(verdict, f, indent=2, sort_keys=True)
    results.update({
        'wall_secs': round(time.monotonic() - t0, 2),
        'served': dict(served),
        'starvation': starvation[0],
        'router': rstats,
        'slo_verdict': {'pass': verdict.get('pass'),
                        'violations': verdict.get('violations')},
    })

    # --- The headline: the kill cost its in-flight request at most;
    # everything after it was served, and the verdict stayed green.
    if served['post_kill'] == 0:
      errors.append('no traffic served after the SIGKILL')
    if starvation[0]:
      errors.append(f'router starved {starvation[0]}x '
                    '(NoReplicasAvailable after warm-up)')
    if rstats['route_failovers'] < 1:
      errors.append('the kill never exercised the failover path '
                    f'(failovers={rstats["route_failovers"]})')
    if not verdict.get('pass'):
      errors.append(f"routed SLO verdict FAILED: "
                    f"{verdict.get('violations')}")
    by_addr = {r['address']: r for r in rstats['replicas']}
    if not smoke:
      if served['post_drain'] == 0:
        errors.append('no traffic served after the drain')
      drained = by_addr.get(addrs[1], {})
      if not drained.get('draining'):
        errors.append(f'the SIGTERM\'d replica never advertised '
                      f'draining: {drained}')
      if by_addr.get(addrs[2], {}).get('serves', 0) == 0:
        errors.append('the replacement replica never served')
    return results, errors
  finally:
    if router is not None:
      router.close()
    for p in children.values():
      if p.poll() is None:
        p.terminate()
    for i, p in children.items():
      try:
        p.communicate(timeout=20)
      except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
      errors += _device_errors(f'replica {i}', ''.join(sinks.get(i, [])))


def _run_corruption_subprocess(device):
  """CHAOS_STORM=all: the corruption storm in a process of its own, as
  JAX's grouping runs it."""
  out_path = os.path.join(tempfile.mkdtemp(prefix='chaos_corr_'),
                          'CHAOS_CORR.json')
  env = _child_env()
  env['CHAOS_STORM'] = 'corruption'
  env['CHAOS_OUT'] = out_path
  proc = subprocess.run(
      [sys.executable, '-m', 'scalable_agent_tpu_torch.scripts.chaos',
       f'--device={device}'],
      cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True, timeout=900)
  try:
    with open(out_path) as f:
      sub = json.load(f)
    return (sub.get('corruption', {}),
            [e for e in sub.get('slo_violations', [])])
  except (OSError, ValueError):
    return ({'tail': proc.stdout[-800:] if proc.stdout else ''},
            [f'corruption subprocess produced no report '
             f'(exit {proc.returncode})'])


def main(argv: Optional[List[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.chaos',
      description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="torch device of every learner and child "
                           "(default cuda; 'cpu' to run on the CPU)")
  args = parser.parse_args(argv)
  from scalable_agent_tpu_torch import driver
  device = str(driver.resolve_device(args.device))
  which = os.environ.get('CHAOS_STORM', 'all')
  kw = dict(smoke=SMOKE, seed=SEED, device=device)
  results = {'device': device}
  errors = []
  if which in ('all', 'fault'):
    with tempfile.TemporaryDirectory(prefix='chaos_') as logdir:
      storm_results, storm_errors = run_storm(logdir, **kw)
    results.update(storm_results)  # top-level keys: JAX's layout
    errors += storm_errors
  if which in ('all', 'overload'):
    with tempfile.TemporaryDirectory(prefix='chaos_ovl_') as logdir:
      results['overload'], overload_errors = run_overload_storm(logdir, **kw)
    errors += [f'overload: {e}' for e in overload_errors]
  if which in ('all', 'partition'):
    with tempfile.TemporaryDirectory(prefix='chaos_part_') as logdir:
      results['partition'], partition_errors = run_partition_storm(
          logdir, **kw)
    errors += [f'partition: {e}' for e in partition_errors]
  if which in ('all', 'controller'):
    with tempfile.TemporaryDirectory(prefix='chaos_ctrl_') as logdir:
      results['controller'], controller_errors = run_controller_storm(
          logdir, **kw)
    errors += [f'controller: {e}' for e in controller_errors]
  if which == 'elastic':
    # By name only: real host replacement dominates its wall clock.
    with tempfile.TemporaryDirectory(prefix='chaos_elastic_') as logdir:
      results['elastic'], elastic_errors = run_elastic_storm(logdir, **kw)
    errors += [f'elastic: {e}' for e in elastic_errors]
  if which == 'routed':
    # By name only: replica start-up is a process each.
    with tempfile.TemporaryDirectory(prefix='chaos_routed_') as logdir:
      results['routed'], routed_errors = run_routed_storm(logdir, **kw)
    errors += [f'routed: {e}' for e in routed_errors]
  if which == 'corruption':
    with tempfile.TemporaryDirectory(prefix='chaos_corr_') as logdir:
      results['corruption'], corruption_errors = run_corruption_storm(
          logdir, **kw)
    errors += [f'corruption: {e}' for e in corruption_errors]
  elif which == 'all':
    results['corruption'], corruption_errors = _run_corruption_subprocess(
        device)
    errors += [f'corruption: {e}' for e in corruption_errors]
  results['slo_violations'] = errors
  results['ok'] = not errors
  with open(OUT_PATH, 'w') as f:
    json.dump(results, f, indent=2, sort_keys=True, default=str)
  print(json.dumps({'chaos_ok': results['ok'],
                    'storms': which,
                    'device': device,
                    'wall_secs': results.get('wall_secs'),
                    'overload_wall_secs':
                        results.get('overload', {}).get('wall_secs'),
                    'partition_wall_secs':
                        results.get('partition', {}).get('wall_secs'),
                    'controller_wall_secs':
                        results.get('controller', {}).get('wall_secs'),
                    'elastic_wall_secs':
                        results.get('elastic', {}).get('wall_secs'),
                    'routed_wall_secs':
                        results.get('routed', {}).get('wall_secs'),
                    'corruption_wall_secs':
                        results.get('corruption', {}).get('wall_secs'),
                    'violations': errors,
                    'out': OUT_PATH}), flush=True)
  if errors:
    sys.exit(1)


if __name__ == '__main__':
  main(sys.argv[1:])
