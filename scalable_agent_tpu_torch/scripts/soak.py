"""The flagship stability soak, and its churn mode.

  python -m scalable_agent_tpu_torch.scripts.soak                  # 600 s
  SOAK_CHURN=1 python -m scalable_agent_tpu_torch.scripts.soak     # 1200 s
  SOAK_SECONDS=900 SOAK_CHURN=1 python -m ...scripts.soak
  SOAK_SMOKE=1 [SOAK_CHURN=1] python -m ...scripts.soak --device=cpu

The port's counterpart of the root `scripts/soak.py`: `driver.train` on
`--device` (default cuda, which raises without CUDA) with every flagship
feature on at once (the deep ResNet at 72x96, bfloat16 compute, the
instruction encoder, PopArt and pixel control, 8 process-hosted actors,
B=4, T=20) on the contextual-bandit task, for SOAK_SECONDS, and over the
whole run:

  - every logged total_loss is finite,
  - PopArt sigma stays inside its clip bounds,
  - the episode return improves (last third's mean above the first
    third's) and clears 1.5x the random baseline (1/3 per step of the
    3-arm bandit),
  - zero integrity violations, the trace stream alive, the SLO verdict
    passing, the controller without apply errors.

SOAK_CHURN=1 adds the `Churn` thread: every ~60 s it SIGKILLs one env
process (the fleet must respawn it), and a remote actor host (the
`--job_name=actor` CLI, on the same device) feeds the learner over TCP
and is SIGKILLed and replaced at ~55 % of the run (its unrolls must
resume). Trimmed RSS, threads, fds and Python blocks are sampled
throughout: the Python-side curves must stay flat, and per-step RSS
growth within 2x the ambient of the no-churn control run,
`_AMBIENT_RSS_MB_PER_STEP`, which is this port's own number on the card
(the steady-state soak samples the same curves and reports it as
`ambient_rss_mb_per_step`). The smoke keeps a 0.5 MB/step bound.

SOAK_SMOKE=1 runs the mechanics at the CPU size (shallow torso, 24x32,
2 actors, 40 s). The record goes to SOAK_TORCH.json at the repo root
(git-ignored), or SOAK_smoke.json in the run's logdir for the smoke; the
last line printed is the record, and the exit code is 1 when it found a
problem. Env processes fork from the port's forkserver, started before
any CUDA call.

Learning hyperparameters are JAX's: lr 5e-4, entropy 3e-3, discount 0
(the task is one step).
"""

import argparse
import json
import multiprocessing
import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _file_tail(path, n):
  """The last n bytes of a possibly large file."""
  if not os.path.exists(path):
    return ''
  with open(path, 'rb') as f:
    f.seek(0, os.SEEK_END)
    size = f.tell()
    f.seek(max(0, size - n))
    return f.read().decode('utf-8', errors='replace')


def _rss_mb():
  """Resident set after malloc_trim, so the curve measures live bytes
  rather than glibc's retained arena pages."""
  try:
    import ctypes
    ctypes.CDLL('libc.so.6').malloc_trim(0)
  except OSError:
    pass
  with open('/proc/self/status') as f:
    for line in f:
      if line.startswith('VmRSS:'):
        return int(line.split()[1]) / 1024.0
  return float('nan')


def _num_fds():
  return len(os.listdir('/proc/self/fd'))


def _spawn_remote_actor(cfg, port, log_path, device):
  """The actor-host CLI (`--job_name=actor`) on loopback, on `device`.
  The flags cover every trajectory-contract field the soak sets, so
  both roles derive the same contract. Output goes to a file: an
  undrained pipe would block the host inside a log write."""
  cmd = [
      sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
      '--job_name=actor', '--task=0',
      f'--learner_address=127.0.0.1:{port}',
      f'--logdir={cfg.logdir}',
      f'--device={device}',
      '--env_backend=bandit', '--num_actors=2',
      f'--batch_size={cfg.batch_size}',
      f'--unroll_length={cfg.unroll_length}',
      '--num_action_repeats=1',
      f'--episode_length={cfg.episode_length}',
      f'--height={cfg.height}', f'--width={cfg.width}',
      f'--torso={cfg.torso}', f'--compute_dtype={cfg.compute_dtype}',
      '--use_instruction=true', '--use_popart=true',
      f'--pixel_control_cost={cfg.pixel_control_cost}',
      '--discounting=0.0',
      f'--inference_timeout_ms={cfg.inference_timeout_ms}',
      '--actor_reconnect_secs=120',
      f'--seed={cfg.seed + 50}',
  ]
  env = dict(os.environ)
  existing = env.get('PYTHONPATH', '')
  env['PYTHONPATH'] = REPO + os.pathsep + existing if existing else REPO
  log_file = open(log_path, 'a')
  try:
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log_file,
                            stderr=subprocess.STDOUT, text=True)
  finally:
    log_file.close()  # the child holds its own descriptor


def _wait_port(port, deadline, stop):
  """Block until the learner's ingest port accepts, or `stop` is set."""
  while time.monotonic() < deadline and not stop.is_set():
    try:
      with socket.create_connection(('127.0.0.1', port), timeout=2):
        return True
    except OSError:
      stop.wait(1.0)
  return False


class Churn:
  """The background failure injector and resource sampler, beside
  driver.train in the learner process: SIGKILLs one env child every
  `kill_every` seconds, drops and replaces the remote actor host once at
  ~55 % of the run, samples trimmed RSS, threads, fds and Python blocks
  every `sample_every` seconds. With `inject=False` it only samples (the
  steady-state soak's no-churn control). `stop()` ends it and reaps the
  host."""

  def __init__(self, cfg, port, seconds, smoke, device, inject=True):
    self._cfg = cfg
    self._port = port
    self._seconds = seconds
    self._smoke = smoke
    self._device = device
    self._inject = inject
    self._stop = threading.Event()
    self.events = []
    self.samples = []  # (t, rss_mb, threads, fds, py_blocks)
    self.env_kills = 0
    self.port_probes = 0  # each probe counts in the server's conns
    self.actor_log = os.path.join(cfg.logdir, 'remote_actor.log')
    self._actor = None
    self._thread = threading.Thread(target=self._run,
                                    name='churn', daemon=True)

  def start(self):
    self._thread.start()

  def _event(self, what):
    self.events.append({'t': round(time.monotonic() - self._t0, 1),
                        'wall_time': round(time.time(), 3),
                        'event': what})

  def _kill_one_env(self):
    # Env processes are this process's multiprocessing (forkserver)
    # children; the remote actor host is a Popen, not among them.
    children = multiprocessing.active_children()
    if not children:
      self._event('no env child to kill')
      return
    victim = random.choice(children)
    try:
      os.kill(victim.pid, signal.SIGKILL)
      self.env_kills += 1
      self._event(f'SIGKILL env pid {victim.pid}')
    except (OSError, AttributeError) as e:
      self._event(f'env kill failed: {e!r}')

  def _reap_actor(self):
    if self._actor is None:
      return
    try:
      self._actor.wait(timeout=10)
    except subprocess.TimeoutExpired:
      self._actor.kill()
      self._actor.wait()
    self._actor = None

  def _spawn_actor(self):
    self._actor = _spawn_remote_actor(self._cfg, self._port,
                                      self.actor_log, self._device)

  def _run(self):
    self._t0 = time.monotonic()
    grace = 20 if self._smoke else 120       # past start-up and warm-up
    kill_every = 8 if self._smoke else 60
    sample_every = 2 if self._smoke else 15
    use_remote = self._inject and not self._smoke  # the CLI boots slowly
    drop_at = self._seconds * 0.55
    next_kill = grace
    next_sample = 0.0
    dropped = False
    if use_remote:
      if _wait_port(self._port, self._t0 + self._seconds, self._stop):
        self.port_probes = 1
        self._spawn_actor()
        self._event('remote actor spawned')
      else:
        self._event('ingest port never opened')
    while not self._stop.wait(0.5):
      t = time.monotonic() - self._t0
      if t >= next_sample:
        self.samples.append((round(t, 1), round(_rss_mb(), 1),
                             threading.active_count(), _num_fds(),
                             sys.getallocatedblocks()))
        next_sample = t + sample_every
      if self._inject and t >= next_kill:
        self._kill_one_env()
        next_kill = t + kill_every
      if use_remote and not dropped and t >= drop_at:
        dropped = True
        if self._actor is not None and self._actor.poll() is None:
          self._actor.kill()
          self._event('SIGKILL remote actor host')
        self._reap_actor()
        self._spawn_actor()
        self.drop_wall_time = time.time()
        self._event('replacement remote actor spawned')

  def stop(self):
    self._stop.set()
    self._thread.join(timeout=10)
    if self._actor is not None and self._actor.poll() is None:
      # The learner is down: the host's reconnect window would only burn.
      self._actor.kill()
    self._reap_actor()


# The ambient RSS growth per learner step of the plain train path (the
# steady-state soak, no churn, no remote host), measured on the card:
# the churn gate bounds per-step growth at 2x this. This is the
# steady-state soak's `ambient_rss_mb_per_step` on an NVIDIA H100 80GB
# HBM3 at 700.00 W (600 s, 2,088 learner steps; RSS after malloc_trim).
# None would leave a full churn soak's RSS without a verdict. (JAX's 5.6
# MB/step was measured on its TPU host and is not this port's.)
_AMBIENT_RSS_MB_PER_STEP: Optional[float] = 0.0008365248540422985


def _rss_window(samples, steps):
  """(RSS growth in MB, learner steps) over the post-warm-up window: the
  samples after the first quarter, the steps inside it estimated in
  proportion to time (steps crowd after the warm-up, so MB/step errs
  high, the strict side)."""
  body = samples[len(samples) // 4:]
  tail = body[-3:]
  rss_growth = max(s[1] for s in tail) - body[0][1]
  span = samples[-1][0] - samples[0][0]
  window_frac = (tail[-1][0] - body[0][0]) / span if span > 0 else 1.0
  return rss_growth, max(steps * window_frac, 1.0)


def rss_mb_per_step(samples, steps) -> Optional[float]:
  """The post-warm-up RSS growth per learner step of a sampled run (the
  steady-state soak's ambient), None with fewer than 8 samples."""
  if len(samples) < 8:
    return None
  growth, window_steps = _rss_window(samples, steps)
  return growth / window_steps


def _flatness_problems(samples, steps, smoke):
  """Growth that looks like a leak in the machinery: the Python blocks,
  threads and fds flat, and per-step RSS growth within 2x
  `_AMBIENT_RSS_MB_PER_STEP`; the smoke's bound is 0.5 MB/step. With no
  measured ambient the RSS gate is not judged."""
  ambient = _AMBIENT_RSS_MB_PER_STEP
  problems = []
  if len(samples) < 8:
    problems.append(f'only {len(samples)} resource samples')
    return problems
  body = samples[len(samples) // 4:]          # drop the warm-up quarter
  ref = body[:max(len(body) // 2, 1)]
  tail = body[-3:]
  ref_thr = max(s[2] for s in ref)
  ref_fds = max(s[3] for s in ref)
  ref_blocks = max(s[4] for s in ref)
  for name, idx, bound in (('threads', 2, ref_thr + 4),
                           ('fds', 3, ref_fds + 16),
                           ('python blocks', 4, ref_blocks * 1.10)):
    worst = max(s[idx] for s in tail)
    if worst > bound:
      problems.append(
          f'{name} grew: tail max {worst} vs reference {bound:.1f} '
          f'(post-warmup ref max × tolerance)')
  rss_growth, window_steps = _rss_window(samples, steps)
  if not smoke and ambient is None:
    return problems
  allowance = 0.5 if smoke else 2 * ambient
  basis = ('CPU smoke' if smoke else
           '2x the measured ambient of the no-churn control')
  if rss_growth / window_steps > allowance:
    problems.append(
        f'rss grew {rss_growth:.0f} MB over ~{window_steps:.0f} '
        f'post-warmup steps ({rss_growth / window_steps:.1f} '
        f'MB/step) — above the {allowance} MB/step allowance '
        f'({basis}); suspect a real leak')
  return problems


def _read_incidents(logdir):
  path = os.path.join(logdir, 'incidents.jsonl')
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def _downsample(samples, n=40):
  if len(samples) <= n:
    return samples
  step = len(samples) / n
  return [samples[int(i * step)] for i in range(n)] + [samples[-1]]


def soak(smoke: bool, churn: bool, seconds: float, device='cuda',
         out_path: Optional[str] = None):
  """One soak run; returns its record (`ok`, `problems`, the curves)."""
  import numpy as np

  from scalable_agent_tpu_torch import controller as controller_lib
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch import popart as popart_lib
  from scalable_agent_tpu_torch import slo as slo_lib
  from scalable_agent_tpu_torch import telemetry
  from scalable_agent_tpu_torch.config import Config

  logdir = tempfile.mkdtemp(prefix='soak_torch_')
  ingest_port = 0
  if churn:
    with socket.create_server(('127.0.0.1', 0)) as s:
      ingest_port = s.getsockname()[1]
  cfg = Config(
      logdir=logdir,
      env_backend='bandit',
      num_actors=8 if not smoke else 2,
      batch_size=4 if not smoke else 2,
      unroll_length=20 if not smoke else 5,
      num_action_repeats=1,
      episode_length=5,
      height=72 if not smoke else 24,
      width=96 if not smoke else 32,
      torso='deep' if not smoke else 'shallow',
      compute_dtype='bfloat16' if not smoke else 'float32',
      # Churn needs real processes to kill, in the smoke too.
      use_py_process=(not smoke) or churn,
      use_instruction=True,
      use_popart=True,
      pixel_control_cost=0.01,
      learning_rate=0.0005,
      entropy_cost=0.003,
      discounting=0.0,
      reward_clipping='abs_one',
      total_environment_frames=int(1e9),
      inference_timeout_ms=20,
      checkpoint_secs=10**6,
      summary_secs=10 if not smoke else 2,
      remote_actor_port=ingest_port,
      # Churn ships the snapshots in bf16 over the wire; the host upcasts
      # and the run still has to learn.
      remote_params_dtype='bfloat16' if churn else '',
      seed=7)

  # The steady-state run samples the same curves without injecting
  # anything: its RSS growth per step is the ambient the churn gate uses.
  churner = Churn(cfg, ingest_port, seconds, smoke, device, inject=churn)
  churner.start()
  t_train = time.monotonic()
  try:
    run = driver.train(cfg, max_seconds=seconds, stall_timeout_secs=180,
                       device=device)
  finally:
    churner.stop()

  losses, sigmas_min, sigmas_max, returns = [], [], [], []
  remote_unrolls = []  # (wall_time, cumulative unrolls over the wire)
  remote_conns = 0
  # The integrity counters over the window, each asserted zero: a soak
  # runs clean hardware.
  integrity_final = {'wire_crc_rejected': 0,
                     'publish_digest_rejected': 0,
                     'ckpt_digest_fallbacks': 0,
                     'sdc_replica_mismatches': 0}
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    for line in f:
      e = json.loads(line)
      if 'value' not in e:
        continue
      if e['tag'] == 'total_loss':
        losses.append(e['value'])
      elif e['tag'] == 'popart_sigma_min':
        sigmas_min.append(e['value'])
      elif e['tag'] == 'popart_sigma_max':
        sigmas_max.append(e['value'])
      elif e['tag'] == 'remote_unrolls':
        remote_unrolls.append((e['wall_time'], e['value']))
      elif e['tag'] == 'remote_connections':
        remote_conns = max(remote_conns, int(e['value']))
      elif e['tag'] in integrity_final:
        integrity_final[e['tag']] = int(e['value'])
      elif e['tag'].endswith('/episode_return'):
        returns.append(e['value'])

  steps = int(run.state.update_steps)
  problems = []
  if run.health is not None:
    integrity_final['sdc_replica_mismatches'] = max(
        integrity_final['sdc_replica_mismatches'],
        run.health.stats().get('sdc_mismatches', 0))
  integrity_final['ckpt_digest_fallbacks'] = max(
      integrity_final['ckpt_digest_fallbacks'],
      run.checkpointer.digest_fallbacks)
  if run.ingest is not None:
    ing = run.ingest.stats()
    integrity_final['wire_crc_rejected'] = max(
        integrity_final['wire_crc_rejected'],
        ing.get('wire_crc_rejected', 0))
    integrity_final['publish_digest_rejected'] = max(
        integrity_final['publish_digest_rejected'],
        ing.get('publish_digest_rejected', 0))
  # The registry is the source the drain manifest and the flight
  # recorder read: cross-check the summaries' integrity counters against
  # the registrations that outlive the run.
  registry_snap = telemetry.registry().snapshot()
  registry_integrity = {
      'wire_crc_rejected': registry_snap.get('ingest/wire_crc_rejected'),
      'sdc_replica_mismatches': registry_snap.get(
          'health/sdc_mismatches'),
  }
  for name, reg_value in registry_integrity.items():
    if reg_value is None:
      continue
    integrity_final[name] = max(integrity_final[name], int(reg_value))
  for name, value in sorted(integrity_final.items()):
    if value:
      problems.append(
          f'integrity violation over the soak window: {name}={value} '
          '(expected 0 on clean hardware — suspect this host\'s '
          'NIC/RAM/disk)')
  # The trace plane stays alive over the window.
  telemetry_block = {'registry_names': len(registry_snap)}
  if cfg.telemetry_trace:
    from scalable_agent_tpu_torch.scripts import trace_report
    trace_summary = trace_report.summarize(
        trace_report.load_traces(logdir))
    telemetry_block.update({
        'trace_batches': trace_summary['batches'],
        'trace_unrolls': trace_summary['unrolls'],
        'policy_lag_p99': trace_summary['policy_lag']['p99'],
        'e2e_ms_p99': trace_summary['e2e_ms']['p99'],
    })
    if trace_summary['batches'] == 0:
      problems.append('telemetry_trace on but traces.jsonl carries '
                      'zero batch records over the soak window')
  # The run judged itself under the default objectives: a failing
  # verdict is a red soak naming the objective.
  slo_verdict = slo_lib.read_verdict(logdir)
  slo_block = None
  if cfg.slo_engine:
    if slo_verdict is None:
      problems.append('slo_engine on but the run wrote no '
                      'SLO_VERDICT.json')
    else:
      slo_block = {
          'pass': slo_verdict.get('pass'),
          'violations': slo_verdict.get('violations') or [],
          'captures': sorted(slo_verdict.get('captures') or {}),
          'margins': {
              name: e.get('margin')
              for name, e in
              (slo_verdict.get('objectives') or {}).items()},
      }
      objs = slo_verdict.get('objectives') or {}
      slo_block['plane_utilization'] = {
          'learner': (objs.get('learner_plane_utilization')
                      or {}).get('value'),
          'learner_filler_floor_state': (
              objs.get('learner_plane_utilization_filler')
              or {}).get('state'),
          'env': (objs.get('env_plane_utilization') or {}).get(
              'value'),
      }
      # A failing verdict's evidence: each violated objective's final
      # state and its slo_violation incidents (when in the run it burned).
      slo_block['violated'] = {
          name: objs.get(name) for name in slo_block['violations']}
      slo_block['violation_incidents'] = [
          e for e in _read_incidents(logdir)
          if e.get('kind') == 'slo_violation'][:20]
      if not slo_verdict.get('pass'):
        problems.append(
            'SLO verdict FAILED over the soak window: '
            + ', '.join(slo_verdict.get('violations') or ['?']))
  # The controller's log rides the record; an apply error is a finding.
  controller_log = controller_lib.read_log(logdir)
  controller_block = None
  if cfg.controller != 'off':
    if controller_log is None:
      problems.append('controller=%s but the run wrote no '
                      'CONTROLLER_LOG.json' % cfg.controller)
    else:
      counts = controller_log.get('counts') or {}
      controller_block = {
          'mode': controller_log.get('mode'),
          'counts': counts,
          'last_actions': [
              {k: a.get(k) for k in ('kind', 'objective', 'actuator',
                                     'from', 'to', 'applied')}
              for a in (controller_log.get('actions') or [])[-8:]],
      }
      if counts.get('apply_errors'):
        problems.append(
            'controller recorded %d actuator apply error(s) over the '
            'soak window' % counts['apply_errors'])
  if steps < (20 if not smoke else 2):
    problems.append(f'only {steps} learner steps in {seconds:.0f}s')
  if not losses or not np.all(np.isfinite(losses)):
    problems.append(f'non-finite or missing losses: {losses[-3:]}')
  # Sigma is clipped to its bounds by design: landing on either means the
  # value scale collapsed or diverged (x1.01 so the check can fire).
  sigma_lo = float(popart_lib.DEFAULT_SIGMA_MIN)
  sigma_hi = float(popart_lib.DEFAULT_SIGMA_MAX)
  if not sigmas_max or not np.all(np.isfinite(sigmas_max)):
    problems.append('missing/non-finite popart sigma')
  elif (max(sigmas_max) >= sigma_hi / 1.01 or
        min(sigmas_min) <= sigma_lo * 1.01):
    problems.append(
        f'popart sigma hit its clip bounds: [{min(sigmas_min)}, '
        f'{max(sigmas_max)}]')
  third = max(len(returns) // 3, 1)
  early = float(np.mean(returns[:third])) if returns else float('nan')
  late = float(np.mean(returns[-third:])) if returns else float('nan')
  # Random play on the 3-arm bandit: 5-step episodes x 1/3.
  random_baseline = cfg.episode_length / 3.0
  if not smoke:
    if len(returns) < 12:
      problems.append(f'only {len(returns)} episode returns logged')
    elif not (late > early):
      problems.append(f'return did not improve: early={early:.3f} '
                      f'late={late:.3f}')
    elif late <= 1.5 * random_baseline:
      problems.append(
          f'return does not clear the random baseline '
          f'({random_baseline:.2f}): late={late:.3f}')

  churn_artifact = None
  ambient = None
  if churn:
    respawns = run.fleet.stats()['respawns']
    if churner.env_kills == 0:
      problems.append('churn mode killed no env process')
    elif respawns == 0:
      problems.append(
          f'{churner.env_kills} env kills but fleet recorded 0 '
          'respawns')
    if not smoke:
      # The host was dropped and replaced: the ingest's cumulative
      # connections show both beyond the churn thread's own probe, and
      # unrolls keep landing after the replacement connected.
      needed = 2 + churner.port_probes
      if remote_conns < needed:
        problems.append(
            f'expected >={needed} cumulative remote connections '
            f'({churner.port_probes} probe + original + replacement), '
            f'saw {remote_conns}')
      drop_wall = getattr(churner, 'drop_wall_time', None)
      if drop_wall is None:
        problems.append('remote actor was never dropped/replaced')
      else:
        before = max((v for w, v in remote_unrolls
                      if w <= drop_wall), default=0)
        after = max((v for w, v in remote_unrolls), default=0)
        if after <= before:
          problems.append(
              f'remote unrolls did not resume after the drop: '
              f'{before} before vs {after} final')
    problems.extend(_flatness_problems(churner.samples, steps, smoke))
    churn_artifact = {
        'env_kills': churner.env_kills,
        'fleet_respawns': respawns,
        'remote_connections': remote_conns,
        'remote_unrolls_final': (remote_unrolls[-1][1]
                                 if remote_unrolls else 0),
        'events': churner.events,
        'rss_mb_per_step': rss_mb_per_step(churner.samples, steps),
        'rss_gate': (
            'CPU smoke: 0.5 MB/step' if smoke else
            f'2x the measured ambient {_AMBIENT_RSS_MB_PER_STEP} MB/step'
            if _AMBIENT_RSS_MB_PER_STEP is not None else
            'not judged: the ambient has not been measured on the card'),
        'actor_tail': _file_tail(churner.actor_log, 400),
    }
  else:
    ambient = rss_mb_per_step(churner.samples, steps)

  n_chunks = 8
  chunk = max(len(returns) // n_chunks, 1)
  curve = [round(float(np.mean(returns[i:i + chunk])), 3)
           for i in range(0, len(returns), chunk)]
  artifact = {
      'ok': not problems,
      'problems': problems,
      'seconds': seconds,
      'device': str(device),
      'steps': steps,
      'frames': int(run.frames),
      'episodes_logged': len(returns),
      'return_early_third': round(early, 3),
      'return_late_third': round(late, 3),
      'random_baseline': round(random_baseline, 3),
      'return_curve': curve,
      # The first learner steps' ends, seconds from the call to train.
      'first_step_secs': [round(s['time'] - t_train, 3)
                          for s in run.step_log[:3]],
      'loss_first': round(float(losses[0]), 4) if losses else None,
      'loss_last': round(float(losses[-1]), 4) if losses else None,
      'popart_sigma_range': ([round(float(min(sigmas_min)), 5),
                              round(float(max(sigmas_max)), 5)]
                             if sigmas_max else None),
      'ambient_rss_mb_per_step': ambient,
      'resource_curve': [
          {'t': t, 'rss_mb': r, 'threads': th, 'fds': fd,
           'py_blocks': bl}
          for t, r, th, fd, bl in _downsample(churner.samples)],
      'integrity': integrity_final,
      'telemetry': telemetry_block,
      'slo': slo_block,
      'controller': controller_block,
      'churn': churn_artifact,
      'stack': {
          'torso': cfg.torso, 'compute_dtype': cfg.compute_dtype,
          'frames': [cfg.height, cfg.width],
          'use_instruction': True, 'use_popart': True,
          'pixel_control_cost': cfg.pixel_control_cost,
          'unroll_length': cfg.unroll_length,
          'batch_size': cfg.batch_size, 'num_actors': cfg.num_actors,
          'use_py_process': cfg.use_py_process,
      },
      'smoke': smoke,
      'logdir': logdir,
  }
  if out_path is None:
    out_path = (os.path.join(logdir, 'SOAK_smoke.json') if smoke else
                os.path.join(REPO, 'SOAK_TORCH.json'))
  with open(out_path, 'w') as f:
    json.dump(artifact, f, indent=1)
  artifact['out'] = out_path
  return artifact


def main(argv: Optional[List[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.soak',
      description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="torch device of the learner and the remote "
                           "host (default cuda; 'cpu' to run on the CPU)")
  args = parser.parse_args(argv)
  from scalable_agent_tpu_torch import driver
  device = str(driver.resolve_device(args.device))
  smoke = os.environ.get('SOAK_SMOKE') == '1'
  churn = os.environ.get('SOAK_CHURN') == '1'
  default_secs = ('40' if smoke else '1200' if churn else '600')
  seconds = float(os.environ.get('SOAK_SECONDS', default_secs))
  artifact = soak(smoke, churn, seconds, device=device)
  print(json.dumps(artifact), flush=True)
  if artifact['problems']:
    sys.exit(1)


if __name__ == '__main__':
  # Before any CUDA call: the env processes fork from this server.
  from scalable_agent_tpu_torch.runtime import py_process
  py_process.warm_forkserver(preload=[__spec__.name])
  try:
    main(sys.argv[1:])
  finally:
    py_process.stop_forkserver()
