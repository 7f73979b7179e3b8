"""Experiment driver of the port, after the JAX package's driver.py:
`build_agent`, `choose_mesh`, the device and float32-precision rules of
the entry points, the fleet runtime's training loop (`make_fleet`,
`train`, with the hybrid filler) and the Anakin runtime's
(`train_anakin`), each with checkpoint and resume, the health ladder and
the preemption drain, and population-based training over Anakin members
(`train_population`, serial or in lockstep), and evaluation
(`evaluate`, every test level at once from the newest checkpoint).

The reference's machinery maps as in the JAX driver:

  FIFOQueue + QueueRunner threads      -> TrajectoryBuffer + ActorFleet
  StagingArea GPU prefetch             -> BatchPrefetcher (pinned host
                                          batch, copied on a side stream)
  dynamic_batching monkey-patch        -> InferenceServer (C++ batcher in
                                          front of the agent on the card)
  tf.summary + manual Summary protos   -> SummaryWriter (JSONL) +
                                          EpisodeStats
  gRPC weight fetch by actors          -> InferenceServer.update_params
  PyProcessHook env lifecycle          -> factory.build_environment +
                                          fleet-owned processes
"""

import collections
import dataclasses
import json
import logging
import os
import shutil
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import checkpoint as checkpoint_lib
from scalable_agent_tpu_torch import controller as controller_lib
from scalable_agent_tpu_torch import health as health_lib
from scalable_agent_tpu_torch import learner as learner_lib
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch import popart as popart_lib
from scalable_agent_tpu_torch import population as population_lib
from scalable_agent_tpu_torch import slo as slo_lib
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.analysis import runtime as lock_check
from scalable_agent_tpu_torch.config import (COMPUTE_DTYPES, Config,
                                             validate_controller,
                                             validate_fleet,
                                             validate_integrity,
                                             validate_population,
                                             validate_replay,
                                             validate_runtime,
                                             validate_serving,
                                             validate_slo,
                                             validate_transport)
from scalable_agent_tpu_torch.envs import factory, suites
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.runtime import faults as faults_lib
from scalable_agent_tpu_torch.runtime import inference as inference_lib
from scalable_agent_tpu_torch.runtime import remote
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import Actor, batch_unrolls
from scalable_agent_tpu_torch.runtime.fleet import ActorFleet
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.structs import (ActorOutput, StepOutput,
                                              map_structure)

log = logging.getLogger('scalable_agent_tpu_torch')

# The preemption drain's handoff: written next to the checkpoints at
# drain time, consumed (renamed) by the resuming run.
RESUME_MANIFEST = 'resume_manifest.json'

PRECISION_LINE = 'float32 precision: tf32 off (cudnn, matmul)'
_precision_logged = False


def set_float32_precision() -> None:
  """Float32 layers run in float32 on the card: TF32 off for cuDNN's
  convolutions and for matmuls (PyTorch leaves TF32 convolutions on),
  so the float32 path a user runs is the one held to the reference and
  measured. Logs PRECISION_LINE once per process."""
  global _precision_logged
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  if not _precision_logged:
    _precision_logged = True
    log.info(PRECISION_LINE)


def read_resume_manifest(logdir: str) -> Optional[Dict]:
  """The drain manifest of a previous preempted run, or None."""
  try:
    with open(os.path.join(logdir, RESUME_MANIFEST)) as f:
      return json.load(f)
  except (OSError, ValueError):
    return None


def _write_resume_manifest(logdir: str, manifest: Dict) -> str:
  """Atomic write (tmp + rename): a resume never reads half a manifest."""
  path = os.path.join(logdir, RESUME_MANIFEST)
  tmp = path + '.tmp'
  with open(tmp, 'w') as f:
    json.dump(manifest, f, indent=2, sort_keys=True)
  os.replace(tmp, path)
  return path


def _consume_resume_manifest(logdir: str, restored_steps: int) -> None:
  """Check a preempted run's manifest against the restored step, log
  it, and rename it to `.consumed`, so a later restart does not announce
  the same preemption again."""
  manifest = read_resume_manifest(logdir)
  if manifest is None:
    return
  manifest_steps = int(manifest.get('update_steps', -1))
  if restored_steps == manifest_steps:
    log.info('resuming from preemption drain manifest: step %d, %d frames '
             '(drain latency %.2fs, %d unroll(s) were left in the buffer)',
             manifest_steps, manifest.get('frames', -1),
             manifest.get('drain_latency_secs', -1.0),
             (manifest.get('buffer') or {}).get('leftover_unrolls', 0))
  else:
    # The drain's save was withheld or failed: the ladder restored an
    # older step, and the frames between the two replay.
    log.warning('resume manifest names step %d but the restored '
                'checkpoint is step %d — resuming from the checkpoint '
                '(frames between them replay)', manifest_steps,
                restored_steps)
  try:
    os.replace(os.path.join(logdir, RESUME_MANIFEST),
               os.path.join(logdir, RESUME_MANIFEST + '.consumed'))
  except OSError:
    log.exception('could not consume the resume manifest')


def resolve_device(device) -> torch.device:
  """The device an entry point runs on. 'cuda' with no CUDA raises: the
  port never falls back to the CPU unless the caller asks for it."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} requested but torch.cuda.is_available() is '
        "False; pass device='cpu' to run on the CPU")
  return device


def build_agent(config: Config, num_actions: int,
                num_tasks: int = 1) -> ImpalaAgent:
  """The config's agent, on the CPU with PyTorch's default init: callers
  initialise it (models.init_params) and move it to their device. Its
  parameters are float32 whatever `config.compute_dtype` says. With
  use_popart the value head has `num_tasks` columns."""
  return ImpalaAgent(
      num_actions=num_actions, frame_shape=(config.height, config.width, 3),
      torso=config.torso, dtype=COMPUTE_DTYPES[config.compute_dtype],
      use_instruction=config.resolved_use_instruction,
      num_popart_tasks=num_tasks if config.use_popart else 0,
      use_pixel_control=config.pixel_control_cost > 0,
      pixel_control_cell_size=config.pixel_control_cell_size,
      pixel_control_head_impl=config.pixel_control_head_impl,
      pixel_control_q_f32=config.pixel_control_q_f32)


def choose_mesh(config: Config, device):
  """A [data, model] mesh over the joined group's ranks, on this rank's
  `device`, when the batch can shard; None means one rank's plain
  training (the reference's single-machine mode).

  As in the JAX driver: one rank and model_parallelism 1 give None; a
  model_parallelism that does not divide the ranks raises; the batch
  must divide the batch-sharding width (every rank when it shards over
  the model axis too, else the data axis), and one that does not warns
  and gives None on one host, where every rank then trains the same
  replica, and raises across hosts (as the group's declared topology
  says), where the replicas would never meet."""
  ranks = distributed.world_size()
  width = config.model_parallelism
  if ranks == 1 and width == 1:
    return None
  if width > ranks or ranks % width:
    raise ValueError(f'model_parallelism={width} does not divide the '
                     f'device count {ranks}')
  batch_width = (ranks if sharding.shard_batch_over_model(config)
                 else ranks // width)
  if config.batch_size % batch_width:
    topology = distributed.declared_topology(config)
    if topology is not None and topology.num_nodes > 1:
      raise ValueError(
          f'batch_size={config.batch_size} not divisible by the '
          f'{batch_width} ranks; the unsharded fallback is only safe on '
          'one host')
    log.warning('batch_size %d not divisible by the %d ranks; falling '
                'back to unsharded training on each rank',
                config.batch_size, batch_width)
    return None
  return mesh_lib.make_mesh(device, model_parallelism=width)


def make_fleet(config: Config, policy, buffer, levels: List[str],
               initial_state_fn: Callable, seed_base: int = 0,
               level_offset: int = 0, is_test: bool = False,
               num_actors: Optional[int] = None,
               tasks: Optional[List] = None) -> ActorFleet:
  """The env + actor + fleet construction of train() and evaluate():
  actor i plays levels[(level_offset + i) % len] with env seed
  `seed_base + i + 1`, its env in its own process when
  config.use_py_process. Every (re)spawn builds a fresh env and takes its
  policy state from `initial_state_fn` (the server's
  `initial_core_state`), admitted at PRIORITY_LIVE at a slot's first
  spawn and PRIORITY_RESPAWN after.

  Mixed fleets: `tasks` is population.parse_fleet_tasks's (name, weight)
  list and `levels` its task names (train() passes both). Actor i's task
  comes from the weighted largest-remainder plan
  (population.plan_actor_assignment), its env spec is built for that
  task's backend, and its level id is the task index (one PopArt slot and
  one EpisodeStats curve per task). The task follows the slot, so a
  respawned actor rejoins its task. (JAX's make_fleet infers a mixed
  fleet from `levels` equalling config.fleet_tasks' names; the port takes
  the plan explicitly.)"""
  n = config.num_actors if num_actors is None else num_actors
  spawns = collections.Counter()
  task_plan = None
  if tasks:
    if [name for name, _ in tasks] != list(levels):
      raise ValueError(f'make_fleet: levels {list(levels)} are not the '
                       f'task names of {tasks}')
    task_plan = population_lib.plan_actor_assignment(tasks, n)

  def make_actor(i):
    idx = level_offset + i
    if task_plan is not None:
      idx = task_plan[idx % len(task_plan)]
    level = levels[idx % len(levels)]
    spec = factory.make_env_spec(
        config, level, seed=seed_base + i + 1, is_test=is_test,
        backend=level if task_plan is not None else None)
    env, process = factory.build_environment(
        spec, use_py_process=config.use_py_process)
    # The env_step fault site: `env` itself unless a plan targets it.
    env = faults_lib.maybe_wrap_env(env)
    state = None
    try:
      state = initial_state_fn(priority=(
          inference_lib.PRIORITY_RESPAWN if spawns[i]
          else inference_lib.PRIORITY_LIVE))
      spawns[i] += 1
      actor = Actor(env, policy, state,
                    unroll_length=config.unroll_length,
                    num_action_repeats=config.num_action_repeats,
                    level_name_id=idx % len(levels))
    except BaseException:
      # A denied admission must not leak the env just built, nor a
      # failed actor its slot.
      if hasattr(state, 'release'):
        state.release()
      (process or env).close()
      raise
    return env, process, actor

  return ActorFleet(make_actor, buffer, n,
                    quarantine_after=config.fleet_quarantine_after,
                    probation_secs=config.fleet_probation_secs)


class TrainRun:
  """What a training run leaves: the final TrainState (under tensor
  parallelism, this rank's blocks), the agent, the live objects (closed
  when train() returns) and their final stats, the checkpointer, the
  health monitor and the mesh, and per learner step the host time it
  ended at and the prefetcher's cumulative blocked-get seconds then
  (`step_log`), the fleet's PipelineTracer when one ran (`tracer`,
  closed; its stats() stay readable) and the remote ingest when there
  was one (`ingest`, closed; likewise). The Anakin runtime's has no
  server, fleet, prefetcher, buffer, ingest or tracer, and holds its
  final AnakinCarry (`carry`)."""

  def __init__(self, config, agent=None, state=None, server=None,
               fleet=None, prefetcher=None, buffer=None):
    self.config = config
    self.agent = agent
    self.state = state
    self.server = server
    self.fleet = fleet
    self.prefetcher = prefetcher
    self.buffer = buffer
    self.ingest: Optional[remote.TrajectoryIngestServer] = None
    self.tracer: Optional[telemetry.PipelineTracer] = None
    self.checkpointer: Optional[checkpoint_lib.Checkpointer] = None
    self.health: Optional[health_lib.HealthMonitor] = None
    # The fleet's self-healing controller (controller.py), stopped and
    # finalized; None with controller off or the SLO engine off.
    self.controller: Optional[controller_lib.Controller] = None
    self.mesh = None
    self.carry = None
    self.members = None
    self.stats: Dict[str, Dict] = {}
    self.step_log: List[Dict[str, float]] = []
    # Under sample reuse: the fresh env frames consumed so far, counted
    # at serve time (driver.train).
    self.env_frames_fn: Optional[Callable[[], int]] = None

  @property
  def frames(self) -> int:
    if self.env_frames_fn is not None:
      return int(self.env_frames_fn())
    return self.state.update_steps * self.config.frames_per_step


def _stats_only_view(batch: ActorOutput) -> ActorOutput:
  """The part of a host batch that EpisodeStats reads: [B] level ids and
  [T+1, B] done and info (a few bytes, peeled before the copy)."""
  info = map_structure(np.copy, batch.env_outputs.info)
  return ActorOutput(
      level_name=np.copy(batch.level_name), agent_state=None,
      env_outputs=StepOutput(reward=None, info=info,
                             done=np.copy(batch.env_outputs.done),
                             observation=None),
      agent_outputs=None)


class _HealthLadder:
  """The loops' side of the health ladder (health.py): feeds the
  monitor each step's sentinels one step late, brackets bad bursts with
  incidents, rolls back to the last good checkpoint on ROLLBACK (the
  step counter stays where it is: params, optimizer state, the PopArt
  statistics and IMPACT's target network revert), and halts with a bundle on HALT or when nothing is
  restorable. `healthy` is False while a bad burst is open: no save
  lands then, since a save would advance LAST_GOOD onto the diverged
  state.

  With `sdc` (the (fingerprint_fn, replicas) of
  train_parallel.make_sdc_fingerprint_fn) each check also all-gathers
  the replicas' param fingerprints, read with the sentinels one step
  late into `sdc_replica_mismatch`; the `replica_divergence` fault fires
  there, one event per check, perturbing one replica's probe lane."""

  def __init__(self, config: Config, monitor, checkpointer, incidents,
               sdc=None, tracer=None):
    self._config = config
    self.monitor = monitor
    self._checkpointer = checkpointer
    self._incidents = incidents
    self._sdc = sdc
    # The fleet's tracer: its flight recorder rides the halt bundle and
    # is dumped beside a rollback's incident.
    self._tracer = tracer
    self._pending = None
    self.bad_count_in_burst = 0

  @property
  def healthy(self) -> bool:
    return self.monitor is None or self.bad_count_in_burst == 0

  def _fingerprints(self, step_now: int, state):
    fingerprint_fn, replicas = self._sdc
    probe = np.zeros((replicas,), np.uint32)
    fault = faults_lib.fire('replica_divergence')
    if fault is not None:
      victim = fault.index % replicas
      probe[victim] = np.uint32(1 + (fault.index % 1000))
      self._incidents.event('fault_replica_divergence', step=step_now,
                            replica=victim)
    return fingerprint_fn(state.params, probe)

  def after_step(self, steps_done: int, step_now: int, metrics, state):
    """Stash this step's sentinels and judge the previous step's; returns
    (state, rolled back step or None). Raises TrainingDivergence on a
    halt."""
    if self.monitor is None:
      return state, None
    previous, self._pending = self._pending, None
    if steps_done % self._config.health_check_every_steps == 0:
      fingerprints = (self._fingerprints(step_now, state)
                      if self._sdc is not None else None)
      self._pending = (step_now, health_lib.stack_sentinels(metrics),
                       fingerprints)
    if previous is None:
      return state, None
    obs_step, handle, fingerprints = previous
    monitor = self.monitor
    values = health_lib.read_handle(handle)
    if fingerprints is not None:
      mismatch, fps = health_lib.read_fingerprints(fingerprints)
      values['sdc_replica_mismatch'] = mismatch
      if mismatch:
        self._incidents.event('sdc_replica_mismatch', step=obs_step,
                              fingerprints=fps)
        log.error('SDC sentinel: per-replica param fingerprints DISAGREE at '
                  'step %d: %s — deterministic compute violated (suspect '
                  'the card or its memory)', obs_step,
                  [f'{v:08x}' for v in fps])
    verdict = monitor.observe_values(obs_step, values)
    # Bursts are judged by verdicts, not the monitor's consecutive count,
    # which a ROLLBACK resets.
    self.bad_count_in_burst += (verdict != health_lib.OK)
    if verdict != health_lib.OK and self.bad_count_in_burst == 1:
      self._incidents.event('health_bad_burst_start', step=obs_step,
                            reason=monitor.last_reason)
      log.warning('unhealthy training step %d: %s', obs_step,
                  monitor.last_reason)
    elif verdict == health_lib.OK and self.bad_count_in_burst > 0:
      self._incidents.event('health_recovered', step=obs_step,
                            bad_steps=self.bad_count_in_burst)
      self.bad_count_in_burst = 0
    restored_step = None
    if verdict == health_lib.ROLLBACK:
      rolled = self._checkpointer.restore_last_good(state)
      if rolled is None:
        verdict = health_lib.HALT
        monitor.rollbacks -= 1  # granted but not honoured
        monitor.last_reason = (f'{monitor.last_reason}; rollback requested '
                               'but no restorable checkpoint exists')
      else:
        restored_step = rolled.update_steps
        state = rolled._replace(update_steps=state.update_steps)
        self._incidents.event('rollback', step=step_now,
                              restored_checkpoint_step=restored_step,
                              reason=monitor.last_reason,
                              flight=self._flight_file(step_now))
        log.warning('health rollback at step %d: restored checkpoint step '
                    '%d (params/optimizer/popart revert; the step counter '
                    'keeps running)', step_now, restored_step)
    if verdict == health_lib.HALT:
      bundle = monitor.write_halt_bundle(
          self._config.logdir, self._config, step_now,
          reason=monitor.last_reason,
          flight=(self._tracer.flight.dump() if self._tracer is not None
                  else None))
      self._incidents.event('health_halt', step=step_now,
                            reason=monitor.last_reason, bundle=bundle)
      raise health_lib.TrainingDivergence(
          f'training halted at step {step_now} after {monitor.rollbacks} '
          f'rollback escalation(s): {monitor.last_reason}. Diagnostic '
          f'bundle: {bundle}', bundle_path=bundle)
    return state, restored_step

  def _flight_file(self, step_now: int) -> Optional[str]:
    """The flight recorder dumped under <logdir>/diagnostics/ beside a
    rollback (the pipeline's recent history, not only a counter total);
    None without a tracer or when the write fails."""
    if self._tracer is None:
      return None
    try:
      out_dir = os.path.join(self._config.logdir, 'diagnostics')
      os.makedirs(out_dir, exist_ok=True)
      return self._tracer.flight.write(os.path.join(
          out_dir, f'flight_rollback_step{step_now}.json'))
    except OSError:
      log.exception('flight-recorder dump failed')
      return None

  def write_summaries(self, writer, step: int):
    if self.monitor is not None:
      stats = self.monitor.stats()
      writer.scalars({k: stats[k] for k in ('skipped_steps', 'flagged_steps',
                                            'rollbacks', 'halts')}, step)
    if self._sdc is not None and self.monitor is not None:
      writer.scalar('sdc_replica_mismatches', self.monitor.sdc_mismatches,
                    step)
    writer.scalars({
        'checkpoint_save_errors': self._checkpointer.save_errors,
        'checkpoint_restore_fallbacks': self._checkpointer.restore_fallbacks,
        'ckpt_digest_fallbacks': self._checkpointer.digest_fallbacks}, step)


def make_checkpointer(config: Config, mesh=None, registry=None,
                      layout=None):
  """The run's Checkpointer, at `<logdir>/checkpoints`."""
  return checkpoint_lib.Checkpointer(
      os.path.join(config.logdir, 'checkpoints'),
      save_interval_secs=config.checkpoint_secs,
      verify_digests=config.ckpt_digests, mesh=mesh, registry=registry,
      layout=layout, torso=config.torso)


def restore_at_start(checkpointer, state):
  """restore_latest into `state`; returns the state to train from."""
  restored = checkpointer.restore_latest(state)
  if restored is None:
    return state
  log.info('restored checkpoint at step %d (%.1f ms)', restored.update_steps,
           1e3 * checkpointer.last_restore_secs)
  return restored


def _periodic_save(config: Config, checkpointer, ladder, state,
                   steps_done: int, grouped: bool) -> None:
  """The loops' periodic save, withheld while a bad burst is open (it
  would advance LAST_GOOD onto the diverged state and evict the healthy
  steps). Under a group the decision is rank 0's clock, checked every
  checkpoint_check_every_steps; the verdicts, so `healthy`, are the
  same on every rank."""
  if not grouped:
    if ladder.healthy:
      checkpointer.maybe_save(state)
  elif steps_done % config.checkpoint_check_every_steps == 0:
    decision = checkpointer.group_should_save() and ladder.healthy
    checkpointer.maybe_save(state, decision=decision)


def _start_slo_engine(config: Config, writer, incidents, flight=None,
                      health=None) -> Optional[slo_lib.SloEngine]:
  """The run's SLO engine (slo.py), started; None with slo_engine off.
  Its cadence defaults to the summary cadence, clamped to [1, 30] s and
  to a quarter of the fast window, so a value objective always gets the
  3 fast-window samples it needs to burn."""
  if not config.slo_engine:
    return None
  objectives = slo_lib.load_objectives(
      config.slo_spec, fast_window_secs=config.slo_fast_window_secs,
      slow_window_secs=config.slo_slow_window_secs)
  engine = slo_lib.SloEngine(
      objectives, config.logdir, writer=writer, incidents=incidents,
      flight=flight, health=health, capture=config.slo_capture,
      interval_secs=_slo_interval(config),
      baseline=slo_lib.load_baseline(config.slo_fps_baseline))
  engine.start()
  return engine


def _slo_interval(config: Config) -> float:
  """The SLO engine's cadence: slo_interval_secs, else the summary
  cadence clamped to [1, 30] s and to a quarter of the fast window."""
  if config.slo_interval_secs > 0:
    return config.slo_interval_secs
  return min(max(float(config.summary_secs), 1.0), 30.0,
             config.slo_fast_window_secs / 4.0)


def _start_controller(config: Config, slo_engine, prefetcher, server, fleet,
                      ingest, publish_cadence: Dict, rank: int, incidents,
                      health) -> Optional[controller_lib.Controller]:
  """The fleet's self-healing controller (controller.py), started; None
  with controller off, or with the SLO engine off (its only input).

  Its actuators, as JAX's driver registers them: `replay_k` (the
  prefetcher, bounded by controller_replay_k_max), `admission` (the
  server's policy), `publish_secs` (the loop's remote publish cadence
  cell, with an ingest), `fleet_size` (the fleet's target, with local
  actors) and, on rank 0 with an ingest and pod_max_hosts > 0,
  `pod_size`: a move writes the desired actor-host count, the live hosts
  and the membership to <logdir>/POD_TARGET.json (atomic) for the
  cluster's supervisor to reconcile; the learner spawns no host. The
  tick defaults to the SLO engine's cadence. The log is
  CONTROLLER_LOG.json on rank 0 and CONTROLLER_LOG_p<rank>.json on
  the others."""
  if config.controller == 'off':
    return None
  if slo_engine is None:
    log.warning('controller=%s ignored: the SLO engine is off and the '
                'controller has no other input', config.controller)
    return None
  rules = controller_lib.load_rules(config.controller_policy)
  actuators = [
      controller_lib.Actuator(
          'replay_k', kind='int', get_fn=lambda: prefetcher.replay_k,
          set_fn=prefetcher.set_replay_k, minimum=1,
          maximum=max(config.controller_replay_k_max, config.replay_k)),
      controller_lib.Actuator(
          'admission', kind='enum', get_fn=lambda: server.admission,
          set_fn=server.set_admission,
          values=inference_lib.ADMISSION_POLICIES),
  ]
  if ingest is not None:
    actuators.append(controller_lib.Actuator(
        'publish_secs', kind='float',
        get_fn=lambda: publish_cadence['secs'],
        set_fn=lambda v: publish_cadence.__setitem__('secs', float(v)),
        minimum=float(config.remote_publish_secs),
        maximum=max(config.controller_publish_secs_max,
                    float(config.remote_publish_secs))))
  if config.num_actors > 0 and hasattr(fleet, 'set_target_size'):
    actuators.append(controller_lib.Actuator(
        'fleet_size', kind='int', get_fn=fleet.target_size,
        set_fn=fleet.set_target_size, minimum=1,
        maximum=config.num_actors))
  if ingest is not None and rank == 0 and config.pod_max_hosts > 0:
    pod_target = {'hosts': None}  # None: never moved, mirror the live

    def pod_target_get():
      if pod_target['hosts'] is not None:
        return pod_target['hosts']
      return max(ingest.live_hosts(), 1)

    def pod_target_set(n):
      pod_target['hosts'] = int(n)
      payload = {'target_hosts': int(n), 'live_hosts': ingest.live_hosts(),
                 'membership': ingest.membership(),
                 'wall_time': round(time.time(), 3)}
      path = os.path.join(config.logdir, 'POD_TARGET.json')
      tmp = f'{path}.tmp'
      with open(tmp, 'w') as f:
        json.dump(payload, f, indent=2)
      os.replace(tmp, path)

    actuators.append(controller_lib.Actuator(
        'pod_size', kind='int', get_fn=pod_target_get,
        set_fn=pod_target_set, minimum=1, maximum=config.pod_max_hosts))
  interval = (config.controller_interval_secs
              if config.controller_interval_secs > 0
              else _slo_interval(config))
  ctrl = controller_lib.Controller(
      slo_engine, rules, actuators, config.logdir, mode=config.controller,
      interval_secs=interval, incidents=incidents, health=health,
      log_name=('CONTROLLER_LOG.json' if rank == 0
                else f'CONTROLLER_LOG_p{rank}.json'))
  ctrl.start()
  log.info('controller started in %r mode: %d rule(s) over %d '
           'actuator(s)', config.controller, len(ctrl._rules),
           len(actuators))
  return ctrl


def _finish_controller(ctrl: controller_lib.Controller) -> None:
  """Stop the controller's thread (it reads the engine and moves
  component knobs, both about to close) and write CONTROLLER_LOG.json,
  on every exit path."""
  try:
    ctrl.stop()
    counts = ctrl.finalize()
    log.info('controller [%s]: %d action(s) (%d escalation(s), %d '
             'revert(s), %d applied) -> %s', ctrl.mode, counts['actions'],
             counts['escalations'], counts['reverts'], counts['applied'],
             os.path.basename(ctrl._log_path))
  except Exception:
    log.exception('controller finalize failed')


def _write_controller_summaries(writer, ctrl, prefetcher,
                                publish_cadence: Dict, step: int) -> None:
  """The controller's counts and the live actuator values, in the
  stream the objectives are judged from."""
  if ctrl is None:
    return
  counts = ctrl.counts()
  writer.scalars({'controller_actions': counts['actions'],
                  'controller_reverts': counts['reverts'],
                  'controller_engaged': ctrl.engaged_rules(),
                  'controller_replay_k': prefetcher.replay_k,
                  'controller_publish_secs': publish_cadence['secs']},
                 step)


def _finish_slo(engine: slo_lib.SloEngine, path: str, extra: Dict) -> None:
  """Stop the engine's thread and write its verdict to `path` (every
  exit path: a crashed run's verdict is what its postmortem reads)."""
  try:
    engine.stop()
    verdict = engine.finalize(path, extra=extra)
    (log.info if verdict['pass'] else log.warning)(
        'SLO verdict: %s (%d objective(s), violations: %s) -> %s',
        'PASS' if verdict['pass'] else 'FAIL', len(verdict['objectives']),
        verdict['violations'] or 'none', os.path.basename(path))
  except Exception:
    log.exception('SLO verdict write failed')


def profiler_running() -> bool:
  """True while a torch.profiler session is enabled anywhere in this
  process (its CUDA collection is process-wide: a second session would
  end the first one's)."""
  from torch.autograd import profiler as autograd_profiler
  return bool(getattr(autograd_profiler, '_is_profiler_enabled', False)
              or torch._C._autograd._profiler_enabled())


class _ProfileWindows:
  """The loop's profiler, one capture at a time over torch.profiler (CPU
  and, on the card, CUDA activities), each written as a Chrome trace
  (trace.json) when it stops:

  - the operator's window (`profile_dir`, when `operator` is True):
    learner steps [profile_start_step, profile_start_step +
    profile_num_steps); it defers past an in-flight SLO capture and
    wins over a queued one;
  - the SLO engine's captures: a page burn's queued request traces the
    next slo_capture_steps steps into diagnostics/slo_profile_<name>/.

  Neither starts while another profiler is enabled in the process (a
  caller's own window): the operator's stays pending, and an SLO request
  takes the engine's failure path, note_profile(name, None). Only a
  profiler this object started is ever stopped."""

  def __init__(self, config: Config, engine, device, operator=True):
    self._config = config
    self._engine = engine
    self._activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
      self._activities.append(torch.profiler.ProfilerActivity.CUDA)
    self._prof = None
    self._owner = None       # 'operator', or the SLO objective's name
    self._out_dir = None
    self._stop_step = None
    self.pending = bool(operator and config.profile_dir)

  def _start(self, out_dir: str) -> bool:
    if profiler_running():
      return False
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=self._activities)
    prof.start()
    self._prof, self._out_dir = prof, out_dir
    return True

  def _stop(self) -> Optional[str]:
    prof, self._prof, self._owner = self._prof, None, None
    if torch.profiler.ProfilerActivity.CUDA in self._activities:
      torch.cuda.synchronize()  # the window's kernels complete inside it
    prof.stop()
    path = os.path.join(self._out_dir, 'trace.json')
    prof.export_chrome_trace(path)
    return path

  def step(self, steps_done: int) -> None:
    """After learner step `steps_done`: stop a window that ran its
    steps, or start the operator's window or the next SLO capture."""
    config = self._config
    if self._prof is not None and steps_done >= self._stop_step:
      owner = self._owner
      path = self._stop()
      if owner == 'operator':
        log.info('profiler trace written to %s', path)
      else:
        log.info('SLO diagnostic profile for %r complete: %s', owner, path)
    if self._prof is not None:
      return
    if self.pending and steps_done >= config.profile_start_step:
      if self._start(config.profile_dir):
        self.pending = False
        self._owner = 'operator'
        self._stop_step = steps_done + config.profile_num_steps
      return
    if self._engine is None:
      return
    req = self._engine.take_profile_request()
    if req is None:
      return
    out_dir = os.path.join(config.logdir, 'diagnostics', f'slo_profile_{req}')
    try:
      started = self._start(out_dir)
    except Exception:
      log.exception('SLO profiler capture failed to start')
      started = False
    if not started:
      log.warning('SLO page (%s): no profiler capture (another profiler is '
                  'running in this process)', req)
      self._engine.note_profile(req, None)
      return
    self._owner = req
    self._stop_step = steps_done + config.slo_capture_steps
    self._engine.note_profile(req, out_dir)
    log.warning('SLO page (%s): capturing a %d-step profiler trace into %s',
                req, config.slo_capture_steps, out_dir)

  def close(self, steps_done: int) -> None:
    """The run's end: stop and write a window still open; warn when the
    operator's never started."""
    if self._prof is not None:
      try:
        log.info('profiler trace written to %s', self._stop())
      except Exception:
        log.exception('profiler stop failed')
    if self.pending:
      log.warning(
          'profile_dir set but the run ended at step %d before the window '
          'could start (profile_start_step=%d, or another profiler held '
          'the process) — no operator trace was captured', steps_done,
          self._config.profile_start_step)


def _final_save(checkpointer, ladder, state, grouped: bool = False):
  """The tail save: forced, unless training was unhealthy at exit (the
  retained last good step covers the resume), or, under a group, an
  exception is on its way out: the save is a collective, only this rank
  is here, and waiting for the others would hang."""
  if grouped and sys.exc_info()[0] is not None:
    return
  if not ladder.healthy:
    log.warning('skipping final checkpoint: training was unhealthy at '
                'exit (the retained last-known-good checkpoint covers '
                'the resume)')
  else:
    checkpointer.save(state, force=True)


def train(config: Config, max_steps: Optional[int] = None, device='cuda',
          stall_timeout_secs: Optional[float] = None,
          on_step: Optional[Callable] = None,
          drain_event: Optional[threading.Event] = None):
  """IMPALA training until total_environment_frames (or `max_steps` more
  learner steps).

  `config.pbt_population >= 2` runs `train_population` (Anakin
  members), and `config.runtime == 'anakin'` runs `train_anakin`. The
  fleet runtime, in
  order: the env spec and the agent, the mesh (`choose_mesh`, under a
  process group) and the learner state, the restore of the newest
  restorable checkpoint under `<logdir>/checkpoints` (steps, frames and
  summaries count on from its step, and a preempted run's resume
  manifest is consumed), the trajectory buffer, the inference server
  (published at the restored step, so its first snapshot holds the
  restored weights, and warmed up to the fleet size), the fleet, the
  batch or unroll staging and the prefetcher; then the loop:
  prefetcher.get -> train step -> the health ladder -> publish every
  `publish_params_every` steps -> summaries -> the periodic save. A
  `finally` tears all of it down, also after a failed set-up, and takes
  the final save unless training was unhealthy at exit.

  The learner extensions: with use_popart the value head has one column
  per training level (a suite's levels, `factory.level_names`), actor i
  stamps level id i % len(levels), and the statistics are logged per
  task at the end. With replay_ratio > 0 a replay tier retains the
  consumed unrolls behind the buffer (its staleness clock is the publish
  cadence), and with replay_k > 1 the prefetcher serves each staged
  batch replay_k times; under either, the frame budget, the fps meter,
  `TrainRun.frames` and the drain manifest count the fresh slots served,
  and episode stats count only a batch's fresh columns at its first
  serve.

  The health ladder (health.py) reads each step's sentinels one step
  late: K bad steps roll back to LAST_GOOD and republish; a rollback with
  nothing to restore, or past the budget, halts with a bundle and raises
  TrainingDivergence. The preemption drain starts when `drain_event` is
  set (the CLI's first SIGTERM) or the `preempt_signal` fault fires: the
  fleet stops producing, the loop trains what the buffer holds until the
  feed dries or preempt_drain_timeout_secs runs out, the fleet is
  quiesced, a verified save runs and resume_manifest.json is written; the
  call then returns normally.

  Under a process group (the JAX driver's multi-host fleet; here every
  rank is a process with its own fleet): `batch_size` is global and each
  rank's fleet feeds its B / ranks rows; env and inference seeds are
  offset by `rank * max(num_actors, 1000)`; rank 0 writes config.json,
  summaries.jsonl and incidents.jsonl, rank r > 0 summaries_p{r}.jsonl
  and incidents_p{r}.jsonl; params start as rank 0's broadcast; the save
  decision is rank 0's, checked every checkpoint_check_every_steps; a
  checkpoint saved on another mesh restores through the registry's
  resharding (`Checkpointer.restore_resharded`, the `topology_resharded`
  incident). A stop request (the drain's triggers) is rank 0's,
  broadcast once per learner step, so every rank leaves the loop at the
  same step: as in JAX, with no drain save and no manifest (the tail save
  still runs). Under tensor parallelism the state holds this rank's
  blocks and each publish gathers a full copy over the model group for
  the server. With >= 2 data replicas the SDC sentinel (sdc_check) runs
  with the health ladder. Every collective runs on this lockstep path.

  The serving plane: the server is built from the config (the state
  arena with its admission policy, the version table, the int8 codec),
  the summaries carry its admission and version counters, and the fleet's
  health is checked after every learner step (respawns, and the slots a
  `set_target_size` unparked). With fleet_tasks the task list replaces
  the level list: one PopArt column and one episode curve per task, the
  actors apportioned by make_fleet's plan, and tasks whose action widths
  differ raise. On a suite (dmlab30, atari57) EpisodeStats writes its
  training scores.

  The hybrid filler (anakin_filler, parallel/anakin.HybridFiller): when
  the prefetcher has no staged batch (its ready() probe), the loop runs
  one fused self-play step on the live train state instead of waiting,
  and probes again. Filler updates leave update_steps, the frame budget,
  the LR's count, the publish cadence and the checkpoint numbering on the
  fleet's clock; `filler_updates`, `filler_frames` and
  `filler_skipped_updates` are summarised apart, and the drain manifest
  carries the filler's stats. Under a process group or a model axis the
  filler parks with a warning (`supports_filler`); a filler core that
  cannot take the task's head width raises at spin-up.

  The telemetry plane: with telemetry_trace a PipelineTracer is installed
  before the fleet starts; each unroll's span is stamped done (actor),
  staged and serve (prefetcher) and step (here), and traces.jsonl
  (traces_p{r}.jsonl off rank 0) gets one record per learner step with
  the policy-lag vector; its flight recorder rides the halt bundle and a
  rollback's dump. The loop's clocks and plane split are registry gauges
  (`driver/*`), and the drain manifest carries the registry's snapshot.
  lock_order_check arms the lock-order checker before any component
  builds its locks; a detection is a durable `lock_order_inversion`
  incident. The env_step fault site wraps each env (make_fleet), and
  slow_learner fires once per learner step before the train step (a
  `fault_slow_learner` incident); a health check that respawns actors
  writes `actors_respawned` with their errors.

  Remote actors (runtime/remote.py): with remote_actor_port a
  TrajectoryIngestServer listens before the inference server is built,
  its unrolls landing in the same buffer as the local fleet's
  (num_actors=0 trains on the wire alone). Each publish step also
  publishes a host copy of the served params to the ingest, at most
  every remote_publish_secs and only while a connection is live (a
  rollback always publishes); live connections count as producers in
  the env-plane split, and the summaries carry the remote_*/ingest_*
  counters, with incidents for CRC and digest refusals, reaps, wedged
  threads and membership changes. The `learner_crash` fault fires once
  per consumed batch. A failed set-up closes the ingest without a 'bye'
  (actors keep retrying), a clean end or a drain with one. After the
  server's warmup the ingest's 'infer' kind is attached to
  `server.serve_remote` (routed serving: actor hosts with a
  runtime/routing.ServingRouter), and its drain notice goes up first at
  the end.

  The SLO engine (slo.py, slo_engine): started before the fleet, judged
  again in every summary block, its verdict written to
  SLO_VERDICT.json (SLO_VERDICT_p{r}.json off rank 0) on every exit path
  before the components close, and carried by the drain manifest under
  'slo'. A page burn's profiler capture and the operator's profile_dir
  window run in this loop (`_ProfileWindows`), one at a time, and never
  while another torch.profiler session is enabled in the process.

  `on_step(run, steps_done, metrics)` runs after each learner step
  (chip_smoke.py times and profiles with it). `device` defaults to CUDA
  and raises without it. Returns the TrainRun.
  """
  # Arm before any component builds its locks (make_lock reads the
  # armed state at construction), for both runtimes. Arm only: a False
  # flag must not strip the LOCK_ORDER_CHECK environment's arming.
  if config.lock_order_check:
    lock_check.arm()
  if config.pbt_population >= 2:
    # The population owns its members' Anakin runs end to end.
    return train_population(config, max_steps=max_steps, device=device,
                            drain_event=drain_event)
  if config.runtime == 'anakin':
    return train_anakin(config, max_steps=max_steps, device=device,
                        drain_event=drain_event)
  validate_fleet(config)
  for warning in (validate_runtime(config) + validate_integrity(config) +
                  validate_replay(config) + validate_population(config) +
                  validate_transport(config) + validate_slo(config) +
                  validate_controller(config) + validate_serving(config)):
    log.warning('%s', warning)
  device = resolve_device(device)
  set_float32_precision()
  world, rank = distributed.world_size(), distributed.rank()
  if config.batch_size % world:
    raise ValueError(f'batch_size={config.batch_size} must divide by '
                     f'process count {world}')
  local_batch_size = config.batch_size // world
  levels = factory.level_names(config)
  fleet_tasks = population_lib.parse_fleet_tasks(config.fleet_tasks)
  if fleet_tasks:
    # A mixed fleet: the task list replaces the level list (one PopArt
    # slot and one EpisodeStats curve per task; make_fleet applies the
    # weighted actor plan). One policy head serves every task, so the
    # tasks' action widths must agree.
    levels = [name for name, _ in fleet_tasks]
    specs = [factory.make_env_spec(config, name, seed=1, backend=name)
             for name in levels]
    widths = sorted({spec.num_actions for spec in specs})
    if len(widths) > 1:
      raise ValueError(
          f'fleet_tasks suites disagree on action width {widths}: one '
          'shared policy head needs one width — set --num_actions')
    spec0 = specs[0]
  else:
    spec0 = factory.make_env_spec(config, levels[0], seed=1)
  num_actions = spec0.num_actions
  # PopArt: one value column per training level (a suite's 30 for
  # dmlab30) or task; actor i stamps its unrolls with its level id.
  num_tasks = len(levels)
  agent = build_agent(config, num_actions, num_tasks)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  mesh = choose_mesh(config, device)
  grouped = mesh is not None and mesh.world_size > 1
  registry = sharding.from_config(config)
  layout = None
  if mesh is not None:
    state = train_parallel.make_sharded_train_state(
        agent, config, mesh, registry=registry, num_popart_tasks=num_tasks)
    train_step, _ = train_parallel.make_sharded_train_step(
        agent, config, mesh, None, registry=registry)
    layout = train_step.layout
  else:
    train_step = learner_lib.make_train_step_fn(agent, config)
    state = learner_lib.make_train_state(agent, config, num_tasks)
  checkpointer = make_checkpointer(config, mesh, registry, layout)
  # The elastic restore gate: a checkpoint saved on another mesh
  # restores through the registry's resharding, strictly.
  topology = distributed.topology_delta(checkpointer.saved_mesh_shape(),
                                        mesh)
  if topology is not None:
    log.warning('cross-topology restore: checkpoint saved on mesh %s, this '
                'run is mesh %s (%d process(es)) — resharding onto registry '
                'targets for the live topology', topology['saved_mesh'],
                topology['live_mesh'], topology['processes'])
    restored = checkpointer.restore_resharded(state, registry, mesh)
    if restored is None:
      topology = None
    else:
      log.info('restored checkpoint at step %d (%.1f ms)',
               restored.update_steps, 1e3 * checkpointer.last_restore_secs)
      state = restored
  else:
    # Before the server exists: its first publish carries these weights.
    state = restore_at_start(checkpointer, state)
  initial_steps = state.update_steps
  if rank == 0:
    _consume_resume_manifest(config.logdir, initial_steps)
  run = TrainRun(config, agent, state)
  run.checkpointer = checkpointer
  run.mesh = mesh
  run.health = (health_lib.monitor_from_config(config)
                if config.health_watchdog else None)
  sdc = None
  if (config.sdc_check and config.health_watchdog
      and train_parallel.supports_sdc_check(config, mesh)):
    sdc = train_parallel.make_sdc_fingerprint_fn(mesh)
    log.info('SDC sentinel armed: param fingerprints cross-checked across '
             '%d data replicas', sdc[1])
  localize = sharding.needs_host_local_params(config, mesh)

  def actor_params(params):
    """What the server serves: under TP a full copy, gathered over the
    model group (a collective: on the lockstep path only)."""
    return layout.gather_tree(params) if localize and layout else params

  if device.type == 'cuda':
    copy_stream = torch.cuda.Stream(device)
    learner_stream = torch.cuda.current_stream(device)

    def stack(items):
      return batch_unrolls(items, empty=learner_lib.pinned_empty)

    def place(batch):
      return learner_lib.place_batch(batch, device, copy_stream,
                                     learner_stream)
  else:
    copy_stream = learner_stream = None
    stack = batch_unrolls

    def place(batch):
      return learner_lib.place_batch(batch, device)

  def stage(host_batch, n_fresh=None):
    """Prefetcher stage: peel the host stats view and the action counts
    of the trained-on steps ([1:] drops the overlap row, as the loss
    does), then copy the batch to the device. With a replay tier the
    peel takes the `n_fresh` fresh columns only: a replayed unroll's
    episodes and actions were counted at its first consumption."""
    view = host_batch
    if n_fresh is not None:
      view = ActorOutput(
          level_name=np.asarray(host_batch.level_name)[:n_fresh],
          agent_state=None,
          env_outputs=StepOutput(
              reward=None,
              info=map_structure(lambda x: np.asarray(x)[:, :n_fresh],
                                 host_batch.env_outputs.info),
              done=np.asarray(host_batch.env_outputs.done)[:, :n_fresh],
              observation=None),
          agent_outputs=host_batch.agent_outputs._replace(
              action=np.asarray(host_batch.agent_outputs.action)[:, :n_fresh]))
    action_counts = np.bincount(
        np.asarray(view.agent_outputs.action)[1:].ravel(),
        minlength=num_actions)
    return _stats_only_view(view), action_counts, place(host_batch)

  no_actions = np.zeros((num_actions,), np.int64)

  def reserve_view(item):
    """A re-serve (replay_k > 1): the staged device batch trains again,
    and its host view is blanked, since it consumes no new env frames."""
    return None, no_actions, item[2]

  def unroll_view(unroll):
    """Unroll staging's per-unroll peel of `stage`'s host view."""
    return (np.asarray(unroll.level_name),
            map_structure(np.copy, unroll.env_outputs.info),
            np.copy(unroll.env_outputs.done),
            np.bincount(np.asarray(unroll.agent_outputs.action)[1:],
                        minlength=num_actions))

  def finalize_views(views, batch):
    stats_view = ActorOutput(
        level_name=np.stack([v[0] for v in views]), agent_state=None,
        env_outputs=StepOutput(
            reward=None,
            info=map_structure(lambda *xs: np.stack(xs, axis=1),
                               *[v[1] for v in views]),
            done=np.stack([v[2] for v in views], axis=1), observation=None),
        agent_outputs=None)
    return stats_view, np.sum([v[3] for v in views], axis=0), batch

  stager = None
  if config.staging_mode == 'unroll':
    if train_parallel.supports_unroll_staging(config, mesh):
      stager = ring_buffer.UnrollBatchStager(
          local_batch_size, device=device, host_view_fn=unroll_view,
          finalize_fn=finalize_views, copy_stream=copy_stream,
          consumer_stream=learner_stream)
    else:
      log.warning(
          'staging_mode=unroll unsupported on this topology (model-axis '
          'batch sharding) — falling back to batch staging')

  process_seed_base = rank * max(config.num_actors, 1000)
  buffer = server = fleet = prefetcher = writer = incidents = None
  filler = tracer = ingest = slo_engine = ctrl = None
  # The remote publish cadence, a cell the controller's publish_secs
  # actuator may stretch; the loop reads it in place of the config.
  publish_cadence = {'secs': float(config.remote_publish_secs)}
  try:
    # The replay tier retains consumed unrolls behind the FIFO; their
    # staleness counts in published param versions.
    replay_tier = None
    if config.replay_ratio > 0:
      replay_tier = ring_buffer.ReplayTier(
          config.resolved_replay_capacity,
          max_staleness=config.resolved_replay_max_staleness,
          verify_crc=config.replay_crc)
    buffer = ring_buffer.TrajectoryBuffer(
        max(config.queue_capacity_batches * config.batch_size,
            config.batch_size), replay=replay_tier,
        replay_ratio=config.replay_ratio)
    buffer.note_param_version(initial_steps)
    # One copy of the served params, before the ingest branch: under TP
    # actor_params is a collective, and remote_actor_port may be set on
    # some ranks only.
    initial_pub = actor_params(state.params)
    if config.remote_actor_port:
      # Before the inference server and its warmup: actor hosts connect
      # and fetch params meanwhile.
      ingest = remote.TrajectoryIngestServer(
          buffer, host_params(initial_pub),
          host=config.remote_actor_bind_host,
          port=config.remote_actor_port,
          contract=remote.trajectory_contract(config, agent, num_actions),
          wire_dtype=config.resolved_wire_dtype,
          ingest_workers=config.ingest_workers,
          max_unroll_staleness=config.max_unroll_staleness,
          heartbeat_secs=config.remote_heartbeat_secs,
          idle_timeout_secs=config.remote_conn_idle_timeout_secs,
          wire_crc=config.wire_crc,
          trace=config.telemetry_trace)
      run.ingest = ingest
      log.info('remote-actor ingest listening on port %d (session epoch '
               '%d)', ingest.port, ingest.session_epoch)
    server = InferenceServer(
        build_agent(config, num_actions, num_tasks), initial_pub, config,
        seed=config.seed + 1000 + process_seed_base,
        fleet_size=config.num_actors, device=device)
    server.update_params(initial_pub, version=initial_steps)
    if config.num_actors > 0:
      server.warmup(spec0.obs_spec, max_size=config.num_actors)
    if ingest is not None:
      # Routed serving: the ingest answers 'infer' requests with this
      # server, attached after the warmup so a routed batch of a warm size
      # pays no first-use set-up.
      ingest.attach_serving(server.serve_remote)
    fleet = make_fleet(config, server.policy, buffer, levels,
                       server.initial_core_state,
                       seed_base=process_seed_base, tasks=fleet_tasks)
    suffix = '' if rank == 0 else f'_p{rank}'
    if config.telemetry_trace:
      # Installed before the prefetcher's thread and the fleet start, so
      # the first batch and the first unroll are traced.
      tracer = telemetry.PipelineTracer(
          config.logdir, filename=f'traces{suffix}.jsonl',
          flight_capacity=config.telemetry_flight_len,
          epoch=ingest.session_epoch if ingest is not None else None)
      telemetry.set_tracer(tracer)
    run.tracer = tracer
    prefetcher = ring_buffer.BatchPrefetcher(
        buffer, local_batch_size, place_fn=stage,
        depth=config.staging_depth, stack_fn=stack, stager=stager,
        replay_k=config.replay_k, reserve_fn=reserve_view)
    if config.reuse_on or config.controller == 'act':
      # Under sample reuse a learner step consumes fewer fresh frames
      # than frames_per_step: the frame budget, the fps meter, the run's
      # frames and the drain manifest count the fresh slots at their
      # first serve (scaled from this rank's rows to the global batch).
      # An acting controller may raise replay_k mid-run, so it counts
      # them so too. Steps before a resume count at frames_per_step.
      frames_per_unroll = config.unroll_length * config.num_action_repeats
      scale = max(config.batch_size // max(local_batch_size, 1), 1)
      resumed_frames = initial_steps * config.frames_per_step

      def env_frames_fn():
        return (resumed_frames + prefetcher.fresh_slots_served() *
                frames_per_unroll * scale)

      run.env_frames_fn = env_frames_fn
    if config.anakin_filler:
      from scalable_agent_tpu_torch.parallel import anakin as anakin_lib
      filler_ok, filler_reason = anakin_lib.supports_filler(config, mesh)
      if not filler_ok:
        log.warning('anakin_filler disabled on this topology: %s',
                    filler_reason)
      else:
        # A core that cannot take the task's head width raises here.
        filler = anakin_lib.HybridFiller(agent, config, num_actions,
                                         device, mesh=mesh)
        log.info('hybrid filler armed: %r self-play (B=%d, T=%d) fills '
                 'idle learner slices; fresh-frame clocks unchanged',
                 filler.backend, filler.stats()['batch_size'],
                 filler.stats()['unroll_length'])
    writer = observability.SummaryWriter(
        config.logdir, filename=f'summaries{suffix}.jsonl')
    incidents = observability.EventLog(
        config.logdir, filename=f'incidents{suffix}.jsonl')
    # Lock-order detections land as durable incidents; cleared at
    # teardown, before the stream closes.
    lock_check.set_incident_sink(incidents.event)
    if topology is not None:
      incidents.event('topology_resharded', step=initial_steps, **topology)
    if rank == 0:
      with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
        json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    run.server, run.fleet = server, fleet
    run.prefetcher, run.buffer = prefetcher, buffer
    # The SLO engine judges the registry from here on: its t0 sample is
    # taken before the fleet starts.
    slo_engine = _start_slo_engine(
        config, writer, incidents,
        flight=tracer.flight if tracer is not None else None,
        health=run.health)
    fleet.start()
    # The controller moves knobs of the started fleet; observe mode only
    # logs the moves it would make.
    ctrl = _start_controller(config, slo_engine, prefetcher, server, fleet,
                             ingest, publish_cadence, rank, incidents,
                             run.health)
    run.controller = ctrl
  except BaseException:
    if ctrl is not None:
      ctrl.stop()  # no log: the run never started
    if slo_engine is not None:
      slo_engine.stop()  # no verdict: the run never started
    if ingest is not None:
      # Crash semantics: actor hosts keep their reconnect window.
      try:
        ingest.close(graceful=False)
      except Exception:
        log.exception('ingest close failed')
    _teardown(fleet, prefetcher, server, buffer, writer, incidents, tracer)
    raise

  ladder = _HealthLadder(config, run.health, checkpointer, incidents, sdc,
                         tracer=tracer)
  episodes = observability.EpisodeStats(
      levels, writer=writer,
      benchmark=(config.level_name if config.level_name in suites.SUITES
                 and not fleet_tasks else None))
  fps_meter = observability.FpsMeter()
  action_counts_acc = np.zeros((num_actions,), np.int64)
  steps_done = 0
  errors: List[BaseException] = []
  last_quarantined = 0
  last_summary = time.monotonic()
  summarised_step = initial_steps
  last_publish_step = initial_steps
  last_batch_time = time.monotonic()
  poll_secs = 10.0 if stall_timeout_secs is None else min(
      10.0, stall_timeout_secs)
  draining = False
  drain_source = None
  drain_t0 = drain_deadline = 0.0
  last_filler_check = time.monotonic()
  last_filler_skipped = 0
  # The loop's clocks, read by the registry live; unregistered at the
  # end (the frames closure reaches the prefetcher).
  loop_gauges = [
      telemetry.gauge('driver/update_steps',
                      fn=lambda: initial_steps + steps_done),
      telemetry.gauge('driver/env_frames', fn=lambda: run.frames),
  ]
  planes = _PlaneSplit(config.num_actors)
  ingest_summaries = (_IngestSummaries(ingest) if ingest is not None
                      else None)
  last_remote_publish = float('-inf')
  exiting_clean = False
  profiles = _ProfileWindows(config, slo_engine, device)

  def check_fleet():
    """fleet.check_health, and an `actors_respawned` incident naming the
    slots it respawned and their errors (read before the respawn
    clears them)."""
    errors = [f'{type(e).__name__}: {e}' for e in fleet.errors()]
    respawned = fleet.check_health(stall_timeout_secs=stall_timeout_secs)
    if respawned:
      incidents.event('actors_respawned', step=initial_steps + steps_done,
                      slots=respawned, errors=errors)
    return respawned

  def stop_signals():
    """(the preempt_signal fault, the drain event): one fault event per
    call."""
    return (faults_lib.fire('preempt_signal') is not None,
            drain_event is not None and drain_event.is_set())

  def group_stop() -> bool:
    """Rank 0's stop request, broadcast: every rank calls this once per
    learner step, before the step's collectives."""
    flag = torch.tensor([int(any(stop_signals()))], device=mesh.device)
    return bool(mesh.broadcast_(flag, src=0)[0])

  try:
    while True:
      if not grouped:
        # The preemption drain: one preempt_signal event per iteration.
        preempt_fault, signaled = stop_signals()
        if not draining and (preempt_fault or signaled):
          draining = True
          drain_source = 'fault' if preempt_fault else 'signal'
          drain_t0 = time.monotonic()
          drain_deadline = drain_t0 + config.preempt_drain_timeout_secs
          incidents.event('preempt_drain_start',
                          step=initial_steps + steps_done,
                          source=drain_source)
          log.warning('preemption drain (%s): admissions stopped; '
                      'flushing in-flight unrolls within %.1fs',
                      drain_source, config.preempt_drain_timeout_secs)
          # Actors finish their current unroll and put it: that is what
          # the loop trains on until the feed dries.
          fleet.stop_event.set()
        if draining and time.monotonic() > drain_deadline:
          log.warning('preemption drain budget exhausted; finalizing')
          break
      frames = run.frames if run.env_frames_fn else (
          (initial_steps + steps_done) * config.frames_per_step)
      if frames >= config.total_environment_frames:
        break
      if max_steps is not None and steps_done >= max_steps:
        break
      if filler is not None and not draining and not prefetcher.ready():
        # Nothing staged: one filler step on the live state, then probe
        # again; a batch staged meanwhile waits for this one step.
        run.state = filler.fill_one(run.state)
        now = time.monotonic()
        if now - last_filler_check > poll_secs:
          # The starved branch's liveness duties, time-gated: a dead
          # fleet still surfaces while the filler keeps the learner busy.
          last_filler_check = now
          errors = fleet.errors() or errors
          check_fleet()
          if (stall_timeout_secs is not None and
              now - last_batch_time > max(3 * stall_timeout_secs, 30.0)):
            raise errors[0] if errors else TimeoutError(
                'no trajectory batch despite healthy actors (the hybrid '
                'filler kept the learner busy; the env plane is the '
                'incident)')
        continue
      try:
        stats_view, action_counts, batch = prefetcher.get(
            timeout=0.5 if draining else poll_secs)
      except TimeoutError:
        if draining:
          break  # the feed dried: every drainable batch is trained
        # No data yet: surface actor failures instead of hanging. Read
        # the errors before check_health, whose respawn clears them.
        errors = fleet.errors() or errors
        check_fleet()
        if (stall_timeout_secs is not None and
            time.monotonic() - last_batch_time >
            max(3 * stall_timeout_secs, 30.0)):
          raise errors[0] if errors else TimeoutError(
              'no trajectory batch despite healthy actors')
        continue
      except ring_buffer.Closed:
        if draining:
          break
        errors = fleet.errors() or errors
        if errors:
          raise errors[0]
        raise
      last_batch_time = time.monotonic()
      # Fault site 'learner_crash': one event per consumed batch; a
      # fired one SIGKILLs this process.
      crash = faults_lib.fire('learner_crash')
      if crash is not None:
        faults_lib.hard_crash(crash)
      errors = []
      if grouped and group_stop():
        # The drain is one process's (JAX's multi-host rule): every rank
        # leaves here, at the same step; the tail save covers it.
        incidents.event('preempt_group_stop',
                        step=initial_steps + steps_done)
        log.warning('preemption requested on a multi-process run: drain '
                    'is single-process, exiting the loop at step %d',
                    initial_steps + steps_done)
        break
      # The operator's profiler window and the SLO engine's captures.
      profiles.step(steps_done)
      # Fault site 'nan_burst': NaN rewards on the staged batch.
      batch, poisoned = faults_lib.maybe_poison_batch(batch)
      if poisoned:
        incidents.event('fault_nan_burst',
                        step=initial_steps + steps_done + 1)
      # Fault site 'slow_learner': a stalled step; the buffer fills and
      # the actors' puts block (backpressure), never unbounded queueing.
      slept = faults_lib.maybe_slow_learner()
      if slept is not None:
        incidents.event('fault_slow_learner',
                        step=initial_steps + steps_done + 1, secs=slept)
      state, metrics = train_step(run.state, batch)
      run.state = state
      steps_done += 1
      step_now = initial_steps + steps_done
      if tracer is not None:
        # The step consuming the oldest served batch was dispatched:
        # its spans complete, and traces.jsonl gets the batch record.
        tracer.on_step(step_now)
      # Under reuse: the fresh frames this batch's first serve credited
      # (0 on a re-serve), so fps stays an env-frame rate.
      fps_meter.update(max(run.frames - frames, 0) if run.env_frames_fn
                       else config.frames_per_step)
      action_counts_acc += action_counts
      if stats_view is not None:
        for name, ep_return, ep_frames in episodes.record_batch(
            stats_view, step_now):
          log.debug('episode %s return=%.2f frames=%d', name, ep_return,
                    ep_frames)
      state, rolled_back = ladder.after_step(steps_done, step_now, metrics,
                                             state)
      run.state = state
      # A rollback republishes at once: the fleet acts on the restored
      # weights.
      if (rolled_back is not None or
          steps_done % config.publish_params_every == 0):
        published = actor_params(state.params)
        server.update_params(published, version=step_now)
        last_publish_step = step_now
        # The replay tier's staleness clock.
        buffer.note_param_version(step_now)
        remote_version = None
        if ingest is not None:
          # Remote hosts refetch when an ack reports a newer version: a
          # host copy of the whole tree, so time-gated and only with a
          # connection live; a rollback always goes out.
          if rolled_back is not None:
            remote_version = ingest.publish_params(host_params(published))
          elif (time.monotonic() - last_remote_publish >=
                publish_cadence['secs'] and ingest.stats()['live'] > 0):
            last_remote_publish = time.monotonic()
            remote_version = ingest.publish_params(host_params(published))
        if tracer is not None:
          # The local publish clock that policy lag counts in, and the
          # ingest's version when the remote fleet got this snapshot.
          tracer.on_publish(step_now, remote_version=remote_version)

      now = time.monotonic()
      if now - last_summary >= config.summary_secs:
        last_summary, summarised_step = now, step_now
        last_quarantined = _write_summaries(
            writer, incidents, step_now, metrics, fps_meter,
            action_counts_acc, fleet, buffer, server, prefetcher,
            last_quarantined, stall_timeout_secs)
        planes.write(writer, step_now, buffer, prefetcher, fleet,
                     stall_timeout_secs, ingest)
        if ingest_summaries is not None:
          ingest_summaries.write(writer, incidents, step_now, run.health)
        _write_telemetry_summaries(writer, tracer, step_now)
        ladder.write_summaries(writer, step_now)
        last_filler_skipped = _write_filler_summaries(
            writer, incidents, filler, step_now, last_filler_skipped,
            run.health)
        _write_controller_summaries(writer, ctrl, prefetcher,
                                    publish_cadence, step_now)
        action_counts_acc[:] = 0
        # Step-synchronous judging where summaries are frequent; the
        # engine's thread covers long summary gaps.
        if slo_engine is not None:
          slo_engine.observe()
      _periodic_save(config, checkpointer, ladder, state, steps_done,
                     grouped)
      # Respawn dead or stalled actors, and spawn slots a resize
      # unparked, once per step (as the JAX loop does).
      check_fleet()
      run.step_log.append({'time': time.monotonic(),
                           'get_wait_secs':
                               prefetcher.stats()['wait_secs']})
      if on_step is not None:
        on_step(run, steps_done, metrics)
    if steps_done and initial_steps + steps_done > summarised_step:
      # A short run can end inside one summary window.
      _write_summaries(writer, incidents, initial_steps + steps_done,
                       metrics, fps_meter, action_counts_acc, fleet, buffer,
                       server, prefetcher, last_quarantined,
                       stall_timeout_secs)
      planes.write(writer, initial_steps + steps_done, buffer, prefetcher,
                   fleet, stall_timeout_secs, ingest)
      if ingest_summaries is not None:
        ingest_summaries.write(writer, incidents,
                               initial_steps + steps_done, run.health)
      _write_telemetry_summaries(writer, tracer, initial_steps + steps_done)
      ladder.write_summaries(writer, initial_steps + steps_done)
      _write_filler_summaries(writer, incidents, filler,
                              initial_steps + steps_done,
                              last_filler_skipped, run.health)
      _write_controller_summaries(writer, ctrl, prefetcher, publish_cadence,
                                  initial_steps + steps_done)
    if draining:
      _finish_drain(config, run, ladder, checkpointer, incidents, writer,
                    initial_steps + steps_done, last_publish_step,
                    drain_source, drain_t0, drain_deadline, filler,
                    slo_engine, ctrl)
    if run.state.popart is not None:
      log.info('PopArt statistics per task: %s', json.dumps(
          popart_lib.stats_summary(run.state.popart, levels)))
    exiting_clean = True
  finally:
    # The controller stops first (it reads the engine and moves the
    # components' knobs); then the verdict, before the components close,
    # so its last observation still reads their gauges.
    if ctrl is not None:
      _finish_controller(ctrl)
    if slo_engine is not None:
      _finish_slo(slo_engine, os.path.join(
          config.logdir, 'SLO_VERDICT.json' if rank == 0 else
          f'SLO_VERDICT_p{rank}.json'),
                  {'clean_exit': exiting_clean,
                   'update_steps': initial_steps + steps_done})
    profiles.close(steps_done)
    if ingest is not None:
      # A clean end (or a drain) says 'bye', so actor hosts exit; an
      # unwind keeps their reconnect window for a restart.
      try:
        ingest.set_draining()
        ingest.close(graceful=exiting_clean)
        run.stats['ingest'] = ingest.stats()
      except Exception:
        log.exception('ingest close failed')
    stats = _teardown(fleet, prefetcher, server, buffer, writer, incidents,
                      tracer)
    run.stats.update(stats)
    for gauge in loop_gauges + planes.gauges() + (
        ingest_summaries.gauges() if ingest_summaries is not None else []):
      telemetry.registry().unregister(gauge.name, gauge)
    if filler is not None:
      run.stats['filler'] = filler.stats()
      filler.close()
    _final_save(checkpointer, ladder, run.state, grouped)
    checkpointer.close()
  return run


def _write_filler_summaries(writer, incidents, filler, step: int,
                            last_skipped: int, health=None) -> int:
  """The filler's own ledger (its updates, frames and the updates the
  watchdog withheld: an incident, and a note in the health monitor's
  bundle, when those grow); returns the skipped count."""
  if filler is None:
    return last_skipped
  stats = filler.stats()
  writer.scalars({'filler_updates': stats['updates'],
                  'filler_frames': stats['frames'],
                  'filler_skipped_updates': stats['skipped']}, step)
  if stats['skipped'] > last_skipped:
    incidents.event('filler_skipped_updates', step=step,
                    total=stats['skipped'],
                    delta=stats['skipped'] - last_skipped)
    if health is not None:
      health.note_external('filler_skipped_updates')
  return stats['skipped']


def _finish_drain(config, run, ladder, checkpointer, incidents, writer,
                  step_final, last_publish_step, drain_source, drain_t0,
                  drain_deadline, filler=None, slo_engine=None, ctrl=None):
  """The drain's end: join the fleet (bounded), close the prefetcher
  (its partial batch's unrolls go back to the buffer), take a verified
  save (withheld mid-burst, as every save is) and write the manifest."""
  quiesce = run.fleet.quiesce(
      timeout=max(1.0, drain_deadline - time.monotonic()))
  # The prefetcher's close unregisters its staging/* gauges: read them
  # first; the snapshot after the save below updates the rest.
  metrics = telemetry.registry().snapshot()
  run.prefetcher.close()
  buffer_stats = run.buffer.stats()
  if ladder.healthy:
    checkpointer.save(run.state, force=True)
  else:
    log.warning('drain checkpoint withheld: training was unhealthy at '
                'preemption (the retained last-known-good step covers the '
                'resume)')
  checkpoint_step = checkpointer.last_good_step()
  latency = time.monotonic() - drain_t0
  manifest = {
      'update_steps': step_final,
      'frames': run.frames,
      'params_version_step': last_publish_step,
      'params_publishes': run.server.stats()['params_version'],
      'checkpoint_step': checkpoint_step,
      'checkpoint_verified': checkpoint_step == step_final,
      'buffer': {'leftover_unrolls': buffer_stats['occupancy'],
                 'high_water': buffer_stats['high_water'],
                 'capacity': buffer_stats['capacity']},
      'unjoined_actors': quiesce['unjoined_actors'],
      'health': (ladder.monitor.drain_report()
                 if ladder.monitor is not None else None),
      # The filler's ledger when one ran.
      'filler': filler.stats() if filler is not None else None,
      # The registry's snapshot: the one source the flight recorder
      # reads too.
      'metrics': dict(metrics, **telemetry.registry().snapshot()),
      # The verdict so far: which objectives were burning at the drain.
      'slo': slo_engine.verdict() if slo_engine is not None else None,
      # What the run did to itself before the drain, beside the health
      # ledger's controller_<actuator> entries.
      'controller': (dict(ctrl.counts(), mode=ctrl.mode)
                     if ctrl is not None else None),
      'drain_source': drain_source,
      'drain_latency_secs': round(latency, 3),
      'wall_time': round(time.time(), 3),
  }
  path = _write_resume_manifest(config.logdir, manifest)
  log.warning('preemption drain complete in %.2fs: checkpoint step %s '
              '(verified=%s), %d unroll(s) left in the buffer, manifest %s',
              latency, checkpoint_step, manifest['checkpoint_verified'],
              buffer_stats['occupancy'], path)
  incidents.event('preempt_drain_complete', step=step_final,
                  drain_latency_secs=round(latency, 3),
                  checkpoint_step=checkpoint_step,
                  leftover_unrolls=buffer_stats['occupancy'],
                  unjoined_actors=quiesce['unjoined_actors'])
  writer.scalar('drain_latency_secs', round(latency, 3), step_final)


def train_anakin(config: Config, max_steps: Optional[int] = None,
                 device='cuda', drain_event: Optional[threading.Event] = None,
                 mesh=None, initial_state=None) -> TrainRun:
  """The Anakin runtime as a production run (`--mode=train
  --runtime=anakin`): fused act+learn steps (parallel/anakin.py) with the
  lifecycle the fleet gets — the restore of the newest restorable
  checkpoint at start (steps, frames and summaries count on from it), the
  periodic save, the health ladder on the fused step's step_ok,
  total_loss and grad_norm (one step late), and the guarded tail save,
  skipped when training was unhealthy at exit or when the start-of-run
  restore failed. `drain_event` (the CLI's first SIGTERM) or the
  `preempt_signal` fault stops the loop at the next fused-step boundary;
  the tail save is the drain (no buffer to flush, no fleet to join).
  Writes config.json, summaries and incidents.

  `initial_state` (the population's in-process exploit): a TrainState to
  start from in place of the restore. It is copied into this run's own
  tensors (the caller's are never aliased); the periodic and tail saves
  then record it in this run's ladder.

  With a curriculum on the procgen core the summaries hold the
  `curriculum_*` scalars, and `<logdir>/CURRICULUM_LEVELS.json` the final
  per-level scores, visits and sampling probabilities.

  Under `mesh` (a process group) every rank trains its columns; rank 0
  writes the logdir and the checkpoints; the save decision is rank 0's,
  checked every checkpoint_check_every_steps steps; the verdicts come
  from the all-reduced metrics, so every rank rolls back in the same
  step. The loop's clocks are registry gauges (`driver/*`; both planes
  pinned at 1.0, since acting and learning are one fused step), and with
  a curriculum the latest summarised `curriculum/*` digests. The SLO
  engine runs as in `train` (on rank 0, which writes the logdir): judged
  in each summary block, a page burn's profiler capture taken in this
  loop, SLO_VERDICT.json (with runtime 'anakin') on every exit path.
  Returns a TrainRun whose fleet, server and prefetcher are None."""
  from scalable_agent_tpu_torch.parallel import anakin as anakin_lib
  for warning in (validate_runtime(config) + validate_population(config) +
                  validate_slo(config)):
    log.warning('%s', warning)
  if config.controller != 'off':
    log.info('controller=%s is a fleet-runtime feature: the anakin '
             'runtime has no actuators (no prefetcher/admission/'
             'publish/fleet knobs) — running without it',
             config.controller)
  _, agent, step, carry = anakin_lib.build_run(config, device=device,
                                               mesh=mesh)
  primary = distributed.rank() == 0
  grouped = mesh is not None and mesh.size > 1
  checkpointer = make_checkpointer(config, mesh)
  if initial_state is not None:
    carry = carry._replace(train_state=learner_lib.load_state_(
        carry.train_state, learner_lib.state_tree(initial_state)))
    log.info('starting from a caller-provided state at step %d',
             carry.train_state.update_steps)
  else:
    # A restore that raises (a config mismatch) ends the call here,
    # before the tail save could write a fresh state next to the old
    # steps.
    carry = carry._replace(train_state=restore_at_start(
        checkpointer, carry.train_state))
  initial_steps = carry.train_state.update_steps
  curriculum = config.curriculum != 'uniform' and hasattr(
      carry.env_state, 'level_scores')
  writer = incidents = None
  if primary:
    _consume_resume_manifest(config.logdir, initial_steps)
    os.makedirs(config.logdir, exist_ok=True)
    with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
      json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    writer = observability.SummaryWriter(config.logdir)
    incidents = observability.EventLog(config.logdir)
  run = TrainRun(config, agent, carry.train_state)
  run.checkpointer = checkpointer
  run.health = (health_lib.monitor_from_config(config)
                if config.health_watchdog else None)
  ladder = _HealthLadder(config, run.health, checkpointer,
                         incidents or _NoEvents())
  fps_meter = observability.FpsMeter()
  steps_done = 0
  metrics = None
  last_summary = time.monotonic()
  summarised_step = initial_steps
  # The registry's view of the loop, under train()'s names. The plane
  # split is a fleet's: in the fused step both planes are busy whenever
  # the loop is, so both gauges read 1.0.
  loop_gauges = [
      telemetry.gauge('driver/update_steps',
                      fn=lambda: initial_steps + steps_done),
      telemetry.gauge('driver/env_frames',
                      fn=lambda: (initial_steps + steps_done) *
                      config.frames_per_step),
      telemetry.gauge('driver/env_plane_utilization', fn=lambda: 1.0),
      telemetry.gauge('driver/learner_plane_utilization',
                      fn=lambda: 1.0),
  ]
  # The curriculum's digests as of the last summary (no extra device
  # read).
  curriculum_latest: Dict[str, float] = {}
  if config.curriculum != 'uniform':
    loop_gauges += [
        telemetry.gauge(
            'curriculum/entropy',
            fn=lambda: curriculum_latest.get('curriculum_entropy', 0.0)),
        telemetry.gauge(
            'curriculum/levels_visited',
            fn=lambda: curriculum_latest.get('curriculum_levels_visited',
                                             0.0)),
        telemetry.gauge(
            'curriculum/score_max',
            fn=lambda: curriculum_latest.get('curriculum_score_max',
                                             0.0)),
    ]

  slo_engine = None
  if primary:
    try:
      slo_engine = _start_slo_engine(config, writer, incidents,
                                     health=run.health)
    except BaseException:
      for stream in (writer, incidents):
        stream.close()
      for gauge in loop_gauges:
        telemetry.registry().unregister(gauge.name, gauge)
      checkpointer.close()
      raise
  profiles = _ProfileWindows(config, slo_engine,
                             next(agent.parameters()).device, operator=False)

  def flush(step_now):
    if writer is None:
      return
    keys = ['total_loss', 'mean_reward', 'learning_rate']
    if curriculum:
      keys += sorted(k for k in metrics if k.startswith('curriculum_'))
      curriculum_latest.update(
          {k: float(metrics[k]) for k in keys
           if k.startswith('curriculum_')})
    writer.scalars({k: float(metrics[k]) for k in keys}, step_now)
    writer.scalar('env_frames_per_sec', fps_meter.fps(), step_now)
    ladder.write_summaries(writer, step_now)
    if slo_engine is not None:
      slo_engine.observe()

  def stop_requested():
    stop = faults_lib.fire('preempt_signal') is not None or (
        drain_event is not None and drain_event.is_set())
    if not grouped:
      return stop
    # Every rank stops in the same step (each has its own signal): rank
    # 0's request, read at the save check's cadence.
    if steps_done % config.checkpoint_check_every_steps:
      return False
    flag = torch.tensor([int(stop)], device=mesh.device)
    return bool(mesh.broadcast_(flag, src=0)[0])

  try:
    while True:
      if stop_requested():
        # The fused loop stops at a step boundary; the tail save below
        # is the drain.
        if incidents is not None:
          incidents.event('anakin_stop_requested',
                          step=initial_steps + steps_done)
        log.warning('stop requested: finalizing at step %d',
                    initial_steps + steps_done)
        break
      if (initial_steps + steps_done) * config.frames_per_step >= (
          config.total_environment_frames):
        break
      if max_steps is not None and steps_done >= max_steps:
        break
      carry, metrics = step(carry)
      steps_done += 1
      step_now = initial_steps + steps_done
      fps_meter.update(config.frames_per_step)
      # A page burn's profiler capture rides the loop that launches the
      # device work.
      profiles.step(steps_done)
      train_state, _ = ladder.after_step(steps_done, step_now, metrics,
                                         carry.train_state)
      carry = carry._replace(train_state=train_state)
      run.state = train_state
      now = time.monotonic()
      if now - last_summary >= config.summary_secs:
        flush(step_now)
        last_summary, summarised_step = now, step_now
      _periodic_save(config, checkpointer, ladder, train_state, steps_done,
                     grouped)
    if steps_done and initial_steps + steps_done > summarised_step:
      flush(initial_steps + steps_done)  # a short run's one window
  finally:
    if slo_engine is not None:
      _finish_slo(slo_engine, os.path.join(config.logdir, 'SLO_VERDICT.json'),
                  {'clean_exit': sys.exc_info()[0] is None,
                   'update_steps': initial_steps + steps_done,
                   'runtime': 'anakin'})
    profiles.close(steps_done)
    try:
      _final_save(checkpointer, ladder, run.state, grouped)
      if curriculum and primary:
        _write_curriculum_levels(config, carry.env_state)
    finally:
      for stream in (writer, incidents):
        if stream is not None:
          stream.close()
      for gauge in loop_gauges:
        telemetry.registry().unregister(gauge.name, gauge)
      checkpointer.close()
  run.carry = carry
  return run


def _write_curriculum_levels(config: Config, env_state) -> None:
  """`<logdir>/CURRICULUM_LEVELS.json`: the final per-level scores,
  visits and sampling distribution (which levels got the frames)."""
  scores = env_state.level_scores.detach().cpu()
  probs = population_lib.level_probs(scores, config.curriculum_temperature,
                                     config.curriculum_eps)
  with open(os.path.join(config.logdir, 'CURRICULUM_LEVELS.json'),
            'w') as f:
    json.dump({'curriculum': config.curriculum,
               'temperature': config.curriculum_temperature,
               'eps': config.curriculum_eps,
               'scores': scores.tolist(),
               'visits': env_state.level_visits.detach().cpu().tolist(),
               'probs': probs.tolist()}, f, indent=2)


def _member_return(member_dir: str, tag: str = 'mean_reward',
                   tail: int = 5) -> float:
  """A member's fitness: the mean of its last `tail` summary values of
  `tag`, by step. Summaries append across rounds, so the tail is the
  round just finished; a member with none scores 0.0."""
  vals = []
  try:
    with open(os.path.join(member_dir, 'summaries.jsonl')) as f:
      for line in f:
        try:
          rec = json.loads(line)
        except ValueError:
          continue
        if rec.get('tag') == tag and 'value' in rec:
          vals.append((int(rec.get('step', 0)), float(rec['value'])))
  except OSError:
    return 0.0
  if not vals:
    return 0.0
  vals.sort(key=lambda sv: sv[0])
  return float(np.mean([v for _, v in vals[-tail:]]))


def _inherit_member_dir(donor_dir: str, loser_dir: str) -> None:
  """Cross-process PBT inheritance: the loser's checkpoint ladder
  becomes a copy of the donor's, by copy then swap, so a failed copy
  leaves the loser's own ladder in place. The loser's next restore
  verifies the donor's digests (a torn copy is refused)."""
  tmp = loser_dir + '.inherit_tmp'
  old = loser_dir + '.inherit_old'
  for leftover in (tmp, old):
    if os.path.isdir(leftover):
      shutil.rmtree(leftover)
  try:
    shutil.copytree(donor_dir, tmp)
  except BaseException:
    # The loser's ladder was never touched; only the partial copy goes.
    shutil.rmtree(tmp, ignore_errors=True)
    raise
  if os.path.isdir(loser_dir):
    os.rename(loser_dir, old)
  os.rename(tmp, loser_dir)
  shutil.rmtree(old, ignore_errors=True)


class _PopulationLog:
  """The population's parent-logdir record, as the JAX driver writes
  it: `population_summaries.jsonl` (one row per member per round),
  `PBT_LOG.json` (every round's returns, hypers and decisions, then the
  winner), the `population/*` summary scalars, mirrored in the registry's
  `population/*` gauges from the first scoring on (a gauge before any
  member has a return would read a placeholder; unregistered at close),
  and the `pbt_exploit` / `pbt_winner` incidents."""

  def __init__(self, config: Config, suites, num_rounds: int,
               vectorized: bool):
    self._logdir = config.logdir
    os.makedirs(config.logdir, exist_ok=True)
    self.writer = observability.SummaryWriter(config.logdir)
    self.incidents = observability.EventLog(config.logdir)
    self.num_rounds = num_rounds
    self.exploits = 0
    self._latest: Dict[str, float] = {}
    self._gauges: List = []
    self.log = {'population': config.pbt_population, 'suites': list(suites),
                'round_frames': config.resolved_pbt_round_frames,
                'num_rounds': num_rounds, 'quantile': config.pbt_quantile,
                'perturb': config.pbt_perturb, 'vectorized': vectorized,
                'rounds': [], 'winner': None}

  def member_row(self, r: int, member, target: int, mean_return: float):
    row = {'wall_time': round(time.time(), 3), 'round': r,
           'member': member['member'], 'suite': member['suite'],
           'frames': target, 'mean_return': mean_return}
    row.update({f'hyper_{h}': float(v)
                for h, v in sorted(member['hypers'].items())})
    with open(os.path.join(self._logdir, 'population_summaries.jsonl'),
              'a') as f:
      f.write(json.dumps(row, sort_keys=True) + '\n')

  def scored(self, target: int, returns, groups):
    per_suite_best = {g: max(returns[i] for i in range(len(returns))
                             if groups[i] == g) for g in set(groups)}
    self._latest.update(task_return_min=min(per_suite_best.values()),
                        best_return=max(returns))
    if not self._gauges:
      self._gauges = [
          telemetry.gauge(
              'population/task_return_min',
              fn=lambda: self._latest.get('task_return_min', 0.0)),
          telemetry.gauge(
              'population/best_return',
              fn=lambda: self._latest.get('best_return', 0.0)),
          telemetry.gauge('population/exploits_total',
                          fn=lambda: float(self.exploits)),
      ]
    self.writer.scalars({
        'population/task_return_min': self._latest['task_return_min'],
        'population/best_return': self._latest['best_return']}, target)

  def exploit(self, r: int, target: int, k: int, decision, members,
              returns, how: str):
    donor = decision['donor']
    self.exploits += 1
    self.incidents.event(
        'pbt_exploit', step=target, round=r, member=k, donor=donor,
        suite=members[k]['suite'], member_return=returns[k],
        donor_return=returns[donor], hypers=decision['hypers'])
    log.info('pbt round %d: member %d (return %.3f) exploits member %d '
             '(return %.3f), new hypers %s [%s]', r, k, returns[k], donor,
             returns[donor], decision['hypers'], how)

  def end_round(self, round_rec, target: int):
    self.writer.scalar('population/exploits_total', self.exploits, target)
    self.log['rounds'].append(round_rec)
    self.write()

  def winner(self, k: int, member, mean_return: float, logdir: str):
    self.log['winner'] = {'member': k, 'suite': member['suite'],
                          'return': mean_return,
                          'hypers': dict(member['hypers']),
                          'logdir': logdir}
    self.write()
    self.incidents.event('pbt_winner', member=k, suite=member['suite'],
                         final_return=mean_return, hypers=member['hypers'])
    log.info('pbt winner: member %d (%s) return %.3f hypers %s', k,
             member['suite'], mean_return, member['hypers'])

  def write(self):
    path = os.path.join(self._logdir, 'PBT_LOG.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(self.log, f, indent=2, sort_keys=True)
    os.replace(tmp, path)

  def close(self):
    self.writer.close()
    self.incidents.close()
    for gauge in self._gauges:
      telemetry.registry().unregister(gauge.name, gauge)


def _initial_members(config: Config, rng: np.random.Generator, suites):
  """Member k's suite (round-robin) and hypers: member 0 keeps the
  configured (learning_rate, entropy_cost), the others start explored."""
  members = []
  for k in range(config.pbt_population):
    hypers = {'learning_rate': config.learning_rate,
              'entropy_cost': config.entropy_cost}
    if k:
      hypers = population_lib.pbt_explore(hypers, rng, config.pbt_perturb)
    members.append({'member': k, 'suite': suites[k % len(suites)],
                    'hypers': hypers})
  return members


def _member_dir(config: Config, k: int) -> str:
  return os.path.join(config.logdir, f'member_{k:02d}')


def _num_rounds(config: Config) -> int:
  return max(1, -(-config.total_environment_frames //
                  config.resolved_pbt_round_frames))


def _member_config(config: Config, member, **fields) -> Config:
  """Member k's config: its logdir, seed, suite and hypers; a plain
  Anakin run (no population, no task mix)."""
  k = member['member']
  return dataclasses.replace(
      config, logdir=_member_dir(config, k),
      seed=config.seed + 101 * k + 1, env_backend=member['suite'],
      learning_rate=member['hypers']['learning_rate'],
      entropy_cost=member['hypers']['entropy_cost'], pbt_population=0,
      pbt_vectorized=False, fleet_tasks='', **fields)


def _run_rounds(config: Config, members, record: _PopulationLog,
                rng: np.random.Generator,
                drain_event: Optional[threading.Event], advance, inherit,
                settle=None) -> int:
  """The rounds of either population form. Each extends every member's
  frame budget by `resolved_pbt_round_frames`: `advance(target)` trains
  the members toward it and returns the members it advanced (a drain may
  stop it early). The advanced members are scored from their summaries;
  then, unless another round would not train on the result, the
  decisions rank members within each suite (np.random from config.seed:
  JAX's decisions) and each bottom-quantile member k takes a donor's
  state, `inherit(k, donor)` (returning how, for the log), and the
  donor's explored hypers. `settle()`, when given, ends each round after
  the exploits. Returns the winner: the best-scoring member that
  trained."""
  drained = lambda: drain_event is not None and drain_event.is_set()  # noqa: E731
  returns = [0.0] * len(members)
  trained = set()
  for r in range(record.num_rounds):
    if drained():
      break
    target = min((r + 1) * config.resolved_pbt_round_frames,
                 config.total_environment_frames)
    for k in advance(target):
      returns[k] = _member_return(_member_dir(config, k))
      record.member_row(r, members[k], target, returns[k])
      trained.add(k)
    groups = [m['suite'] for m in members]
    record.scored(target, returns, groups)
    round_rec = {'round': r, 'target_frames': target,
                 'returns': list(returns), 'suites': list(groups),
                 'hypers': [dict(m['hypers']) for m in members],
                 'decisions': []}
    if r < record.num_rounds - 1 and not drained():
      decisions = population_lib.pbt_decide(
          returns, groups, rng, quantile=config.pbt_quantile,
          perturb=config.pbt_perturb, hypers=[m['hypers'] for m in members])
      for k, decision in enumerate(decisions):
        if decision is None:
          continue
        how = inherit(k, decision['donor'])
        members[k]['hypers'] = dict(decision['hypers'])
        record.exploit(r, target, k, decision, members, returns, how)
        round_rec['decisions'].append(dict(decision, member=k))
    if settle is not None:
      settle()
    record.end_round(round_rec, target)
  if not trained:
    raise RuntimeError('population run trained no member (drained before '
                       'the first round?)')
  winner = max(sorted(trained), key=lambda k: returns[k])
  record.winner(winner, members[winner], returns[winner],
                _member_dir(config, winner))
  return winner


def train_population(config: Config, max_steps: Optional[int] = None,
                     device='cuda',
                     drain_event: Optional[threading.Event] = None
                     ) -> TrainRun:
  """Population-based training over Anakin members (PBT, arXiv
  1711.09846): `pbt_population` members, each a `train_anakin` run in
  `<logdir>/member_XX` with its own checkpoint ladder and summaries,
  suites round-robin from `resolved_pbt_suites`, (learning_rate,
  entropy_cost) exploited and explored between rounds (`_run_rounds`).

  Each round a member resumes from its own ladder. A bottom-quantile
  member inherits its donor's state: in process through
  `train_anakin(initial_state=...)`, copied into the loser's own
  tensors; else by copying the donor's ladder (`_inherit_member_dir`).
  Each exploit is a durable `pbt_exploit` incident. The parent logdir
  holds _PopulationLog's record.

  With pbt_vectorized (one suite) and model_parallelism 1 the members
  advance in lockstep instead (`_train_population_fused`); with a model
  axis the serial loop runs, with a warning (JAX's rule). `max_steps`
  bounds each member run (the fused path: each round); `drain_event`
  stops at the next member or round boundary. One process only. Returns
  the winning member's TrainRun."""
  for warning in validate_population(config):
    log.warning('%s', warning)
  if config.pbt_population < 2:
    raise ValueError(f'train_population needs pbt_population >= 2, '
                     f'got {config.pbt_population}')
  if distributed.world_size() > 1:
    raise ValueError('a population runs in one process: its members are '
                     'one-device Anakin runs')
  if config.pbt_vectorized:
    if config.model_parallelism <= 1:
      return _train_population_fused(config, max_steps=max_steps,
                                     device=device, drain_event=drain_event)
    log.warning('pbt_vectorized ignored (model_parallelism=%d): running '
                'the serial member loop', config.model_parallelism)
  suites = list(config.resolved_pbt_suites)
  rng = np.random.default_rng(config.seed)
  members = _initial_members(config, rng, suites)
  runs: Dict[int, TrainRun] = {}
  # An exploited loser's next run starts from the donor's state as it
  # was at the decision (a member's later runs train new tensors, so the
  # held state does not move); train_anakin copies it.
  inherited: Dict[int, learner_lib.TrainState] = {}

  def advance(target):
    advanced = []
    for m in members:
      if drain_event is not None and drain_event.is_set():
        break
      k = m['member']
      runs[k] = train_anakin(
          _member_config(config, m, total_environment_frames=target),
          max_steps=max_steps, device=device, drain_event=drain_event,
          initial_state=inherited.pop(k, None))
      advanced.append(k)
    return advanced

  def inherit(k, donor):
    if donor in runs:
      inherited[k] = runs[donor].state
      return 'in process'
    src = os.path.join(_member_dir(config, donor), 'checkpoints')
    if os.path.isdir(src):
      _inherit_member_dir(src, os.path.join(_member_dir(config, k),
                                            'checkpoints'))
    return 'through the ladder'

  record = _PopulationLog(config, suites, _num_rounds(config),
                          vectorized=False)
  try:
    return runs[_run_rounds(config, members, record, rng, drain_event,
                            advance, inherit)]
  finally:
    record.close()


def _train_population_fused(config: Config, max_steps: Optional[int] = None,
                            device='cuda',
                            drain_event: Optional[threading.Event] = None
                            ) -> TrainRun:
  """The vectorized population (pbt_vectorized): every member advances
  in lockstep, one `make_vectorized_anakin_step` per step (one V-trace
  launch over all members' columns), with (learning_rate, entropy_cost)
  as per-member tensors, so an explore rebuilds nothing. The rounds and
  decisions are the serial loop's (`_run_rounds`); an exploit copies the
  donor's train state into the loser's tensors on the device (the loser
  keeps its own env stream, as in the serial path). Each member owns a
  ladder in `<logdir>/member_XX/checkpoints`, restored at start and
  force-saved at each round boundary after the exploits, so its
  directory resumes in either path, and its own summaries; the parent
  logdir holds the population's record (PBT_LOG.json with
  vectorized=true) and, with slo_engine, the population's SLO verdict
  (judged in each summary block; runtime 'anakin', vectorized, the
  population's size). One suite, one device. Returns the winner's
  TrainRun."""
  from scalable_agent_tpu_torch.parallel import anakin as anakin_lib
  device = resolve_device(device)
  set_float32_precision()
  suites = list(config.resolved_pbt_suites)[:1]
  n = config.pbt_population
  rng = np.random.default_rng(config.seed)
  members = _initial_members(config, rng, suites)
  member_configs = [_member_config(config, m) for m in members]
  base = member_configs[0]
  env_core = anakin_lib.make_env_core(base)
  agents, carries = anakin_lib.init_members(
      base, env_core, [c.seed for c in member_configs], device)
  vstep = anakin_lib.make_vectorized_anakin_step(agents, env_core, base)
  checkpointers = [make_checkpointer(c) for c in member_configs]
  for k in range(n):
    carries[k] = carries[k]._replace(train_state=restore_at_start(
        checkpointers[k], carries[k].train_state))
  record = _PopulationLog(config, suites, _num_rounds(config),
                          vectorized=True)
  member_writers = []
  loop_gauges: List = []
  slo_engine = None
  steps_done = 0
  initial_steps = 0
  try:
    for c in member_configs:
      with open(os.path.join(c.logdir, 'config.json'), 'w') as f:
        json.dump(dataclasses.asdict(c), f, indent=2, sort_keys=True)
      member_writers.append(observability.SummaryWriter(c.logdir))
    with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
      json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    initial_steps = max(c.train_state.update_steps for c in carries)
    fps_meter = observability.FpsMeter()
    steps_done = 0
    last_summary = time.monotonic()
    metrics = None
    # train_anakin's registry view of the loop, the frames over all n
    # members.
    loop_gauges.extend([
        telemetry.gauge('driver/update_steps',
                        fn=lambda: initial_steps + steps_done),
        telemetry.gauge('driver/env_frames',
                        fn=lambda: (initial_steps + steps_done) *
                        config.frames_per_step * n),
        telemetry.gauge('driver/env_plane_utilization', fn=lambda: 1.0),
        telemetry.gauge('driver/learner_plane_utilization',
                        fn=lambda: 1.0),
    ])
    slo_engine = _start_slo_engine(config, record.writer, record.incidents)

    def flush_members(step_now):
      values = {key: v.tolist() for key, v in metrics.items()}
      for k, writer in enumerate(member_writers):
        writer.scalars({key: v[k] for key, v in values.items()}, step_now)

    def advance(target):
      nonlocal carries, metrics, steps_done, last_summary
      hypers = {name: torch.tensor([m['hypers'][name] for m in members],
                                   dtype=torch.float32, device=device)
                for name in population_lib.PBT_HYPERS}
      round_steps = 0
      while not (drain_event is not None and drain_event.is_set()):
        step_now = initial_steps + steps_done
        if step_now * config.frames_per_step >= target:
          break
        if max_steps is not None and round_steps >= max_steps:
          break
        carries, metrics = vstep(carries, hypers)
        steps_done += 1
        round_steps += 1
        fps_meter.update(config.frames_per_step * n)
        now = time.monotonic()
        if now - last_summary >= config.summary_secs:
          last_summary = now
          flush_members(step_now + 1)
          record.writer.scalar('env_frames_per_sec', fps_meter.fps(),
                               step_now + 1)
          if slo_engine is not None:
            slo_engine.observe()
      if metrics is not None:
        # This round's tail, so the scoring reads it.
        flush_members(initial_steps + steps_done)
      return range(n)

    def inherit(k, donor):
      carries[k] = carries[k]._replace(train_state=learner_lib.load_state_(
          carries[k].train_state,
          learner_lib.state_tree(carries[donor].train_state)))
      return 'on device'

    def settle():
      # Every member's state, inherited weights included, lands in its
      # own ladder.
      for k in range(n):
        checkpointers[k].save(carries[k].train_state, force=True)

    winner = _run_rounds(config, members, record, rng, drain_event,
                         advance, inherit, settle)
    run = TrainRun(member_configs[winner], agents[winner],
                   carries[winner].train_state)
    run.checkpointer = checkpointers[winner]
    run.carry = carries[winner]
    run.members = carries
    return run
  finally:
    if slo_engine is not None:
      _finish_slo(slo_engine, os.path.join(config.logdir, 'SLO_VERDICT.json'),
                  {'clean_exit': sys.exc_info()[0] is None,
                   'update_steps': initial_steps + steps_done,
                   'runtime': 'anakin', 'vectorized': True,
                   'population': n})
    for writer in member_writers:
      writer.close()
    record.close()
    for gauge in loop_gauges:
      telemetry.registry().unregister(gauge.name, gauge)


def eval_partition(num_levels: int, world: int, rank: int):
  """This rank's contiguous share of the test levels, as the JAX
  evaluate splits them over processes: (start, count, counts per
  rank)."""
  base, rem = divmod(num_levels, world)
  counts = [base + (i < rem) for i in range(world)]
  return sum(counts[:rank]), counts[rank], counts


def _gather_level_returns(level_returns, train_levels, my_ids, counts,
                          episodes: int, device):
  """Every rank's per-level returns, each level's row from its owner: a
  dense [L, E] matrix (NaN where not played) all-gathered over the
  group."""
  import torch.distributed as dist
  mat = torch.full((len(train_levels), episodes), float('nan'),
                   dtype=torch.float32)
  for lid in my_ids:
    returns = level_returns[train_levels[lid]][:episodes]
    mat[lid, :len(returns)] = torch.tensor(returns, dtype=torch.float32)
  on = device if dist.get_backend() == 'nccl' else torch.device('cpu')
  parts = [torch.empty_like(mat, device=on) for _ in counts]
  dist.all_gather(parts, mat.to(on))
  owner = np.repeat(np.arange(len(counts)), counts)
  for lid, name in enumerate(train_levels):
    row = parts[owner[lid]][lid].cpu().numpy()
    level_returns[name] = [float(x) for x in row if not np.isnan(x)]


def evaluate(config: Config, device='cuda',
             stall_timeout_secs: Optional[float] = 300.0,
             eval_drought_secs: float = 600.0) -> Dict[str, List[float]]:
  """Play `test_num_episodes` episodes per test level from the newest
  checkpoint under `<logdir>/checkpoints` (params and step only,
  `Checkpointer.restore_latest_params`; FileNotFoundError when there is
  none). Returns {train_level_name: [episode returns]} on every rank.

  Every test level plays at once: one env and actor per level, all
  feeding one inference server (`pad_batch_to` the level count, so one
  bucket serves every merged call, and no auto merge floor: levels
  retire as their episodes finish). The actors take state-arena slots in
  the PRIORITY_EVAL admission class. Under a process group the test
  levels split in contiguous parts over the ranks (`eval_partition`),
  level ids and env seeds stay global (`level_offset`, `seed_base`), and
  the per-level returns are all-gathered, each level's row from its
  owner rank. Rank 0 alone writes `<logdir>/eval_summaries.jsonl`: a
  `<test_level>/test_episode_return` row per level (the mean) at the
  restored step, and for a suite (dmlab30, atari57) its human-normalised
  test scores. A dead or wedged actor is respawned; no unroll for
  `eval_drought_secs` raises the last actor error (or TimeoutError).
  `device` defaults to CUDA and raises without it."""
  # Every knob group, as JAX's evaluate runs them: a range error fails an
  # eval as it fails a train.
  validate_fleet(config)
  for warning in (validate_replay(config) + validate_transport(config) +
                  validate_integrity(config) + validate_slo(config) +
                  validate_controller(config) + validate_runtime(config) +
                  validate_serving(config) + validate_population(config)):
    log.warning('%s', warning)
  device = resolve_device(device)
  set_float32_precision()
  world, rank = distributed.world_size(), distributed.rank()
  train_levels = factory.level_names(config)
  test_levels = factory.test_level_names(config)
  start, my_count, counts = eval_partition(len(test_levels), world, rank)
  my_ids = list(range(start, start + my_count))
  if world > 1:
    log.info('eval rank %d/%d plays levels [%d, %d) of %d', rank, world,
             start, start + my_count, len(test_levels))
  spec0 = factory.make_env_spec(config, test_levels[0], seed=1,
                                is_test=True)
  agent = build_agent(config, spec0.num_actions, len(train_levels))
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  params = dict(agent.named_parameters())
  restored = make_checkpointer(config).restore_latest_params(params)
  if restored is None:
    raise FileNotFoundError(
        f'no checkpoint under {config.logdir}/checkpoints')
  params, restored_steps = restored
  log.info('eval restored the params of checkpoint step %d', restored_steps)
  level_returns: Dict[str, List[float]] = {name: [] for name in train_levels}

  def stats_view(unroll):
    """One unroll as a [T+1, 1] batch view."""
    expand = lambda x: np.asarray(x)[:, None]  # noqa: E731
    return ActorOutput(
        level_name=np.asarray([unroll.level_name]), agent_state=None,
        env_outputs=StepOutput(
            reward=None, info=map_structure(expand, unroll.env_outputs.info),
            done=expand(unroll.env_outputs.done), observation=None),
        agent_outputs=None)

  if my_count > 0:
    server = fleet = None
    try:
      server = InferenceServer(agent, params, config,
                               seed=config.seed + 2000, device=device,
                               pad_batch_to=my_count)
      server.warmup(spec0.obs_spec, max_size=my_count)
      buffer = ring_buffer.TrajectoryBuffer(max(2 * my_count, 2))
      fleet = make_fleet(
          config, server.policy, buffer, test_levels,
          initial_state_fn=lambda priority=None: server.initial_core_state(
              priority=inference_lib.PRIORITY_EVAL),
          seed_base=config.seed - 1 + start, level_offset=start,
          is_test=True, num_actors=my_count)
    except BaseException:
      if server is not None:
        server.close()
      raise
    t0 = time.monotonic()
    try:
      fleet.start()
      last_unroll_time = time.monotonic()
      errors: List[BaseException] = []
      while any(len(level_returns[train_levels[i]])
                < config.test_num_episodes for i in my_ids):
        try:
          unroll = buffer.get(timeout=10)
        except TimeoutError:
          # Read the errors before check_health, whose respawn clears
          # them.
          errors = fleet.errors() or errors
          fleet.check_health(stall_timeout_secs=stall_timeout_secs)
          if time.monotonic() - last_unroll_time > eval_drought_secs:
            raise errors[0] if errors else TimeoutError(
                f'eval produced no unrolls for {eval_drought_secs}s')
          continue
        except ring_buffer.Closed:
          errors = fleet.errors() or errors
          raise errors[0] if errors else ring_buffer.Closed()
        last_unroll_time = time.monotonic()
        errors = []
        for level_id, ep_return, _ in observability.extract_episodes(
            stats_view(unroll)):
          level_returns[train_levels[level_id]].append(ep_return)
        fleet.check_health(stall_timeout_secs=stall_timeout_secs)
    finally:
      fleet.stop()
      server.close()
    stats = server.stats()
    log.info('eval played %d level(s) in %.2f s: %d merged calls, mean '
             'batch %.3f, latency p50 %s ms p99 %s ms', my_count,
             time.monotonic() - t0, stats['calls'], stats['mean_batch'],
             stats['latency_p50_ms'], stats['latency_p99_ms'])
    if device.type == 'cuda':
      log.info('eval peak device memory: %d bytes',
               torch.cuda.max_memory_allocated(device))

  if world > 1:
    _gather_level_returns(level_returns, train_levels, my_ids, counts,
                          config.test_num_episodes, device)
  for name in train_levels:
    level_returns[name] = level_returns[name][:config.test_num_episodes]
  if rank != 0:
    return level_returns

  writer = observability.SummaryWriter(config.logdir,
                                       filename='eval_summaries.jsonl')
  try:
    for train_name, test_name in zip(train_levels, test_levels):
      returns = level_returns[train_name]
      mean_return = float(np.mean(returns)) if returns else float('nan')
      log.info('level %s: mean return %.2f over %d episodes', test_name,
               mean_return, len(returns))
      writer.scalar(f'{test_name}/test_episode_return', mean_return,
                    restored_steps)
    if config.level_name in suites.SUITES:
      scores = suites.SUITES[config.level_name].eval_scores(level_returns)
      log.info('%s human-normalized: %s', config.level_name,
               ' '.join(f'{t.split("/")[-1]}={v:.1f}'
                        for t, v in scores.items()))
      writer.scalars(scores, restored_steps)
  finally:
    writer.close()
  return level_returns


class _NoEvents:
  """The incident stream of a rank that does not write the logdir."""

  def event(self, kind, **fields):
    del kind, fields


def _write_summaries(writer, incidents, step, metrics, fps_meter,
                     action_counts, fleet, buffer, server, prefetcher,
                     last_quarantined, stall_timeout_secs):
  """One summary block: the losses, env-frames/s, the action histogram
  of the interval, and the fleet's, buffer's, server's and prefetcher's
  counters. Returns the quarantined-slot count (an incident when it
  grows)."""
  writer.scalars({k: float(v) for k, v in metrics.items()}, step)
  writer.scalar('env_frames_per_sec', fps_meter.fps(), step)
  writer.histogram('actions', action_counts, step)
  fleet_stats = fleet.stats(healthy_horizon_secs=(
      60.0 if stall_timeout_secs is None else stall_timeout_secs))
  buffer_stats = buffer.stats()
  server_stats = server.stats()
  prefetch_stats = prefetcher.stats()
  writer.scalars({
      'actors_alive': fleet_stats['alive'],
      'actors_healthy': fleet_stats['healthy'],
      'actors_wedged': fleet_stats['wedged'],
      'fleet_healthy_fraction': fleet_stats['healthy_fraction'],
      'actor_respawns': fleet_stats['respawns'],
      'slots_quarantined': fleet_stats['slots_quarantined'],
      'buffer_unrolls': buffer_stats['occupancy'],
      'buffer_high_water': buffer_stats['high_water'],
      'buffer_put_waits': buffer_stats['put_waits'],
      'inference_mean_batch': server_stats['mean_batch'],
      'inference_latency_p50_ms': server_stats['latency_p50_ms'],
      'inference_latency_p99_ms': server_stats['latency_p99_ms'],
      'inference_publishes_skipped': server_stats['publishes_skipped'],
      # Admission: sheds are the serving plane's load-shedding answer,
      # admission_waits how often an acquire parked.
      'inference_sheds': server_stats['sheds'],
      'inference_admission_waits': server_stats['admission_waits'],
      'inference_arena_grows': server_stats['arena_grows'],
      'inference_resident_versions': server_stats['resident_versions'],
      'inference_shadow_divergence': server_stats['shadow_divergence'],
      'params_version': server_stats['params_version'],
      'staged_batches': prefetch_stats['staged_batches'],
      'h2d_overlap_fraction': prefetch_stats['h2d_overlap_fraction'],
      'prefetch_wait_secs': prefetch_stats['wait_secs'],
      'batch_serves': prefetch_stats['serves'],
      'batch_reserves': prefetch_stats['batch_reserves'],
      'fresh_slots_served': prefetch_stats['fresh_slots_served'],
  }, step)
  # The replay tier's occupancy, evictions and reuse, when there is one.
  writer.scalars({k: v for k, v in buffer_stats.items()
                  if k.startswith('replay_')}, step)
  quarantined = fleet_stats['slots_quarantined']
  if quarantined > last_quarantined:
    incidents.event('actor_slots_quarantined', step=step,
                    total=quarantined)
  return quarantined


def _teardown(fleet, prefetcher, server, buffer, writer, incidents,
              tracer=None):
  """Stop what was built, most-blocking first, each step on its own (one
  failure does not skip the rest); returns the final stats of what was
  running. The lock-order sink is cleared before the incident stream
  closes, and the tracer uninstalled and closed last."""
  stats = {}

  def attempt(name, fn):
    try:
      out = fn()
      if name:
        stats[name] = out
    except Exception:
      log.exception('fleet teardown step %r failed', name)

  for name, obj in (('fleet', fleet), ('prefetcher', prefetcher),
                    ('server', server), ('buffer', buffer)):
    if obj is not None:
      attempt(name, obj.stats)
  if fleet is not None:
    # Actors stop between unrolls; closing the buffer and then the
    # server (which cancels their parked inference calls) ends each one
    # mid-unroll, so the join below is short.
    fleet.stop_event.set()
  if buffer is not None:
    attempt(None, buffer.close)
  if server is not None:
    attempt(None, server.close)
  if fleet is not None:
    attempt('fleet_stop', lambda: fleet.stop(timeout=10.0))
  if prefetcher is not None:
    attempt(None, prefetcher.close)
  attempt(None, lambda: lock_check.set_incident_sink(None))
  for stream in (writer, incidents):
    if stream is not None:
      attempt(None, stream.close)
  if tracer is not None:
    attempt(None, lambda: telemetry.set_tracer(None))
    attempt('trace', tracer.stats)
    attempt(None, tracer.close)
  return stats


class _PlaneSplit:
  """The summary block's utilization split, as the JAX loop computes it,
  over each summary interval: the learner plane's share of the wall
  time not blocked on the feed (the prefetcher's wait), and the env
  plane's share not parked on the buffer's backpressure (the actors'
  summed put waits over `num_actors` producers). Written as the
  `learner_plane_utilization` and `env_plane_utilization` scalars and
  mirrored, with the fleet's healthy fraction, in the registry's
  `driver/*` gauges, registered at the first interval (a 0.0 before any
  measurement would read as a dead plane)."""

  def __init__(self, num_actors: int):
    self._num_actors = int(num_actors)
    self._producers = max(int(num_actors), 1)
    self._last = None  # (time, feed wait secs, put wait secs)
    self._gauges: Dict[str, telemetry.Gauge] = {}

  def _set(self, name: str, value: float):
    gauge = self._gauges.get(name)
    if gauge is None:
      # Literal registration names: the name-parity test reads them.
      if name == 'env':
        gauge = telemetry.gauge('driver/env_plane_utilization')
      elif name == 'learner':
        gauge = telemetry.gauge('driver/learner_plane_utilization')
      else:
        gauge = telemetry.gauge('driver/fleet_healthy_fraction')
      self._gauges[name] = gauge
    gauge.set(value)

  def write(self, writer, step: int, buffer, prefetcher, fleet,
            stall_timeout_secs, ingest=None):
    """One interval's split; live ingest connections count as producers
    beside the local actors."""
    producers = self._producers
    if ingest is not None:
      producers = max(self._num_actors + ingest.stats()['live'], 1)
    now = time.monotonic()
    snap = (now, prefetcher.stats()['wait_secs'],
            buffer.stats()['put_wait_secs'])
    last, self._last = self._last, snap
    if last is None:
      return
    interval = now - last[0]
    if interval <= 0:
      return
    learner = min(max(1.0 - (snap[1] - last[1]) / interval, 0.0), 1.0)
    env = min(max(1.0 - (snap[2] - last[2]) /
                  (interval * producers), 0.0), 1.0)
    writer.scalars({'learner_plane_utilization': learner,
                    'env_plane_utilization': env}, step)
    self._set('env', env)
    self._set('learner', learner)
    self._set('fleet', fleet.stats(healthy_horizon_secs=(
        60.0 if stall_timeout_secs is None
        else stall_timeout_secs))['healthy_fraction'])

  def gauges(self) -> List:
    return list(self._gauges.values())


def host_params(params) -> Dict[str, np.ndarray]:
  """A host (numpy) copy of a parameter dict: what the remote ingest
  publishes."""
  return {name: value.detach().to('cpu', copy=True).numpy()
          for name, value in params.items()}


class _IngestSummaries:
  """The remote ingest's summary block, as JAX driver.train writes it:
  its counters (remote_*, the CRC, digest and discard ledger, the ack
  percentiles, the liveness counters), per-interval rates, the
  membership gauge `driver/remote_live_hosts` (registered only with an
  ingest), and incidents when a refusal, reap, wedged thread or
  membership change shows since the last interval."""

  def __init__(self, ingest):
    self._ingest = ingest
    self._last = {'unrolls': 0, 'per_conn_unrolls': {}}
    self._last_time = time.monotonic()
    self._hosts = telemetry.gauge('driver/remote_live_hosts')

  def gauges(self) -> List:
    return [self._hosts]

  def write(self, writer, incidents, step: int, health=None):
    ing, last = self._ingest.stats(), self._last
    writer.scalars({
        'remote_unrolls': ing['unrolls'],
        'remote_connections': ing['connections'],
        'remote_rejected': ing['rejected'],
        'remote_stale_rejected': ing['stale_rejected'],
        'quarantined': ing['quarantined'],
        'wire_crc_rejected': ing['wire_crc_rejected'],
        'publish_digest_rejected': ing['publish_digest_rejected'],
        'ingest_discarded_frames': ing['discarded_frames'],
        'ingest_discarded_bytes': ing['discarded_bytes'],
        'remote_ack_p50_ms': ing['ack_p50_ms'],
        'remote_ack_p99_ms': ing['ack_p99_ms'],
        'remote_param_blobs': ing['param_blobs'],
        'remote_conns_reaped': ing['conns_reaped'],
        'remote_heartbeat_misses': ing['heartbeat_misses'],
        'param_subs_dropped': ing['param_subs_dropped'],
        'remote_stale_epoch_rejected': ing['stale_epoch_rejected'],
        'remote_reattached': ing['reattached'],
        'remote_reattach_latency_secs': ing['reattach_latency_secs'],
        'ingest_threads_wedged': ing['ingest_threads_wedged'],
        'remote_live_hosts': ing['live_hosts'],
    }, step)
    if ing['wire_crc_rejected'] > last.get('wire_crc_rejected', 0):
      incidents.event('wire_crc_rejected', step=step,
                      total=ing['wire_crc_rejected'],
                      delta=(ing['wire_crc_rejected'] -
                             last.get('wire_crc_rejected', 0)))
    if (ing['publish_digest_rejected'] >
        last.get('publish_digest_rejected', 0)):
      incidents.event('publish_digest_rejected', step=step,
                      total=ing['publish_digest_rejected'])
      if health is not None:
        health.note_external('publish_digest_rejected')
    if ing['conns_reaped'] > last.get('conns_reaped', 0):
      incidents.event('remote_conn_reaped', step=step,
                      total=ing['conns_reaped'],
                      delta=ing['conns_reaped'] -
                      last.get('conns_reaped', 0))
    wedged = ing['ingest_threads_wedged']
    if wedged > last.get('ingest_threads_wedged', 0):
      names = ing['wedged_thread_names']
      incidents.event('ingest_threads_wedged', step=step, count=wedged,
                      names=names)
      if health is not None:
        health.note_external('ingest_threads_wedged')
      log.error('ingest watchdog: %d wedged thread(s): %s', wedged,
                ', '.join(names))
    live_hosts = ing['live_hosts']
    self._hosts.set(live_hosts)
    for event in self._ingest.drain_membership_events():
      if event.get('kind') == 'host_left':
        incidents.event('host_left', step=step, host=event.get('host'),
                        reason=event.get('reason'))
        log.warning('pod membership: host %s left (%s); %d host(s) '
                    'remain — continuing at reduced topology',
                    event.get('host'), event.get('reason'), live_hosts)
      else:
        incidents.event('host_joined', step=step, host=event.get('host'),
                        reattach=event.get('reattach', False))
        log.info('pod membership: host %s joined (%d live)',
                 event.get('host'), live_hosts)
    now = time.monotonic()
    dt = now - self._last_time
    writer.scalar('remote_unrolls_per_sec',
                  (ing['unrolls'] - last['unrolls']) / dt if dt else 0.0,
                  step)
    per_conn, prev = ing['per_conn_unrolls'], last['per_conn_unrolls']
    rates = ([(per_conn[k] - prev.get(k, 0)) / dt for k in per_conn]
             if dt else [])
    if rates:
      writer.scalars({'remote_conn_unrolls_per_sec_min': min(rates),
                      'remote_conn_unrolls_per_sec_max': max(rates)}, step)
    self._last, self._last_time = ing, now


def _write_telemetry_summaries(writer, tracer, step: int):
  """The telemetry plane's summary scalars: the live policy-lag and
  end-to-end span percentiles (NaN until traffic flows), the untagged
  unrolls and the flight recorder's occupancy, one registry snapshot
  into the flight recorder; and the process-wide dropped JSONL
  writes."""
  if tracer is not None:
    writer.scalars(tracer.span_percentiles(), step)
    writer.scalar('trace_untagged_unrolls',
                  tracer.stats()['untagged_unrolls'], step)
    tracer.flight.note_registry(telemetry.registry().snapshot())
    writer.scalar('trace_flight_records', len(tracer.flight), step)
  writer.scalar('dropped_writes', telemetry.dropped_writes_total(), step)
