"""Experiment driver of the port, after the JAX package's driver.py:
`build_agent`, `choose_mesh`, the device and float32-precision rules of
the entry points, the fleet runtime's training loop (`make_fleet`,
`train`) and the Anakin runtime's (`train_anakin`), each with checkpoint
and resume, the health ladder and the preemption drain. Evaluation is a
later slice (ROADMAP A7.1).

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

import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import checkpoint as checkpoint_lib
from scalable_agent_tpu_torch import health as health_lib
from scalable_agent_tpu_torch import learner as learner_lib
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.config import (COMPUTE_DTYPES, Config,
                                             validate_fleet,
                                             validate_integrity)
from scalable_agent_tpu_torch.envs import factory
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.runtime import faults as faults_lib
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


def build_agent(config: Config, num_actions: int) -> ImpalaAgent:
  """The config's agent, on the CPU with PyTorch's default init: callers
  initialise it (models.init_params) and move it to their device. Its
  parameters are float32 whatever `config.compute_dtype` says."""
  return ImpalaAgent(num_actions=num_actions,
                     frame_shape=(config.height, config.width, 3),
                     torso=config.torso,
                     dtype=COMPUTE_DTYPES[config.compute_dtype])


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
               initial_state_fn: Callable, seed_base: int = 0
               ) -> ActorFleet:
  """The env + actor + fleet construction: actor i plays
  levels[i % len] with env seed `seed_base + i + 1`, its env in its own
  process when config.use_py_process. Every (re)spawn builds a fresh env
  and takes its carry from `initial_state_fn` (the server's
  `initial_core_state`)."""
  if config.fleet_tasks:
    raise NotImplementedError('fleet_tasks (mixed fleets) is not in the '
                              'PyTorch port yet (ROADMAP A7)')

  def make_actor(i):
    spec = factory.make_env_spec(config, levels[i % len(levels)],
                                 seed=seed_base + i + 1)
    env, process = factory.build_environment(
        spec, use_py_process=config.use_py_process)
    try:
      actor = Actor(env, policy, initial_state_fn(),
                    unroll_length=config.unroll_length,
                    num_action_repeats=config.num_action_repeats,
                    level_name_id=i % len(levels))
    except BaseException:
      (process or env).close()
      raise
    return env, process, actor

  return ActorFleet(make_actor, buffer, config.num_actors,
                    quarantine_after=config.fleet_quarantine_after)


class TrainRun:
  """What a training run leaves: the final TrainState (under tensor
  parallelism, this rank's blocks), the agent, the live objects (closed
  when train() returns) and their final stats, the checkpointer, the
  health monitor and the mesh, and per learner step the host time it
  ended at and the prefetcher's cumulative blocked-get seconds then
  (`step_log`). The Anakin runtime's has no server, fleet, prefetcher or
  buffer, and holds its final AnakinCarry (`carry`)."""

  def __init__(self, config, agent=None, state=None, server=None,
               fleet=None, prefetcher=None, buffer=None):
    self.config = config
    self.agent = agent
    self.state = state
    self.server = server
    self.fleet = fleet
    self.prefetcher = prefetcher
    self.buffer = buffer
    self.checkpointer: Optional[checkpoint_lib.Checkpointer] = None
    self.health: Optional[health_lib.HealthMonitor] = None
    self.mesh = None
    self.carry = None
    self.stats: Dict[str, Dict] = {}
    self.step_log: List[Dict[str, float]] = []

  @property
  def frames(self) -> int:
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
  step counter stays where it is: only params and optimizer state
  revert), and halts with a bundle on HALT or when nothing is
  restorable. `healthy` is False while a bad burst is open: no save
  lands then, since a save would advance LAST_GOOD onto the diverged
  state.

  With `sdc` (the (fingerprint_fn, replicas) of
  train_parallel.make_sdc_fingerprint_fn) each check also all-gathers
  the replicas' param fingerprints, read with the sentinels one step
  late into `sdc_replica_mismatch`; the `replica_divergence` fault fires
  there, one event per check, perturbing one replica's probe lane."""

  def __init__(self, config: Config, monitor, checkpointer, incidents,
               sdc=None):
    self._config = config
    self.monitor = monitor
    self._checkpointer = checkpointer
    self._incidents = incidents
    self._sdc = sdc
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
                              reason=monitor.last_reason)
        log.warning('health rollback at step %d: restored checkpoint step '
                    '%d (params and optimizer revert; the step counter '
                    'keeps running)', step_now, restored_step)
    if verdict == health_lib.HALT:
      bundle = monitor.write_halt_bundle(self._config.logdir, self._config,
                                         step_now, reason=monitor.last_reason)
      self._incidents.event('health_halt', step=step_now,
                            reason=monitor.last_reason, bundle=bundle)
      raise health_lib.TrainingDivergence(
          f'training halted at step {step_now} after {monitor.rollbacks} '
          f'rollback escalation(s): {monitor.last_reason}. Diagnostic '
          f'bundle: {bundle}', bundle_path=bundle)
    return state, restored_step

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
      layout=layout)


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

  `config.runtime == 'anakin'` runs `train_anakin`. The fleet runtime, in
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

  `on_step(run, steps_done, metrics)` runs after each learner step
  (chip_smoke.py times and profiles with it). `device` defaults to CUDA
  and raises without it. Returns the TrainRun.
  """
  if config.runtime == 'anakin':
    return train_anakin(config, max_steps=max_steps, device=device,
                        drain_event=drain_event)
  if config.runtime != 'fleet':
    raise ValueError(f'unknown runtime {config.runtime!r} (fleet | anakin)')
  validate_fleet(config)
  for warning in validate_integrity(config):
    log.warning('%s', warning)
  device = resolve_device(device)
  set_float32_precision()
  world, rank = distributed.world_size(), distributed.rank()
  if config.batch_size % world:
    raise ValueError(f'batch_size={config.batch_size} must divide by '
                     f'process count {world}')
  local_batch_size = config.batch_size // world
  levels = factory.level_names(config)
  spec0 = factory.make_env_spec(config, levels[0], seed=1)
  num_actions = spec0.num_actions
  agent = build_agent(config, num_actions)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  mesh = choose_mesh(config, device)
  grouped = mesh is not None and mesh.world_size > 1
  registry = sharding.from_config(config)
  layout = None
  if mesh is not None:
    state = train_parallel.make_sharded_train_state(agent, config, mesh,
                                                    registry=registry)
    train_step, _ = train_parallel.make_sharded_train_step(
        agent, config, mesh, None, registry=registry)
    layout = train_step.layout
  else:
    train_step = learner_lib.make_train_step_fn(agent, config)
    state = learner_lib.make_train_state(agent, config)
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

  def stage(host_batch):
    """Prefetcher stage: peel the host stats view and the action counts
    of the trained-on steps ([1:] drops the overlap row, as the loss
    does), then copy the batch to the device."""
    action_counts = np.bincount(
        np.asarray(host_batch.agent_outputs.action)[1:].ravel(),
        minlength=num_actions)
    return _stats_only_view(host_batch), action_counts, place(host_batch)

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
  try:
    buffer = ring_buffer.TrajectoryBuffer(
        max(config.queue_capacity_batches * config.batch_size,
            config.batch_size))
    initial_pub = actor_params(state.params)
    server = InferenceServer(
        build_agent(config, num_actions), initial_pub, config,
        seed=config.seed + 1000 + process_seed_base,
        fleet_size=config.num_actors, device=device)
    server.update_params(initial_pub, version=initial_steps)
    if config.num_actors > 0:
      server.warmup(spec0.obs_spec, max_size=config.num_actors)
    fleet = make_fleet(config, server.policy, buffer, levels,
                       server.initial_core_state,
                       seed_base=process_seed_base)
    prefetcher = ring_buffer.BatchPrefetcher(
        buffer, local_batch_size, place_fn=stage,
        depth=config.staging_depth, stack_fn=stack, stager=stager)
    suffix = '' if rank == 0 else f'_p{rank}'
    writer = observability.SummaryWriter(
        config.logdir, filename=f'summaries{suffix}.jsonl')
    incidents = observability.EventLog(
        config.logdir, filename=f'incidents{suffix}.jsonl')
    if topology is not None:
      incidents.event('topology_resharded', step=initial_steps, **topology)
    if rank == 0:
      with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
        json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    run.server, run.fleet = server, fleet
    run.prefetcher, run.buffer = prefetcher, buffer
    fleet.start()
  except BaseException:
    _teardown(fleet, prefetcher, server, buffer, writer, incidents)
    raise

  ladder = _HealthLadder(config, run.health, checkpointer, incidents, sdc)
  episodes = observability.EpisodeStats(levels, writer=writer)
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
      if (initial_steps + steps_done) * config.frames_per_step >= (
          config.total_environment_frames):
        break
      if max_steps is not None and steps_done >= max_steps:
        break
      try:
        stats_view, action_counts, batch = prefetcher.get(
            timeout=0.5 if draining else poll_secs)
      except TimeoutError:
        if draining:
          break  # the feed dried: every drainable batch is trained
        # No data yet: surface actor failures instead of hanging. Read
        # the errors before check_health, whose respawn clears them.
        errors = fleet.errors() or errors
        fleet.check_health(stall_timeout_secs=stall_timeout_secs)
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
      # Fault site 'nan_burst': NaN rewards on the staged batch.
      batch, poisoned = faults_lib.maybe_poison_batch(batch)
      if poisoned:
        incidents.event('fault_nan_burst',
                        step=initial_steps + steps_done + 1)
      state, metrics = train_step(run.state, batch)
      run.state = state
      steps_done += 1
      step_now = initial_steps + steps_done
      fps_meter.update(config.frames_per_step)
      action_counts_acc += action_counts
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
        server.update_params(actor_params(state.params), version=step_now)
        last_publish_step = step_now

      now = time.monotonic()
      if now - last_summary >= config.summary_secs:
        last_summary, summarised_step = now, step_now
        last_quarantined = _write_summaries(
            writer, incidents, step_now, metrics, fps_meter,
            action_counts_acc, fleet, buffer, server, prefetcher,
            last_quarantined, stall_timeout_secs)
        ladder.write_summaries(writer, step_now)
        action_counts_acc[:] = 0
      _periodic_save(config, checkpointer, ladder, state, steps_done,
                     grouped)
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
      ladder.write_summaries(writer, initial_steps + steps_done)
    if draining:
      _finish_drain(config, run, ladder, checkpointer, incidents, writer,
                    initial_steps + steps_done, last_publish_step,
                    drain_source, drain_t0, drain_deadline)
  finally:
    run.stats = _teardown(fleet, prefetcher, server, buffer, writer,
                          incidents)
    _final_save(checkpointer, ladder, run.state, grouped)
  return run


def _finish_drain(config, run, ladder, checkpointer, incidents, writer,
                  step_final, last_publish_step, drain_source, drain_t0,
                  drain_deadline):
  """The drain's end: join the fleet (bounded), close the prefetcher
  (its partial batch's unrolls go back to the buffer), take a verified
  save (withheld mid-burst, as every save is) and write the manifest."""
  quiesce = run.fleet.quiesce(
      timeout=max(1.0, drain_deadline - time.monotonic()))
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
      'frames': step_final * config.frames_per_step,
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
      # Planes the port does not have yet (A7.4, A6).
      'metrics': None, 'slo': None, 'controller': None, 'filler': None,
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
                 mesh=None) -> TrainRun:
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

  Under `mesh` (a process group) every rank trains its columns; rank 0
  writes the logdir and the checkpoints; the save decision is rank 0's,
  checked every checkpoint_check_every_steps steps; the verdicts come
  from the all-reduced metrics, so every rank rolls back in the same
  step. The JAX runtime's SLO engine and profiler capture (ROADMAP A7.4)
  and its population seam `initial_state` (A6) are not here. Returns a
  TrainRun whose fleet, server and prefetcher are None."""
  from scalable_agent_tpu_torch.parallel import anakin as anakin_lib
  _, agent, step, carry = anakin_lib.build_run(config, device=device,
                                               mesh=mesh)
  primary = distributed.rank() == 0
  grouped = mesh is not None and mesh.size > 1
  checkpointer = make_checkpointer(config, mesh)
  # A restore that raises (a config mismatch) ends the call here, before
  # the tail save could write a fresh state next to the old steps.
  carry = carry._replace(train_state=restore_at_start(
      checkpointer, carry.train_state))
  initial_steps = carry.train_state.update_steps
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

  def flush(step_now):
    if writer is None:
      return
    writer.scalars({k: float(metrics[k]) for k in (
        'total_loss', 'mean_reward', 'learning_rate')}, step_now)
    writer.scalar('env_frames_per_sec', fps_meter.fps(), step_now)
    ladder.write_summaries(writer, step_now)

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
    try:
      _final_save(checkpointer, ladder, run.state, grouped)
    finally:
      for stream in (writer, incidents):
        if stream is not None:
          stream.close()
  run.carry = carry
  return run


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
      'params_version': server_stats['params_version'],
      'staged_batches': prefetch_stats['staged_batches'],
      'h2d_overlap_fraction': prefetch_stats['h2d_overlap_fraction'],
      'prefetch_wait_secs': prefetch_stats['wait_secs'],
  }, step)
  quarantined = fleet_stats['slots_quarantined']
  if quarantined > last_quarantined:
    incidents.event('actor_slots_quarantined', step=step,
                    total=quarantined)
  return quarantined


def _teardown(fleet, prefetcher, server, buffer, writer, incidents):
  """Stop what was built, most-blocking first, each step on its own (one
  failure does not skip the rest); returns the final stats of what was
  running."""
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
  for stream in (writer, incidents):
    if stream is not None:
      attempt(None, stream.close)
  return stats
