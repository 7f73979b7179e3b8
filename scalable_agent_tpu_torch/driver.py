"""Experiment driver of the port, after the JAX package's driver.py:
`build_agent`, `choose_mesh`, the device rule of the entry points, and
the fleet runtime's training loop (`make_fleet`, `train`). Evaluation is a
later slice (ROADMAP A7).

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
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import learner as learner_lib
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.config import (COMPUTE_DTYPES, Config,
                                             validate_fleet)
from scalable_agent_tpu_torch.envs import factory
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.runtime.actor import Actor, batch_unrolls
from scalable_agent_tpu_torch.runtime.fleet import ActorFleet
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.structs import (ActorOutput, StepOutput,
                                              map_structure)

log = logging.getLogger('scalable_agent_tpu_torch')


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
  """A mesh over the joined group's ranks, on this rank's `device`, when
  the batch can shard; None means one rank's plain training (the
  reference's single-machine mode).

  As in the JAX driver: one rank (and model_parallelism 1, the only
  width the port has) gives None; a batch the ranks do not divide warns
  and gives None on one host, where every rank then trains the same
  replica, and raises across hosts (as the group's declared topology
  says), where the replicas would never meet."""
  ranks = distributed.world_size()
  if ranks == 1 and config.model_parallelism == 1:
    return None
  if config.batch_size % ranks:
    topology = distributed.declared_topology(config)
    if topology is not None and topology.num_nodes > 1:
      raise ValueError(
          f'batch_size={config.batch_size} not divisible by the '
          f'{ranks} ranks; the unsharded fallback is only safe on one '
          'host')
    log.warning('batch_size %d not divisible by the %d ranks; falling '
                'back to unsharded training on each rank',
                config.batch_size, ranks)
    return None
  return mesh_lib.make_mesh(device, model_parallelism=config.model_parallelism)


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
  """What a training run leaves: the final TrainState, the agent, the
  live objects (closed when train() returns) and their final stats, and
  per learner step the host time it ended at and the prefetcher's
  cumulative blocked-get seconds then (`step_log`)."""

  def __init__(self, config, agent=None, state=None, server=None,
               fleet=None, prefetcher=None, buffer=None):
    self.config = config
    self.agent = agent
    self.state = state
    self.server = server
    self.fleet = fleet
    self.prefetcher = prefetcher
    self.buffer = buffer
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


def train(config: Config, max_steps: Optional[int] = None, device='cuda',
          stall_timeout_secs: Optional[float] = None,
          on_step: Optional[Callable] = None):
  """IMPALA training until total_environment_frames (or `max_steps`).

  `config.runtime == 'anakin'` runs `parallel.anakin.train` (the fused
  on-device loop) and returns what it returns. The fleet runtime, in
  order: the env spec and the agent, the learner state, the trajectory
  buffer, the inference server (published at version 0 and warmed up to
  the fleet size), the fleet, the batch staging and the prefetcher; then
  the loop: prefetcher.get -> train step -> publish every
  `publish_params_every` steps -> summaries. A `finally` tears all of it
  down, also after a failed set-up. `on_step(run, steps_done, metrics)`
  runs after each learner step (chip_smoke.py times and profiles with
  it). `device` defaults to CUDA and raises without it.

  Not in the port yet: a process group (data-parallel fleets, ROADMAP
  A5b) raises; checkpoint and resume (ROADMAP A4) are skipped, so a run
  starts from fresh params and saves nothing. Returns the TrainRun.
  """
  if config.runtime == 'anakin':
    from scalable_agent_tpu_torch.parallel import anakin
    return anakin.train(config, max_steps=max_steps, device=device)
  if config.runtime != 'fleet':
    raise ValueError(f'unknown runtime {config.runtime!r} (fleet | anakin)')
  if (torch.distributed.is_available() and torch.distributed.is_initialized()
      ) or config.num_processes > 1:
    raise NotImplementedError(
        'the fleet runtime over a process group (data-parallel fleets) is '
        'not in the PyTorch port yet (ROADMAP A5b)')
  validate_fleet(config)
  device = resolve_device(device)
  log.info('fleet runtime: checkpoint and resume are not in the PyTorch '
           'port yet (ROADMAP A4); this run starts from fresh params and '
           'saves nothing')
  levels = factory.level_names(config)
  spec0 = factory.make_env_spec(config, levels[0], seed=1)
  num_actions = spec0.num_actions
  agent = build_agent(config, num_actions)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  state = learner_lib.make_train_state(agent, config)
  train_step = learner_lib.make_train_step_fn(agent, config)
  run = TrainRun(config, agent, state)

  if device.type == 'cuda':
    copy_stream = torch.cuda.Stream(device)
    learner_stream = torch.cuda.current_stream(device)

    def stack(items):
      return batch_unrolls(items, empty=learner_lib.pinned_empty)

    def place(batch):
      return learner_lib.place_batch(batch, device, copy_stream,
                                     learner_stream)
  else:
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

  buffer = server = fleet = prefetcher = writer = incidents = None
  try:
    buffer = ring_buffer.TrajectoryBuffer(
        max(config.queue_capacity_batches * config.batch_size,
            config.batch_size))
    server = InferenceServer(
        build_agent(config, num_actions), state.params, config,
        seed=config.seed + 1000, fleet_size=config.num_actors,
        device=device)
    server.update_params(state.params, version=0)
    if config.num_actors > 0:
      server.warmup(spec0.obs_spec, max_size=config.num_actors)
    fleet = make_fleet(config, server.policy, buffer, levels,
                       server.initial_core_state)
    prefetcher = ring_buffer.BatchPrefetcher(
        buffer, config.batch_size, place_fn=stage,
        depth=config.staging_depth, stack_fn=stack)
    writer = observability.SummaryWriter(config.logdir)
    incidents = observability.EventLog(config.logdir)
    with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
      json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    run.server, run.fleet = server, fleet
    run.prefetcher, run.buffer = prefetcher, buffer
    fleet.start()
  except BaseException:
    _teardown(fleet, prefetcher, server, buffer, writer, incidents)
    raise

  episodes = observability.EpisodeStats(levels, writer=writer)
  fps_meter = observability.FpsMeter()
  action_counts_acc = np.zeros((num_actions,), np.int64)
  steps_done = 0
  errors: List[BaseException] = []
  last_quarantined = 0
  last_summary = time.monotonic()
  summarised_step = 0
  last_batch_time = time.monotonic()
  poll_secs = 10.0 if stall_timeout_secs is None else min(
      10.0, stall_timeout_secs)
  try:
    while True:
      if steps_done * config.frames_per_step >= (
          config.total_environment_frames):
        break
      if max_steps is not None and steps_done >= max_steps:
        break
      try:
        stats_view, action_counts, batch = prefetcher.get(timeout=poll_secs)
      except TimeoutError:
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
        errors = fleet.errors() or errors
        if errors:
          raise errors[0]
        raise
      last_batch_time = time.monotonic()
      errors = []
      state, metrics = train_step(state, batch)
      run.state = state
      steps_done += 1
      fps_meter.update(config.frames_per_step)
      action_counts_acc += action_counts
      for name, ep_return, ep_frames in episodes.record_batch(
          stats_view, steps_done):
        log.debug('episode %s return=%.2f frames=%d', name, ep_return,
                  ep_frames)
      if steps_done % config.publish_params_every == 0:
        server.update_params(state.params, version=steps_done)

      now = time.monotonic()
      if now - last_summary >= config.summary_secs:
        last_summary, summarised_step = now, steps_done
        last_quarantined = _write_summaries(
            writer, incidents, steps_done, metrics, fps_meter,
            action_counts_acc, fleet, buffer, server, prefetcher,
            last_quarantined, stall_timeout_secs)
        action_counts_acc[:] = 0
      run.step_log.append({'time': time.monotonic(),
                           'get_wait_secs':
                               prefetcher.stats()['wait_secs']})
      if on_step is not None:
        on_step(run, steps_done, metrics)
    if steps_done > summarised_step:
      # A short run can end inside one summary window.
      _write_summaries(writer, incidents, steps_done, metrics, fps_meter,
                       action_counts_acc, fleet, buffer, server, prefetcher,
                       last_quarantined, stall_timeout_secs)
  finally:
    run.stats = _teardown(fleet, prefetcher, server, buffer, writer,
                          incidents)
  return run


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
