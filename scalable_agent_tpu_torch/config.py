"""Experiment configuration of the port.

The field names and defaults are those of the JAX package's `Config`
(scalable_agent_tpu/config.py), so a config carries across the two
packages unchanged. Only the fields the port reads are here; a setting
that selects a path the port does not have yet raises
`NotImplementedError` naming the ROADMAP item that brings it — the port
never ignores a setting silently.
"""

import dataclasses
from typing import List, Optional

import torch

# The JAX CLI's `--compute_dtype` enum (experiment.py), by torch dtype.
COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass
class Config:
  # Experiment / run control.
  logdir: str = '/tmp/agent'
  mode: str = 'train'                     # train | test | anakin
  test_num_episodes: int = 10             # per level, --mode=test

  # The reference's roles: job_name 'learner', or 'actor' for an
  # actor-only host that feeds a learner over TCP (runtime/remote.py,
  # `--job_name=actor --learner_address=host:port`); `task` is that
  # host's index (its env seeds and level offset), and a process
  # group's rank when process_id is -1.
  task: int = -1
  job_name: str = 'learner'

  # Process group (parallel/distributed.py). 'host:port' of rank 0; empty
  # = no group, or one joined by the caller or by torch.distributed.run.
  # In the port a process is one rank with one device: num_processes is
  # the group's size and process_id this process's rank (-1 = 0).
  coordinator_address: str = ''
  num_processes: int = 1
  process_id: int = -1

  # Training.
  total_environment_frames: int = int(1e9)
  batch_size: int = 2
  unroll_length: int = 100
  num_action_repeats: int = 4
  seed: int = 1

  # Loss.
  entropy_cost: float = 0.00025
  baseline_cost: float = 0.5
  discounting: float = 0.99
  reward_clipping: str = 'abs_one'        # abs_one | soft_asymmetric | none

  # Environment.
  dataset_path: str = ''                  # DMLab's datasetPath
  level_cache_dir: str = ''               # DMLab compiled-map cache
                                          # ('' = the adapter's default)
  level_name: str = 'explore_goal_locations_small'
  width: int = 96
  height: int = 72

  # Optimizer (RMSProp, linear decay to 0 over total frames).
  learning_rate: float = 0.00048
  decay: float = 0.99
  momentum: float = 0.0
  epsilon: float = 0.1

  env_backend: str = 'dmlab'
  num_actions: Optional[int] = None       # backend default when None
  # Atari: per-frame probability that the previous executed action
  # repeats (0.25 is Machado et al.'s evaluation protocol).
  sticky_action_prob: float = 0.0
  episode_length: int = 100               # bandit episode length
  torso: str = 'deep'                     # deep | deep_fast | shallow
  # Tensor parallelism (parallel/sharding.py, train_parallel.py): the
  # mesh's model-axis width; how the TP step computes (auto: gathered on
  # every device, where JAX takes sharded off the CPU; see
  # train_parallel.resolve_tp_compute); the partition-rule set (auto: megatron
  # when model_parallelism > 1, replicated otherwise).
  model_parallelism: int = 1
  tp_compute: str = 'auto'                # auto | sharded | gathered
  sharding_rules: str = 'auto'            # auto | megatron | replicated
  # The JAX package's LSTM time-scan unroll factor (an XLA loop knob).
  # The port's core is an eager loop: it accepts the field so configs
  # carry across, and ignores it.
  scan_unroll: int = 10
  # None = auto by level name (resolved_use_instruction).
  use_instruction: Optional[bool] = None
  # Layer compute dtype (Flax's `dtype=`): float32 | bfloat16. Params,
  # optimizer state, the LSTM carry between calls, V-trace and the losses
  # stay float32 either way.
  compute_dtype: str = 'float32'
  use_associative_scan: bool = False      # V-trace by recursive doubling
  # The fused hand-written V-trace kernel (ops/vtrace_cuda.py,
  # csrc/vtrace.cu). The JAX name is kept so configs carry across.
  use_pallas_vtrace: bool = False
  # PopArt value normalization (popart.py): one value column per task.
  use_popart: bool = False
  popart_beta: float = 3e-4               # the stats' EMA step size
  # UNREAL pixel control (unreal.py): >0 adds the auxiliary Q-head.
  pixel_control_cost: float = 0.0
  pixel_control_discount: float = 0.9
  pixel_control_cell_size: int = 4
  # Pseudo-rewards in the integer domain (uint8 frames only; a float
  # observation takes the float32 form).
  pixel_control_integer_rewards: bool = False
  # The Q-head's stride-2 deconv: 'deconv' (the transposed convolution)
  # or 'd2s' (one 2x2 convolution and a depth-to-space interleave), on
  # the same parameters.
  pixel_control_head_impl: str = 'deconv'  # deconv | d2s
  # Cast the Q-map to float32 at the head; False keeps it in the compute
  # dtype until the loss's gather and max.
  pixel_control_q_f32: bool = True
  grad_clip_norm: Optional[float] = None
  summary_secs: int = 30
  # The policy-gradient surrogate: vtrace, or IMPACT's clipped ratio
  # against a target network (learner.py).
  surrogate: str = 'vtrace'               # vtrace | impact
  impact_epsilon: float = 0.2             # the surrogate's clip width
  # Learner steps between refreshes of the target network (impact).
  target_update_interval: int = 1
  # Sample reuse: each staged batch is served replay_k times, and a
  # replay_ratio share of each batch's unrolls comes from the replay
  # tier (runtime/ring_buffer.py).
  replay_k: int = 1
  replay_ratio: float = 0.0
  # The replay tier's capacity in unrolls (0: 4 x batch_size), its
  # staleness window in published param versions (0: defer to
  # max_unroll_staleness; both 0: no bound), and the CRC check of every
  # replayed unroll against its insert-time digest.
  replay_capacity_unrolls: int = 0
  replay_max_staleness: int = 0
  replay_crc: bool = True
  # The ingest admission window of remote actors (runtime/remote.py),
  # in published param versions; the replay window defers to it.
  max_unroll_staleness: int = 0
  # Remote actors (runtime/remote.py). The learner listens on
  # remote_actor_port (0 = no ingest) on remote_actor_bind_host
  # (loopback by default: the wire is unauthenticated pickle); actor
  # hosts point learner_address at it. The learner publishes a param
  # snapshot to them at most every remote_publish_secs, cast per
  # publish_codec (remote_params_dtype, the older spelling, wins when
  # set; resolved_wire_dtype). An actor host retries a lost learner for
  # actor_reconnect_secs (0 = exit on disconnect). Idle connections ping
  # every remote_heartbeat_secs and a connection silent for
  # remote_conn_idle_timeout_secs is reaped (0 = never; it is also every
  # socket's stall deadline). ingest_workers validate and commit the
  # received unrolls (0 = min(4, cpus)); wire_crc offers a CRC32C
  # trailer on every frame of both lanes.
  remote_actor_port: int = 0
  remote_actor_bind_host: str = '127.0.0.1'
  learner_address: str = ''
  remote_publish_secs: float = 2.0
  remote_params_dtype: str = ''
  actor_reconnect_secs: float = 180.0
  remote_heartbeat_secs: float = 10.0
  remote_conn_idle_timeout_secs: float = 60.0
  ingest_workers: int = 0
  wire_crc: bool = True
  runtime: str = 'fleet'                  # fleet | anakin
  # The hybrid filler (fleet runtime; parallel/anakin.HybridFiller): when
  # the prefetcher has no staged batch, the learner runs one fused Anakin
  # self-play step on the live train state instead of waiting. Filler
  # updates leave update_steps, the frame budget, the LR's count and the
  # checkpoint numbering on the fleet's clock, and are counted apart.
  anakin_filler: bool = False
  # The filler's core: '' = env_backend when it is on-device, else
  # 'bandit' (which takes any head width).
  filler_backend: str = ''
  # The filler's rollout (0 = auto: batch_size, and min(unroll_length,
  # 16), so a staged batch waits for at most one short filler step).
  filler_batch_size: int = 0
  filler_unroll_length: int = 0

  # The fleet runtime (driver.train, runtime/). Host actors, one env
  # each, hosted in their own processes.
  num_actors: int = 4
  use_py_process: bool = True
  publish_params_every: int = 1           # learner steps per publish
  # Trajectory buffer capacity in batches, and staged batches in flight.
  queue_capacity_batches: int = 1
  staging_depth: int = 2
  # batch: stack each batch on the host, copy it at once; unroll: copy
  # each unroll as it arrives into a device arena (ring_buffer.py).
  staging_mode: str = 'batch'             # batch | unroll
  # Inference batching. min_batch 0 = AUTO: the merge floor is the fleet
  # size, so every call carries the whole fleet; timeout_ms bounds the
  # wait when an actor is busy elsewhere.
  inference_min_batch: int = 0
  inference_max_batch: int = 1024
  inference_timeout_ms: int = 100
  # Merged batches dispatched but not completed at once.
  inference_pipeline_depth: int = 2
  # The device-resident state arena (runtime/inference.py): each actor
  # owns a slot of [slots, hidden] carries on the device, and only its
  # slot id rides each call. Slots 0 = auto: 2x the fleet, at least 8.
  inference_state_cache: bool = False
  inference_state_slots: int = 0
  # Slot admission when the arena is full: block (park on a priority
  # waitlist until a slot frees or the deadline passes), shed (the same,
  # with the deadline's rejection counted as a shed), grow (double the
  # arena).
  inference_admission: str = 'block'      # block | shed | grow
  inference_admission_timeout_secs: float = 10.0
  # Fleet health: consecutive respawns without a completed unroll before
  # a slot is quarantined (0 = never); the cool-down before
  # set_target_size may rehabilitate a quarantined slot on probation.
  fleet_quarantine_after: int = 5
  fleet_probation_secs: float = 30.0
  # Mixed fleets: 'suite:weight,...' (population.parse_fleet_tasks);
  # actors are apportioned by weight, one PopArt slot per task.
  fleet_tasks: str = ''
  # The serving version table (runtime/inference.py): resident versions
  # (LRU eviction of unpinned, non-live entries), an optional byte
  # budget, the A/B and shadow shares of merged calls, int8-resident
  # entries (publish_codec='int8', runtime/codec.py) and the warm
  # forward per warmed bucket of a new parameter structure at publish
  # (serving_aot). publish_codec is also the remote actors' wire codec
  # (resolved_wire_dtype). serving_replicas names the routed-inference
  # replicas of an actor host (runtime/routing.py); the learner role
  # ignores it.
  publish_codec: str = 'bf16'             # bf16 | f32 | int8
  serving_resident_versions: int = 1
  serving_hbm_budget_mb: float = 0.0
  serving_ab_fraction: float = 0.0
  serving_shadow_fraction: float = 0.0
  serving_aot: bool = False
  serving_replicas: str = ''
  # Checkpoint and resume (checkpoint.py): the save interval (the
  # reference's save_checkpoint_secs), how often a process group asks
  # rank 0 whether to save, the content-digest ledger, and the budget of
  # the preemption drain (driver.train).
  checkpoint_secs: int = 600
  checkpoint_check_every_steps: int = 20
  ckpt_digests: bool = True
  preempt_drain_timeout_secs: float = 30.0
  # Skip a non-finite update: the step keeps the old params and
  # optimizer state, and still advances update_steps.
  health_watchdog: bool = True
  # The health ladder (health.py): skip and count -> roll back to the
  # last good checkpoint after `health_rollback_after` consecutive bad
  # steps -> halt with a bundle after `health_max_rollbacks`.
  health_check_every_steps: int = 1
  health_window: int = 64                 # retained recent checks
  health_min_window: int = 16             # samples before relative
                                          # detectors arm
  health_rollback_after: int = 5          # K consecutive bad steps
  health_max_rollbacks: int = 3           # then halt
  health_loss_explosion_factor: float = 100.0
  health_sigma_divergence_factor: float = 10.0
  # The SDC sentinel (train_parallel.make_sdc_fingerprint_fn): per-replica
  # param fingerprints, all-gathered over the data axis and read one step
  # late by the health ladder. Pure data parallelism with >= 2 replicas
  # only. sdc_allgather=False turns it off under a process group, as in
  # the JAX package, where the gather is what lets a process read it.
  sdc_check: bool = True
  sdc_allgather: bool = True
  # The telemetry plane (telemetry.py). telemetry_trace: per-unroll trace
  # spans stamped when an actor completes an unroll and completed through
  # staging, serve and the train step; the learner writes traces.jsonl,
  # one line per trained batch with the policy-lag vector
  # (scripts/trace_report.py reads it). False turns off the stamping,
  # the tracer and the stream. telemetry_flight_len: the flight
  # recorder's depth, the latest trace records dumped with the halt
  # bundle.
  telemetry_trace: bool = True
  telemetry_flight_len: int = 512
  # Arm the lock-order checker (analysis/runtime.py) for this run: the
  # runtime's locks record the process-wide acquisition graph, and a
  # cycle (a latent ABBA deadlock) lands as a durable
  # lock_order_inversion incident and on the analysis/lock_cycles
  # counter. driver.train arms it before it builds any component.
  lock_order_check: bool = False
  # The SLO engine (slo.py): the default objectives (or the slo_spec JSON
  # list) judged over the metrics registry on fast and slow burn windows
  # by a `slo-engine` thread (every slo_interval_secs; 0 = derived from
  # summary_secs and the fast window) and the summary block; each burn is
  # an slo_violation incident, a page-severity one also captures the
  # flight recorder, a trace slice and (slo_capture) a torch.profiler
  # trace of the next slo_capture_steps learner steps into
  # <logdir>/diagnostics/; SLO_VERDICT.json at the end. slo_fps_baseline:
  # the per-host baseline file of the fps floor ('' = none).
  slo_engine: bool = True
  slo_spec: str = ''
  slo_fast_window_secs: float = 30.0
  slo_slow_window_secs: float = 300.0
  slo_interval_secs: float = 0.0
  slo_capture: bool = True
  slo_capture_steps: int = 5
  slo_fps_baseline: str = ''
  # The operator's profiler window: with profile_dir set, a torch.profiler
  # trace (CPU and CUDA) of learner steps [profile_start_step,
  # profile_start_step + profile_num_steps), written there as a Chrome
  # trace.
  profile_dir: str = ''
  profile_start_step: int = 20            # past the warmup
  profile_num_steps: int = 5
  # The self-healing controller (controller.py): a `controller` thread
  # maps the SLO engine's burning set and margins to bounded moves of the
  # fleet's knobs (replay_k, admission, the remote publish cadence, the
  # fleet's and the pod's target size) through a policy table. 'observe'
  # logs every move it would make (CONTROLLER_LOG.json, applied false)
  # and touches nothing; 'act' applies them; 'off' runs no thread and
  # writes no log. controller_policy: a JSON rule list ('' = the
  # DEFAULT_RULES). controller_interval_secs: its tick (0 = the SLO
  # engine's cadence). The two *_max fields bound the replay_k and
  # publish_secs actuators.
  controller: str = 'observe'             # off | observe | act
  controller_policy: str = ''
  controller_interval_secs: float = 0.0
  controller_replay_k_max: int = 4
  controller_publish_secs_max: float = 30.0
  # The pod_size actuator's bound: a move writes the desired actor-host
  # count to <logdir>/POD_TARGET.json (atomic) for the cluster's
  # supervisor to reconcile; the learner spawns no host. 0 = no actuator.
  pod_max_hosts: int = 0
  # The population engine (population.py). The level curriculum over the
  # procgen level set, inside the fused step (Anakin and the filler):
  # 'uniform' keeps the plain draw; 'regret' EMAs the positive value loss
  # per level, 'td' the |TD error|; new levels are drawn from an
  # eps-smoothed softmax over the scores at `curriculum_temperature`.
  curriculum: str = 'uniform'             # uniform | regret | td
  curriculum_temperature: float = 1.0
  curriculum_eps: float = 0.1             # the uniform mixing floor
  curriculum_alpha: float = 0.3           # per-level score EMA step
  curriculum_decay: float = 0.995         # unvisited levels' decay per step
  # The procgen level set (envs/jittable.ProcgenCore), both runtimes.
  procgen_num_levels: int = 8
  procgen_wall_density: float = 0.25
  # Minimal PBT over Anakin members (driver.train_population): 0 = off;
  # >= 2 members in <logdir>/member_XX, suites round-robin from
  # pbt_suites ('' = env_backend); every pbt_round_frames frames per
  # member (0 = a quarter of the budget) the bottom pbt_quantile of each
  # suite exploits a top-quantile donor and explores (learning_rate,
  # entropy_cost) by pbt_perturb. pbt_vectorized advances every member in
  # lockstep in one step (one suite only).
  pbt_population: int = 0
  pbt_round_frames: int = 0
  pbt_suites: str = ''
  pbt_quantile: float = 0.25
  pbt_perturb: float = 1.2
  pbt_vectorized: bool = False
  # The JAX package's persistent XLA compile cache ('auto' = under the
  # logdir). The port has no run-time compiler to cache: eager PyTorch
  # compiles nothing, and the CUDA kernels are built by nvcc once per
  # source digest into scalable_agent_tpu_torch/_build/ (ops/build.py),
  # whatever this field says. Kept so a JAX config carries over.
  compile_cache_dir: str = 'auto'

  def __post_init__(self):
    if self.compute_dtype not in COMPUTE_DTYPES:
      raise ValueError(f'compute_dtype must be one of '
                       f'{sorted(COMPUTE_DTYPES)}, got '
                       f'{self.compute_dtype!r}')
    if self.use_pallas_vtrace and self.use_associative_scan:
      raise ValueError('use_pallas_vtrace and use_associative_scan are '
                       'mutually exclusive — pick one V-trace form')

  @property
  def frames_per_step(self):
    return self.batch_size * self.unroll_length * self.num_action_repeats

  @property
  def resolved_wire_dtype(self) -> str:
    """The ingest server's wire_dtype: remote_params_dtype when set,
    else publish_codec ('bf16' -> 'bfloat16', 'f32' -> '' for exact
    float32, 'int8')."""
    if self.remote_params_dtype:
      return self.remote_params_dtype
    if self.publish_codec == 'bf16':
      return 'bfloat16'
    if self.publish_codec == 'f32':
      return ''
    if self.publish_codec == 'int8':
      return 'int8'
    raise ValueError(
        f"publish_codec must be 'bf16', 'f32' or 'int8', got "
        f'{self.publish_codec!r}')

  @property
  def resolved_replay_capacity(self) -> int:
    """The replay tier's capacity with the 0-auto rule (4 x batch)."""
    if self.replay_capacity_unrolls > 0:
      return self.replay_capacity_unrolls
    return 4 * self.batch_size

  @property
  def resolved_replay_max_staleness(self) -> int:
    """The replay staleness window in published param versions: 0
    defers to the ingest window; both 0 is no bound."""
    if self.replay_max_staleness > 0:
      return self.replay_max_staleness
    return self.max_unroll_staleness

  @property
  def reuse_on(self) -> bool:
    """Whether a learner step may consume fewer than frames_per_step
    fresh frames (sample reuse), so the frame clock counts fresh slots
    at serve time."""
    return self.replay_k > 1 or self.replay_ratio > 0

  @property
  def resolved_filler_backend(self) -> str:
    """The filler's core: the explicit knob, else env_backend when it is
    on-device (the filler self-plays the run's own task), else 'bandit'
    (which takes the main task's head width)."""
    if self.filler_backend:
      return self.filler_backend
    if self.env_backend in JITTABLE_BACKENDS:
      return self.env_backend
    return 'bandit'

  @property
  def resolved_filler_batch_size(self) -> int:
    return (self.filler_batch_size if self.filler_batch_size > 0
            else self.batch_size)

  @property
  def resolved_filler_unroll_length(self) -> int:
    """The filler's rollout length (0-auto: min(T, 16))."""
    if self.filler_unroll_length > 0:
      return self.filler_unroll_length
    return min(self.unroll_length, 16)

  @property
  def resolved_pbt_suites(self) -> List[str]:
    """The population's suites: the comma list, else env_backend."""
    if self.pbt_suites:
      return [s.strip() for s in self.pbt_suites.split(',') if s.strip()]
    return [self.env_backend]

  @property
  def resolved_pbt_round_frames(self) -> int:
    """Frames per member between PBT decisions (0-auto: a quarter of
    the budget)."""
    if self.pbt_round_frames > 0:
      return self.pbt_round_frames
    return max(self.total_environment_frames // 4, 1)

  @property
  def resolved_use_instruction(self) -> bool:
    """`use_instruction` with the JAX package's None-auto rule: on for
    multi-task dmlab30 and language_*/psychlab_* levels."""
    if self.use_instruction is not None:
      return self.use_instruction
    if self.level_name == 'dmlab30':
      return True
    return self.level_name.startswith(('language_', 'psychlab_'))


# The env backends with an on-device core (parallel/anakin.ENV_CORES):
# the backends of --runtime=anakin, the filler and the population.
JITTABLE_BACKENDS = ('bandit', 'cue_memory', 'gridworld', 'procgen')

_INFERENCE_ADMISSIONS = ('block', 'shed', 'grow')
_STAGING_MODES = ('batch', 'unroll')


# Config fields that are deliberately no CLI flag, each with the reason
# on its line: the `config-flags` checker (analysis/contracts.py) holds
# that every other field is one, and that no entry here is stale. Empty,
# as JAX's is: every field is operator-facing.
INTERNAL_FIELDS = ()


def validate_fleet(config: Config) -> None:
  """The fleet runtime's knob group: the JAX package's hard checks on
  these fields (ValueError)."""
  if config.num_actors < 0:
    raise ValueError(f'num_actors must be >= 0, got {config.num_actors}')
  for name in ('publish_params_every', 'queue_capacity_batches',
               'staging_depth', 'inference_max_batch'):
    if getattr(config, name) < 1:
      raise ValueError(f'{name} must be >= 1, got {getattr(config, name)}')
  if config.inference_min_batch < 0 or config.inference_timeout_ms < 0:
    raise ValueError('inference_min_batch and inference_timeout_ms must '
                     f'be >= 0, got {config.inference_min_batch} and '
                     f'{config.inference_timeout_ms}')
  if config.fleet_probation_secs < 0:
    raise ValueError(f'fleet_probation_secs must be >= 0, got '
                     f'{config.fleet_probation_secs}')
  if config.staging_mode not in _STAGING_MODES:
    raise ValueError(f'unknown staging_mode {config.staging_mode!r} '
                     '(batch | unroll)')
  if config.inference_admission not in _INFERENCE_ADMISSIONS:
    raise ValueError(f'unknown inference_admission '
                     f'{config.inference_admission!r} (policies: '
                     f'{_INFERENCE_ADMISSIONS})')
  if config.publish_codec not in ('bf16', 'f32', 'int8'):
    raise ValueError(f"publish_codec must be 'bf16', 'f32' or 'int8', "
                     f'got {config.publish_codec!r}')
  if config.inference_state_slots < 0:
    raise ValueError(f'inference_state_slots must be >= 0, got '
                     f'{config.inference_state_slots}')
  if config.inference_admission_timeout_secs < 0:
    raise ValueError(f'inference_admission_timeout_secs must be >= 0, got '
                     f'{config.inference_admission_timeout_secs}')
  validate_serving(config)


def validate_serving(config: Config) -> List[str]:
  """The JAX package's `validate_serving`: the serving version table's
  knob group. Raises ValueError on a hard error; returns the warnings."""
  warnings = []
  if config.serving_resident_versions < 1:
    raise ValueError(f'serving_resident_versions must be >= 1, got '
                     f'{config.serving_resident_versions}')
  if config.serving_hbm_budget_mb < 0:
    raise ValueError(f'serving_hbm_budget_mb must be >= 0, got '
                     f'{config.serving_hbm_budget_mb}')
  for name in ('serving_ab_fraction', 'serving_shadow_fraction'):
    value = getattr(config, name)
    if not 0.0 <= value <= 1.0:
      raise ValueError(f'{name} must be in [0, 1], got {value}')
  if (config.serving_resident_versions == 1
      and (config.serving_ab_fraction > 0
           or config.serving_shadow_fraction > 0)):
    warnings.append(
        'serving_ab_fraction/serving_shadow_fraction > 0 with '
        'serving_resident_versions=1: there is never a non-live '
        'resident candidate, so A/B and shadow traffic will not fire '
        '— raise serving_resident_versions')
  if config.serving_replicas and not config.learner_address:
    warnings.append(
        'serving_replicas set without learner_address: routed '
        'inference replicas are an ACTOR-host knob — the learner '
        'role ignores it')
  return warnings


def validate_replay(config: Config) -> List[str]:
  """The JAX package's `validate_replay`: the sample-reuse knob group.
  Raises ValueError on a hard error; returns the warnings."""
  warnings = []
  if config.surrogate not in ('vtrace', 'impact'):
    raise ValueError(f'surrogate must be vtrace|impact, got '
                     f'{config.surrogate!r}')
  if config.replay_k < 1:
    raise ValueError(f'replay_k must be >= 1, got {config.replay_k}')
  if not 0.0 <= config.replay_ratio < 1.0:
    raise ValueError(f'replay_ratio must be in [0, 1) (a batch needs '
                     f'at least one fresh slot), got '
                     f'{config.replay_ratio}')
  if config.target_update_interval < 1:
    raise ValueError(f'target_update_interval must be >= 1, got '
                     f'{config.target_update_interval}')
  if config.impact_epsilon <= 0:
    raise ValueError(f'impact_epsilon must be > 0, got '
                     f'{config.impact_epsilon}')
  if config.replay_capacity_unrolls < 0:
    raise ValueError(f'replay_capacity_unrolls must be >= 0, got '
                     f'{config.replay_capacity_unrolls}')
  if config.replay_max_staleness < 0:
    raise ValueError(f'replay_max_staleness must be >= 0, got '
                     f'{config.replay_max_staleness}')
  if config.reuse_on and config.surrogate == 'vtrace':
    warnings.append(
        'sample reuse (replay_k=%d, replay_ratio=%.2f) with '
        'surrogate=vtrace: plain V-trace has no clipped-target anchor '
        'against reused/stale data (IMPACT, arXiv 1912.00167) — '
        'consider --surrogate=impact' %
        (config.replay_k, config.replay_ratio))
  if (config.replay_max_staleness > 0 and
      config.max_unroll_staleness > 0 and
      config.replay_max_staleness < config.max_unroll_staleness):
    warnings.append(
        'replay_max_staleness=%d is narrower than '
        'max_unroll_staleness=%d (both in published param-version '
        'deltas): unrolls admitted near the ingest window will be '
        'version-evicted from the replay tier without ever being '
        'replayed' %
        (config.replay_max_staleness, config.max_unroll_staleness))
  if (config.replay_ratio > 0 and
      config.resolved_replay_capacity < config.batch_size):
    warnings.append(
        'replay capacity %d is below batch_size %d: replayed slots '
        'will repeat the same few unrolls within adjacent batches' %
        (config.resolved_replay_capacity, config.batch_size))
  return warnings


def resolve_process_id(config: Config) -> int:
  """This process's rank as the config declares it: process_id when
  set, else the reference's --task spelling, floored at 0."""
  return (config.process_id if config.process_id >= 0
          else max(config.task, 0))


def validate_distributed(config: Config,
                         live_process_count: int = 1) -> List[str]:
  """The JAX package's `validate_distributed`: raises ValueError on an
  error, returns the warnings. The checks of the process-group fields
  read the declared topology; the multi-process cross-links read the
  larger of it and `live_process_count` (the joined group's size). Its
  refusal of multi-process Anakin is not here: a rank of the port is a
  device, and the Anakin runtime spans the devices of one host (the CLI
  refuses a group across nodes, experiment.py)."""
  warnings = []
  if config.num_processes < 1:
    raise ValueError(f'num_processes must be >= 1, got '
                     f'{config.num_processes}')
  if config.tp_compute not in ('auto', 'sharded', 'gathered'):
    raise ValueError(f'tp_compute must be auto|sharded|gathered, got '
                     f'{config.tp_compute!r}')
  from scalable_agent_tpu_torch.parallel import sharding
  if (config.sharding_rules != 'auto'
      and config.sharding_rules not in sharding.RULE_SETS):
    raise ValueError(
        f'sharding_rules must be auto|'
        f'{"|".join(sorted(sharding.RULE_SETS))}, got '
        f'{config.sharding_rules!r}')
  if (config.sharding_rules == 'replicated'
      and config.model_parallelism > 1):
    warnings.append(
        'sharding_rules=replicated with model_parallelism=%d: the '
        'model axis exists but no rule cuts over it — every param '
        'replicates across it (TP memory win forfeited); use '
        'sharding_rules=auto or =megatron to shard'
        % config.model_parallelism)
  if config.coordinator_address:
    host, sep, port = config.coordinator_address.rpartition(':')
    if not sep or not host or not port.isdigit():
      raise ValueError(
          f'coordinator_address must be host:port, got '
          f'{config.coordinator_address!r}')
    if config.num_processes == 1:
      warnings.append(
          'coordinator_address=%r with num_processes=1: a one-process '
          'group works but coordinates nothing — drop the flag or raise '
          'the count' % config.coordinator_address)
    resolved_id = resolve_process_id(config)
    if resolved_id >= config.num_processes:
      raise ValueError(
          f'process_id {resolved_id} out of range for num_processes='
          f'{config.num_processes}')
  elif config.num_processes > 1:
    raise ValueError(
        f'num_processes={config.num_processes} needs '
        'coordinator_address (host:port of process 0)')
  elif config.process_id >= 0:
    warnings.append(
        'process_id=%d without coordinator_address: nothing will join a '
        'process group' % config.process_id)
  if max(config.num_processes, live_process_count) <= 1:
    return warnings
  if config.sdc_check and not config.sdc_allgather:
    warnings.append(
        'sdc_check=True with sdc_allgather=False on a multi-process '
        'topology: the per-replica fingerprint readback needs the '
        'all-gather, so the SDC sentinel will be silently OFF — enable '
        'sdc_allgather or drop sdc_check')
  if config.model_parallelism > 1:
    warnings.append(
        'model_parallelism=%d on a multi-process topology: the model '
        'axis crosses processes, so the batch shards over BOTH mesh axes '
        '(sharding.shard_batch_over_model) — batch_size must divide the '
        'full rank count, param publishes gather a full copy over the '
        'model group, and staging_mode=unroll falls back to batch'
        % config.model_parallelism)
  if config.anakin_filler:
    warnings.append(
        'anakin_filler=True on a multi-process topology: the filler '
        'mutates params OUTSIDE the collective train step, so hosts '
        'with different idle patterns would diverge — the driver '
        'disables it (supports_filler) and parks idle slices instead')
  return warnings


def validate_integrity(config: Config) -> List[str]:
  """The JAX package's `validate_integrity`: no hard errors, the
  warnings of a half-enabled integrity plane (the SDC sentinel without
  the ladder, remote ingest or the replay check without wire CRC)."""
  warnings = []
  if config.sdc_check and not config.health_watchdog:
    warnings.append(
        'sdc_check=True with health_watchdog=False: replica '
        'fingerprint mismatches would be computed but never escalated '
        '(no monitor, no rollback ladder) — enable the watchdog or '
        'disable the SDC sentinel')
  if not config.wire_crc and config.remote_actor_port:
    warnings.append(
        'wire_crc=False with remote ingest enabled: a bit-flipped '
        'unroll frame that still parses will train the learner on '
        'garbage with no detection (the round-12 integrity plane is '
        'off on the wire); param publishes keep their content digest '
        'either way')
  if (config.replay_crc and not config.wire_crc
      and config.replay_ratio > 0):
    warnings.append(
        'replay_crc=True with wire_crc=False: replayed unrolls are '
        'verified against their INSERT-time CRC, but a remote unroll '
        'corrupted on the wire is inserted already-rotten and will '
        're-serve cleanly — the replay check only covers rot AFTER '
        'retention')
  return warnings


# What a learner restart from its checkpoint costs before the ingest
# port answers hellos again (process start, imports, restore, the first
# compiles): an actor host's reconnect window shorter than this gives up
# on a restarting learner.
LEARNER_RESTART_BUDGET_SECS = 90.0


def validate_transport(config: Config) -> List[str]:
  """The JAX package's `validate_transport`, the transport-liveness
  knobs: raises ValueError on a negative window; returns the warnings
  of the cross-links (a reconnect window shorter than a learner
  restart, heartbeats that cannot keep a connection inside its reaping
  window, one of the two off). driver.train and run_remote_actor call
  it before spin-up."""
  warnings = []
  if config.remote_heartbeat_secs < 0:
    raise ValueError(f'remote_heartbeat_secs must be >= 0, got '
                     f'{config.remote_heartbeat_secs}')
  if config.remote_conn_idle_timeout_secs < 0:
    raise ValueError(f'remote_conn_idle_timeout_secs must be >= 0, '
                     f'got {config.remote_conn_idle_timeout_secs}')
  if config.actor_reconnect_secs < 0:
    raise ValueError(f'actor_reconnect_secs must be >= 0, got '
                     f'{config.actor_reconnect_secs}')
  if 0 < config.actor_reconnect_secs < LEARNER_RESTART_BUDGET_SECS:
    warnings.append(
        'actor_reconnect_secs=%.1f is shorter than the learner '
        'restart budget (~%.0fs: restore + recompile before the '
        'ingest port answers) — the fleet will give up mid-restart '
        'and a hard-crashed learner comes back to nobody '
        '(docs/RUNBOOK.md §8)' %
        (config.actor_reconnect_secs, LEARNER_RESTART_BUDGET_SECS))
  hb = config.remote_heartbeat_secs
  idle = config.remote_conn_idle_timeout_secs
  if hb > 0 and idle > 0 and hb >= idle:
    warnings.append(
        'remote_heartbeat_secs=%.1f >= remote_conn_idle_timeout_secs'
        '=%.1f: heartbeats cannot keep an idle-but-healthy connection '
        'inside the reaping window — every quiet period becomes a '
        'reap + reconnect cycle' % (hb, idle))
  if idle > 0 and hb == 0:
    warnings.append(
        'remote_conn_idle_timeout_secs=%.1f with heartbeats disabled: '
        'idle-but-healthy peers (slow envs, v5 clients) will be '
        'reaped and must reconnect — set remote_heartbeat_secs > 0 '
        'or size the window above the slowest unroll cadence' % idle)
  if hb > 0 and idle == 0:
    warnings.append(
        'remote_heartbeat_secs=%.1f with idle reaping disabled '
        '(remote_conn_idle_timeout_secs=0): mid-frame stalls still '
        'abort, but a BETWEEN-frames half-open connection is never '
        'reaped and heartbeat misses are not counted — set a nonzero '
        'idle window to get the full liveness story' % hb)
  return warnings


def validate_runtime(config: Config) -> List[str]:
  """The JAX package's `validate_runtime`: the runtime axis and the
  filler's knobs. Raises ValueError on a hard error; returns the
  warnings."""
  warnings = []
  if config.runtime not in ('fleet', 'anakin'):
    raise ValueError(f'runtime must be fleet|anakin, got '
                     f'{config.runtime!r}')
  if config.filler_batch_size < 0:
    raise ValueError(f'filler_batch_size must be >= 0, got '
                     f'{config.filler_batch_size}')
  if config.filler_unroll_length < 0:
    raise ValueError(f'filler_unroll_length must be >= 0, got '
                     f'{config.filler_unroll_length}')
  if config.runtime == 'anakin':
    if config.env_backend not in JITTABLE_BACKENDS:
      raise ValueError(
          f'--runtime=anakin needs a jittable env backend '
          f'({", ".join(JITTABLE_BACKENDS)}), got '
          f'{config.env_backend!r}; real simulators use the fleet '
          'runtime')
    if config.anakin_filler:
      warnings.append(
          'anakin_filler=True under runtime=anakin is a no-op: the '
          'whole run IS the on-device loop (the filler is the fleet '
          "runtime's idle-slice workload)")
    return warnings
  if not config.anakin_filler:
    if config.filler_backend:
      warnings.append(
          'filler_backend=%r with anakin_filler=False: nothing will '
          'run it' % config.filler_backend)
    return warnings
  if config.resolved_filler_backend not in JITTABLE_BACKENDS:
    raise ValueError(
        f'filler_backend must be jittable '
        f'({", ".join(JITTABLE_BACKENDS)}), got '
        f'{config.filler_backend!r}')
  if config.surrogate == 'vtrace':
    warnings.append(
        'anakin_filler=True with surrogate=vtrace: filler updates are '
        'off-cadence relative to the fleet stream and plain V-trace '
        'has no clipped-target anchor against them (IMPACT, '
        'arXiv 1912.00167) — consider --surrogate=impact')
  if not config.slo_engine:
    warnings.append(
        'anakin_filler=True with slo_engine=False: the filler lifts '
        'learner_plane_utilization to ~1.0 by construction, and with '
        'the engine off nothing watches env_plane_utilization — the '
        'dead-env-plane signal the filler could otherwise mask '
        '(docs/OBSERVABILITY.md)')
  return warnings


def validate_slo(config: Config) -> List[str]:
  """The JAX package's `validate_slo`: the SLO knob group. Raises
  ValueError on a hard error; returns the warnings. The spec file itself
  is loaded (so validated) by slo.load_objectives when the engine is
  built."""
  warnings = []
  if config.slo_fast_window_secs <= 0:
    raise ValueError(f'slo_fast_window_secs must be > 0, got '
                     f'{config.slo_fast_window_secs}')
  if config.slo_slow_window_secs <= 0:
    raise ValueError(f'slo_slow_window_secs must be > 0, got '
                     f'{config.slo_slow_window_secs}')
  if config.slo_capture_steps < 1:
    raise ValueError(f'slo_capture_steps must be >= 1, got '
                     f'{config.slo_capture_steps}')
  if config.slo_interval_secs < 0:
    raise ValueError(f'slo_interval_secs must be >= 0, got '
                     f'{config.slo_interval_secs}')
  if not config.slo_engine:
    if config.slo_spec:
      warnings.append(
          'slo_spec=%r with slo_engine=False: the objective set is '
          'loaded by the engine — nothing will judge it' %
          config.slo_spec)
    return warnings
  if config.slo_fast_window_secs >= config.slo_slow_window_secs:
    warnings.append(
        'slo_fast_window_secs=%.1f >= slo_slow_window_secs=%.1f: the '
        'slow window no longer confirms a sustained burn — every '
        'fast-window blip escalates straight to a violation' %
        (config.slo_fast_window_secs, config.slo_slow_window_secs))
  if (config.slo_interval_secs > 0 and
      config.slo_interval_secs * 3 > config.slo_fast_window_secs):
    warnings.append(
        'slo_interval_secs=%.1f leaves fewer than the 3 samples the '
        'fast window (%.1fs) needs before a value objective can '
        'burn — the policy-lag/utilization/fleet objectives would be '
        'structurally unable to fire; lower the interval or widen '
        'slo_fast_window_secs' %
        (config.slo_interval_secs, config.slo_fast_window_secs))
  if not config.telemetry_trace:
    warnings.append(
        'slo_engine=True with telemetry_trace=False: the policy-lag '
        'and end-to-end-span objectives will evaluate as no_data '
        '(their histograms never fill), and page captures lose the '
        'flight/trace-slice artifacts — the verdict only judges the '
        'counter planes')
  if config.slo_capture and not config.health_watchdog:
    warnings.append(
        'slo_capture=True with health_watchdog=False: SLO burns '
        'cannot feed the external-incident ledger (no monitor), so '
        'drain manifests and halt bundles will not name them')
  return warnings


def validate_controller(config: Config) -> List[str]:
  """The JAX package's `validate_controller`: the controller's knob
  group. Raises ValueError on a hard error; returns the warnings of the
  cross-links. The policy file itself is loaded (so validated) by
  controller.load_rules when the controller is built."""
  warnings = []
  if config.controller not in ('off', 'observe', 'act'):
    raise ValueError(f'controller must be off|observe|act, got '
                     f'{config.controller!r}')
  if config.controller_interval_secs < 0:
    raise ValueError(f'controller_interval_secs must be >= 0, got '
                     f'{config.controller_interval_secs}')
  if config.controller_replay_k_max < 1:
    raise ValueError(f'controller_replay_k_max must be >= 1, got '
                     f'{config.controller_replay_k_max}')
  if config.controller_publish_secs_max <= 0:
    raise ValueError(f'controller_publish_secs_max must be > 0, got '
                     f'{config.controller_publish_secs_max}')
  if config.fleet_probation_secs < 0:
    raise ValueError(f'fleet_probation_secs must be >= 0, got '
                     f'{config.fleet_probation_secs}')
  if config.pod_max_hosts < 0:
    raise ValueError(f'pod_max_hosts must be >= 0, got '
                     f'{config.pod_max_hosts}')
  if config.pod_max_hosts > 0 and not config.remote_actor_port:
    warnings.append(
        'pod_max_hosts=%d with remote ingest disabled '
        '(remote_actor_port=0): the pod_size actuator reads the '
        'ingest membership ledger — it will not be registered'
        % config.pod_max_hosts)
  if (config.remote_heartbeat_secs == 0
      and config.remote_conn_idle_timeout_secs > 0
      and config.fleet_probation_secs >
      config.remote_conn_idle_timeout_secs):
    warnings.append(
        'fleet_probation_secs=%.1f exceeds the idle-reaping window '
        '(remote_conn_idle_timeout_secs=%.1f) with heartbeats '
        'disabled: a remote client cooling down in CRC probation '
        'cannot ping, so the learner will reap it as half-open '
        'mid-probation — enable heartbeats or shorten the cool-down'
        % (config.fleet_probation_secs,
           config.remote_conn_idle_timeout_secs))
  if config.controller == 'off':
    if config.controller_policy:
      warnings.append(
          'controller_policy=%r with controller=off: the policy '
          'table is loaded by the controller — nothing will read it'
          % config.controller_policy)
    return warnings
  if not config.slo_engine:
    warnings.append(
        'controller=%s with slo_engine=False: the controller\'s only '
        'input is the SLO engine\'s burning set and margins — it '
        'will be disabled for this run' % config.controller)
  if (config.controller == 'act' and config.surrogate == 'vtrace'
      and config.controller_replay_k_max > 1):
    warnings.append(
        'controller=act may raise replay_k up to %d, but '
        'surrogate=vtrace has no clipped-target anchor against '
        'reused data (IMPACT, arXiv 1912.00167) — consider '
        '--surrogate=impact, or cap --controller_replay_k_max=1'
        % config.controller_replay_k_max)
  return warnings


def validate_population(config: Config) -> List[str]:
  """The JAX package's `validate_population`: the curriculum, mixed
  fleets and PBT. Raises ValueError on a hard error; returns the
  warnings."""
  warnings = []
  if config.curriculum not in ('uniform', 'regret', 'td'):
    raise ValueError(f'curriculum must be uniform|regret|td, got '
                     f'{config.curriculum!r}')
  if config.curriculum_temperature <= 0:
    raise ValueError(f'curriculum_temperature must be > 0, got '
                     f'{config.curriculum_temperature}')
  if not 0.0 <= config.curriculum_eps <= 1.0:
    raise ValueError(f'curriculum_eps must be in [0, 1], got '
                     f'{config.curriculum_eps}')
  if not 0.0 < config.curriculum_alpha <= 1.0:
    raise ValueError(f'curriculum_alpha must be in (0, 1], got '
                     f'{config.curriculum_alpha}')
  if not 0.0 < config.curriculum_decay <= 1.0:
    raise ValueError(f'curriculum_decay must be in (0, 1], got '
                     f'{config.curriculum_decay}')
  if config.procgen_num_levels < 1:
    raise ValueError(f'procgen_num_levels must be >= 1, got '
                     f'{config.procgen_num_levels}')
  if not 0.0 <= config.procgen_wall_density < 1.0:
    raise ValueError(f'procgen_wall_density must be in [0, 1), got '
                     f'{config.procgen_wall_density}')
  if config.curriculum != 'uniform':
    curriculum_backends = {config.env_backend}
    if config.anakin_filler:
      curriculum_backends.add(config.resolved_filler_backend)
    if 'procgen' not in curriculum_backends:
      warnings.append(
          'curriculum=%s with env_backend=%r: only the procgen core '
          'has a finite level-id space to prioritize — the sampler '
          'is inert for this run' %
          (config.curriculum, config.env_backend))
    if config.unroll_length < 2:
      warnings.append(
          'curriculum=%s with unroll_length=1: a TD error needs two '
          'consecutive value estimates, so no per-level signal can '
          'accumulate (scores only decay) — use unroll_length >= 2' %
          config.curriculum)
    if config.curriculum_eps == 0:
      warnings.append(
          'curriculum_eps=0: no uniform mixing floor — a level whose '
          'score collapses early may never be revisited, so its stale '
          'score cannot recover (the decay then has nothing to rescue)')
  if config.fleet_tasks:
    from scalable_agent_tpu_torch import population
    tasks = population.parse_fleet_tasks(config.fleet_tasks)
    if not tasks:
      raise ValueError(f'fleet_tasks={config.fleet_tasks!r} names no '
                       'tasks')
    names = [name for name, _ in tasks]
    for name in names:
      if name not in JITTABLE_BACKENDS:
        raise ValueError(
            f'fleet_tasks names {name!r}: mixed fleets compose the '
            f'jittable suites ({", ".join(JITTABLE_BACKENDS)}) — '
            'real simulators keep their own single-task fleets')
    if 'cue_memory' in names and any(n in ('gridworld', 'procgen')
                                     for n in names):
      raise ValueError(
          'fleet_tasks mixes cue_memory (a fixed 3-action task) with '
          'gridworld/procgen (>= 4 movement actions): one shared '
          'policy head cannot satisfy both — drop one side or widen '
          'with bandit (any head width)')
    if config.runtime == 'anakin':
      warnings.append(
          'fleet_tasks is a fleet-runtime feature (per-actor task '
          'assignment); runtime=anakin runs env_backend=%r only — '
          'the spec is ignored' % config.env_backend)
    elif len(tasks) > config.num_actors:
      raise ValueError(
          f'fleet_tasks names {len(tasks)} tasks but num_actors='
          f'{config.num_actors} cannot cover them at >= 1 actor each')
    if not config.use_popart and len(tasks) > 1:
      warnings.append(
          'fleet_tasks mixes %d suites with use_popart=False: reward '
          'scales will compete in one value head — consider '
          '--use_popart' % len(tasks))
  if config.pbt_population < 0:
    raise ValueError(f'pbt_population must be >= 0, got '
                     f'{config.pbt_population}')
  if config.pbt_round_frames < 0:
    raise ValueError(f'pbt_round_frames must be >= 0, got '
                     f'{config.pbt_round_frames}')
  if not 0.0 < config.pbt_quantile <= 0.5:
    raise ValueError(f'pbt_quantile must be in (0, 0.5] (bottom and '
                     f'top slices must not overlap), got '
                     f'{config.pbt_quantile}')
  if config.pbt_perturb <= 1.0:
    raise ValueError(f'pbt_perturb must be > 1 (the explore factor '
                     f'multiplies OR divides), got {config.pbt_perturb}')
  if config.pbt_population == 1:
    warnings.append(
        'pbt_population=1: a population of one has no donor to '
        'exploit — PBT is off (use >= 2, ideally >= 2 per suite)')
  if config.pbt_vectorized and config.pbt_population < 2:
    warnings.append(
        'pbt_vectorized without pbt_population >= 2: there is no '
        'population to vectorize — the flag is inert')
  if config.pbt_population >= 2:
    if config.runtime != 'anakin':
      raise ValueError(
          'pbt_population >= 2 needs --runtime=anakin: population '
          'members are fused-loop replicas (the fleet runtime owns '
          'the host devices exclusively — replicas would contend)')
    suites = config.resolved_pbt_suites
    for suite in suites:
      if suite not in JITTABLE_BACKENDS:
        raise ValueError(
            f'pbt_suites names {suite!r}: population members are '
            f'anakin runs and need jittable backends '
            f'({", ".join(JITTABLE_BACKENDS)})')
    if 'cue_memory' in suites and any(s in ('gridworld', 'procgen')
                                      for s in suites):
      raise ValueError(
          'pbt_suites mixes cue_memory (fixed 3-action) with '
          'gridworld/procgen (>= 4 actions): members share one agent '
          'architecture, so their policy heads must be one width')
    if config.pbt_vectorized:
      if len(set(suites)) > 1:
        raise ValueError(
            'pbt_vectorized: one vmapped program trains ONE suite '
            '(member programs must be structurally identical), but '
            f'pbt_suites names {sorted(set(suites))} — drop '
            '--pbt_vectorized or train a single-suite population')
      if config.model_parallelism > 1:
        warnings.append(
            'pbt_vectorized with model_parallelism=%d: vectorized '
            'members are single-device programs — train_population '
            'degrades to the serial member loop' %
            config.model_parallelism)
    if config.pbt_population < len(suites):
      raise ValueError(
          f'pbt_population={config.pbt_population} cannot cover '
          f'{len(suites)} suites at >= 1 member each')
    if config.pbt_population < 2 * len(suites):
      warnings.append(
          'pbt_population=%d over %d suite(s): some suites get a '
          'single member, and exploit/explore only fires WITHIN a '
          'suite — size the population at >= 2 per suite' %
          (config.pbt_population, len(suites)))
  return warnings
