"""Experiment configuration of the port.

The field names and defaults are those of the JAX package's `Config`
(scalable_agent_tpu/config.py), so a config carries across the two
packages unchanged. Only the fields this slice of the port reads are
here; a setting that selects a path the port does not have yet raises
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
  level_name: str = 'explore_goal_locations_small'
  width: int = 96
  height: int = 72

  # Optimizer (RMSProp, linear decay to 0 over total frames).
  learning_rate: float = 0.00048
  decay: float = 0.99
  momentum: float = 0.0
  epsilon: float = 0.1

  env_backend: str = 'dmlab'              # the port's Anakin runs 'bandit'
  num_actions: Optional[int] = None       # backend default when None
  episode_length: int = 100               # bandit episode length
  torso: str = 'deep'                     # deep | shallow
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
  use_popart: bool = False
  pixel_control_cost: float = 0.0
  grad_clip_norm: Optional[float] = None
  summary_secs: int = 30
  surrogate: str = 'vtrace'               # vtrace (impact: later slice)
  replay_k: int = 1
  replay_ratio: float = 0.0
  runtime: str = 'fleet'                  # fleet | anakin

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
  inference_state_cache: bool = False     # True: ROADMAP A7
  inference_admission: str = 'block'      # block (shed | grow: A7)
  # Fleet health: consecutive respawns without a completed unroll before
  # a slot is quarantined (0 = never); the probation cool-down of a
  # quarantined slot, read by the elastic fleet's actuators (ROADMAP A7).
  fleet_quarantine_after: int = 5
  fleet_probation_secs: float = 30.0
  # Fields of paths the port does not have yet: validate_fleet raises
  # when one leaves its default.
  fleet_tasks: str = ''                   # mixed fleets: ROADMAP A7
  publish_codec: str = 'bf16'             # int8: ROADMAP A7
  serving_resident_versions: int = 1      # serving_*: ROADMAP A7
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
  curriculum: str = 'uniform'

  def __post_init__(self):
    later = []
    if self.resolved_use_instruction:
      later.append('use_instruction=True (instruction encoder: ROADMAP '
                   'Queue A, extensions slice)')
    if self.use_popart:
      later.append('use_popart (ROADMAP Queue A, extensions slice)')
    if self.pixel_control_cost > 0:
      later.append('pixel_control_cost>0 (ROADMAP Queue A, extensions '
                   'slice)')
    if self.surrogate != 'vtrace':
      later.append(f'surrogate={self.surrogate!r} (IMPACT: ROADMAP Queue '
                   'A, extensions slice)')
    if self.replay_k != 1 or self.replay_ratio != 0.0:
      later.append('replay_k>1 / replay_ratio>0 (sample reuse and the '
                   'replay tier: ROADMAP A2)')
    if self.curriculum != 'uniform':
      later.append(f'curriculum={self.curriculum!r} (population: ROADMAP '
                   'Queue A, population slice)')
    if self.torso not in ('deep', 'shallow'):
      later.append(f'torso={self.torso!r} (the port has deep and '
                   'shallow; ROADMAP Queue A)')
    if later:
      raise NotImplementedError(
          'not in the PyTorch port yet: ' + '; '.join(later))
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
  def resolved_use_instruction(self) -> bool:
    """`use_instruction` with the JAX package's None-auto rule: on for
    multi-task dmlab30 and language_*/psychlab_* levels."""
    if self.use_instruction is not None:
      return self.use_instruction
    if self.level_name == 'dmlab30':
      return True
    return self.level_name.startswith(('language_', 'psychlab_'))


_INFERENCE_ADMISSIONS = ('block', 'shed', 'grow')
_STAGING_MODES = ('batch', 'unroll')
_SERVING_DEFAULTS = dict(serving_resident_versions=1,
                         serving_hbm_budget_mb=0.0, serving_ab_fraction=0.0,
                         serving_shadow_fraction=0.0, serving_aot=False,
                         serving_replicas='')


def validate_fleet(config: Config) -> None:
  """The fleet runtime's knob group: the JAX package's hard checks on
  these fields (ValueError), and NotImplementedError, naming the ROADMAP
  item, for a setting that picks a path the port does not have yet."""
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
  later = []
  if config.inference_state_cache:
    later.append('inference_state_cache=True (ROADMAP A7)')
  if config.inference_admission != 'block':
    later.append(f'inference_admission={config.inference_admission!r} '
                 '(ROADMAP A7)')
  if config.publish_codec == 'int8':
    later.append("publish_codec='int8' (ROADMAP A7)")
  changed = sorted(k for k, v in _SERVING_DEFAULTS.items()
                   if getattr(config, k) != v)
  if changed:
    later.append(f'{", ".join(changed)} (the serving plane: ROADMAP A7)')
  if config.fleet_tasks:
    later.append('fleet_tasks (mixed fleets: ROADMAP A7)')
  if later:
    raise NotImplementedError(
        'not in the PyTorch port\'s fleet runtime yet: ' + '; '.join(later))


def resolve_process_id(config: Config) -> int:
  """This process's rank as the config declares it: process_id, floored
  at 0 (the JAX package's rule with its `task` field at its default)."""
  return max(config.process_id, 0)


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
  return warnings


def validate_integrity(config: Config) -> List[str]:
  """The JAX package's `validate_integrity` for the fields the port has:
  no hard errors, the warning of a half-enabled SDC sentinel."""
  warnings = []
  if config.sdc_check and not config.health_watchdog:
    warnings.append(
        'sdc_check=True with health_watchdog=False: replica '
        'fingerprint mismatches would be computed but never escalated '
        '(no monitor, no rollback ladder) — enable the watchdog or '
        'disable the SDC sentinel')
  return warnings
