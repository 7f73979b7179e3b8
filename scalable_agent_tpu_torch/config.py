"""Experiment configuration of the port.

The field names and defaults are those of the JAX package's `Config`
(scalable_agent_tpu/config.py), so a config carries across the two
packages unchanged. Only the fields this slice of the port reads are
here; a setting that selects a path the port does not have yet raises
`NotImplementedError` naming the ROADMAP item that brings it — the port
never ignores a setting silently.
"""

import dataclasses
from typing import Optional

import torch

# The JAX CLI's `--compute_dtype` enum (experiment.py), by torch dtype.
COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@dataclasses.dataclass
class Config:
  # Experiment / run control.
  logdir: str = '/tmp/agent'
  mode: str = 'train'                     # train | test | anakin

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
  # Skip a non-finite update: the step keeps the old params and
  # optimizer state, and still advances update_steps.
  health_watchdog: bool = True
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
      later.append('replay_k>1 / replay_ratio>0 (sample reuse: ROADMAP '
                   'Queue A, extensions slice)')
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
