"""The memory-fit check of the full-feature learner, the port's
counterpart of the JAX package's parallel/fit.py.

The JAX module compiles the sharded full-feature step ahead of time and
reads XLA's buffer sizes. The port runs the step: `memory_fit` builds
the flagship full-feature learner (`full_feature_config`: the deep
torso, T=100, 72x96, bf16, PopArt over DMLab-30's 30 tasks, pixel
control at cost 0.01, the instruction encoder) at B / data_parallelism
rows, the rows one card holds under data parallelism, takes one train
step on the card, and reports `torch.cuda.max_memory_allocated` over the
step against HBM_BUDGET_FRACTION of the card's memory. The gradient
all-reduce's flat buffer of a process group is not in it.

On the CPU, only when the caller asks for it (`device='cpu'`), it takes
no step and reports the bytes of the step's arguments (params, RMSProp
state, PopArt statistics, batch), so a test can hold them against JAX's
`argument_size_in_bytes` at a small shape.

  python -m scalable_agent_tpu_torch.parallel.fit   # B=32 and B=16
"""

import json
import time
from typing import Any, Dict

import torch

# Headroom for allocations the step's peak does not see (the caching
# allocator's blocks, NCCL and cuDNN workspaces); the JAX module's margin.
HBM_BUDGET_FRACTION = 0.85
NUM_ACTIONS = 9


def full_feature_config(batch_size: int = 32, unroll_length: int = 100,
                        height: int = 72, width: int = 96, **overrides):
  """The flagship full-feature learner config (the JAX function's)."""
  from scalable_agent_tpu_torch.config import Config
  kwargs = dict(batch_size=batch_size, unroll_length=unroll_length,
                num_action_repeats=4, torso='deep',
                compute_dtype='bfloat16', use_popart=True,
                pixel_control_cost=0.01, use_instruction=True,
                height=height, width=width,
                total_environment_frames=int(1e9))
  kwargs.update(overrides)
  return Config(**kwargs)


def _nbytes(tensors) -> int:
  return sum(t.numel() * t.element_size() for t in tensors)


def state_bytes(state) -> int:
  """Bytes of a TrainState's tensors (the step counter lives on the
  host)."""
  from scalable_agent_tpu_torch import learner
  payload = learner.state_to_payload(state)
  total = _nbytes(payload['params'].values())
  opt = payload['opt_state']
  total += _nbytes(opt['nu'].values()) + _nbytes([opt['count']])
  total += _nbytes((opt['trace'] or {}).values())
  for name in ('popart', 'target_params', 'target_popart'):
    total += _nbytes(payload.get(name, {}).values())
  return total


def batch_bytes(batch) -> int:
  from scalable_agent_tpu_torch.structs import map_structure
  sizes = []
  map_structure(lambda t: sizes.append(t.numel() * t.element_size()), batch)
  return sum(sizes)


def memory_fit(device='cuda', batch_size: int = 32,
               data_parallelism: int = 1, num_tasks: int = 30,
               unroll_length: int = 100, height: int = 72, width: int = 96,
               torso: str = 'deep') -> Dict[str, Any]:
  """One full-feature train step at batch_size / data_parallelism rows
  on `device`; returns the fit as a dict (the JAX result's field names
  where they mean the same). `device` 'cuda' with no CUDA raises."""
  from scalable_agent_tpu_torch import driver, learner
  from scalable_agent_tpu_torch.models import init_params
  from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN
  from scalable_agent_tpu_torch.testing import make_example_batch
  device = driver.resolve_device(device)
  if batch_size % data_parallelism:
    raise ValueError(f'batch_size={batch_size} must divide the data '
                     f'parallelism {data_parallelism}')
  rows = batch_size // data_parallelism
  config = full_feature_config(rows, unroll_length, height, width,
                               torso=torso)
  agent = driver.build_agent(config, NUM_ACTIONS, num_tasks)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  agent.to(device)
  state = learner.make_train_state(agent, config, num_tasks)
  batch = make_example_batch(unroll_length + 1, rows, height, width,
                             NUM_ACTIONS, MAX_INSTRUCTION_LEN,
                             device=device, num_tasks=num_tasks)
  argument_bytes = state_bytes(state) + batch_bytes(batch)
  out = {'mesh': {'data': data_parallelism}, 'backend': device.type,
         'batch_size': batch_size, 'per_device_batch': rows,
         'unroll_length': unroll_length, 'num_tasks': num_tasks,
         'argument_bytes': int(argument_bytes)}
  if device.type != 'cuda':
    return out
  step = learner.make_train_step_fn(agent, config)
  torch.cuda.synchronize(device)
  torch.cuda.reset_peak_memory_stats(device)
  t0 = time.perf_counter()
  state, metrics = step(state, batch)
  float(metrics['total_loss'])
  torch.cuda.synchronize(device)
  step_secs = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated(device)
  total = torch.cuda.get_device_properties(device).total_memory
  budget = int(total * HBM_BUDGET_FRACTION)
  out.update({
      'device': torch.cuda.get_device_name(device),
      'live_bytes': int(peak), 'live_gib': round(peak / 2**30, 3),
      'hbm_bytes': int(total), 'hbm_budget_bytes': budget,
      'fits': bool(peak <= budget),
      'first_step_secs': round(step_secs, 3),
      'total_loss_finite': bool(torch.isfinite(metrics['total_loss'])),
  })
  return out


def format_fit(fit: Dict[str, Any]) -> str:
  """One line of a fit result."""
  gib = 1 / 2**30
  return ('memory_fit: B=%d (per-device %d) T=%d mesh=%s peak=%.3f GiB '
          '(args %.3f) vs budget %.1f GiB of %.1f on %s: %s' % (
              fit['batch_size'], fit['per_device_batch'],
              fit['unroll_length'], fit['mesh'], fit['live_bytes'] * gib,
              fit['argument_bytes'] * gib, fit['hbm_budget_bytes'] * gib,
              fit['hbm_bytes'] * gib, fit['device'],
              'fits' if fit['fits'] else 'DOES NOT FIT'))


if __name__ == '__main__':
  for rows in (32, 16):
    result = memory_fit('cuda', batch_size=rows)
    print(format_fit(result))
    print(json.dumps(result, sort_keys=True))
