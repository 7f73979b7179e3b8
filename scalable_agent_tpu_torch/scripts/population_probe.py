"""The population's lockstep step on the card:

  python -m scalable_agent_tpu_torch.scripts.population_probe \
      [--members=4] [--steps=3]

At the slice's full width (deep torso, 72x96, T=100, B=32, float32,
fused V-trace) on the procgen core (8 levels, 4 actions) with the regret
curriculum:

- `lockstep`: ms per lockstep step of `--members` members
  (parallel/anakin.make_vectorized_anakin_step) after one untimed step,
  beside ms per fused step of one member alone (the same seed and
  hypers), each over `--steps` steps ended by a synchronize; peak memory
  of each;
- `vtrace`: the V-trace kernel (K1) at the lockstep step's [100, 32P]
  and at one member's [100, 32]: median ms per call by CUDA events (200
  calls) and device us per launch by torch.profiler, with the bound;

One JSON line per measurement; the card's name and power limit first.
Needs CUDA.
"""

import argparse
import json
import subprocess
import time

import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.observability import (cuda_median_ms,
                                                    profiled_device_us)
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.profile_anakin import SLICE

PROCGEN = dict(SLICE, env_backend='procgen', num_actions=4,
               curriculum='regret')
HBM_BYTES_PER_S = 3.35e12


def _timed_steps(step, state, steps):
  state, _ = step(state)  # untimed: cuDNN's algorithm search, the build
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for _ in range(steps):
    state, metrics = step(state)
  torch.cuda.synchronize()
  return 1e3 * (time.perf_counter() - t0) / steps


def measure_lockstep(members: int, steps: int):
  config = Config(**PROCGEN)
  core = anakin.make_env_core(config)
  seeds = [config.seed + 101 * k + 1 for k in range(members)]
  torch.cuda.reset_peak_memory_stats()
  agents, carries = anakin.init_members(config, core, seeds, 'cuda')
  hypers = {name: torch.full((members,), getattr(config, name),
                             device='cuda')
            for name in ('learning_rate', 'entropy_cost')}
  vstep = anakin.make_vectorized_anakin_step(agents, core, config)
  lockstep_ms = _timed_steps(lambda c: vstep(c, hypers), carries, steps)
  lockstep_peak = torch.cuda.max_memory_allocated() / 2**30
  del agents, carries, vstep
  torch.cuda.empty_cache()

  torch.cuda.reset_peak_memory_stats()
  (agent,), (carry,) = anakin.init_members(config, core, seeds[:1], 'cuda')
  fused = anakin.make_anakin_step(agent, core, config)
  member_ms = _timed_steps(fused, carry, steps)
  return {'measure': 'lockstep', 'members': members,
          'lockstep_ms': lockstep_ms, 'one_member_ms': member_ms,
          'lockstep_over_members_x_one': lockstep_ms / (members * member_ms),
          'lockstep_peak_gib': lockstep_peak,
          'one_member_peak_gib': torch.cuda.max_memory_allocated() / 2**30}


def measure_vtrace(cols: int):
  generator = torch.Generator(device='cuda').manual_seed(0)
  shape = (SLICE['unroll_length'], cols)
  rand = lambda: torch.rand(shape, generator=generator,  # noqa: E731
                            device='cuda')
  args = (rand() - 0.5, 0.99 * (rand() > 0.1).float(), rand(), rand(),
          torch.rand((cols,), generator=generator, device='cuda'))
  call = lambda: vtrace_cuda.from_importance_weights(*args)  # noqa: E731
  nbytes = 4 * (6 * shape[0] * cols + cols)  # 4 inputs + 2 outputs, bootstrap
  return {'measure': 'vtrace', 'shape': list(shape),
          'ms_per_call': cuda_median_ms(call, 200),
          'device_us_per_launch': profiled_device_us(call, 200, 'vtrace'),
          'bytes': nbytes, 'bound_ms': 1e3 * nbytes / HBM_BYTES_PER_S}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--members', type=int, default=4)
  parser.add_argument('--steps', type=int, default=3)
  args = parser.parse_args(argv)
  driver.resolve_device('cuda')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  driver.set_float32_precision()
  print(json.dumps(measure_lockstep(args.members, args.steps)), flush=True)
  for cols in (SLICE['batch_size'] * args.members, SLICE['batch_size']):
    print(json.dumps(measure_vtrace(cols)), flush=True)


if __name__ == '__main__':
  main()
