"""Where the time of one fused Anakin step goes, on one NVIDIA card.

  python -m scalable_agent_tpu_torch.profile_anakin \
      [--compute_dtype=bfloat16] [--extensions]

Runs the chip_smoke.py slice configuration (deep torso, 72x96 frames,
T=100, B=32, 9 actions, fused V-trace; `--compute_dtype` float32, the
default, with TF32 off, or bfloat16; `--extensions` adds the learner
extensions of the full-feature config: PopArt, pixel control at 0.01
and the instruction encoder) and prints:

- host wall time per fused step, split into acting (T policy steps and
  env steps) and learning (the train step), each ended by a
  synchronize;
- over a profiled window of fused steps (torch.profiler, CPU + CUDA):
  the device's busy time and idle share, and the ops that take the most
  device time;
- the V-trace kernel's device time per launch;

then one JSON line with those numbers. It needs CUDA.
"""

import argparse
import json
import sys
import time

import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import anakin

# The slice's full-width configuration (chip_smoke.py runs it too).
SLICE = dict(env_backend='bandit', torso='deep', height=72, width=96,
             batch_size=32, unroll_length=100, num_actions=9,
             use_pallas_vtrace=True, use_instruction=False, seed=0)
STEPS = 3  # timed steps, then as many profiled ones
# The learner extensions of the full-feature config (parallel/fit.py).
EXTENSIONS = dict(use_popart=True, pixel_control_cost=0.01,
                  use_instruction=True)


def _device_us(event):
  for name in ('self_device_time_total', 'self_cuda_time_total'):
    value = getattr(event, name, None)
    if value is not None:
      return float(value)
  return 0.0


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.profile_anakin')
  parser.add_argument('--compute_dtype', default='float32',
                      choices=('float32', 'bfloat16'))
  parser.add_argument('--extensions', action='store_true')
  args = parser.parse_args(argv)
  driver.resolve_device('cuda')
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  config = Config(**dict(SLICE, compute_dtype=args.compute_dtype,
                         **(EXTENSIONS if args.extensions else {})))
  env_core = anakin.make_env_core(config)
  agent = driver.build_agent(config, env_core.num_actions)
  train = learner.make_train_step_fn(agent, config)
  learn_s = []

  def timed_train(state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train(state, batch)
    torch.cuda.synchronize()
    learn_s.append(time.perf_counter() - t0)
    return out

  step = anakin.make_anakin_step(agent, env_core, config,
                                 train_step_fn=timed_train)
  carry = anakin.init_carry(agent, env_core, config, config.seed, 'cuda')
  for _ in range(2):  # warm-up: kernel build, cuDNN plans, allocator
    carry, _ = step(carry)
  torch.cuda.synchronize()

  learn_s.clear()
  step_s = []
  for _ in range(STEPS):
    t0 = time.perf_counter()
    carry, metrics = step(carry)
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
  step_ms = 1e3 * sum(step_s) / len(step_s)
  learn_ms = 1e3 * sum(learn_s) / len(learn_s)

  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    t0 = time.perf_counter()
    for _ in range(STEPS):
      carry, metrics = step(carry)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
  events = prof.key_averages()
  # Device-side entries only (kernels, copies, memsets): the CPU ops that
  # launched them carry the same time again.
  kernels = [e for e in events
             if str(getattr(e, 'device_type', '')).endswith('CUDA')]
  busy_us = sum(_device_us(e) for e in kernels)
  top = sorted(kernels, key=_device_us, reverse=True)[:15]
  vtrace = [e for e in kernels if 'vtrace_kernel' in e.key]
  vtrace_us = (sum(_device_us(e) for e in vtrace) /
               max(sum(e.count for e in vtrace), 1)) if vtrace else None

  card = torch.cuda.get_device_name(0)
  torch.cuda.reset_peak_memory_stats()
  carry, metrics = step(carry)
  torch.cuda.synchronize()
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  print(f'{card}, {config.compute_dtype}'
        f'{" with the extensions" if args.extensions else ""}: fused step '
        f'{step_ms:.1f} ms = '
        f'acting {step_ms - learn_ms:.1f} ms + learning {learn_ms:.1f} ms '
        f'({config.frames_per_step / step_ms * 1e3:.0f} env-frames/s)')
  print(f'profiled window: {STEPS} steps in {window_s * 1e3:.1f} ms, '
        f'device busy {busy_us / 1e3:.1f} ms, idle share '
        f'{1 - busy_us / 1e6 / window_s:.3f}')
  for e in top:
    print(f'  {_device_us(e) / 1e3 / STEPS:9.2f} ms/step  '
          f'{e.count // STEPS:6d} calls/step  {e.key[:90]}')
  if vtrace_us is not None:
    print(f'vtrace kernel: {vtrace_us:.2f} us device time per launch')
  print(f'peak {peak_gib:.3f} GiB allocated over one fused step')
  print(json.dumps({
      'card': card, 'compute_dtype': config.compute_dtype,
      'extensions': args.extensions,
      'peak_gib': peak_gib, 'step_ms': step_ms,
      'acting_ms': step_ms - learn_ms, 'learning_ms': learn_ms,
      'env_frames_per_sec': config.frames_per_step / step_ms * 1e3,
      'device_busy_ms_per_step': busy_us / 1e3 / STEPS,
      'idle_share': 1 - busy_us / 1e6 / window_s,
      'vtrace_device_us': vtrace_us,
      'top_ops': [[e.key, _device_us(e) / 1e3 / STEPS]
                  for e in top]}))


if __name__ == '__main__':
  main(sys.argv[1:])
