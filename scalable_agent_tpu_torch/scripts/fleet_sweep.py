"""The fleet runtime's operating points on the card:

  python -m scalable_agent_tpu_torch.scripts.fleet_sweep [--steps=6]

`driver.train` at the slice's full width (deep torso, 72x96, T=100, B=32,
9 actions, 4 action repeats, float32, fused V-trace) under each variant
of the fleet: the number of actors, whether each env has its own process,
and the interpreter's thread switch interval (`sys.setswitchinterval`:
how long a thread computing in Python keeps the GIL from one that waits).
One JSON line per variant: env-frames/s and ms per learner step over the
steps after the first two, the learner's blocked-get seconds and the rest
of its step per step, and the inference server's mean batch and latency
percentiles; the card's name and power limit first. Needs CUDA; the
variants run in this one process, one after the other.
"""

import argparse
import json
import subprocess
import sys
import tempfile

import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.profile_anakin import SLICE
from scalable_agent_tpu_torch.runtime import py_process

# (num_actors, use_py_process, switch interval in ms)
VARIANTS = [(32, True, 5.0), (32, False, 5.0), (16, True, 5.0),
            (8, True, 5.0), (32, True, 0.5)]
TIMED_FROM = 2


def run_variant(num_actors, use_py_process, switch_ms, steps):
  default_switch = sys.getswitchinterval()
  sys.setswitchinterval(switch_ms / 1e3)
  try:
    with tempfile.TemporaryDirectory(prefix='fleet_sweep_') as logdir:
      config = Config(**SLICE, num_actors=num_actors,
                      use_py_process=use_py_process, summary_secs=0,
                      logdir=logdir)
      run = driver.train(config, max_steps=steps, device='cuda',
                         stall_timeout_secs=300)
  finally:
    sys.setswitchinterval(default_switch)
  first, last = run.step_log[TIMED_FROM - 1], run.step_log[-1]
  timed = steps - TIMED_FROM
  seconds = last['time'] - first['time']
  waited = last['get_wait_secs'] - first['get_wait_secs']
  server = run.stats['server']
  return {
      'num_actors': num_actors, 'use_py_process': use_py_process,
      'switch_interval_ms': switch_ms,
      'env_frames_per_sec': timed * config.frames_per_step / seconds,
      'ms_per_learner_step': 1e3 * seconds / timed,
      'blocked_get_ms_per_step': 1e3 * waited / timed,
      'rest_of_step_ms': 1e3 * (seconds - waited) / timed,
      'inference_mean_batch': server['mean_batch'],
      'inference_latency_p50_ms': server['latency_p50_ms'],
      'inference_latency_p99_ms': server['latency_p99_ms'],
      'buffer_high_water': run.stats['buffer']['high_water'],
  }


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--steps', type=int, default=6)
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    raise SystemExit('fleet_sweep: needs CUDA (torch.cuda.is_available() '
                     'is False)')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  for variant in VARIANTS:
    print(json.dumps(run_variant(*variant, steps=args.steps)), flush=True)


if __name__ == '__main__':
  # Before any CUDA call: env processes fork from this server.
  py_process.warm_forkserver(preload=[__spec__.name])
  main()
