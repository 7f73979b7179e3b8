"""Head-to-head return curves: the `deep` torso against `deep_fast`.

    python -m scalable_agent_tpu_torch.scripts.compare_torsos           # card
    SMOKE=1 python -m scalable_agent_tpu_torch.scripts.compare_torsos --device=cpu

`deep_fast` (stride-2 convolutions in place of the max-pools) is a
different function from `deep`: a receptive field of 3 against 5 per
section and no max nonlinearity. This harness trains both head to head
on `cue_memory`, the task that needs vision and memory (the cue shows on
the first frame only; envs/fake.py CueMemoryEnv), through the production
pipeline (`driver.train`: batcher, buffer, prefetcher, learner) with the
same seed and step budget, and records each torso's return curve.

The port's copy of the JAX package's `scripts/compare_torsos.py`, with
its configuration: 4 actors, B=4, T=16, 72x96, bf16, 400 learner steps,
seed 11 (SMOKE=1: 2 actors, B=2, T=8, 24x32, float32, 8 steps), V-trace
through `vtrace.py` (`use_pallas_vtrace` left off). `--device` defaults
to cuda, which raises without CUDA; `--device=cpu` runs on the CPU.

The artifact (JAX's keys: task, note, runs[].torso, steps, frames,
return_curve_deciles, tail_mean_return; and each run's device, wall and
first-step seconds) goes to TORSO_COMPARE_OUT, by default
TORSO_COMPARE.json in the run's temporary directory; the last line
printed names it. It asserts only mechanics (steps taken; at full size,
curves not empty): whether deep_fast's returns match deep's is read
from the curves, not gated here.
"""

import argparse
import json
import os
import sys
import tempfile
import time

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config

TORSOS = ('deep', 'deep_fast')
NOTE = ('memory policy 3.0, best memoryless 2.33 — a torso that cannot '
        'feed the LSTM usable features plateaus below 2.6 '
        '(tests/test_e2e_smoke.py)')


def _return_curve(logdir, buckets=10):
  """[(step, ep_return)] from summaries.jsonl, bucketed into step deciles
  (mean per bucket): the curve's shape without per-episode noise.
  Returns (curve, mean of the last three non-empty buckets)."""
  events = []
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    for line in f:
      e = json.loads(line)
      if e.get('tag', '').endswith('/episode_return'):
        events.append((e['step'], e['value']))
  if not events:
    return [], 0.0
  events.sort()
  max_step = max(s for s, _ in events) or 1
  sums = [[0.0, 0] for _ in range(buckets)]
  for step, value in events:
    i = min(step * buckets // (max_step + 1), buckets - 1)
    sums[i][0] += value
    sums[i][1] += 1
  curve = [round(s / n, 3) if n else None for s, n in sums]
  tail = [v for v in curve[-3:] if v is not None]
  return curve, round(sum(tail) / max(len(tail), 1), 3)


def run_one(torso, smoke, seed=11, device='cuda', root=None):
  """One torso's run; its logdir is a new directory under `root`."""
  cfg = Config(
      logdir=tempfile.mkdtemp(prefix=f'torso_cmp_{torso}_', dir=root),
      env_backend='cue_memory',
      num_actions=3,
      num_actors=4 if not smoke else 2,
      batch_size=4 if not smoke else 2,
      unroll_length=16 if not smoke else 8,
      num_action_repeats=1,
      height=72 if not smoke else 24,
      width=96 if not smoke else 32,
      torso=torso,
      compute_dtype='bfloat16' if not smoke else 'float32',
      use_py_process=False,     # in-process envs: the pipeline under test
                                # is batcher/buffer/prefetcher, not IPC
      use_instruction=False,
      learning_rate=0.003, entropy_cost=0.01, discounting=0.9,
      total_environment_frames=10**8,
      checkpoint_secs=10**6, summary_secs=2 if not smoke else 1,
      seed=seed)
  max_steps = 400 if not smoke else 8
  t0 = time.monotonic()
  run = driver.train(cfg, max_steps=max_steps, stall_timeout_secs=180,
                     device=device)
  wall = time.monotonic() - t0
  curve, tail_mean = _return_curve(cfg.logdir)
  return {
      'torso': torso,
      'steps': int(run.state.update_steps),
      'frames': int(run.frames),
      'return_curve_deciles': curve,
      'tail_mean_return': tail_mean,
      'device': str(device),
      'wall_secs': round(wall, 3),
      # The first learner steps' ends, seconds after the call to train.
      'first_step_secs': [round(s['time'] - t0, 3)
                          for s in run.step_log[:3]],
  }


def main(argv=None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.compare_torsos',
      description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="torch device of both runs (default cuda; 'cpu' "
                           'to run on the CPU)')
  args = parser.parse_args(argv)
  device = str(driver.resolve_device(args.device))
  driver.set_float32_precision()
  smoke = os.environ.get('SMOKE') == '1'
  root = tempfile.mkdtemp(prefix='torso_cmp_')
  results = {'task': 'cue_memory', 'note': NOTE,
             'runs': [run_one(t, smoke, device=device, root=root)
                      for t in TORSOS]}
  for run in results['runs']:
    assert run['steps'] > 0, run
    if not smoke:
      assert run['return_curve_deciles'], (
          f"no episodes finished for {run['torso']} — window too short "
          'for the curve to exist')
  out = os.environ.get('TORSO_COMPARE_OUT',
                       os.path.join(root, 'TORSO_COMPARE.json'))
  with open(out, 'w') as f:
    json.dump(results, f, indent=1)
  print(json.dumps(results))
  print('compare_torsos OK ->', out, flush=True)
  return 0


if __name__ == '__main__':
  # Before any CUDA call: env processes fork from this server.
  from scalable_agent_tpu_torch.runtime import py_process
  py_process.warm_forkserver(preload=[__spec__.name])
  try:
    sys.exit(main(sys.argv[1:]))
  finally:
    py_process.stop_forkserver()
