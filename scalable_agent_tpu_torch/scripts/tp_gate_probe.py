"""How close chip_smoke's tp comparison runs to its parameter gate.

  python -m scalable_agent_tpu_torch.scripts.tp_gate_probe \\
      [--reps 2] [--modes gathered,sharded] [--hold_gib 0]

From the repo's root, on the card only (chip_smoke.py raises without
CUDA). Two gloo ranks share the card as chip_smoke's tp phase runs them:
each mode's 3 TP steps from the seeded params, and on rank 0 the
one-rank step from each TP step's gathered state before it. Every
repetition runs with cuDNN free to pick any algorithm, then again with
`torch.backends.cudnn.deterministic`. `--hold_gib` has the parent
process hold that much of the card while the ranks run, as a parent
whose allocator cache was not released would.

Prints the card's name and power limit, then one JSON line per TP step:
the largest share of the phase's parameter gate (|TP - one rank| over
5e-6 + 5e-4 |one rank|, above 1 fails), the tensor and element it was
taken at, and the relative L2 distance of that tensor against its
update.
"""

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib


def _rank(rank, world, port, outdir, reps, modes):
  import chip_smoke as cs

  def body(group, device):
    mesh = mesh_lib.make_mesh(device, model_parallelism=2)
    out = []
    for deterministic in (False, True):
      torch.backends.cudnn.deterministic = deterministic
      for rep in range(reps):
        for mode in modes:
          cut = cs.TP_SHARDED_CUT if mode == 'sharded' else {}
          config = Config(**dict(cs.SLICE, **cut), **group,
                          model_parallelism=2, tp_compute=mode)
          batch = cs._small_batch(config.unroll_length, config.batch_size,
                                  config.num_actions, config.height,
                                  config.width)
          _, losses, _, states, _, _ = cs._tp_steps(config, device, mesh,
                                                    batch, cs.TP_STEPS)
          result = dict(deterministic=deterministic, rep=rep, mode=mode,
                        losses=losses, states=states)
          if rank == 0:
            one = Config(**dict(cs.SLICE, **cut))
            result['one'] = cs._one_rank_steps(one, device, batch, states)
          out.append(result)
    return out

  cs._in_rank(rank, world, port, outdir, body)


def _worst(before, after, got):
  """The step's largest share of the gate and where it was taken."""
  share, at = 0.0, None
  for k, v in after['params'].items():
    want = v.numpy().astype(np.float64)
    have = got['params'][k].numpy().astype(np.float64)
    update = want - before['params'][k].numpy().astype(np.float64)
    ratio = np.abs(have - want) / (5e-6 + 5e-4 * np.abs(want))
    j = int(np.argmax(ratio))
    if ratio.flat[j] > share:
      share = float(ratio.flat[j])
      at = dict(tensor=k, diff=float(np.abs(have - want).flat[j]),
                param=float(want.flat[j]), update=float(update.flat[j]),
                over_gate=int((ratio > 1).sum()),
                rel_l2=float(np.linalg.norm(have - want) /
                             np.linalg.norm(update)))
  return share, at


def main():
  import chip_smoke as cs
  parser = argparse.ArgumentParser()
  parser.add_argument('--reps', type=int, default=2)
  parser.add_argument('--modes', default='gathered,sharded')
  parser.add_argument('--hold_gib', type=int, default=0)
  args = parser.parse_args()
  if not torch.cuda.is_available():
    raise SystemExit('tp_gate_probe runs on the card')
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip(), flush=True)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  held = (torch.empty(args.hold_gib * 2**30, dtype=torch.uint8,
                      device='cuda') if args.hold_gib else None)
  free, _ = torch.cuda.mem_get_info()
  print(json.dumps(dict(hold_gib=args.hold_gib, free_gib=free / 2**30)),
        flush=True)
  with tempfile.TemporaryDirectory(prefix='tp_gate_probe_') as outdir:
    ranks = cs._run_ranks('tp_gate_probe', _rank, outdir, args.reps,
                          args.modes.split(','))
  del held
  for run in ranks[0]:
    _, forced = run['one']
    for i, (loss, _, after) in enumerate(forced):
      share, at = _worst(run['states'][i], after, run['states'][i + 1])
      print(json.dumps(dict(
          hold_gib=args.hold_gib, deterministic=run['deterministic'],
          rep=run['rep'], mode=run['mode'], step=i + 1,
          loss=run['losses'][i], one_rank_loss=loss, gate_share=share,
          at=at)), flush=True)


if __name__ == '__main__':
  main()
