"""The readings that the limits of a cell's comparison are set from.

  python -m port_bench.calibrate --workload <cell> --first <seed> \
      --seeds 12 [--control 12] [--fault half_batch:3 ...]

For each seed, in one process: the cell's set-up and recorded steps
(runtimes/anakin.py), the program's numbers against the reference (a
sound run), and with `--control` on the first seeds the control's: the
reference computed in TF32 in the program's place. Each `--fault
name:n` plants that fault (faults.py) and reads the numbers on n seeds
after the sound ones. One JSON line per reading, then a summary: the
largest sound reading of each number, and the smallest of the control's
and of each fault's.
"""

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time

import torch

from port_bench import cells
from port_bench import faults as faults_lib
from port_bench.runtimes import anakin


def reading(cell, seed, device, control=False, fault=None):
  with tempfile.TemporaryDirectory(prefix='port_bench_') as logdir:
    plant = (faults_lib.FAULTS[fault]() if fault
             else contextlib.nullcontext())
    with plant:
      prog = anakin.AnakinRun(cell, seed, device, logdir)
      prog.record(cell['traffic']['recorded_steps'])
    prog.free()
    out = prog.numbers(control=control)
  del prog
  gc.collect()
  if torch.device(device).type == 'cuda':
    torch.cuda.empty_cache()
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(prog='python -m port_bench.calibrate')
  parser.add_argument('--workload', required=True)
  parser.add_argument('--first', type=int, required=True)
  parser.add_argument('--seeds', type=int, default=12)
  parser.add_argument('--control', type=int, default=0)
  parser.add_argument('--fault', action='append', default=[])
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)
  cell = cells.load(args.workload, cells.benchmark())
  summary = {'sound': {}, 'control': {}}
  seed = args.first

  def emit(mode, seed, numbers, kind):
    print(json.dumps({'workload': args.workload, 'mode': mode,
                      'seed': seed, 'numbers': numbers}), flush=True)
    into = summary.setdefault(mode, {})
    for k, v in numbers.items():
      pick = max if kind == 'max' else min
      into[k] = v if k not in into else pick(into[k], v)

  for i in range(args.seeds):
    t = time.perf_counter()
    control = i < args.control
    out = reading(cell, seed, args.device, control=control)
    if control:
      out, ctl = out
      emit('control', seed, ctl, 'min')
    emit('sound', seed, out, 'max')
    print(f'seed {seed}: {time.perf_counter() - t:.1f} s', file=sys.stderr)
    seed += 1
  for spec in args.fault:
    name, n = spec.split(':')
    for _ in range(int(n)):
      emit(name, seed, reading(cell, seed, args.device, fault=name), 'min')
      seed += 1
  print(json.dumps({'workload': args.workload, 'summary': summary}))


if __name__ == '__main__':
  main(sys.argv[1:])
