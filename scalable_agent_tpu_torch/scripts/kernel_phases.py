"""Where the CUDA kernels' device time goes, phase by phase.

  python -m scalable_agent_tpu_torch.scripts.kernel_phases

On the card only (it raises without CUDA). Each kernel of csrc/ is built
again with one phase compiled out (`-DSKIP_PHASES=<bit>`, see the top of
each source) and timed at the shapes its paths give it: V-trace at the
learner's [100, 32] and the data-parallel rank's [100, 16], the fused
conv+pool at [3232, 72, 96]. It prints one JSON line per kernel and shape:
the device time per launch (torch.profiler) of the whole kernel and of
the kernel without each phase, the card's name and its power limit. A
phase's cost is about the whole time minus the time without it (blocks
overlap, so the costs need not add up to the whole). The variants' results
are wrong by construction and are not used.
"""

import ctypes
import json
import os
import subprocess
import sys
from typing import List, Optional

import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.observability import profiled_device_us
from scalable_agent_tpu_torch.ops import build
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script

# Phase bits of each source's SKIP_PHASES, in its order.
PHASES = {
    'vtrace': ['stage', 'pre_pass', 'walk', 'post_pass', 'store'],
    'conv_pool': ['stage_copies', 'convert', 'convolve', 'pool'],
}
PHASE_DIR = os.path.join(build.BUILD_DIR, 'phases')
LAUNCHES = {'vtrace': 200, 'conv_pool': 20}


def _build_variants(name: str):
  """{phase: ctypes function of csrc/<name>.cu built without it}, the
  variants compiled in parallel."""
  os.makedirs(PHASE_DIR, exist_ok=True)
  source = os.path.join(build.CSRC_DIR, name + '.cu')
  procs = {}
  for bit, phase in enumerate(PHASES[name]):
    library = os.path.join(PHASE_DIR, f'lib{name}-without-{phase}.so')
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, f'-DSKIP_PHASES={1 << bit}',
           '-o', library, source]
    procs[phase] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    library)
  functions = {}
  for phase, (proc, library) in procs.items():
    output, _ = proc.communicate()
    if proc.returncode != 0:
      raise build.KernelBuildError(f'{name} without {phase}:\n{output}')
    functions[phase] = getattr(ctypes.CDLL(library), f'{name}_launch')
  return functions


def _times(name, module, call, functions, kernel_name):
  """Device µs per launch of `call` through the built kernel and through
  each variant, swapped in as the wrapper's bound launcher."""
  result = {'whole': profiled_device_us(call, LAUNCHES[name], kernel_name)}
  bound = module._launcher()  # pylint: disable=protected-access
  try:
    for phase, fn in functions.items():
      fn.argtypes, fn.restype = bound.argtypes, bound.restype
      module._LAUNCHER = fn  # pylint: disable=protected-access
      result[f'without_{phase}'] = profiled_device_us(
          call, LAUNCHES[name], kernel_name)
  finally:
    module._LAUNCHER = bound  # pylint: disable=protected-access
  return result


def _card() -> str:
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True, timeout=60)
  return smi.stdout.strip().splitlines()[0]


def main(argv: Optional[List[str]] = None):
  del argv
  device = driver.resolve_device('cuda')
  card = _card()
  build.build_all()
  variants = {name: _build_variants(name) for name in PHASES}
  gen = torch.Generator().manual_seed(0)
  for shape in ((100, 32), (100, 16)):
    x = {k: torch.randn(shape if k != 'bootstrap_value' else shape[1:],
                        generator=gen).to(device)
         for k in ('log_rhos', 'discounts', 'rewards', 'values',
                   'bootstrap_value')}
    times = _times('vtrace', vtrace_cuda,
                   lambda x=x: vtrace_cuda.from_importance_weights(**x),
                   variants['vtrace'], 'vtrace_kernel')
    print(json.dumps(dict(kernel='vtrace', shape=list(shape), device_us=times,
                          card=card)), flush=True)
  frames, weight, bias = conv_pool_script.make_inputs(
      *conv_pool_script.CARD_SHAPE, device)
  times = _times('conv_pool', conv_pool_cuda,
                 lambda: conv_pool_cuda.fused_conv_pool(frames, weight, bias),
                 variants['conv_pool'], 'conv_pool_kernel')
  print(json.dumps(dict(kernel='conv_pool',
                        shape=list(conv_pool_script.CARD_SHAPE),
                        device_us=times, card=card)), flush=True)


if __name__ == '__main__':
  main(sys.argv[1:])
