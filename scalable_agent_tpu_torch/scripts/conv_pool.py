"""The fused conv3x3 + max-pool kernel against its plain twin, and its times.

  python -m scalable_agent_tpu_torch.scripts.conv_pool               # card
  python -m scalable_agent_tpu_torch.scripts.conv_pool --device=cpu  # twin

The port's counterpart of scripts/pallas_conv_pool.py `main()`. On the card
(the default) it runs N=3232 frames of 72x96, (T+1)*B of the learner at
T=100, B=32, through `ops.conv_pool_cuda.fused_conv_pool` and prints:

- one JSON line of parity, the kernel against `plain_conv_pool` on the same
  inputs: max |kernel - plain|, the scale max |plain| and the count of
  elements that differ at all. It raises when max |kernel - plain| exceeds
  2**-7 * max |plain| (one bf16 ulp at the output's scale: the two sum the
  float32 products in another order, so a value near a rounding boundary
  may round the other way);
- one JSON line of times: the median over CUDA events of 50 launches
  each of the kernel, the plain twin and `library_conv_pool`
  (cuDNN), with the bound (the larger of the bytes over the HBM rate and
  the FLOPs over the bf16 tensor-core rate) and the card's name.

`--device=cpu` runs N=64 frames of 24x32 on the plain twin and prints the
parity line only: a CPU time is no measure of the card. With no CUDA the
default device raises. Weights come from a seeded torch.Generator
(`randn * 0.3`, as the JAX script draws them), with a nonzero bias.
"""

import argparse
import json
import sys
from typing import List, Optional

import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.observability import cuda_median_ms
from scalable_agent_tpu_torch.ops import conv_pool_cuda

# NVIDIA H100 SXM data sheet: HBM rate and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# One bf16 ulp of the output's scale (bf16 keeps 8 significant bits).
PARITY_RTOL = 2.0**-7

CARD_SHAPE = (3232, 72, 96)
CPU_SHAPE = (64, 24, 32)
# Timed launches of each version on the card, after untimed warm-up ones.
REPEATS, WARMUP = 50, 3


def make_inputs(n: int, h: int, w: int, device, seed: int = 0):
  """uint8 frames [n, h, w, 3], float32 weight [16, 3, 3, 3] and bias [16],
  drawn on the CPU from `seed` and moved to `device`."""
  gen = torch.Generator().manual_seed(seed)
  frames = torch.randint(0, 256, (n, h, w, conv_pool_cuda.CIN),
                         generator=gen, dtype=torch.uint8)
  weight = torch.randn(conv_pool_cuda.WEIGHT_SHAPE, generator=gen) * 0.3
  bias = torch.randn(conv_pool_cuda.COUT, generator=gen) * 0.3
  return frames.to(device), weight.to(device), bias.to(device)


def parity(got, ref):
  """{max_abs_err, scale, n_differ} of bf16 `got` against `ref`; raises
  when max_abs_err > PARITY_RTOL * scale."""
  got, ref = got.float(), ref.float()
  err = float((got - ref).abs().max())
  scale = float(ref.abs().max())
  result = dict(max_abs_err=err, scale=scale,
                n_differ=int((got != ref).sum()))
  if not err <= PARITY_RTOL * scale:
    raise AssertionError(f'fused conv+pool parity broke: max|kernel - '
                         f'plain| {err} > 2**-7 * {scale}')
  return result


def bound(n: int, h: int, w: int):
  """(bound_ms, 'bytes' or 'operations', bytes, flops) on one H100."""
  nbytes, flops = conv_pool_cuda.work(n, h, w)
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / BF16_FLOPS_PER_S * 1e3
  return (max(bytes_ms, ops_ms),
          'bytes' if bytes_ms >= ops_ms else 'operations', nbytes, flops)


def timings(frames, weight, bias):
  """Kernel, plain-twin and library times (ms), each the median of
  REPEATS launches after WARMUP, and the bound."""
  args = (frames, weight, bias)
  bound_ms, bound_by, nbytes, flops = bound(*frames.shape[:3])
  times = {
      key: cuda_median_ms(lambda fn=fn: fn(*args), REPEATS, WARMUP)
      for key, fn in (('ms', conv_pool_cuda.fused_conv_pool),
                      ('plain_ms', conv_pool_cuda.plain_conv_pool),
                      ('library_ms', conv_pool_cuda.library_conv_pool))}
  return dict(times, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
              flops=flops)


def main(argv: Optional[List[str]] = None):
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.scripts.conv_pool',
      description=__doc__.split('\n\n')[0])
  parser.add_argument('--device', default='cuda',
                      help="torch device (default cuda; 'cpu' runs the "
                           'plain twin at a small size)')
  args = parser.parse_args(argv)
  device = driver.resolve_device(args.device)
  shape = CARD_SHAPE if device.type == 'cuda' else CPU_SHAPE
  frames, weight, bias = make_inputs(*shape, device)

  got = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
  result = parity(got, conv_pool_cuda.plain_conv_pool(frames, weight, bias))
  print(json.dumps(dict(result, shape=list(shape), device=str(device))),
        flush=True)
  if device.type == 'cuda':
    times = timings(frames, weight, bias)
    times['card'] = torch.cuda.get_device_name(device)
    print(json.dumps(times), flush=True)
    result.update(times)
  return result


if __name__ == '__main__':
  main(sys.argv[1:])
