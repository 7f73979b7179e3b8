"""Fused conv3x3 + max-pool 3x3/2 in bfloat16: the hand-written CUDA kernel
and its plain twin.

`fused_conv_pool` is the port of scripts/pallas_conv_pool.py
`fused_conv_pool` (whose Pallas kernel is `_kernel`): the deep torso's
section-1 conv (3 -> 16 channels, SAME) and SAME max-pool at
`compute_dtype='bfloat16'`, with the pre-pool tensor kept out of device
memory. Dispatch is by the frames' device:

- CUDA tensors go to `csrc/conv_pool.cu` (built by ops/build.py at first
  use), launched on the current stream. A launch that fails raises; there
  is no fallback.
- CPU tensors go to `plain_conv_pool`, the same rounding points in plain
  PyTorch. The CPU tests use it, and chip_smoke.py holds the kernel to it
  on the card.

`fused_conv_pool.launches` counts kernel launches (plain-twin calls do not
count). `library_conv_pool` (cuDNN's bf16 conv and PyTorch's pool) is the
timing yardstick of chip_smoke.py and scripts/conv_pool.py; the port does
not call it. The kernel's design and bound are described in
csrc/conv_pool.cu. No autograd: the JAX package's trainer never calls the
TPU kernel either (its torso uses XLA's conv and pool).
"""

import ctypes
import math

import torch
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.torsos import max_pool_same, scaled_nchw
from scalable_agent_tpu_torch.ops import build

CIN, COUT = 3, 16
WEIGHT_SHAPE = (COUT, CIN, 3, 3)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def output_shape(n: int, h: int, w: int):
  """[N, ceil(H/2), ceil(W/2), 16]: the SAME pool's output."""
  return (n, -(-h // 2), -(-w // 2), COUT)


def work(n: int, h: int, w: int):
  """(bytes, flops) the function needs: uint8 frames read once, the bf16
  weight and bias read once, the bf16 output written once; two FLOPs per
  multiply-add of the 3x3x3 -> 16 conv at every pixel."""
  nbytes = (n * h * w * CIN + 2 * (COUT * CIN * 9 + COUT)
            + 2 * math.prod(output_shape(n, h, w)))
  return nbytes, 2 * 9 * CIN * COUT * n * h * w


def plain_conv_pool(frames, weight, bias):
  """The kernel's function in plain PyTorch, by its rounding points: the
  bf16 x and weight convolved with float32 sums, the SAME max-pool, then
  rounded to bf16 and the bf16 bias added. bf16 values are exact in TF32,
  so cuDNN's TF32 mode does not change the products."""
  y = F.conv2d(scaled_nchw(frames, torch.bfloat16).float(),
               weight.to(torch.bfloat16).float(), padding=1)
  y = max_pool_same(y).permute(0, 2, 3, 1)
  return y.to(torch.bfloat16) + bias.to(torch.bfloat16)


def library_conv_pool(frames, weight, bias):
  """The timing yardstick: cuDNN's bf16 conv in channels-last with its
  fused bias, then the SAME max-pool; NHWC out. It writes and reads the
  pre-pool tensor, which the kernel keeps in shared memory."""
  x = scaled_nchw(frames, torch.bfloat16).contiguous(
      memory_format=torch.channels_last)
  y = F.conv2d(x, weight.to(torch.bfloat16), bias.to(torch.bfloat16),
               padding=1)
  return max_pool_same(y).permute(0, 2, 3, 1)


def _check(frames, weight, bias):
  if frames.dtype != torch.uint8:
    raise TypeError(f'frames must be uint8, got {frames.dtype}')
  if frames.dim() != 4 or frames.shape[-1] != CIN or min(frames.shape) < 1:
    raise ValueError(f'frames must be [N, H, W, {CIN}] with N, H, W >= 1, '
                     f'got {tuple(frames.shape)}')
  if not frames.is_contiguous():
    raise ValueError('frames must be contiguous')
  for name, x, shape in (('weight', weight, WEIGHT_SHAPE),
                         ('bias', bias, (COUT,))):
    if x.device != frames.device:
      raise ValueError(f'{name} is on {x.device}, expected '
                       f'{frames.device}')
    if not x.is_floating_point():
      raise TypeError(f'{name} must be floating point, got {x.dtype}')
    if tuple(x.shape) != shape:
      raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                       f'{shape}')


def fused_conv_pool(frames, weight, bias):
  """uint8 frames [N, H, W, 3], weight [16, 3, 3, 3] (OIHW) and bias [16]
  in any float dtype (cast to bf16, as Flax's `dtype` does) -> bf16
  [N, ceil(H/2), ceil(W/2), 16]."""
  _check(frames, weight, bias)
  device = frames.device
  if device.type == 'cpu':
    return plain_conv_pool(frames, weight, bias)
  if device.type != 'cuda':
    raise ValueError(f'fused conv+pool runs on CUDA or CPU tensors, got '
                     f'{device}')

  lib = build.load('conv_pool')
  fn = lib.conv_pool_launch
  fn.argtypes = _ARGTYPES
  fn.restype = ctypes.c_int

  n, h, w, _ = frames.shape
  weight = weight.to(torch.bfloat16).contiguous()
  bias = bias.to(torch.bfloat16).contiguous()
  out = torch.empty(output_shape(n, h, w), dtype=torch.bfloat16,
                    device=device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(frames.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, h, w, stream)
  if err != 0:
    raise RuntimeError(f'conv_pool kernel launch failed: CUDA error {err}')
  fused_conv_pool.launches += 1
  return out


fused_conv_pool.launches = 0
