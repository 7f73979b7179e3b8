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
csrc/conv_pool.cu; `pack_weight` (the tensor cores' B operand) and
`launch_geometry` (bands, tiles, threads, shared memory) are its layout
helpers, in plain Python so the CPU tests reach them. No autograd: the JAX package's trainer never calls the
TPU kernel either (its torso uses XLA's conv and pool).
"""

import ctypes
import math
from typing import NamedTuple

import torch
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.torsos import max_pool_same, scaled_nchw
from scalable_agent_tpu_torch.ops import build

CIN, COUT = 3, 16
WEIGHT_SHAPE = (COUT, CIN, 3, 3)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

K_PADDED = 32   # the 27 taps padded to two k-steps of the bf16 mma
SEG = 16        # conv positions per mma tile
ROWS_PER_BAND = 6
MAX_COLS_PER_TILE = 64
MAX_WARPS = 8


class LaunchGeometry(NamedTuple):
  rows: int        # pooled rows per band
  cols: int        # pooled columns per tile (all of them up to 64)
  threads: int
  smem_bytes: int  # dynamic shared memory per block
  row_bands: int
  col_tiles: int
  segs: int        # 16-position segments of a band's conv row
  blocks: int      # n * row_bands * col_tiles


def window_layout(segs: int, in_rows: int):
  """(elements per window row, bytes from copy 0 to copy 1): a row holds
  3 * 16 segs + 9 elements at least (+1 of shift), a multiple of 6; the
  stride and copy 1's offset mod 128 bytes put the 32 lanes of each A
  load of the kernel on 32 banks."""
  win_stride = 3 * SEG * segs + (24 if segs % 2 else 72)
  copy1 = -(-(in_rows * win_stride * 2) // 128) * 128 + 56
  return win_stride, copy1


def launch_geometry(n: int, h: int, w: int) -> LaunchGeometry:
  """The kernel's launch for [n, h, w] frames: one block per (frame, band
  of `rows` pooled rows, tile of `cols` pooled columns). The shared memory
  holds the band's input rows as staged (16-byte rows), the bf16 window
  twice (the second shifted by one element), and the bf16 row maxima of
  the band's pooled rows; the kernel computes the same sum and refuses a
  launch whose `smem_bytes` differs."""
  if min(n, h, w) < 1:
    raise ValueError(f'conv+pool needs N, H, W >= 1, got [{n}, {h}, {w}]')
  _, out_h, out_w, _ = output_shape(n, h, w)
  rows = min(ROWS_PER_BAND, out_h)
  cols = min(MAX_COLS_PER_TILE, out_w)
  segs = -(-(2 * cols + 1) // SEG)
  in_rows, in_pixels = 2 * rows + 3, 2 * cols + 3
  raw_stride = -(-(in_pixels * CIN + 15) // 16) * 16
  win_stride, copy1 = window_layout(segs, in_rows)
  win_offset = 16 + in_rows * raw_stride
  vmax_offset = win_offset + -(-(copy1 + in_rows * win_stride * 2) // 16) * 16
  smem_bytes = vmax_offset + rows * segs * SEG * COUT * 2
  row_bands, col_tiles = -(-out_h // rows), -(-out_w // cols)
  return LaunchGeometry(rows, cols, 32 * min(MAX_WARPS, segs),
                        smem_bytes, row_bands, col_tiles, segs,
                        n * row_bands * col_tiles)


def k_element(k: int):
  """What row k of the mma's K dimension multiplies: (dy, e), element e of
  a position's window row dy (e = 3 dx + ci for e < 9; e = 9 is channel 0
  of the pixel after the 3x3 window), or None for the last pair. Pair
  p = k // 2 = 4 dy + j (j < 4) holds elements 2j, 2j + 1 of row dy, and
  pair 12 + dy elements 8, 9: every pair is two neighbouring elements (one
  32-bit load in the kernel), and the four pairs of one load lie in one
  row or are the rows' element 8."""
  p, h = divmod(k, 2)
  if p < 12:
    return p // 4, 2 * (p % 4) + h
  if p < 15:
    return p - 12, 8 + h
  return None


# Column of OIHW's [16, 27] (ci, dy, dx) taps, plus a zero column 27, that
# each row of the packed weight takes.
_PACK_INDEX = [
    27 if tap is None or tap[1] >= 9
    else tap[1] % CIN * 9 + tap[0] * 3 + tap[1] // CIN
    for tap in map(k_element, range(K_PADDED))]
_pack_index = {}


def pack_weight(weight):
  """The tensor cores' B operand: OIHW [16, 3, 3, 3] -> bf16 [32, 16], row
  k the tap `k_element(k)` names, column the output channel. Rows 25, 27,
  29 (element 9 of a window row) and 30, 31 (the last pair) are zero."""
  device = weight.device
  index = _pack_index.get(device)
  if index is None:
    index = _pack_index[device] = torch.tensor(_PACK_INDEX, device=device)
  taps = weight.to(torch.bfloat16).reshape(COUT, 9 * CIN)
  taps = torch.cat([taps, taps.new_zeros((COUT, 1))], dim=1)
  return taps.index_select(1, index).t().contiguous()


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

  fn = _launcher()
  n, h, w, _ = frames.shape
  geometry = launch_geometry(n, h, w)
  packed = pack_weight(weight)
  bias = bias.to(torch.bfloat16).contiguous()
  out = torch.empty(output_shape(n, h, w), dtype=torch.bfloat16,
                    device=device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(frames.data_ptr(), packed.data_ptr(), bias.data_ptr(),
             out.data_ptr(), n, h, w, *geometry[:4], stream)
  if err != 0:
    raise RuntimeError(f'conv_pool kernel launch failed: CUDA error {err}')
  fused_conv_pool.launches += 1
  return out


fused_conv_pool.launches = 0


_LAUNCHER = None


def _launcher():
  """`conv_pool_launch` of the built library, bound once per process."""
  global _LAUNCHER
  if _LAUNCHER is None:
    fn = build.load('conv_pool').conv_pool_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    _LAUNCHER = fn
  return _LAUNCHER
