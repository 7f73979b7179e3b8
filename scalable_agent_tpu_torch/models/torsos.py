"""Visual torsos: the IMPALA deep ResNet and the paper's shallow CNN.

The port of scalable_agent_tpu/models/torsos.py. The public layout stays
the reference's: uint8 frames [N, H, W, C] in, features [N, 256] out. Inside,
the convolutions run NCHW (PyTorch's layout), and three places are written
to match Flax exactly:

- Flax's `padding='SAME'` 3x3/2 max-pool pads asymmetrically with -inf:
  (0, 1) at an even size, (1, 1) at an odd one. `max_pool2d(padding=1)`
  would pad (1, 1) always, so the pads are computed from the shape.
- The 3x3 stride-1 SAME conv pads (1, 1): symmetric, so `padding=1`.
- Flax flattens NHWC before the Dense layer, so the port permutes back to
  NHWC before its flatten; converted Dense weights then need no row
  permutation.

`dtype` is Flax's `dtype=`: the compute dtype. Parameters stay float32;
each layer casts its input and its parameters to `dtype`, computes there,
and adds the bias to the rounded product (`Conv`, `Dense`), as Flax does.
The frame is scaled in `dtype` (`frame.to(dtype) / 255`), and the pool,
residual adds, flatten and relus stay in it.
"""

import math
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of one spatial dim under XLA's SAME rule."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def max_pool_same(x, kernel: int = 3, stride: int = 2):
  """Flax `nn.max_pool(x, (k, k), strides=(s, s), padding='SAME')` on an
  NCHW tensor: -inf padding, asymmetric where the shape asks for it."""
  top, bottom = same_pads(x.shape[2], kernel, stride)
  left, right = same_pads(x.shape[3], kernel, stride)
  x = F.pad(x, (left, right, top, bottom), value=-math.inf)
  return F.max_pool2d(x, kernel, stride)


def _flatten_nhwc(x):
  return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class Conv(nn.Conv2d):
  """`nn.Conv2d` computing in `compute_dtype` like Flax's
  `nn.Conv(dtype=)`; its parameters stay float32.

  In bfloat16 the bias is added to the bf16-rounded convolution, where
  cuDNN's fused bias would add it before the rounding. In float32 the two
  round alike, and the fused form is kept."""

  def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
               **kwargs):
    super().__init__(*args, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x):
    dtype = self.compute_dtype
    if dtype == torch.float32:
      return super().forward(x)
    y = self._conv_forward(x.to(dtype), self.weight.to(dtype), None)
    return y + self.bias.to(dtype)[:, None, None]


class Dense(nn.Linear):
  """`nn.Linear` computing in `compute_dtype` like Flax's
  `nn.Dense(dtype=)`: the bias is added to the rounded product."""

  def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
               **kwargs):
    super().__init__(*args, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x):
    dtype = self.compute_dtype
    if dtype == torch.float32:
      return super().forward(x)
    return F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)


def scaled_nchw(frame, dtype):
  """uint8 NHWC frames -> NCHW `frame.to(dtype) / 255`: in bfloat16 the
  quotient is rounded to bfloat16, as in Flax."""
  return frame.permute(0, 3, 1, 2).to(dtype) / 255.0


class ResidualBlock(nn.Module):

  def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.conv0 = Conv(channels, channels, 3, padding=1, compute_dtype=dtype)
    self.conv1 = Conv(channels, channels, 3, padding=1, compute_dtype=dtype)

  def forward(self, x):
    y = self.conv0(F.relu(x))
    y = self.conv1(F.relu(y))
    return x + y


class _Section(nn.Module):

  def __init__(self, in_channels: int, channels: int, num_blocks: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.conv = Conv(in_channels, channels, 3, padding=1, compute_dtype=dtype)
    self.blocks = nn.ModuleList(
        ResidualBlock(channels, dtype) for _ in range(num_blocks))

  def forward(self, x):
    x = max_pool_same(self.conv(x))
    for block in self.blocks:
      x = block(x)
    return x


class DeepResNetTorso(nn.Module):
  """IMPALA deep torso: per section Conv3x3 -> 3x3/2 max-pool -> residual
  blocks; then relu -> flatten -> Linear(256) -> relu."""

  def __init__(self, frame_shape: Tuple[int, int, int],
               sections: Sequence[Tuple[int, int]] = ((16, 2), (32, 2),
                                                      (32, 2)),
               output_size: int = 256, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    height, width, in_channels = frame_shape
    self.sections = nn.ModuleList()
    for channels, num_blocks in sections:
      self.sections.append(_Section(in_channels, channels, num_blocks,
                                    dtype))
      in_channels = channels
      height, width = -(-height // 2), -(-width // 2)
    self.linear = Dense(height * width * in_channels, output_size,
                        compute_dtype=dtype)

  def forward(self, frame):
    x = scaled_nchw(frame, self.dtype)
    for section in self.sections:
      x = section(x)
    x = _flatten_nhwc(F.relu(x))
    return F.relu(self.linear(x))


class ShallowTorso(nn.Module):
  """The paper's shallow torso: Conv 8x8/4 (16) -> Conv 4x4/2 (32) ->
  flatten -> Linear(256), relu between layers, VALID padding."""

  def __init__(self, frame_shape: Tuple[int, int, int],
               output_size: int = 256, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    height, width, in_channels = frame_shape
    if height < 20 or width < 20:
      raise ValueError(
          f'shallow torso needs frames >= 20x20, got {height}x{width} '
          '(--height/--width)')
    self.conv0 = Conv(in_channels, 16, 8, stride=4, compute_dtype=dtype)
    self.conv1 = Conv(16, 32, 4, stride=2, compute_dtype=dtype)
    height, width = (height - 8) // 4 + 1, (width - 8) // 4 + 1
    height, width = (height - 4) // 2 + 1, (width - 4) // 2 + 1
    self.linear = Dense(height * width * 32, output_size, compute_dtype=dtype)

  def forward(self, frame):
    x = scaled_nchw(frame, self.dtype)
    x = F.relu(self.conv0(x))
    x = F.relu(self.conv1(x))
    return F.relu(self.linear(_flatten_nhwc(x)))


TORSOS = {
    'deep': DeepResNetTorso,
    'shallow': ShallowTorso,
}
