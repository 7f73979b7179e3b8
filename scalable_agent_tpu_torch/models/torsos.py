"""Visual torsos: the IMPALA deep ResNet, its `deep_fast` variant and the
paper's shallow CNN.

The port of scalable_agent_tpu/models/torsos.py. The public layout stays
the reference's: uint8 frames [N, H, W, C] in, features [N, 256] out. Inside,
the convolutions run NCHW (PyTorch's layout), and three places are written
to match Flax exactly:

- Flax's `padding='SAME'` 3x3/2 max-pool pads asymmetrically with -inf:
  (0, 1) at an even size, (1, 1) at an odd one. `max_pool2d(padding=1)`
  would pad (1, 1) always, so the pads are computed from the shape.
- The 3x3 stride-1 SAME conv pads (1, 1): symmetric, so `padding=1`.
  `deep_fast`'s 3x3 stride-2 SAME conv pads like the pool, the smaller
  half first ((0, 1) at an even size, (1, 1) at an odd one), where
  `padding=1` would shift every output by a pixel; the zero pads are
  computed from the shape.
- Flax flattens NHWC before the Dense layer, so the port permutes back to
  NHWC before its flatten; converted Dense weights then need no row
  permutation.

`dtype` is Flax's `dtype=`: the compute dtype. Parameters stay float32;
each layer casts its input and its parameters to `dtype`, computes there,
and adds the bias to the rounded product (`Conv`, `Dense`), as Flax does.
The frame is scaled in `dtype` (`frame.to(dtype) / 255`), and the pool,
residual adds, flatten and relus stay in it.

Tensor parallelism (`tp`, a `TensorParallel`): a `Conv` or `Dense`
whose weight holds fewer output features than the layer declares (its
parameters swapped for this rank's blocks, torch.func.functional_call)
computes this rank's block of the output features, and an all-gather
over the model group joins the blocks; every layer after it computes
the same values on every rank of the group. The input of such a layer
passes through `TensorParallel.enter`: the identity forward, and a sum
over the group backward, since each rank's block of the output gives
only its part of the input's gradient (Megatron's f and g operators).
"""

import math
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F


class _Enter(torch.autograd.Function):
  """Identity forward; the gradient summed over the model group."""

  @staticmethod
  def forward(ctx, x, tp):
    ctx.tp = tp
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):
    grad = grad.contiguous().clone()
    ctx.tp.all_reduce_(grad)
    return grad, None


class _Gather(torch.autograd.Function):
  """All-gather of every rank's block along `dim`, in rank order; the
  gradient is this rank's block of the (group-wide equal) gradient."""

  @staticmethod
  def forward(ctx, x, dim, tp):
    ctx.dim, ctx.tp, ctx.size = dim, tp, x.shape[dim]
    return torch.cat(tp.all_gather(x), dim)

  @staticmethod
  def backward(ctx, grad):
    start = ctx.tp.index * ctx.size
    return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None


class TensorParallel:
  """This rank's place on the model axis: its `index` of `count` and the
  axis' process group (None when count is 1). `gather` and `enter` are
  the autograd-aware collectives of the layers computing in blocks."""

  def __init__(self, index: int, count: int, group=None):
    self.index, self.count, self.group = index, count, group

  def all_gather(self, x):
    x = x.contiguous()
    if self.count == 1:
      return [x]
    parts = [torch.empty_like(x) for _ in range(self.count)]
    dist.all_gather(parts, x, group=self.group)
    return parts

  def all_reduce_(self, x):
    if self.count > 1:
      dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
    return x

  def gather(self, x, dim: int):
    return _Gather.apply(x, dim, self)

  def enter(self, x):
    return _Enter.apply(x, self) if x.requires_grad else x


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

  def forward(self, x, tp=None):
    blocked = tp is not None and self.weight.shape[0] != self.out_channels
    if blocked:
      x = tp.enter(x)
    dtype = self.compute_dtype
    if dtype == torch.float32:
      y = super().forward(x)
    else:
      y = self._conv_forward(x.to(dtype), self.weight.to(dtype), None)
      y = y + self.bias.to(dtype)[:, None, None]
    return tp.gather(y, 1) if blocked else y


class Dense(nn.Linear):
  """`nn.Linear` computing in `compute_dtype` like Flax's
  `nn.Dense(dtype=)`: the bias is added to the rounded product."""

  def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
               **kwargs):
    super().__init__(*args, **kwargs)
    self.compute_dtype = compute_dtype

  def forward(self, x, tp=None):
    blocked = tp is not None and self.weight.shape[0] != self.out_features
    if blocked:
      x = tp.enter(x)
    dtype = self.compute_dtype
    if dtype == torch.float32:
      y = super().forward(x)
    else:
      y = F.linear(x.to(dtype), self.weight.to(dtype)) + self.bias.to(dtype)
    return tp.gather(y, -1) if blocked else y


def scaled_nchw(frame, dtype):
  """uint8 NHWC frames -> NCHW `frame.to(dtype) / 255`: in bfloat16 the
  quotient is rounded to bfloat16, as in Flax."""
  return frame.permute(0, 3, 1, 2).to(dtype) / 255.0


class ResidualBlock(nn.Module):

  def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
    super().__init__()
    self.conv0 = Conv(channels, channels, 3, padding=1, compute_dtype=dtype)
    self.conv1 = Conv(channels, channels, 3, padding=1, compute_dtype=dtype)

  def forward(self, x, tp=None):
    y = self.conv0(F.relu(x), tp)
    y = self.conv1(F.relu(y), tp)
    return x + y


def conv_same_stride2(conv, x, tp=None):
  """Flax `nn.Conv(..., (3, 3), strides=(2, 2), padding='SAME')` on an
  NCHW tensor, `conv` built with padding 0: zero pads from the shape."""
  top, bottom = same_pads(x.shape[2], 3, 2)
  left, right = same_pads(x.shape[3], 3, 2)
  return conv(F.pad(x, (left, right, top, bottom)), tp)


class _Section(nn.Module):
  """Conv3x3 -> 3x3/2 max-pool -> residual blocks; with `fast`
  (deep_fast) one stride-2 conv3x3 in place of the conv and the pool."""

  def __init__(self, in_channels: int, channels: int, num_blocks: int,
               dtype: torch.dtype = torch.float32, fast: bool = False):
    super().__init__()
    self.fast = fast
    self.conv = Conv(in_channels, channels, 3, stride=2 if fast else 1,
                     padding=0 if fast else 1, compute_dtype=dtype)
    self.blocks = nn.ModuleList(
        ResidualBlock(channels, dtype) for _ in range(num_blocks))

  def forward(self, x, tp=None):
    if self.fast:
      x = conv_same_stride2(self.conv, x, tp)
    else:
      x = max_pool_same(self.conv(x, tp))
    for block in self.blocks:
      x = block(x, tp)
    return x


class DeepResNetTorso(nn.Module):
  """IMPALA deep torso: per section Conv3x3 -> 3x3/2 max-pool -> residual
  blocks; then relu -> flatten -> Linear(256) -> relu."""

  FAST = False

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
                                    dtype, fast=self.FAST))
      in_channels = channels
      height, width = -(-height // 2), -(-width // 2)
    self.linear = Dense(height * width * in_channels, output_size,
                        compute_dtype=dtype)

  def forward(self, frame, tp=None):
    x = scaled_nchw(frame, self.dtype)
    for section in self.sections:
      x = section(x, tp)
    x = _flatten_nhwc(F.relu(x))
    return F.relu(self.linear(x, tp))


class DeepFastTorso(DeepResNetTorso):
  """`deep_fast`: the deep ResNet with each section's conv3x3 + 3x3/2
  max-pool replaced by one stride-2 conv3x3. The same parameters as
  `deep` (names and shapes), so its converted weights, sharding rules
  and blocked TP form are deep's; not the same function (a smaller
  receptive field per section and no max)."""

  FAST = True


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

  def forward(self, frame, tp=None):
    x = scaled_nchw(frame, self.dtype)
    x = F.relu(self.conv0(x, tp))
    x = F.relu(self.conv1(x, tp))
    return F.relu(self.linear(_flatten_nhwc(x), tp))


TORSOS = {
    'deep': DeepResNetTorso,
    'deep_fast': DeepFastTorso,
    'shallow': ShallowTorso,
}
