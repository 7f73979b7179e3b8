"""UNREAL pixel control, ported from the JAX package's unreal.py
(Jaderberg et al. 2017, section 3.1):

- pseudo-rewards: the frame is cut into cell_size x cell_size cells; a
  cell's reward at step t is its mean absolute pixel change from frame t
  to frame t+1 (`pixel_control_rewards`, in a float32 form and, for
  uint8 frames, an integer-domain form that sums exactly in int32 and
  scales once);
- a dueling deconvolution Q-head on the LSTM output predicts, per cell
  and action, the discounted pseudo-return (`PixelControlHead`);
- the loss is n-step Q-learning over the unroll, bootstrapped from
  max_a Q at the last frame (`pixel_control_loss`). The reverse
  recursion over T is a loop of torch ops, as JAX's is a `lax.scan`
  outside any Pallas kernel.

The head's convolutions follow Flax's `ConvTranspose`, which correlates
its un-flipped [kh, kw, in, out] kernel with the stride-dilated input.
The port holds each kernel as the OIHW weight of that correlation
(`weight[o, i, y, x] = kernel[y, x, i, o]`, convert.conv_from_jax):

- the stride-1 3x3 SAME `pc_value` and `pc_advantage` are then plain
  correlations with padding 1;
- the stride-2 4x4 SAME `pc_deconv` pads the dilated input (2, 2).
  `head_impl='deconv'` runs it as `F.conv_transpose2d`, which flips the
  kernel and swaps its in and out dims, so it is handed the flipped,
  transposed weight and padding 1 (4 - 1 - 1 = 2 on the dilated
  input). `head_impl='d2s'` computes the same map as JAX's `_DeconvD2S`:
  output row 2i+r only meets kernel rows of parity r, so the four 2x2
  phase kernels `weight[:, :, r::2, c::2]` run as one VALID 2x2
  convolution over the (1, 1)-padded input, and a pixel shuffle
  interleaves the phases. Both run on the same parameters.

`dtype` is Flax's compute dtype: inputs and parameters cast to it and
the bias added to the rounded product. `out_f32=False` keeps the Q-map
in `dtype` until the loss's gather and max.

The loss is a mean over T and B. Under a process group each rank passes
the global T*B (`denominator`), so the ranks' summed losses and
gradients are the global batch's mean (learner.py).
"""

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.torsos import Conv, Dense

DEFAULT_CELL_SIZE = 4
DEFAULT_DISCOUNT = 0.9

HEAD_IMPLS = ('deconv', 'd2s')
_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def pixel_control_rewards(frames, cell_size: int = DEFAULT_CELL_SIZE,
                          integer_path: Optional[bool] = None):
  """Per-cell mean |delta pixel| between consecutive frames.

  Args:
    frames: uint8 or float [T+1, B, H, W, C] observations (H and W
      divisible by cell_size).
    integer_path: None -> the integer form exactly when `frames` is
      uint8; True forces it (uint8 required); False forces the float32
      form. Both compute the same quantity.
  Returns:
    float32 [T, B, H/cell, W/cell]; entry t covers frame t -> t+1.
  """
  t1, b, h, w, c = frames.shape
  if h % cell_size or w % cell_size:
    raise ValueError(
        f'frame {h}x{w} not divisible by pixel-control cell_size '
        f'{cell_size}')
  hc, wc = h // cell_size, w // cell_size
  is_uint8 = frames.dtype == torch.uint8
  if integer_path is None:
    integer_path = is_uint8
  if integer_path and not is_uint8:
    raise ValueError(
        f'integer-domain pixel_control_rewards needs uint8 frames, '
        f'got {frames.dtype}')
  if integer_path:
    # |a - b| exactly in int16, the cell sums in int32, one float32
    # scale at the [T, B, Hc, Wc] output.
    d = torch.abs(frames[1:].to(torch.int16) - frames[:-1].to(torch.int16))
    d = d.reshape(t1 - 1, b, hc, cell_size, wc, cell_size, c)
    cell_sum = d.to(torch.int32).sum(dim=(3, 5, 6))
    scale = 1.0 / (255.0 * cell_size * cell_size * c)
    return cell_sum.to(torch.float32) * torch.tensor(
        scale, dtype=torch.float32, device=frames.device)
  f = frames.to(torch.float32) / 255.0
  diff = torch.abs(f[1:] - f[:-1])
  diff = diff.reshape(t1 - 1, b, hc, cell_size, wc, cell_size, c)
  return diff.mean(dim=(3, 5, 6))


class Deconv(nn.Module):
  """Flax's `ConvTranspose(features, (4, 4), strides=(2, 2),
  padding='SAME')` on NCHW input: `weight` is the OIHW correlation
  kernel (see the module docstring), `bias` [out]."""

  def __init__(self, in_channels: int, features: int, head_impl: str,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(features, in_channels, 4, 4))
    self.bias = nn.Parameter(torch.zeros(features))
    self.head_impl = head_impl
    self.dtype = dtype

  def forward(self, x):
    w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
    x = x.to(self.dtype)
    if self.head_impl == 'deconv':
      y = F.conv_transpose2d(x, w.flip(2, 3).transpose(0, 1), stride=2,
                             padding=1)
      return y + b[:, None, None]
    n, _, h, width = x.shape
    f = w.shape[0]
    phased = torch.cat([w[:, :, r::2, c::2] for r, c in _PHASES], dim=0)
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), phased)    # [n, 4f, h+1, w+1]
    parts = [y[:, i * f:(i + 1) * f, r:r + h, c:c + width]
             for i, (r, c) in enumerate(_PHASES)]
    y = torch.stack(parts, dim=2).reshape(n, f, 2, 2, h, width)
    y = y.permute(0, 1, 4, 2, 5, 3).reshape(n, f, 2 * h, 2 * width)
    return y + b[:, None, None]


class PixelControlHead(nn.Module):
  """Dueling deconv Q-head: LSTM features [N, hidden] -> Q [N, Hc, Wc, A].

  pc_fc (Dense to a (ceil(Hc/2), ceil(Wc/2), 32) map) -> relu -> the
  stride-2 deconv -> relu -> crop to (Hc, Wc) (odd grids) -> the 3x3
  value (1) and advantage (A) maps -> Q = V + A - mean_a A."""

  def __init__(self, hidden_size: int, num_actions: int,
               target_cells: Tuple[int, int],
               dtype: torch.dtype = torch.float32,
               head_impl: str = 'deconv', out_f32: bool = True):
    super().__init__()
    if head_impl not in HEAD_IMPLS:
      raise ValueError(f'head_impl must be one of {HEAD_IMPLS}, got '
                       f'{head_impl!r}')
    self.target_cells = tuple(target_cells)
    hc, wc = self.target_cells
    self.base = ((hc + 1) // 2, (wc + 1) // 2, 32)
    self.out_f32 = out_f32
    self.dtype = dtype
    base_h, base_w, ch = self.base
    self.pc_fc = Dense(hidden_size, base_h * base_w * ch, compute_dtype=dtype)
    self.pc_deconv = Deconv(ch, ch, head_impl, dtype=dtype)
    self.pc_value = Conv(ch, 1, 3, padding=1, compute_dtype=dtype)
    self.pc_advantage = Conv(ch, num_actions, 3, padding=1,
                             compute_dtype=dtype)

  def forward(self, core_out):
    hc, wc = self.target_cells
    base_h, base_w, ch = self.base
    x = F.relu(self.pc_fc(core_out))
    x = x.reshape(x.shape[0], base_h, base_w, ch).permute(0, 3, 1, 2)
    x = F.relu(self.pc_deconv(x))[:, :, :hc, :wc]
    value = self.pc_value(x)
    advantage = self.pc_advantage(x)
    advantage = advantage - advantage.mean(dim=1, keepdim=True)
    q = (value + advantage).permute(0, 2, 3, 1)   # [N, hc, wc, A]
    return q.float() if self.out_f32 else q


def pixel_control_loss(q_values, actions, rewards, done,
                       discount: float = DEFAULT_DISCOUNT,
                       denominator: Optional[int] = None):
  """The n-step Q loss of the pixel-control head.

  Args:
    q_values: float32 or bf16 [T+1, B, Hc, Wc, A]; the last frame gives
      the max-Q bootstrap. A bf16 map is cast to float32 only after the
      gather and the max.
    actions: int [T, B], the action of transition t -> t+1.
    rewards: float32 [T, B, Hc, Wc] pseudo-rewards.
    done: bool [T, B]; done[t] means the transition crosses an episode
      reset: no reward flows and the return recursion cuts.
    denominator: the T*B the loss is a mean over (None: this batch's).
  Returns:
    0.5 * sum over cells of (target - Q[a])^2, meaned over T and B.
  """
  not_done = (~done).to(torch.float32)[..., None, None]     # [T, B, 1, 1]
  rewards = rewards * not_done
  ret = q_values[-1].max(dim=-1).values.to(torch.float32).detach()
  targets = [None] * rewards.shape[0]
  for t in reversed(range(rewards.shape[0])):
    ret = rewards[t] + discount * not_done[t] * ret
    targets[t] = ret
  targets = torch.stack(targets)                           # [T, B, Hc, Wc]
  q_taken = torch.gather(
      q_values[:-1], -1,
      actions.long()[:, :, None, None, None].expand(
          q_values[:-1].shape[:-1] + (1,)))[..., 0].to(torch.float32)
  per_step = 0.5 * torch.square(targets - q_taken).sum(dim=(2, 3))
  if denominator is None:
    return per_step.mean()
  return per_step.sum() / denominator
