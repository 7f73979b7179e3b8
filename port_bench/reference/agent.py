"""The IMPALA agent (arXiv:1802.01561, Fig. 3) in plain PyTorch.

Parameters are a dict of float32 tensors under the names the program
gives its modules (`param_specs`), so one set of weights made by the
benchmark can be handed to both. Frames are uint8 [N, H, W, 3].

- deep torso: per section Conv3x3 (stride 1, SAME) -> 3x3/2 max-pool
  (SAME, -inf padding, the smaller half of an odd pad first) -> residual
  blocks (relu, conv3x3, relu, conv3x3, + skip); then relu, flatten in
  H, W, C order, Linear 256, relu.
- shallow torso: Conv 8x8/4 (16) -> relu -> Conv 4x4/2 (32) -> relu ->
  flatten in H, W, C order -> Linear 256 -> relu; VALID padding.
- core: LSTM over concat[torso, clip(r, -1, 1), one_hot(a_prev)], the
  carry zeroed where `done` marks the first frame of an episode, gates
  in the order i, f, g, o, one bias (on the hidden product).
- heads: Linear to the policy logits and to one baseline value.
"""

import math
from collections import OrderedDict

import torch
from torch.nn import functional as F


def _conv_spec(specs, name, out_ch, in_ch, k):
  specs[f'{name}.weight'] = (out_ch, in_ch, k, k)
  specs[f'{name}.bias'] = (out_ch,)


def torso_output_hw(model):
  """(height, width, channels) of the torso's last feature map."""
  h, w = model['height'], model['width']
  if model['torso'] == 'shallow':
    h, w = (h - 8) // 4 + 1, (w - 8) // 4 + 1
    return (h - 4) // 2 + 1, (w - 4) // 2 + 1, 32
  for _ in model['sections']:
    h, w = -(-h // 2), -(-w // 2)
  return h, w, model['sections'][-1][0]


def param_specs(model):
  """OrderedDict name -> shape of every trainable parameter."""
  specs = OrderedDict()
  if model['torso'] == 'shallow':
    _conv_spec(specs, 'torso.conv0', 16, 3, 8)
    _conv_spec(specs, 'torso.conv1', 32, 16, 4)
  else:
    in_ch = 3
    for i, (ch, blocks) in enumerate(model['sections']):
      _conv_spec(specs, f'torso.sections.{i}.conv', ch, in_ch, 3)
      for j in range(blocks):
        for c in ('conv0', 'conv1'):
          _conv_spec(specs, f'torso.sections.{i}.blocks.{j}.{c}', ch, ch, 3)
      in_ch = ch
  h, w, c = torso_output_hw(model)
  out, hidden, actions = (model['torso_output'], model['hidden_size'],
                          model['num_actions'])
  specs['torso.linear.weight'] = (out, h * w * c)
  specs['torso.linear.bias'] = (out,)
  specs['core.weight_ih'] = (4 * hidden, out + 1 + actions)
  specs['core.weight_hh'] = (4 * hidden, hidden)
  specs['core.bias_hh'] = (4 * hidden,)
  specs['policy_logits.weight'] = (actions, hidden)
  specs['policy_logits.bias'] = (actions,)
  specs['baseline.weight'] = (1, hidden)
  specs['baseline.bias'] = (1,)
  return specs


def make_weights(model, seed: int, device):
  """Weights from `seed` on `device`: one normal draw for every kernel
  together, each kernel scaled to variance 1/fan_in (LeCun), biases
  zero. A generator on `device` makes them in two calls."""
  specs = param_specs(model)
  kernels = [(n, s) for n, s in specs.items() if len(s) > 1]
  total = sum(math.prod(s) for _, s in kernels)
  gen = torch.Generator(device=device).manual_seed(int(seed))
  flat = torch.randn(total, generator=gen, device=device)
  weights, offset = {}, 0
  for name, shape in kernels:
    n = math.prod(shape)
    fan_in = n // shape[0]
    weights[name] = (flat[offset:offset + n].view(shape)
                     / math.sqrt(fan_in)).clone()
    offset += n
  for name, shape in specs.items():
    if name not in weights:
      weights[name] = torch.zeros(shape, device=device)
  return OrderedDict((n, weights[n]) for n in specs)


def _pool_same(x):
  """3x3/2 max-pool, SAME: -inf pads, (0, 1) at an even size and (1, 1)
  at an odd one."""
  pads = []
  for size in (x.shape[3], x.shape[2]):
    out = -(-size // 2)
    total = max((out - 1) * 2 + 3 - size, 0)
    pads += [total // 2, total - total // 2]
  return F.max_pool2d(F.pad(x, pads, value=-math.inf), 3, 2)


def torso(p, model, frames):
  """uint8 [N, H, W, 3] -> float32 [N, torso_output]."""
  x = frames.permute(0, 3, 1, 2).float() / 255.0
  if model['torso'] == 'shallow':
    x = F.relu(F.conv2d(x, p['torso.conv0.weight'], p['torso.conv0.bias'],
                        stride=4))
    x = F.relu(F.conv2d(x, p['torso.conv1.weight'], p['torso.conv1.bias'],
                        stride=2))
  else:
    for i, (_, blocks) in enumerate(model['sections']):
      pre = f'torso.sections.{i}'
      x = _pool_same(F.conv2d(x, p[f'{pre}.conv.weight'],
                              p[f'{pre}.conv.bias'], padding=1))
      for j in range(blocks):
        b = f'{pre}.blocks.{j}'
        y = F.conv2d(F.relu(x), p[f'{b}.conv0.weight'], p[f'{b}.conv0.bias'],
                     padding=1)
        y = F.conv2d(F.relu(y), p[f'{b}.conv1.weight'], p[f'{b}.conv1.bias'],
                     padding=1)
        x = x + y
    x = F.relu(x)
  x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
  return F.relu(F.linear(x, p['torso.linear.weight'], p['torso.linear.bias']))


def unroll(p, model, frames, rewards, dones, prev_actions, carry,
           carry_after=None):
  """The agent over a [T, B] trajectory from the LSTM carry (c, h).

  Returns (logits [T, B, A], baseline [T, B], carry after the last step)
  and, with `carry_after` = k, the carry after the first k steps in place
  of the last."""
  t, b = rewards.shape
  feats = torso(p, model, frames.reshape((t * b,) + frames.shape[2:]))
  core_in = torch.cat([
      feats, torch.clamp(rewards, -1.0, 1.0).reshape(t * b, 1),
      F.one_hot(prev_actions.reshape(-1).long(),
                model['num_actions']).float()], dim=-1).reshape(t, b, -1)
  x_product = F.linear(core_in, p['core.weight_ih'])
  c, h = carry
  outputs, kept = [], None
  for i in range(t):
    keep = (~dones[i]).float()[:, None]
    c, h = c * keep, h * keep
    gates = x_product[i] + F.linear(h, p['core.weight_hh'], p['core.bias_hh'])
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
    h = torch.sigmoid(go) * torch.tanh(c)
    outputs.append(h)
    if carry_after is not None and i + 1 == carry_after:
      kept = (c, h)
  core = torch.stack(outputs).reshape(t * b, -1)
  logits = F.linear(core, p['policy_logits.weight'], p['policy_logits.bias'])
  baseline = F.linear(core, p['baseline.weight'], p['baseline.bias'])
  return (logits.reshape(t, b, -1), baseline.reshape(t, b),
          kept if carry_after is not None else (c, h))
