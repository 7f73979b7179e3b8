"""Flax's OptimizedLSTMCell over time on the port's `nn.LSTMCell`
parameters: the agent's core (models/agent.py) and the instruction
encoder (models/instruction.py) both run it."""

import torch
from torch import nn
from torch.nn import functional as F


def _lstm_step(cell: nn.LSTMCell, input_product, c, h, dtype, tp=None):
  """One step of Flax's OptimizedLSTMCell in `dtype` on the port's
  LSTMCell parameters: `input_product` (x @ W_ih, no bias, precomputed
  for all steps at once: a row's product does not depend on the others)
  plus the hidden product with its bias, then i, f, g, o,
  `c' = f*c + i*g` and `h' = o*tanh(c')`, every op rounding in `dtype`
  (a float32 carry promotes, as in Flax). Returns (c', h'). With `tp`
  the cell's parameters are this rank's blocks of the gates: `c` and
  the result are blocks, `h` is whole."""
  if tp is not None:
    h = tp.enter(h)
  hidden = (F.linear(h.to(dtype), cell.weight_hh.to(dtype)) +
            cell.bias_hh.to(dtype))
  i, f, g, o = (hidden + input_product).chunk(4, dim=-1)
  c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
  return c, torch.sigmoid(o) * torch.tanh(c)


def unroll_lstm(cell: nn.LSTMCell, inputs, c, h, dtype, tp=None,
                resets=None):
  """Flax's OptimizedLSTMCell over time: `inputs` [T, B, in], carry
  (c, h) [B, hidden]; `resets` (bool [T, B] or None) zeroes the carry
  before a step. Returns (outputs [T, B, hidden], c, h).

  In float32 the step is `nn.LSTMCell`'s; in another dtype
  `_lstm_step`. With `tp`, when the cell's parameters are this rank's
  blocks of the gates, each step computes this rank's block of the
  hidden units: the cell state stays a block through the loop, and each
  step's hidden state is gathered over the model group."""
  t, b = inputs.shape[0], inputs.shape[1]
  block = cell.weight_hh.shape[0] // 4
  blocked = tp is not None and block != cell.weight_hh.shape[1]
  if blocked:
    c = c[:, tp.index * block:(tp.index + 1) * block]
    inputs = tp.enter(inputs)
  if blocked or dtype != torch.float32:
    input_product = F.linear(inputs.to(dtype), cell.weight_ih.to(dtype))
  outputs = []
  for step in range(t):
    if resets is not None:
      reset = resets[step].reshape(b, 1)
      c = c.masked_fill(reset, 0.0)
      h = h.masked_fill(reset, 0.0)
    if blocked:
      c, h = _lstm_step(cell, input_product[step], c, h, dtype, tp)
      h = tp.gather(h, -1)
    elif dtype == torch.float32:
      h, c = cell(inputs[step], (h, c))
    else:
      c, h = _lstm_step(cell, input_product[step], c, h, dtype)
    outputs.append(h)
  if blocked:
    c = tp.gather(c, -1)
  return torch.stack(outputs), c, h
