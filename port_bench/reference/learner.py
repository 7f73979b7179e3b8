"""The IMPALA learner step in plain PyTorch: V-trace (arXiv:1802.01561,
Remark 1's recursion), the sum-reduced policy-gradient, baseline and
entropy losses, and RMSProp with eps inside the square root and the
learning rate decayed linearly over the frame budget.

`follow` runs the reference's steps over the batches the program acted,
from the weights the benchmark made: each step's loss, gradient, acting
logits, parameters and RMSProp state; each step either from the
reference's own state or from the program's.
"""

import contextlib
from typing import Dict, List

import torch
from torch.nn import functional as F

from port_bench.reference import agent


@contextlib.contextmanager
def precision(tf32: bool):
  """Float32 matmuls and convolutions in float32 (tf32=False) or in
  TF32 on the card; restores the flags after."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def vtrace(log_rhos, discounts, rewards, values, bootstrap):
  """(vs, pg_advantages), rho and c clipped at 1; no gradient."""
  rhos = torch.exp(log_rhos)
  clipped = torch.clamp(rhos, max=1.0)
  cs = torch.clamp(rhos, max=1.0)
  v_next = torch.cat([values[1:], bootstrap[None]])
  deltas = clipped * (rewards + discounts * v_next - values)
  acc = torch.zeros_like(bootstrap)
  out = []
  for t in range(deltas.shape[0] - 1, -1, -1):
    acc = deltas[t] + discounts[t] * cs[t] * acc
    out.append(acc)
  vs = values + torch.stack(out[::-1])
  vs_next = torch.cat([vs[1:], bootstrap[None]])
  return vs, clipped * (rewards + discounts * vs_next - values)


def loss(params, model, hyper, batch, carry):
  """Total loss of one [T+1, B] batch from the LSTM carry at its start.
  Returns (loss, learner logits [T+1, B, A], carry after T steps)."""
  t = batch['reward'].shape[0] - 1
  logits, baseline, carry_t = agent.unroll(
      params, model, batch['frames'], batch['reward'], batch['done'],
      batch['action'], carry, carry_after=t)
  actions = batch['action'][1:]
  rewards = torch.clamp(batch['reward'][1:], -1.0, 1.0)
  discounts = (~batch['done'][1:]).float() * hyper['discounting']
  target = F.log_softmax(logits[:-1], dim=-1)
  behaviour = F.log_softmax(batch['logits'][1:], dim=-1)
  target_a = torch.gather(target, -1, actions[..., None])[..., 0]
  behaviour_a = torch.gather(behaviour, -1, actions[..., None])[..., 0]
  with torch.no_grad():
    vs, pg_adv = vtrace(target_a - behaviour_a, discounts, rewards,
                        baseline[:-1], baseline[-1])
  pg_loss = torch.sum(-target_a * pg_adv)
  baseline_loss = 0.5 * torch.sum(torch.square(vs - baseline[:-1]))
  entropy_loss = torch.sum(torch.exp(target) * target)
  total = (pg_loss + hyper['baseline_cost'] * baseline_loss +
           hyper['entropy_cost'] * entropy_loss)
  return total, logits, carry_t


def learning_rate(hyper, count: int, frames_per_step: int):
  done = torch.tensor(float(count * frames_per_step), dtype=torch.float32)
  frac = torch.clamp(done / float(hyper['total_environment_frames']), max=1.0)
  return float(hyper['learning_rate'] * (1.0 - frac))


def follow(batches: List[Dict], weights: Dict, model, hyper,
           frames_per_step: int, tf32: bool = False, starts=None):
  """The reference's steps over `batches` from `weights` (left as they
  are), with RMSProp's state starting at zero. With `starts`, a run's own
  (params, nu) after each of its steps but the last, each later step
  starts from the run's state instead of the reference's own: the step
  alone is followed, not the run's trajectory. The LSTM carry at each
  batch's start is the reference's own, from the step before.

  Returns {'logits': [acting logits [T, B, A] of each batch], 'losses':
  [float], 'grads': [{leaf: tensor}], 'params': [{leaf: tensor} after
  each step], 'nu': [{leaf: tensor} after each step], 'starts': [the
  (params, nu) each step started from]}."""
  b = batches[0]['reward'].shape[1]
  hidden = model['hidden_size']
  device = batches[0]['reward'].device
  carry = (torch.zeros(b, hidden, device=device),
           torch.zeros(b, hidden, device=device))
  start = ({k: v.detach() for k, v in weights.items()},
           {k: torch.zeros_like(v) for k, v in weights.items()})
  out = {'logits': [], 'losses': [], 'grads': [], 'params': [], 'nu': [],
         'starts': []}
  decay, eps = hyper['decay'], hyper['epsilon']
  with precision(tf32):
    for count, batch in enumerate(batches):
      if starts is not None and count > 0:
        start = starts[count - 1]
      out['starts'].append(start)
      params = {k: v.detach().clone().requires_grad_(True)
                for k, v in start[0].items()}
      total, logits, carry = loss(params, model, hyper, batch, carry)
      grads = dict(zip(params, torch.autograd.grad(total,
                                                   list(params.values()))))
      carry = tuple(x.detach() for x in carry)
      out['logits'].append(logits[:-1].detach())
      out['losses'].append(float(total.detach()))
      out['grads'].append(grads)
      lr = learning_rate(hyper, count, frames_per_step)
      with torch.no_grad():
        nu = {k: decay * start[1][k] + (1.0 - decay) * torch.square(g)
              for k, g in grads.items()}
        new = {k: params[k].detach() - lr * g * torch.rsqrt(nu[k] + eps)
               for k, g in grads.items()}
      out['params'].append(new)
      out['nu'].append(nu)
      start = (new, nu)
  return out
