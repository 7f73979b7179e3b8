"""IMPALA losses, ported from scalable_agent_tpu/losses.py.

Sum-reductions over [T, B], as in the reference (not means): the loss scale
interacts with the tuned learning rate, so this is load-bearing for
hyperparameter parity.
"""

import torch
from torch.nn import functional as F


def compute_baseline_loss(advantages):
  """0.5 * sum((vs - V)^2)."""
  return 0.5 * torch.sum(torch.square(advantages))


def compute_entropy_loss(logits):
  """Negative total entropy (minimizing it maximizes entropy)."""
  policy = F.softmax(logits, dim=-1)
  log_policy = F.log_softmax(logits, dim=-1)
  entropy_per_timestep = -torch.sum(policy * log_policy, dim=-1)
  return -torch.sum(entropy_per_timestep)


def compute_policy_gradient_loss(logits, actions, advantages):
  """sum over T, B of -log pi(a|x) * advantage, advantages detached."""
  log_probs = F.log_softmax(logits, dim=-1)
  cross_entropy = -torch.gather(log_probs, -1,
                                actions.long()[..., None])[..., 0]
  return torch.sum(cross_entropy * advantages.detach())


def compute_impact_surrogate_loss(log_ratio, advantages, epsilon: float):
  """IMPACT's clipped-target surrogate (arXiv 1912.00167):
  -sum over T, B of min(r * A, clip(r, 1-eps, 1+eps) * A), with
  r = exp(log pi_theta(a|x) - log pi_target(a|x)) and the advantages
  detached. At r == 1 (target == current params) the clip never binds
  and the gradient is `compute_policy_gradient_loss`'s."""
  advantages = advantages.detach()
  ratio = torch.exp(log_ratio)
  unclipped = ratio * advantages
  clipped = torch.clamp(ratio, 1.0 - epsilon, 1.0 + epsilon) * advantages
  return -torch.sum(torch.minimum(unclipped, clipped))


def impact_clip_fraction(log_ratio, epsilon: float, denominator=None):
  """The share of (t, b) elements whose ratio left the clip band: a mean
  over T and B, or the count over `denominator` (a process group's
  global T*B, so the ranks' values sum to the global share)."""
  ratio = torch.exp(log_ratio.detach())
  outside = (torch.abs(ratio - 1.0) > epsilon).float()
  if denominator is None:
    return torch.mean(outside)
  return torch.sum(outside) / denominator
