"""PopArt value normalization, ported from the JAX package's popart.py
(Pop-Art, van Hasselt et al. 2016, as multi-task PopArt-IMPALA uses it,
Hessel et al. 2018):

- the value head emits NORMALIZED values n_i(x), one column per task;
  the agent selects each trajectory's column by its task id;
- per-task first and second moments (mu_i, nu_i) of the V-trace targets
  follow an EMA; sigma_i = sqrt(nu_i - mu_i^2), clipped;
- V-trace runs on the unnormalized sigma*n + mu, the baseline loss in
  normalized space on the targets (vs - mu)/sigma;
- when the statistics move, the head is rewritten so that its
  unnormalized outputs are preserved exactly:
      w'_i = w_i * sigma_i/sigma'_i,  b'_i = (sigma_i*b_i + mu_i - mu'_i)/sigma'_i.

Every function works on tensors. The head is the port's
`baseline` Linear, whose weight is [K, hidden]: Flax scales the columns
of its [hidden, K] kernel, the port scales rows.

Under a process group the statistics' batch sums are all-reduced before
the EMA (learner.py), so `update_stats` splits into `batch_moments` (the
per-task count, sum and sum of squares of this rank's targets) and
`update_from_moments`.
"""

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch.nn import functional as F

# Paper defaults (Hessel et al. 2018, section 3 and appendix).
DEFAULT_BETA = 3e-4
DEFAULT_SIGMA_MIN = 1e-4
DEFAULT_SIGMA_MAX = 1e6


class PopArtState(NamedTuple):
  mu: torch.Tensor          # float32 [K]: first moment of the targets
  nu: torch.Tensor          # float32 [K]: second moment
  sigma_min: torch.Tensor   # float32 []
  sigma_max: torch.Tensor   # float32 []


def init(num_tasks: int, sigma_min: float = DEFAULT_SIGMA_MIN,
         sigma_max: float = DEFAULT_SIGMA_MAX, device=None) -> PopArtState:
  """mu=0, nu=1, so sigma=1: normalization starts as the identity."""
  scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
  return PopArtState(mu=torch.zeros((num_tasks,), device=device),
                     nu=torch.ones((num_tasks,), device=device),
                     sigma_min=scalar(sigma_min), sigma_max=scalar(sigma_max))


def sigma(state: PopArtState) -> torch.Tensor:
  # The variance is clipped before the sqrt: rounding can push nu - mu^2
  # slightly negative for a near-constant target.
  variance = torch.clamp(state.nu - torch.square(state.mu),
                         torch.square(state.sigma_min),
                         torch.square(state.sigma_max))
  return torch.sqrt(variance)


def unnormalize(state: PopArtState, normalized_values, task_ids):
  """sigma[task] * n + mu[task]; `task_ids` [B] broadcasts against the
  trailing batch dim of [T, B] values."""
  task_ids = task_ids.long()
  return sigma(state)[task_ids] * normalized_values + state.mu[task_ids]


def normalize(state: PopArtState, values, task_ids):
  task_ids = task_ids.long()
  return (values - state.mu[task_ids]) / sigma(state)[task_ids]


def batch_moments(targets, task_ids, num_tasks: int):
  """Per-task (count, sum, sum of squares) of float32 [T, B] targets,
  each float32 [K]: the sums `update_stats` takes its batch moments
  from."""
  onehot = F.one_hot(task_ids.long(), num_tasks).float()       # [B, K]
  count = torch.ones_like(targets).sum(0) @ onehot
  total = targets.sum(0) @ onehot
  total_sq = torch.square(targets).sum(0) @ onehot
  return count, total, total_sq


def update_from_moments(state: PopArtState, count, total, total_sq,
                        beta: float = DEFAULT_BETA) -> PopArtState:
  """The EMA of the per-task moments toward a batch's; a task absent
  from the batch keeps its statistics."""
  present = count > 0
  safe = torch.clamp(count, min=1.0)
  new_mu = torch.where(present, (1 - beta) * state.mu + beta * (total / safe),
                       state.mu)
  new_nu = torch.where(present,
                       (1 - beta) * state.nu + beta * (total_sq / safe),
                       state.nu)
  return state._replace(mu=new_mu, nu=new_nu)


def update_stats(state: PopArtState, targets, task_ids,
                 beta: float = DEFAULT_BETA) -> PopArtState:
  """EMA the per-task moments toward this batch's float32 [T, B] value
  targets (task ids [B])."""
  return update_from_moments(
      state, *batch_moments(targets, task_ids, state.mu.shape[0]), beta=beta)


def stats_summary(state: PopArtState,
                  task_names: Optional[Sequence[str]] = None) -> Dict:
  """{'mu': [...], 'sigma': [...]} as floats in task order, and 'tasks'
  when `task_names` is given."""
  out = {'mu': [float(x) for x in state.mu.detach().cpu()],
         'sigma': [float(x) for x in sigma(state).detach().cpu()]}
  if task_names is not None:
    out['tasks'] = list(task_names)
  return out


def preserve_outputs(weight, bias, old: PopArtState, new: PopArtState):
  """The value head rewritten so its unnormalized outputs are unchanged:
  `weight` [K, hidden] (the port's Linear layout), `bias` [K]. Exact per
  task: sigma'(w'x + b') + mu' == sigma(wx + b) + mu."""
  old_sigma, new_sigma = sigma(old), sigma(new)
  new_weight = weight * (old_sigma / new_sigma)[:, None]
  new_bias = (old_sigma * bias + old.mu - new.mu) / new_sigma
  return new_weight, new_bias


def apply_preservation(params: Dict[str, torch.Tensor], old: PopArtState,
                       new: PopArtState, head_name: str = 'baseline'
                       ) -> Dict[str, torch.Tensor]:
  """`preserve_outputs` on the head's parameters in a {name: tensor}
  dict; returns a new dict."""
  weight, bias = preserve_outputs(params[f'{head_name}.weight'],
                                  params[f'{head_name}.bias'], old, new)
  return dict(params, **{f'{head_name}.weight': weight,
                         f'{head_name}.bias': bias})
