"""Population engine, ported from scalable_agent_tpu/population.py: the
functions behind the in-step level curriculum, mixed-fleet planning and
minimal PBT.

1. CURRICULUM (in the fused step, on tensors): the procgen core's finite
   level-id space (envs/jittable.py) becomes a driven distribution.
   Per-level regret or TD-error EMAs accumulate in the fused Anakin step
   (`score_signal` + `update_scores`, a segment sum over the unroll's
   transition level ids by `index_add_`), and a new episode's level id is
   drawn from an epsilon-smoothed softmax over those scores
   (`level_probs` + `sample_levels`, a Gumbel-argmax draw from an
   explicit generator: JAX's distribution, not its stream). A level the
   batch did not visit has its score multiplied by `decay < 1`, so a
   stale "hard" level drifts back toward the smoothed floor. 'regret'
   scores the positive value loss (the PLR proxy, arXiv 2010.03934);
   'td' scores |delta|.

2. FLEET COMPOSITION (host side, numpy): `parse_fleet_tasks`,
   `plan_actor_assignment` and `padding_report`, copied unchanged;
   driver.make_fleet plans a mixed fleet's actors with them.

3. PBT (host side, numpy): `pbt_decide` ranks members within their
   comparability group (the suite), bottom-quantile members exploit a
   top-quantile donor, and `pbt_explore` perturbs (learning_rate,
   entropy_cost) multiplicatively — the minimal PBT of arXiv 1711.09846.
   Given the same `np.random.Generator` state these make JAX's decisions
   exactly.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# The config axis (config.curriculum; experiment.py --curriculum).
CURRICULUM_MODES = ('uniform', 'regret', 'td')

# The two hyperparameters minimal PBT explores: the IMPALA paper's own
# PBT axes.
PBT_HYPERS = ('learning_rate', 'entropy_cost')


# --------------------------------------------------------------------
# Curriculum (tensors; runs inside the fused step).
# --------------------------------------------------------------------


def level_probs(scores, temperature: float, eps: float) -> torch.Tensor:
  """The sampling distribution over levels, an epsilon-smoothed softmax:
  `(1-eps) * softmax(normalize(scores) / temperature) + eps / n`.
  normalize() divides by the largest score (clipped away from zero), so
  the prioritisation does not depend on the reward scale; all-zero
  scores give the uniform distribution."""
  scores = torch.as_tensor(scores, dtype=torch.float32)
  n = scores.shape[0]
  norm = scores / torch.clamp(torch.max(scores), min=1e-8)
  soft = torch.softmax(norm / max(temperature, 1e-6), dim=0)
  return (1.0 - eps) * soft + eps / n


def sample_levels(generator: torch.Generator, scores, batch: int,
                  temperature: float, eps: float) -> torch.Tensor:
  """`batch` level ids (int64) drawn from `level_probs` by Gumbel-argmax
  with noise from `generator` (on the scores' device)."""
  logits = torch.log(level_probs(scores, temperature, eps))
  uniform = torch.rand((batch, logits.shape[0]), generator=generator,
                       device=logits.device)
  gumbel = -torch.log(-torch.log(uniform.clamp_min(1e-20)))
  return torch.argmax(logits + gumbel, dim=-1)


def score_signal(delta, mode: str) -> torch.Tensor:
  """The per-transition priority from the TD error `delta`: 'regret'
  relu(delta), 'td' |delta|."""
  if mode == 'regret':
    return torch.relu(delta)
  if mode == 'td':
    return torch.abs(delta)
  raise ValueError(f'unknown curriculum mode {mode!r} '
                   f'(signal modes: regret, td)')


def update_scores(scores, visits, level_ids, signals, alpha: float,
                  decay: float,
                  all_reduce: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """EMA the per-level scores from one unroll's transition signals.

  `level_ids`/`signals`: matching shapes of transition level ids and
  priorities. Visited levels move to `(1-alpha)*s + alpha*mean(signal)`,
  unvisited ones decay to `decay*s`. Returns (scores, visits + per-level
  transition counts). `all_reduce` (a process group's in-place SUM of
  one float32 tensor) sums the segment sums and counts over the ranks
  before the EMA, so every rank holds the same table (JAX gets this from
  the partitioner's psum)."""
  scores = torch.as_tensor(scores, dtype=torch.float32)
  n = scores.shape[0]
  ids = level_ids.reshape(-1).long()
  sig = signals.reshape(-1).float()
  totals = torch.zeros((2, n), dtype=torch.float32, device=scores.device)
  totals[0].index_add_(0, ids, sig)
  totals[1].index_add_(0, ids, torch.ones_like(sig))
  if all_reduce is not None:
    totals = all_reduce(totals.reshape(-1)).reshape(2, n)
  sums, counts = totals[0], totals[1]
  means = sums / torch.clamp(counts, min=1.0)
  new_scores = torch.where(counts > 0, (1.0 - alpha) * scores + alpha * means,
                           decay * scores)
  return new_scores, visits + counts


def curriculum_metrics(scores, visits, temperature: float,
                       eps: float) -> Dict[str, torch.Tensor]:
  """The fused step's curriculum scalars: the sampling distribution's
  entropy (uniform = log n), the score mean and max, and how many levels
  have ever been visited."""
  p = level_probs(scores, temperature, eps)
  entropy = -torch.sum(p * torch.log(torch.clamp(p, min=1e-12)))
  return {
      'curriculum_entropy': entropy,
      'curriculum_score_mean': torch.mean(scores),
      'curriculum_score_max': torch.max(scores),
      'curriculum_levels_visited': torch.sum((visits > 0).float()),
  }


# --------------------------------------------------------------------
# Heterogeneous fleet composition (host-side planning).
# --------------------------------------------------------------------


def parse_fleet_tasks(spec: str) -> List[Tuple[str, float]]:
  """Parse `--fleet_tasks='bandit:2,gridworld:1'` into [(backend,
  weight)]: weights are relative actor (and frame-budget) shares; a bare
  name means weight 1."""
  tasks = []
  for part in spec.split(','):
    part = part.strip()
    if not part:
      continue
    if ':' in part:
      name, _, weight = part.partition(':')
      try:
        w = float(weight)
      except ValueError:
        raise ValueError(f'fleet_tasks weight {weight!r} for task '
                         f'{name!r} is not a number')
    else:
      name, w = part, 1.0
    name = name.strip()
    if not name:
      raise ValueError(f'fleet_tasks entry {part!r} has no task name')
    if w <= 0:
      raise ValueError(f'fleet_tasks weight for {name!r} must be > 0, '
                       f'got {w}')
    if any(existing == name for existing, _ in tasks):
      raise ValueError(f'fleet_tasks names {name!r} twice')
    tasks.append((name, w))
  return tasks


def plan_actor_assignment(tasks: Sequence[Tuple[str, float]],
                          num_actors: int) -> List[int]:
  """Apportion `num_actors` across weighted tasks (largest remainder,
  every task >= 1 actor) and return the per-actor task index,
  interleaved round-robin so a partial fleet still samples every task."""
  if not tasks:
    raise ValueError('plan_actor_assignment needs at least one task')
  if num_actors < len(tasks):
    raise ValueError(f'{num_actors} actor(s) cannot cover '
                     f'{len(tasks)} task(s) at >= 1 actor each')
  weights = np.asarray([w for _, w in tasks], np.float64)
  quotas = num_actors * weights / weights.sum()
  counts = np.maximum(np.floor(quotas).astype(int), 1)
  # Largest remainder for the leftover seats (ties break by index).
  while counts.sum() < num_actors:
    frac = quotas - counts
    counts[int(np.argmax(frac))] += 1
  while counts.sum() > num_actors:
    # The >= 1 floor can overshoot tiny fleets: shave the largest
    # overage, never below 1.
    over = counts - quotas
    over[counts <= 1] = -np.inf
    counts[int(np.argmax(over))] -= 1
  remaining = counts.copy()
  plan: List[int] = []
  while len(plan) < num_actors:
    for i in range(len(tasks)):
      if remaining[i] > 0:
        plan.append(i)
        remaining[i] -= 1
        if len(plan) == num_actors:
          break
  return plan


def frame_bytes(frame_shape: Sequence[int], dtype_bytes: int = 1) -> int:
  """Bytes of one observation frame (uint8 frames by default)."""
  n = dtype_bytes
  for d in frame_shape:
    n *= int(d)
  return n


def padding_report(family_counts: Dict[Tuple[int, ...], int]
                   ) -> Dict[str, float]:
  """Padded bytes per useful frame under obs-spec family bucketing
  against naive max-shape padding (`family_counts`: {frame_shape:
  frames served})."""
  if not family_counts:
    return {'useful_bytes': 0.0, 'bucketed_bytes': 0.0,
            'max_shape_bytes': 0.0, 'bucketed_bytes_per_frame': 0.0,
            'max_shape_bytes_per_frame': 0.0, 'waste_ratio': 0.0}
  max_frame = max(frame_bytes(s) for s in family_counts)
  frames = sum(family_counts.values())
  useful = float(sum(frame_bytes(s) * c for s, c in family_counts.items()))
  naive = float(max_frame * frames)
  return {
      'useful_bytes': useful,
      'bucketed_bytes': useful,  # family merges pad zero extra bytes
      'max_shape_bytes': naive,
      'bucketed_bytes_per_frame': useful / frames,
      'max_shape_bytes_per_frame': naive / frames,
      'waste_ratio': (naive - useful) / naive if naive else 0.0,
  }


# --------------------------------------------------------------------
# Minimal PBT (host side, between rounds).
# --------------------------------------------------------------------


def pbt_explore(hypers: Dict[str, float], rng: np.random.Generator,
                perturb: float) -> Dict[str, float]:
  """Multiply each hyper by `perturb` or `1/perturb` (a fair coin each,
  in sorted name order)."""
  out = dict(hypers)
  for name in sorted(hypers):
    factor = perturb if rng.random() < 0.5 else 1.0 / perturb
    out[name] = float(hypers[name] * factor)
  return out


def pbt_decide(returns: Sequence[float], groups: Sequence[Any],
               rng: np.random.Generator, quantile: float = 0.25,
               perturb: float = 1.2,
               hypers: Optional[Sequence[Dict[str, float]]] = None
               ) -> List[Optional[Dict[str, Any]]]:
  """One PBT round's decisions: in each group of >= 2 members the bottom
  `quantile` exploit a donor drawn uniformly from the top `quantile`
  ({'donor': j, 'hypers': explored donor hypers}), when the donor's
  return is strictly higher; everyone else gets None."""
  n = len(returns)
  if hypers is not None and len(hypers) != n:
    raise ValueError(f'{len(hypers)} hyper sets for {n} members')
  decisions: List[Optional[Dict[str, Any]]] = [None] * n
  for g in sorted(set(groups), key=repr):
    idx = [i for i in range(n) if groups[i] == g]
    if len(idx) < 2:
      continue
    ranked = sorted(idx, key=lambda i: (returns[i], i))
    k = max(1, int(round(quantile * len(idx))))
    k = min(k, len(idx) // 2)  # bottom and top never overlap
    bottom, top = ranked[:k], ranked[-k:]
    for i in bottom:
      donor = top[int(rng.integers(len(top)))]
      if returns[donor] <= returns[i]:
        continue
      donor_hypers = dict(hypers[donor]) if hypers is not None else {}
      decisions[i] = {
          'donor': donor,
          'hypers': pbt_explore(donor_hypers, rng, perturb),
      }
  return decisions
