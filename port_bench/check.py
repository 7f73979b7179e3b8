"""The numbers that decide `correct` for a training cell, each held to
its limit (the workload file's `limits`). The reference follows each of
the program's recorded steps on the batch the program acted: the first
from the benchmark's weights, each later one from the program's own
parameters and RMSProp state before it (the trajectories of the deep
agent part at rounding level: see PERF.md). Each number is the largest
over the steps:

- loss_gap: |the step's loss - reference| as a share of |reference|.
- logit_gap: the largest |acting logit - reference| of the step, as a
  share of the largest |reference logit|.
- grad_gap: the worst leaf's |norm of the step's gradient as RMSProp
  got it - reference's norm|, as a share of the larger of that leaf's
  reference norm and the median leaf's. The program's gradient is read
  from its RMSProp state: nu = decay nu_before + (1 - decay) g^2.
- update_gap: the same for each leaf's change in the step. Leaves whose
  reference gradient is under GRAD_FLOOR of the median leaf's move by
  round-off alone and are not counted.
- env_errors: the bandit's guarantees broken over every recorded batch
  (reference/bandit.py); exact, limit 0.
- action_z: how far the first step's drawn actions lie from the
  reference policy.

A number passes when it is at most its limit; a number that is not
finite fails.
"""

import math
import statistics

GRAD_FLOOR = 1e-3


def norms(tree):
  """{leaf: float64 norm}."""
  return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(got, want, leaves=None):
  """{leaf: |got - want| / max(want, median of want)} over `leaves`."""
  floor = statistics.median(want.values())
  leaves = want if leaves is None else leaves
  return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
          for k in leaves}


def worst(gaps):
  """(leaf, gap) of the largest gap; a NaN gap counts as the largest."""
  return max(gaps.items(),
             key=lambda kv: kv[1] if kv[1] == kv[1] else math.inf)


def compare(run, reference, decay):
  """The gaps between a run's recorded steps and the reference's steps
  from the run's states. `run` has 'logits' (the acting logits [T, B, A]
  of each step), 'losses', 'params' and 'nu' ({leaf: tensor} after each
  step); `reference` is reference.learner.follow's over the same
  batches, from the run's states."""
  gaps = {'loss_gap': 0.0, 'logit_gap': 0.0, 'grad_gap': 0.0,
          'update_gap': 0.0}
  for k, (params_before, nu_before) in enumerate(reference['starts']):
    ref_grads = norms(reference['grads'][k])
    floor = GRAD_FLOOR * statistics.median(ref_grads.values())
    moved = [name for name, n in ref_grads.items() if n >= floor]
    grads = {name: math.sqrt(max(float(
        (run['nu'][k][name].double() - decay * nu_before[name].double()
         ).sum()) / (1.0 - decay), 0.0)) for name in ref_grads}
    steps = {
        'loss_gap': abs(run['losses'][k] - reference['losses'][k]) / max(
            abs(reference['losses'][k]), 1e-30),
        'logit_gap': float((run['logits'][k] - reference['logits'][k]
                            ).abs().max() / reference['logits'][k].abs().max()),
        'grad_gap': worst(leaf_gaps(grads, ref_grads))[1],
        'update_gap': worst(leaf_gaps(
            norms({n: run['params'][k][n] - v
                   for n, v in params_before.items()}),
            norms({n: reference['params'][k][n] - v
                   for n, v in params_before.items()}), moved))[1]}
    for name, value in steps.items():
      # A NaN stays: max() would drop it.
      gaps[name] = value if not value <= gaps[name] else gaps[name]
  return gaps


def judge(numbers, limits):
  """(correct, checks): checks maps each number to its value and limit,
  in the order of `limits`; a limit with no number fails."""
  checks, correct = {}, True
  for name, limit in limits.items():
    value = numbers.get(name)
    ok = value is not None and math.isfinite(value) and value <= limit
    correct = correct and ok
    checks[name] = {'value': value, 'limit': limit}
  return correct, checks
