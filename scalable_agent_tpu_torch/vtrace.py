"""V-trace off-policy actor-critic returns, ported from
scalable_agent_tpu/vtrace.py: the same namedtuple API, clip semantics and
time-major [T, B, ...] layout, rank-generic.

Three forms of the backward recursion `acc_t = delta_t + gamma_t c_t
acc_{t+1}`, chosen as in the reference:

- `use_pallas=True`: the fused hand-written V-trace kernel
  (ops/vtrace_cuda.py, csrc/vtrace.cu). The JAX field name
  `use_pallas_vtrace` is kept so configs carry across. On CPU tensors it
  runs the kernel's plain twin. With a `mesh` (parallel/mesh.py) the
  inputs are this rank's columns and the sharded kernel (K1b) runs on
  them, as the JAX package runs its kernel under `shard_map`.
- `use_associative_scan=True`: recursive doubling over time, O(log T)
  passes (the reference's lax.associative_scan form).
- otherwise: a plain sequential reverse loop (the reference's lax.scan).

Every column is an independent recursion, so without the fused kernel
the plain forms run on a rank's own columns unchanged.

The outputs carry no gradient, as in the reference.
"""

import collections

import torch
from torch.nn import functional as F

from scalable_agent_tpu_torch.ops import vtrace_cuda

VTraceFromLogitsReturns = collections.namedtuple(
    'VTraceFromLogitsReturns',
    ['vs', 'pg_advantages', 'log_rhos',
     'behaviour_action_log_probs', 'target_action_log_probs'])

VTraceReturns = collections.namedtuple('VTraceReturns', 'vs pg_advantages')


def log_probs_from_logits_and_actions(policy_logits, actions):
  """log pi(a|x) for the given actions: `policy_logits` [T, B, ..., A],
  `actions` [T, B, ...]."""
  log_probs = F.log_softmax(policy_logits.float(), dim=-1)
  return torch.gather(log_probs, -1, actions.long()[..., None])[..., 0]


def from_logits(behaviour_policy_logits, target_policy_logits, actions,
                discounts, rewards, values, bootstrap_value,
                clip_rho_threshold=1.0, clip_pg_rho_threshold=1.0,
                use_associative_scan=False, use_pallas=False, mesh=None,
                batch_axis='data', batch_size=None):
  """V-trace for softmax policies. Shapes (time-major): logits
  [T, B, A], actions [T, B], discounts/rewards/values [T, B], bootstrap
  [B]; extra trailing dims are allowed everywhere. With `mesh`, B is this
  rank's shard of the global `batch_size` (see from_importance_weights)."""
  behaviour_action_log_probs = log_probs_from_logits_and_actions(
      behaviour_policy_logits, actions)
  target_action_log_probs = log_probs_from_logits_and_actions(
      target_policy_logits, actions)
  log_rhos = target_action_log_probs - behaviour_action_log_probs
  vtrace_returns = from_importance_weights(
      log_rhos=log_rhos, discounts=discounts, rewards=rewards,
      values=values, bootstrap_value=bootstrap_value,
      clip_rho_threshold=clip_rho_threshold,
      clip_pg_rho_threshold=clip_pg_rho_threshold,
      use_associative_scan=use_associative_scan, use_pallas=use_pallas,
      mesh=mesh, batch_axis=batch_axis, batch_size=batch_size)
  return VTraceFromLogitsReturns(
      log_rhos=log_rhos,
      behaviour_action_log_probs=behaviour_action_log_probs,
      target_action_log_probs=target_action_log_probs,
      **vtrace_returns._asdict())


def _vs_minus_v_xs_doubling(deltas, discounts_cs):
  """Same recurrence in ceil(log2 T) whole-array passes: each pass
  composes every step's affine map x -> b + a x with the one `offset`
  steps later (identity past the end)."""
  a, b = discounts_cs, deltas
  offset = 1
  while offset < deltas.shape[0]:
    a_shift = torch.cat([a[offset:], torch.ones_like(a[:offset])])
    b_shift = torch.cat([b[offset:], torch.zeros_like(b[:offset])])
    b = b + a * b_shift
    a = a * a_shift
    offset *= 2
  return b


def from_importance_weights(log_rhos, discounts, rewards, values,
                            bootstrap_value, clip_rho_threshold=1.0,
                            clip_pg_rho_threshold=1.0,
                            use_associative_scan=False, use_pallas=False,
                            mesh=None, batch_axis='data', batch_size=None):
  """V-trace from log importance weights: rhos = exp(log_rhos), clipped
  at `clip_rho_threshold` for the value targets and at
  `clip_pg_rho_threshold` for the policy-gradient advantages (None = no
  clip); cs = min(1, rhos). Returns detached VTraceReturns.

  With `mesh` and `use_pallas`, the inputs are this rank's shard of the
  batch over `batch_axis` and the sharded kernel checks it against the
  global `batch_size` (None: the shard times the axis' size)."""
  if use_pallas and use_associative_scan:
    raise ValueError('use_pallas and use_associative_scan are mutually '
                     'exclusive — pick one V-trace form')
  log_rhos, discounts, rewards, values, bootstrap_value = (
      x.detach().float().contiguous()
      for x in (log_rhos, discounts, rewards, values, bootstrap_value))
  if use_pallas:
    if mesh is not None:
      vs, pg_advantages = vtrace_cuda.sharded_from_importance_weights(
          mesh, log_rhos, discounts, rewards, values, bootstrap_value,
          clip_rho_threshold=clip_rho_threshold,
          clip_pg_rho_threshold=clip_pg_rho_threshold,
          batch_axis=batch_axis, batch_size=batch_size)
    else:
      vs, pg_advantages = vtrace_cuda.from_importance_weights(
          log_rhos, discounts, rewards, values, bootstrap_value,
          clip_rho_threshold=clip_rho_threshold,
          clip_pg_rho_threshold=clip_pg_rho_threshold)
    return VTraceReturns(vs=vs, pg_advantages=pg_advantages)

  recursion = (_vs_minus_v_xs_doubling if use_associative_scan
               else vtrace_cuda.sequential_recursion)
  vs, pg_advantages = vtrace_cuda.plain_from_importance_weights(
      log_rhos, discounts, rewards, values, bootstrap_value,
      clip_rho_threshold=clip_rho_threshold,
      clip_pg_rho_threshold=clip_pg_rho_threshold, recursion=recursion)
  return VTraceReturns(vs=vs, pg_advantages=pg_advantages)
