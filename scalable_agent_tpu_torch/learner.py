"""Learner: one SGD step over a [T+1, B] batch of unrolls, ported from
scalable_agent_tpu/learner.py.

The step runs the agent over the batch, aligns it (the 1-frame overlap),
computes V-trace, the three sum-reduced losses, and RMSProp with the
frame-driven linear learning-rate decay. The JAX learner's extensions
are here too, in its order:

- PopArt (popart.py): V-trace runs on the unnormalized values, the
  baseline loss in normalized space with the current statistics; after
  the update the statistics move toward the batch's targets and the
  value head is rewritten to preserve its outputs;
- UNREAL pixel control (unreal.py): the Q-head's n-step loss, a mean
  over T and B, added at pixel_control_cost;
- IMPACT (surrogate='impact'): a target network (`target_params`, with
  the PopArt statistics it was frozen under, `target_popart`) runs a
  second forward without autograd; V-trace takes its IS ratios and
  values from it, and the policy gradient is the clipped surrogate of
  the current policy against it. The target refreshes every
  target_update_interval steps, after the watchdog's keep.

PyTorch runs the step eagerly; the parameters are the agent's own
tensors and are updated in place (the JAX step returns new arrays and
donates the old ones — the same memory footprint, reached the PyTorch
way).

Trajectory layout reminder (time-major [T+1, B]):
  env_outputs[i]  = o_i  (o_0 is the previous unroll's last frame)
  agent_outputs[i].action = a_{i-1} (action *before* o_i)
so rewards[1:] pair with values[:-1] and the bootstrap is V(o_T).

Under a mesh (parallel/mesh.py) each rank holds B/D columns of the batch
and a replica of the parameters. The losses are sums over columns, so the
JAX sharded step's gradient is the sum of the ranks' gradients: one SUM
all-reduce of a flat buffer of the gradients and the four losses, after
which every rank takes the same norm, clip, watchdog decision and update.

Under tensor parallelism (parallel/train_parallel.py) the step is built
from the same parts: `loss_fn` on given parameters, and
`apply_gradients` on this rank's blocks of the parameters.

The fleet runtime hands the learner host numpy batches: `place_batch`
moves one to the learner's device with the dtypes the Anakin path
builds, reading from pinned host memory (`pinned_empty`) on CUDA.

RMSProp is written by hand because optax's differs from
`torch.optim.RMSprop`: optax puts eps *inside* the square root,
    nu <- decay * nu + (1 - decay) * g^2
    update = -lr * g / sqrt(nu + eps)
with nu starting at 0, and with the reference's eps = 0.1 the two diverge
at once. Momentum (optax's trace) applies after the learning rate, and an
optional clip_by_global_norm comes first.
"""

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import losses as losses_lib
from scalable_agent_tpu_torch import popart as popart_lib
from scalable_agent_tpu_torch import unreal
from scalable_agent_tpu_torch import vtrace
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.structs import ActorOutput, map_structure


class RMSPropState(NamedTuple):
  count: torch.Tensor   # int32 [] — updates applied: the schedule's clock
  nu: Dict[str, torch.Tensor]
  trace: Optional[Dict[str, torch.Tensor]] = None  # when momentum != 0


class TrainState(NamedTuple):
  params: Dict[str, torch.Tensor]  # the agent's parameters, by name
  opt_state: RMSPropState
  update_steps: int                # host-side: counting needs no sync
  popart: Optional[popart_lib.PopArtState] = None  # with use_popart
  # IMPACT's target network (surrogate='impact'): tensors apart from
  # the params (which train in place), and the PopArt statistics taken
  # with it at each refresh (impact with use_popart): the frozen head
  # is unnormalized with the statistics it was frozen under.
  target_params: Optional[Dict[str, torch.Tensor]] = None
  target_popart: Optional[popart_lib.PopArtState] = None


class VTraceInputs(NamedTuple):
  behaviour_logits: Any  # [T, B, A] — actor's logits at acting time
  target_logits: Any     # [T, B, A] — learner's logits, same steps
  actions: Any           # [T, B]    — actions actually taken
  discounts: Any         # [T, B]
  rewards: Any           # [T, B]    — clipped
  values: Any            # [T, B]    — learner baseline V(o_i)
  bootstrap_value: Any   # [B]       — V(o_T)


def clip_rewards(rewards, mode: str):
  """Reference reward clipping."""
  if mode == 'abs_one':
    return torch.clamp(rewards, -1.0, 1.0)
  elif mode == 'soft_asymmetric':
    squeezed = torch.tanh(rewards / 5.0)
    return torch.where(rewards < 0, 0.3 * squeezed, squeezed) * 5.0
  elif mode == 'none':
    return rewards
  raise ValueError(f'unknown reward clipping: {mode!r}')


def align_batch(env_outputs, agent_outputs, learner_outputs,
                config: Config) -> VTraceInputs:
  """Shift the [T+1] trajectory into aligned [T] V-trace inputs: the
  bootstrap is the last learner baseline, actor/env tensors drop the
  overlap frame ([1:]), learner tensors drop the last frame ([:-1])."""
  clipped_rewards = clip_rewards(env_outputs.reward[1:],
                                 config.reward_clipping)
  discounts = (~env_outputs.done[1:]).float() * config.discounting
  return VTraceInputs(
      behaviour_logits=agent_outputs.policy_logits[1:],
      target_logits=learner_outputs.policy_logits[:-1],
      actions=agent_outputs.action[1:],
      discounts=discounts,
      rewards=clipped_rewards,
      values=learner_outputs.baseline[:-1],
      bootstrap_value=learner_outputs.baseline[-1])


# The metrics a process group sums over its ranks: the sum-reduced
# losses, and the means that each rank computes over the global T*B.
SUMMED_KEYS = ('total_loss', 'pg_loss', 'baseline_loss', 'entropy_loss',
               'pixel_control_loss', 'impact_clip_fraction')


class LossForward(NamedTuple):
  """The forward half of `loss_fn`, up to its V-trace call."""
  outputs: Any            # the agent's forward: (AgentOutput, carry[, Q])
  inputs: VTraceInputs    # aligned on the learner's (unnormalized) values
  vtrace_src: VTraceInputs  # what V-trace runs on (IMPACT: the target's)
  task_ids: Any
  use_impact: bool
  denominator: Any        # the mean-reduced terms' T*B under a mesh


def loss_forward(agent, batch: ActorOutput, config: Config, mesh=None,
                 params=None, tp=None, popart_state=None,
                 target_params=None, target_popart=None) -> LossForward:
  """`loss_fn`'s forward: the agent over the batch (and IMPACT's target
  network, without autograd) and the aligned V-trace inputs."""
  args = (batch.agent_outputs.action, batch.env_outputs, batch.agent_state)
  task_ids = (None if batch.level_name is None
              else torch.as_tensor(batch.level_name).long())
  use_pc = config.pixel_control_cost > 0

  def forward(weights, **kwargs):
    kwargs = dict(kwargs, tp=tp, level_ids=task_ids)
    if weights is None:
      return agent(*args, **kwargs)
    return torch.func.functional_call(agent, weights, args, kwargs,
                                      strict=False)

  outputs = forward(params, compute_pixel_control=use_pc)
  learner_outputs = outputs[0]
  learner_for_align = learner_outputs
  if popart_state is not None:
    learner_for_align = learner_outputs._replace(
        baseline=popart_lib.unnormalize(popart_state,
                                        learner_outputs.baseline, task_ids))
  inputs = align_batch(batch.env_outputs, batch.agent_outputs,
                       learner_for_align, config)
  # The mean-reduced terms' T*B: the global batch's under a mesh.
  denominator = (inputs.rewards.shape[0] * config.batch_size
                 if mesh is not None else None)

  use_impact = config.surrogate == 'impact' and target_params is not None
  vtrace_src = inputs
  if use_impact:
    # The target network's logits and values over the same batch; no
    # gradient reaches it.
    with torch.no_grad():
      target_outputs = forward(target_params)[0]
    if popart_state is not None:
      stats = target_popart if target_popart is not None else popart_state
      target_outputs = target_outputs._replace(
          baseline=popart_lib.unnormalize(stats, target_outputs.baseline,
                                          task_ids))
    vtrace_src = align_batch(batch.env_outputs, batch.agent_outputs,
                             target_outputs, config)
  return LossForward(outputs, inputs, vtrace_src, task_ids, use_impact,
                     denominator)


def run_vtrace(src: VTraceInputs, config: Config, mesh=None,
               vtrace_axis='data'):
  """V-trace over `src`, in the form the config picks (the fused kernel
  with use_pallas_vtrace; K1b on this rank's columns under a mesh)."""
  return vtrace.from_logits(
      behaviour_policy_logits=src.behaviour_logits,
      target_policy_logits=src.target_logits,
      actions=src.actions,
      discounts=src.discounts,
      rewards=src.rewards,
      values=src.values,
      bootstrap_value=src.bootstrap_value,
      use_associative_scan=config.use_associative_scan,
      use_pallas=config.use_pallas_vtrace, mesh=mesh, batch_axis=vtrace_axis,
      batch_size=config.batch_size if mesh is not None else None)


def loss_from_vtrace(fwd: LossForward, vtrace_returns, batch: ActorOutput,
                     config: Config, popart_state=None, entropy_cost=None):
  """`loss_fn`'s second half: the losses from the forward and the
  V-trace returns. `entropy_cost` (a float or a 0-d tensor: a population
  member's) replaces config.entropy_cost."""
  inputs, learner_outputs = fwd.inputs, fwd.outputs[0]
  if entropy_cost is None:
    entropy_cost = config.entropy_cost
  metrics = {}
  if fwd.use_impact:
    log_ratio = (vtrace.log_probs_from_logits_and_actions(
        inputs.target_logits, inputs.actions) -
        vtrace_returns.target_action_log_probs)
    pg_loss = losses_lib.compute_impact_surrogate_loss(
        log_ratio, vtrace_returns.pg_advantages, config.impact_epsilon)
    metrics['impact_clip_fraction'] = losses_lib.impact_clip_fraction(
        log_ratio, config.impact_epsilon, fwd.denominator)
  else:
    pg_loss = losses_lib.compute_policy_gradient_loss(
        inputs.target_logits, inputs.actions, vtrace_returns.pg_advantages)
  if popart_state is not None:
    # The normalized head regresses toward the normalized targets.
    norm_targets = popart_lib.normalize(popart_state, vtrace_returns.vs,
                                        fwd.task_ids)
    baseline_loss = losses_lib.compute_baseline_loss(
        norm_targets.detach() - learner_outputs.baseline[:-1])
  else:
    baseline_loss = losses_lib.compute_baseline_loss(
        vtrace_returns.vs - inputs.values)
  entropy_loss = losses_lib.compute_entropy_loss(inputs.target_logits)
  total_loss = (pg_loss + config.baseline_cost * baseline_loss +
                entropy_cost * entropy_loss)
  if config.pixel_control_cost > 0:
    # Pseudo-rewards from frame deltas; the action of transition t ->
    # t+1 is agent_outputs[t+1] (inputs.actions, the [1:] slice).
    frames = batch.env_outputs.observation[0]
    use_int = (config.pixel_control_integer_rewards and
               frames.dtype == torch.uint8)
    pc_rewards = unreal.pixel_control_rewards(
        frames, config.pixel_control_cell_size, integer_path=use_int)
    pc_loss = unreal.pixel_control_loss(
        fwd.outputs[2], inputs.actions, pc_rewards,
        batch.env_outputs.done[1:], discount=config.pixel_control_discount,
        denominator=fwd.denominator)
    total_loss = total_loss + config.pixel_control_cost * pc_loss
    metrics['pixel_control_loss'] = pc_loss.detach()
  metrics.update({
      'total_loss': total_loss.detach(),
      'pg_loss': pg_loss.detach(),
      'baseline_loss': baseline_loss.detach(),
      'entropy_loss': entropy_loss.detach(),
  })
  aux = {'vs': vtrace_returns.vs, 'task_ids': fwd.task_ids}
  return total_loss, metrics, aux


def loss_fn(agent, batch: ActorOutput, config: Config, mesh=None,
            params=None, tp=None, vtrace_axis='data', popart_state=None,
            target_params=None, target_popart=None):
  """Total IMPALA loss for one batch: (loss, metrics, aux), aux holding
  the V-trace targets `vs` and the task ids for the PopArt update:
  `loss_forward`, `run_vtrace`, `loss_from_vtrace`.

  With `mesh` the batch is this rank's shard and so are the loss and
  metrics; its columns are the shard of the global batch over
  `vtrace_axis` (an axis of the mesh or a tuple of them), and the
  mean-reduced terms divide by the global T*B. `params` ({name:
  tensor}) replace the agent's parameters for this call
  (torch.func.functional_call), and `tp` (a models.TensorParallel) runs
  the layers whose parameters are blocks as blocks. `popart_state`,
  `target_params` and `target_popart` are the TrainState's."""
  fwd = loss_forward(agent, batch, config, mesh=mesh, params=params, tp=tp,
                     popart_state=popart_state, target_params=target_params,
                     target_popart=target_popart)
  vtrace_returns = run_vtrace(fwd.vtrace_src, config, mesh=mesh,
                              vtrace_axis=vtrace_axis)
  return loss_from_vtrace(fwd, vtrace_returns, batch, config,
                          popart_state=popart_state)


def make_schedule(config: Config):
  """Linear learning-rate decay to 0 over total env frames, driven by the
  update count x fresh frames per step; float32 arithmetic as in the
  reference. Under sample reuse an update consumes frames_per_step *
  (1 - replay_ratio) / replay_k fresh frames at steady state (the frame
  budget counts fresh frames too). `count` is an int or an integer
  tensor (the result then lives on its device)."""
  fps = (float(config.frames_per_step) *
         (1.0 - config.replay_ratio) / config.replay_k)

  def schedule(count):
    frames = torch.as_tensor(count).to(torch.float32) * fps
    frac = torch.clamp(frames / float(config.total_environment_frames),
                       max=1.0)
    return config.learning_rate * (1.0 - frac)

  return schedule


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
  """sqrt of the sum of squares of every element (optax.global_norm)."""
  return torch.sqrt(sum(torch.sum(torch.square(t))
                        for t in tensors.values()))


def rmsprop_init(params: Dict[str, torch.Tensor],
                 config: Config) -> RMSPropState:
  device = next(iter(params.values())).device
  zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
  return RMSPropState(
      count=torch.zeros((), dtype=torch.int32, device=device),
      nu=zeros(), trace=zeros() if config.momentum else None)


@torch.no_grad()
def rmsprop_update(grads: Dict[str, torch.Tensor], state: RMSPropState,
                   config: Config, schedule, g_norm=None):
  """optax.chain([clip_by_global_norm,] rmsprop(schedule, decay, eps,
  momentum)).update: returns (updates, new state). `g_norm` is the
  global norm of the gradients when `grads` are blocks of them (tensor
  parallelism); None: computed from `grads`."""
  if config.grad_clip_norm is not None:
    if g_norm is None:
      g_norm = global_norm(grads)
    max_norm = config.grad_clip_norm
    grads = {k: torch.where(g_norm < max_norm, g, g / g_norm * max_norm)
             for k, g in grads.items()}
  decay, eps = config.decay, config.epsilon
  nu = {k: (1.0 - decay) * torch.square(g) + decay * state.nu[k]
        for k, g in grads.items()}
  lr = schedule(state.count)
  updates = {k: -lr * (torch.rsqrt(nu[k] + eps) * g)
             for k, g in grads.items()}
  trace = None
  if state.trace is not None:
    trace = {k: u + config.momentum * state.trace[k]
             for k, u in updates.items()}
    updates = trace
  return updates, RMSPropState(state.count + 1, nu, trace)


def _copy_popart(state: Optional[popart_lib.PopArtState]):
  if state is None:
    return None
  return popart_lib.PopArtState(*(x.detach().clone() for x in state))


def make_train_state(agent, config: Config,
                     num_popart_tasks: Optional[int] = None) -> TrainState:
  """The agent's own parameters, fresh RMSProp state, and with the
  extensions the PopArt statistics (`num_popart_tasks` tasks, None: the
  agent's value columns) and IMPACT's target network, a copy of the
  parameters in tensors of its own."""
  params = dict(agent.named_parameters())
  device = next(iter(params.values())).device
  popart = None
  if config.use_popart:
    if num_popart_tasks is None:
      num_popart_tasks = getattr(agent, 'num_popart_tasks', 0)
    popart = popart_lib.init(max(num_popart_tasks, 1), device=device)
  return with_target(TrainState(params=params,
                                opt_state=rmsprop_init(params, config),
                                update_steps=0, popart=popart), config)


def with_target(state: TrainState, config: Config) -> TrainState:
  """`state` with IMPACT's target network set to a copy of its params
  (and of its PopArt statistics) when config.surrogate is 'impact'."""
  if config.surrogate != 'impact':
    return state
  target = {k: p.detach().clone() for k, p in state.params.items()}
  return state._replace(target_params=target,
                        target_popart=_copy_popart(state.popart))


def state_to_payload(state: TrainState) -> Dict[str, Any]:
  """The TrainState as plain dicts of CPU tensors, the form a checkpoint
  holds (`torch.load(weights_only=True)` refuses NamedTuples):
  {'params', 'opt_state': {'count', 'nu', 'trace'}, 'update_steps'},
  and, as in JAX's TrainState tree, 'popart' ({'mu', 'nu', 'sigma_min',
  'sigma_max'}), 'target_params' and 'target_popart' when the state has
  them (absent when None)."""
  def host(tree):
    if isinstance(tree, torch.Tensor):
      return tree.detach().to('cpu', copy=True)
    if isinstance(tree, dict):
      return {k: host(v) for k, v in tree.items()}
    return tree

  return host(state_tree(state))


@torch.no_grad()
def load_state_(state: TrainState, payload: Dict[str, Any]) -> TrainState:
  """Copy a `state_to_payload` payload into `state`'s own tensors, on
  their device, and return a TrainState holding those same tensors.

  In place because the agent trains its own parameter tensors
  (`make_train_state`): a restore that rebound the dict would leave the
  agent training its old weights. The caller has checked the payload's
  structure against `state`."""
  def copy_tree(tree, saved):
    for k, v in tree.items():
      v.copy_(saved[k])

  copy_tree(state.params, payload['params'])
  opt, saved = state.opt_state, payload['opt_state']
  opt.count.copy_(saved['count'])
  copy_tree(opt.nu, saved['nu'])
  if opt.trace is not None:
    copy_tree(opt.trace, saved['trace'])
  for name in ('popart', 'target_popart'):
    if getattr(state, name) is not None:
      copy_tree(getattr(state, name)._asdict(), payload[name])
  if state.target_params is not None:
    copy_tree(state.target_params, payload['target_params'])
  return state._replace(update_steps=int(payload['update_steps']))


def param_fingerprint(params) -> torch.Tensor:
  """The JAX package's `param_fingerprint`: every leaf viewed as the
  unsigned integers of its width (8-byte leaves as pairs of 32-bit
  ones, bool as uint8) and summed mod 2**32. Integer addition is exact
  in any order, so bit-equal replicas give equal values, and the value
  does not depend on the port's layouts (transposed kernels, fused LSTM
  gates): it equals JAX's on the converted params. A 0-d int64 tensor
  holding the uint32 value, on the params' device."""
  total = None
  for leaf in params.values():
    x = leaf.detach()
    if x.numel() == 0:
      continue
    if x.dtype == torch.bool:
      bits, width = x.to(torch.uint8).to(torch.int64), 8
    else:
      size = x.element_size()
      view = {1: torch.uint8, 2: torch.int16}.get(size, torch.int32)
      x = x.contiguous().reshape(-1)
      bits, width = x.view(view).to(torch.int64), min(8 * size, 32)
    part = torch.sum(bits & ((1 << width) - 1))
    total = part if total is None else total + part
  if total is None:
    return torch.zeros((), dtype=torch.int64)
  return total & 0xFFFFFFFF


def popart_moments(state: TrainState, aux):
  """This rank's PopArt batch moments ([K] count, sum and sum of squares
  of the V-trace targets per task), or None without PopArt."""
  if state.popart is None:
    return None
  return popart_lib.batch_moments(aux['vs'], aux['task_ids'],
                                  state.popart.mu.shape[0])


def _all_reduce_sum(mesh, grads, metrics, axis='data', moments=None):
  """The gradients, the summed metrics (SUMMED_KEYS) and the PopArt
  moments summed over the ranks of the mesh's `axis` (None: every rank),
  in one all-reduce of one flat float32 buffer. Returns (grads, metrics,
  moments)."""
  keys = [k for k in SUMMED_KEYS if k in metrics]
  extra = list(moments) if moments is not None else []
  leaves = (list(grads.values()) + [metrics[k] for k in keys] + extra)
  flat = mesh.all_reduce_sum_(torch.cat([x.reshape(-1) for x in leaves]),
                              axis=axis)
  parts = [part.view_as(x) for part, x in
           zip(torch.split(flat, [x.numel() for x in leaves]), leaves)]
  n = len(grads)
  metrics = dict(metrics, **dict(zip(keys, parts[n:n + len(keys)])))
  moments = tuple(parts[n + len(keys):]) if moments is not None else None
  return dict(zip(grads, parts[:n])), metrics, moments


@torch.no_grad()
def apply_gradients(state: TrainState, grads, metrics, config: Config,
                    schedule, g_norm=None, moments=None):
  """RMSProp on `state`'s parameters with `grads` (the same keys and
  shapes), then in JAX's order: the PopArt statistics move by
  `moments` (`popart_moments`, summed over a group's ranks) and the
  value head is rewritten to preserve its outputs; the health
  watchdog's keep-or-skip, over the parameters, the optimizer state and
  the statistics; the in-place update; and the target network's
  refresh every target_update_interval steps, after the keep, so a
  skipped step's target takes the kept parameters. Returns
  (TrainState, metrics). `g_norm` is the pre-clip global norm (None:
  computed from `grads`); it is reported as `grad_norm`."""
  params = state.params
  metrics['grad_norm'] = global_norm(grads) if g_norm is None else g_norm
  updates, opt_state = rmsprop_update(grads, state.opt_state, config,
                                      schedule, g_norm=metrics['grad_norm'])
  new_params = {k: p + updates[k] for k, p in params.items()}
  popart = state.popart
  if popart is not None:
    popart = popart_lib.update_from_moments(state.popart, *moments,
                                            beta=config.popart_beta)
    new_params = popart_lib.apply_preservation(new_params, state.popart,
                                               popart)
    sig = popart_lib.sigma(popart)
    metrics['popart_sigma_min'] = torch.min(sig)
    metrics['popart_sigma_max'] = torch.max(sig)
  if config.health_watchdog:
    step_ok = (torch.isfinite(metrics['total_loss']) &
               torch.isfinite(metrics['grad_norm']))
    keep = lambda new, old: {k: torch.where(step_ok, new[k], old[k])  # noqa: E731
                             for k in new}
    new_params = keep(new_params, params)
    opt_state = RMSPropState(
        count=torch.where(step_ok, opt_state.count, state.opt_state.count),
        nu=keep(opt_state.nu, state.opt_state.nu),
        trace=(None if opt_state.trace is None
               else keep(opt_state.trace, state.opt_state.trace)))
    if popart is not None:
      popart = popart_lib.PopArtState(**keep(popart._asdict(),
                                             state.popart._asdict()))
    metrics['step_ok'] = step_ok.float()
  for k, p in params.items():
    p.copy_(new_params[k])
  metrics['learning_rate'] = schedule(state.update_steps)
  new_state = state._replace(opt_state=opt_state,
                             update_steps=state.update_steps + 1,
                             popart=popart)
  if (state.target_params is not None and
      (state.update_steps + 1) % config.target_update_interval == 0):
    # The refresh: the target takes the kept parameters, and the
    # statistics with them, in place.
    for k, t in state.target_params.items():
      t.copy_(params[k])
    new_state = new_state._replace(target_popart=_copy_popart(popart))
  return new_state, metrics


def _member_schedule(unit_schedule, learning_rate):
  """A population member's schedule: its learning rate (a 0-d tensor)
  times the unit-rate schedule's decay."""
  return lambda count: learning_rate * unit_schedule(count)


def make_train_step_fn(agent, config: Config, mesh=None):
  """The train step: (TrainState, batch) -> (TrainState, metrics).

  The returned state holds the same parameter tensors, updated in place.
  Metrics are 0-d device tensors; reading one waits for the device. With
  `health_watchdog` a non-finite loss or gradient norm keeps the old
  parameters, optimizer state and PopArt statistics (one `where` per
  tensor, no host sync) and `update_steps` still advances.

  With `mesh` the batch is this rank's shard (parallel/train_parallel.py
  places it), the gradients, losses and PopArt batch moments are summed
  over the ranks, and the metrics are the global batch's."""
  schedule = make_schedule(config)

  def train_step(state: TrainState, batch: ActorOutput):
    params = state.params
    total_loss, metrics, aux = loss_fn(
        agent, batch, config, mesh=mesh, popart_state=state.popart,
        target_params=state.target_params,
        target_popart=state.target_popart)
    grads = dict(zip(params, torch.autograd.grad(total_loss,
                                                 list(params.values()))))
    with torch.no_grad():
      moments = popart_moments(state, aux)
      if mesh is not None:
        grads, metrics, moments = _all_reduce_sum(mesh, grads, metrics,
                                                  moments=moments)
      # Pre-clip norm: explosions stay visible even with clipping on.
      return apply_gradients(state, grads, metrics, config, schedule,
                             moments=moments)

  return train_step


def _split_columns(returns, sizes):
  """A V-trace result over stacked columns, back to one per member."""
  parts = [torch.split(x, sizes, dim=1) for x in returns]
  return [type(returns)(*(p[k] for p in parts)) for k in range(len(sizes))]


def make_vectorized_train_step_fn(agents, config: Config):
  """One train step of a population's members in lockstep (JAX vmaps its
  traced-hypers step over a member axis): (states, batches, hypers) ->
  (states, metrics list), hypers {'learning_rate', 'entropy_cost'} of
  [P] float32 tensors.

  Every member's forward runs first; then V-trace runs once over the
  members' columns stacked to [T, P*B] (one launch of the fused kernel:
  each column is its own recursion, so this is each member's V-trace);
  then each member's losses, one backward over their sum (the members'
  parameters are disjoint, so each gets its own gradient), and each
  member's RMSProp at its own rate. A member whose loss or gradient is
  not finite skips its own update alone. Member k's result is that of
  `make_train_step_fn(agents[k], config_k)` on its state and batch,
  config_k holding member k's hypers (the step a serial population
  member runs)."""
  unit = make_schedule(dataclasses.replace(config, learning_rate=1.0))

  def train_step(states, batches, hypers):
    fwds = [loss_forward(agent, batch, config, popart_state=state.popart,
                         target_params=state.target_params,
                         target_popart=state.target_popart)
            for agent, state, batch in zip(agents, states, batches)]
    srcs = [f.vtrace_src for f in fwds]
    stacked = VTraceInputs(*(
        torch.cat([getattr(s, name) for s in srcs],
                  dim=0 if name == 'bootstrap_value' else 1)
        for name in VTraceInputs._fields))
    returns = _split_columns(run_vtrace(stacked, config),
                             [s.actions.shape[1] for s in srcs])
    totals, metrics, auxes = [], [], []
    for k, (fwd, state, batch) in enumerate(zip(fwds, states, batches)):
      total, m, aux = loss_from_vtrace(
          fwd, returns[k], batch, config, popart_state=state.popart,
          entropy_cost=hypers['entropy_cost'][k])
      totals.append(total)
      metrics.append(m)
      auxes.append(aux)
    flat = [p for state in states for p in state.params.values()]
    flat_grads = iter(torch.autograd.grad(sum(totals), flat))
    out_states, out_metrics = [], []
    with torch.no_grad():
      for k, state in enumerate(states):
        grads = {name: next(flat_grads) for name in state.params}
        new_state, m = apply_gradients(
            state, grads, metrics[k], config,
            _member_schedule(unit, hypers['learning_rate'][k]),
            moments=popart_moments(state, auxes[k]))
        out_states.append(new_state)
        out_metrics.append(m)
    return out_states, out_metrics

  return train_step


def state_tree(state: TrainState) -> Dict[str, Any]:
  """The TrainState as `state_to_payload`'s dicts, of its own tensors (no
  copy): what `load_state_` copies from, on device."""
  opt = state.opt_state
  tree = {'params': dict(state.params),
          'opt_state': {'count': opt.count, 'nu': dict(opt.nu),
                        'trace': None if opt.trace is None
                        else dict(opt.trace)},
          'update_steps': int(state.update_steps)}
  for name in ('popart', 'target_popart'):
    if getattr(state, name) is not None:
      tree[name] = getattr(state, name)._asdict()
  if state.target_params is not None:
    tree['target_params'] = dict(state.target_params)
  return tree


def pinned_empty(shape, dtype) -> np.ndarray:
  """An uninitialised numpy array in pinned (page-locked) host memory:
  the allocator `actor.batch_unrolls` stacks a CUDA learner's batches
  into, so their copy to the card is asynchronous. The array keeps its
  pinned tensor alive."""
  torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
  return torch.empty(shape, dtype=torch_dtype, pin_memory=True).numpy()


def place_batch(batch: ActorOutput, device, copy_stream=None,
                consumer_stream=None) -> ActorOutput:
  """A host numpy [T+1, B] ActorOutput (actor.batch_unrolls) as tensors
  on `device`, with the dtypes the Anakin path builds: actions int64,
  the rest as the actors wrote them (float32 rewards, logits, baselines,
  returns and carry; int32 episode steps, level ids and instruction ids;
  bool done; uint8 frames).

  On CUDA the copies run on `copy_stream` (a side stream, so they
  overlap the learner's step) from pinned memory (`pinned_empty`), and
  this call returns once they are complete; each tensor is marked as
  used on `consumer_stream` (default: the current stream), so the
  allocator does not hand its memory back to the side stream while the
  learner still reads it."""
  device = torch.device(device)
  host = map_structure(lambda x: torch.from_numpy(np.ascontiguousarray(x)),
                       batch)

  def to_device(non_blocking):
    placed = map_structure(
        lambda t: t.to(device, non_blocking=non_blocking), host)
    actions = placed.agent_outputs.action.long()
    return placed._replace(
        agent_outputs=placed.agent_outputs._replace(action=actions))

  if device.type != 'cuda':
    return to_device(False)
  consumer = consumer_stream or torch.cuda.current_stream(device)
  stream = copy_stream or consumer
  with torch.cuda.stream(stream):
    placed = to_device(True)
    done = torch.cuda.Event()
    done.record(stream)
  done.synchronize()  # the pinned source may be freed after return
  consumer.wait_event(done)
  map_structure(lambda t: t.record_stream(consumer), placed)
  return placed
