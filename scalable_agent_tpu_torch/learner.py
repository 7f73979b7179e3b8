"""Learner: one SGD step over a [T+1, B] batch of unrolls, ported from
scalable_agent_tpu/learner.py (the V-trace branch).

The step runs the agent over the batch, aligns it (the 1-frame overlap),
computes V-trace, the three sum-reduced losses, and RMSProp with the
frame-driven linear learning-rate decay. PyTorch runs it eagerly; the
parameters are the agent's own tensors and are updated in place (the JAX
step returns new arrays and donates the old ones — the same memory
footprint, reached the PyTorch way).

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

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from scalable_agent_tpu_torch import losses as losses_lib
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


LOSS_KEYS = ('total_loss', 'pg_loss', 'baseline_loss', 'entropy_loss')


def loss_fn(agent, batch: ActorOutput, config: Config, mesh=None,
            params=None, tp=None, vtrace_axis='data'):
  """Total IMPALA loss for one batch: (loss, metrics). With `mesh` the
  batch is this rank's shard and so are the loss and metrics; its
  columns are the shard of the global batch over `vtrace_axis` (an axis
  of the mesh or a tuple of them). `params` ({name: tensor}) replace the
  agent's parameters for this call (torch.func.functional_call), and
  `tp` (a models.TensorParallel) runs the layers whose parameters are
  blocks as blocks."""
  args = (batch.agent_outputs.action, batch.env_outputs, batch.agent_state)
  if params is None:
    learner_outputs, _ = agent(*args)
  else:
    learner_outputs, _ = torch.func.functional_call(
        agent, params, args, {'tp': tp}, strict=False)
  inputs = align_batch(batch.env_outputs, batch.agent_outputs,
                       learner_outputs, config)
  vtrace_returns = vtrace.from_logits(
      behaviour_policy_logits=inputs.behaviour_logits,
      target_policy_logits=inputs.target_logits,
      actions=inputs.actions,
      discounts=inputs.discounts,
      rewards=inputs.rewards,
      values=inputs.values,
      bootstrap_value=inputs.bootstrap_value,
      use_associative_scan=config.use_associative_scan,
      use_pallas=config.use_pallas_vtrace, mesh=mesh, batch_axis=vtrace_axis,
      batch_size=config.batch_size if mesh is not None else None)
  pg_loss = losses_lib.compute_policy_gradient_loss(
      inputs.target_logits, inputs.actions, vtrace_returns.pg_advantages)
  baseline_loss = losses_lib.compute_baseline_loss(
      vtrace_returns.vs - inputs.values)
  entropy_loss = losses_lib.compute_entropy_loss(inputs.target_logits)
  total_loss = (pg_loss + config.baseline_cost * baseline_loss +
                config.entropy_cost * entropy_loss)
  metrics = {
      'total_loss': total_loss.detach(),
      'pg_loss': pg_loss.detach(),
      'baseline_loss': baseline_loss.detach(),
      'entropy_loss': entropy_loss.detach(),
  }
  return total_loss, metrics


def make_schedule(config: Config):
  """Linear learning-rate decay to 0 over total env frames, driven by the
  update count x frames-per-step; float32 arithmetic as in the
  reference. `count` is an int or an integer tensor (the result then
  lives on its device)."""
  fps = float(config.frames_per_step)

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


def make_train_state(agent, config: Config) -> TrainState:
  params = dict(agent.named_parameters())
  return TrainState(params=params, opt_state=rmsprop_init(params, config),
                    update_steps=0)


def state_to_payload(state: TrainState) -> Dict[str, Any]:
  """The TrainState as plain dicts of CPU tensors, the form a checkpoint
  holds (`torch.load(weights_only=True)` refuses NamedTuples):
  {'params', 'opt_state': {'count', 'nu', 'trace'}, 'update_steps'}."""
  host = lambda tree: {k: v.detach().to('cpu', copy=True)  # noqa: E731
                       for k, v in tree.items()}
  opt = state.opt_state
  return {'params': host(state.params),
          'opt_state': {'count': opt.count.detach().to('cpu', copy=True),
                        'nu': host(opt.nu),
                        'trace': None if opt.trace is None
                        else host(opt.trace)},
          'update_steps': int(state.update_steps)}


@torch.no_grad()
def load_state_(state: TrainState, payload: Dict[str, Any]) -> TrainState:
  """Copy a `state_to_payload` payload into `state`'s own tensors, on
  their device, and return a TrainState holding those same tensors.

  In place because the agent trains its own parameter tensors
  (`make_train_state`): a restore that rebound the dict would leave the
  agent training its old weights. The caller has checked the payload's
  structure against `state`."""
  for k, p in state.params.items():
    p.copy_(payload['params'][k])
  opt, saved = state.opt_state, payload['opt_state']
  opt.count.copy_(saved['count'])
  for k, v in opt.nu.items():
    v.copy_(saved['nu'][k])
  if opt.trace is not None:
    for k, v in opt.trace.items():
      v.copy_(saved['trace'][k])
  return TrainState(state.params, opt, int(payload['update_steps']))


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


def _all_reduce_sum(mesh, grads, metrics, axis='data'):
  """The gradients and the losses summed over the ranks of the mesh's
  `axis` (None: every rank), in one all-reduce of one flat float32
  buffer."""
  leaves = list(grads.values()) + [metrics[k] for k in LOSS_KEYS]
  flat = mesh.all_reduce_sum_(torch.cat([x.reshape(-1) for x in leaves]),
                              axis=axis)
  parts = [part.view_as(x) for part, x in
           zip(torch.split(flat, [x.numel() for x in leaves]), leaves)]
  metrics = dict(metrics, **dict(zip(LOSS_KEYS, parts[len(grads):])))
  return dict(zip(grads, parts)), metrics


@torch.no_grad()
def apply_gradients(state: TrainState, grads, metrics, config: Config,
                    schedule, g_norm=None):
  """RMSProp on `state`'s parameters with `grads` (the same keys and
  shapes), the health watchdog's keep-or-skip, and the in-place update;
  returns (TrainState, metrics). `g_norm` is the pre-clip global norm
  (None: computed from `grads`); it is reported as `grad_norm`."""
  params = state.params
  metrics['grad_norm'] = global_norm(grads) if g_norm is None else g_norm
  updates, opt_state = rmsprop_update(grads, state.opt_state, config,
                                      schedule, g_norm=metrics['grad_norm'])
  new_params = {k: p + updates[k] for k, p in params.items()}
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
    metrics['step_ok'] = step_ok.float()
  for k, p in params.items():
    p.copy_(new_params[k])
  metrics['learning_rate'] = schedule(state.update_steps)
  return TrainState(params, opt_state, state.update_steps + 1), metrics


def make_train_step_fn(agent, config: Config, mesh=None):
  """The train step: (TrainState, batch) -> (TrainState, metrics).

  The returned state holds the same parameter tensors, updated in place.
  Metrics are 0-d device tensors; reading one waits for the device. With
  `health_watchdog` a non-finite loss or gradient norm keeps the old
  parameters and optimizer state (one `where` per tensor, no host sync)
  and `update_steps` still advances.

  With `mesh` the batch is this rank's shard (parallel/train_parallel.py
  places it), the gradients and losses are summed over the ranks, and
  the metrics are the global batch's."""
  schedule = make_schedule(config)

  def train_step(state: TrainState, batch: ActorOutput):
    params = state.params
    total_loss, metrics = loss_fn(agent, batch, config, mesh=mesh)
    grads = dict(zip(params, torch.autograd.grad(total_loss,
                                                 list(params.values()))))
    with torch.no_grad():
      if mesh is not None:
        grads, metrics = _all_reduce_sum(mesh, grads, metrics)
      # Pre-clip norm: explosions stay visible even with clipping on.
      return apply_gradients(state, grads, metrics, config, schedule)

  return train_step


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
