"""Anakin: acting and learning in one device step, ported from
scalable_agent_tpu/parallel/anakin.py.

The environment is a batched state machine on the device (BanditCore),
so a step acts T times with the agent's T=1 call, assembles the [T+1, B]
batch with the 1-frame overlap, and runs the learner's train step on it —
no host transport and no inference server. Semantics follow the JAX
module:

- acting uses the *pre-update* params of the same step, so behaviour ==
  target at loss time for the T timesteps acted this step; the t=0 overlap
  timestep carries one update of policy lag;
- `agent_state` is the LSTM carry at unroll start; episode stats flow
  through the trajectory (the emitted StepOutputInfo carries the final
  stats at done, the carried state resets them);
- the first env output has done=True and a zero priming agent output.

PyTorch runs it eagerly: the JAX `lax.scan` over acting steps is a Python
loop, and acting records no autograd graph.

Scale-out over a mesh (parallel/mesh.py), the JAX module's data-parallel
form: each rank holds B/D environments, their LSTM carry and pending
outputs, acts and learns on them, and the learner sums the gradients over
the ranks. Every rank draws the env contexts and the acting noise at the
global batch shape from the same generators and keeps its own columns,
so a D-rank run follows the 1-rank run up to the order of the gradient
sum. Frames are counted globally; only rank 0 writes the logdir. Unlike
the JAX module, whose fused step builds its train step without the mesh,
the train step runs the sharded V-trace kernel (K1b) on each rank's
columns: the same function, since each column is its own recursion.

The JAX module's vectorized population and hybrid filler are later
slices, as are its other env cores (ROADMAP.md).
"""

import dataclasses
import json
import os
import sys
import time
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch import observability
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.models.agent import make_step_fn
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.parallel.sharding import (DATA_AXIS,
                                                       shard_range)
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

MAX_INSTRUCTION_LEN = 16  # the JAX package's instruction length


class EnvCoreState(NamedTuple):
  """Batched env state (all [B] unless noted)."""
  rng: Any              # torch.Generator on the env's device
  context: Any          # int64 [B] — the bandit target
  step_in_episode: Any  # int32 [B]
  episode_return: Any   # f32 [B] — flow-style carried stats
  episode_frames: Any   # int32 [B]


def _frame_from_channel(channel, batch, height, width):
  """uint8 [B, H, W, 3] with `channel`'s plane at 255."""
  plane = (F.one_hot(channel, 3).float() * 255.0).to(torch.uint8)
  return plane[:, None, None, :].expand(batch, height, width, 3)


class BanditCore:
  """The contextual bandit (envs/fake.py ContextualBanditEnv) as batched
  tensors: the frame's dominant colour channel is the rewarded action,
  `episode_length` steps per context. The rewarded channel is
  `randint(num_actions) % 3`, the host env's own draw, so a wider policy
  head (num_actions > 3) is legal.

  `shard=(index, count)`: the core's batch is block `index` of `count`
  equal blocks of a global batch, and each context draw is made for the
  global batch, keeping this block's."""

  def __init__(self, height=24, width=32, episode_length=5,
               num_action_repeats=1, num_actions=3, shard=(0, 1)):
    if num_actions < 1:
      raise ValueError(f'num_actions must be >= 1, got {num_actions}')
    self.height, self.width = height, width
    self.episode_length = episode_length
    self.num_action_repeats = num_action_repeats
    self.num_actions = num_actions
    self.shard = shard

  def _observation(self, state):
    b = state.context.shape[0]
    frame = _frame_from_channel(state.context, b, self.height, self.width)
    instr = torch.zeros((b, MAX_INSTRUCTION_LEN), dtype=torch.int32,
                        device=state.context.device)
    return (frame, instr)

  def _sample_context(self, rng, batch):
    index, count = self.shard
    start, stop = shard_range(batch * count, index, count)
    draw = torch.randint(0, self.num_actions, (batch * count,),
                         generator=rng, device=rng.device) % 3
    return draw[start:stop]

  def init(self, rng: torch.Generator, batch: int
           ) -> Tuple[EnvCoreState, StepOutput]:
    device = rng.device
    state = EnvCoreState(
        rng=rng,
        context=self._sample_context(rng, batch),
        step_in_episode=torch.zeros((batch,), dtype=torch.int32,
                                    device=device),
        episode_return=torch.zeros((batch,), device=device),
        episode_frames=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))
    # The actor's priming output: done=True (the first obs starts an
    # episode), zero reward and stats.
    output = StepOutput(
        reward=torch.zeros((batch,), device=device),
        info=StepOutputInfo(
            torch.zeros((batch,), device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device)),
        done=torch.ones((batch,), dtype=torch.bool, device=device),
        observation=self._observation(state))
    return state, output

  def step(self, state: EnvCoreState, action
           ) -> Tuple[EnvCoreState, StepOutput]:
    reward = (action == state.context).float()
    step_count = state.step_in_episode + 1
    done = step_count >= self.episode_length

    ep_return = state.episode_return + reward
    ep_frames = state.episode_frames + self.num_action_repeats
    info = StepOutputInfo(ep_return, ep_frames)  # emitted: incl. done
    fresh = self._sample_context(state.rng, action.shape[0])
    new_state = EnvCoreState(
        rng=state.rng,
        context=torch.where(done, fresh, state.context),
        step_in_episode=torch.where(done, 0, step_count),
        episode_return=torch.where(done, 0.0, ep_return),
        episode_frames=torch.where(done, 0, ep_frames))
    output = StepOutput(reward=reward, info=info, done=done,
                        observation=self._observation(new_state))
    return new_state, output


_LATER_CORES = ('cue_memory', 'gridworld', 'procgen')


def _check_divisible(config: Config, mesh):
  if mesh is not None and config.batch_size % mesh.shape[DATA_AXIS]:
    raise ValueError(
        f'batch_size={config.batch_size} not divisible by the data axis '
        f'({mesh.shape[DATA_AXIS]} ranks)')


def _shard(mesh):
  return (0, 1) if mesh is None else (mesh.rank, mesh.shape[DATA_AXIS])


def make_env_core(config: Config, mesh=None):
  """The env core a config names, with config.num_actions as its head
  width (None: the core's default); with `mesh`, this rank's block of
  the batch."""
  if config.env_backend in _LATER_CORES:
    raise NotImplementedError(
        f'env core {config.env_backend!r} is not in the PyTorch port yet '
        '(ROADMAP Queue A, Anakin env cores); the port runs bandit')
  if config.env_backend != 'bandit':
    raise ValueError(
        f'anakin needs an on-device env core, got {config.env_backend!r} '
        '(the port has: bandit); real simulators use the fleet runtime, '
        'a later slice')
  kwargs = dict(height=config.height, width=config.width,
                episode_length=config.episode_length,
                num_action_repeats=config.num_action_repeats,
                shard=_shard(mesh))
  if config.num_actions is not None:
    kwargs['num_actions'] = config.num_actions
  return BanditCore(**kwargs)


class AnakinCarry(NamedTuple):
  """Everything that persists across fused steps (all on the device)."""
  train_state: Any   # learner.TrainState
  env_state: Any     # EnvCoreState
  env_output: Any    # StepOutput [B] — the pending overlap timestep
  agent_output: Any  # AgentOutput [B] — ditto
  core_state: Any    # LSTM carry (c, h) [B, hidden]
  rng: Any           # torch.Generator for action sampling


def init_carry(agent, env_core, config: Config, seed: int,
               device, mesh=None) -> AnakinCarry:
  """Initial params/optimizer/env/agent state for `make_anakin_step`.

  Initialises `agent` in place from a CPU generator seeded with `seed`
  (so the params do not depend on the device), moves it to `device`, and
  seeds the env's and the action sampler's generators on `device` from
  the same stream.

  With `mesh` (whose env core is `make_env_core(config, mesh)`), the env
  state, pending outputs and LSTM carry are this rank's B/D columns, and
  the params are rank 0's (train_parallel.make_sharded_train_state)."""
  _check_divisible(config, mesh)
  device = torch.device(device)
  seeder = torch.Generator().manual_seed(seed)
  init_params(agent, seeder)
  agent.to(device)

  def generator():
    sub_seed = int(torch.randint(2**62, (), generator=seeder))
    return torch.Generator(device=device).manual_seed(sub_seed)

  start, stop = shard_range(config.batch_size, *_shard(mesh))
  b = stop - start
  env_state, env_output = env_core.init(generator(), b)
  agent_output = AgentOutput(  # the actor's priming output
      action=torch.zeros((b,), dtype=torch.int64, device=device),
      policy_logits=torch.zeros((b, env_core.num_actions), device=device),
      baseline=torch.zeros((b,), device=device))
  core_state = agent.initial_state(b, device=device)
  if mesh is None:
    train_state = learner.make_train_state(agent, config)
  else:
    train_state = train_parallel.make_sharded_train_state(agent, config,
                                                          mesh)
  return AnakinCarry(train_state, env_state, env_output, agent_output,
                     core_state, generator())


def make_anakin_step(agent, env_core, config: Config,
                     return_batch: bool = False, train_step_fn=None,
                     mesh=None):
  """One fused step: act T steps, then the SGD update.

  Returns `f(carry) -> (carry, metrics)`; metrics are 0-d device tensors,
  of the global batch under `mesh`. With `return_batch` the assembled
  [T+1, B] ActorOutput (this rank's columns) is added to the metrics
  under 'batch'."""
  if train_step_fn is None:
    train_step_fn = learner.make_train_step_fn(agent, config, mesh=mesh)
  act = make_step_fn(agent, sample_shard=_shard(mesh))
  t = config.unroll_length

  def anakin_step(carry: AnakinCarry):
    env_state, env_output, agent_output, core_state = (
        carry.env_state, carry.env_output, carry.agent_output,
        carry.core_state)
    env_outputs, agent_outputs = [env_output], [agent_output]
    for _ in range(t):
      # The T=1 call of the same agent the learner unrolls — one model,
      # with the pre-update params.
      agent_output, core_state = act(carry.rng, agent_output.action,
                                     env_output, core_state)
      env_state, env_output = env_core.step(env_state, agent_output.action)
      env_outputs.append(env_output)
      agent_outputs.append(agent_output)
    # T+1 assembly with the overlap frame (the actor's unroll()).
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    batch = ActorOutput(
        level_name=torch.zeros_like(env_output.reward, dtype=torch.int32),
        agent_state=carry.core_state,
        env_outputs=map_structure(stack, *env_outputs),
        agent_outputs=map_structure(stack, *agent_outputs))
    # Fault site 'nan_burst' (runtime/faults.py): NaN rewards for the
    # learner, as the fleet's staged batch gets them.
    learn_batch, _ = faults.maybe_poison_batch(batch)
    train_state, metrics = train_step_fn(carry.train_state, learn_batch)
    rewards = batch.env_outputs.reward[1:]
    if mesh is None:
      metrics['mean_reward'] = torch.mean(rewards)
    else:
      metrics['mean_reward'] = mesh.all_reduce_sum_(
          rewards.sum().reshape(1))[0] / (t * config.batch_size)
    if return_batch:
      metrics['batch'] = batch
    return (AnakinCarry(train_state, env_state, env_output, agent_output,
                        core_state, carry.rng),
            metrics)

  return anakin_step


def build_run(config: Config, device='cuda', mesh=None):
  """Shared construction for run()/train(): env core, agent, fused step,
  initial carry seeded from config.seed. `device` 'cuda' with no CUDA
  raises. With `mesh` the run is this rank's and its device the mesh's,
  which must be of `device`'s type; a batch the data axis does not
  divide, or a model axis (JAX's Anakin is data-parallel only), raises
  ValueError before any work."""
  if config.model_parallelism > 1:
    raise ValueError('runtime=anakin is data-parallel only; drop '
                     '--model_parallelism')
  _check_divisible(config, mesh)
  device = driver.resolve_device(device)
  driver.set_float32_precision()
  if mesh is not None:
    if mesh.device.type != device.type:
      raise ValueError(f'the mesh is on {mesh.device}, the run on {device}')
    device = mesh.device
  env_core = make_env_core(config, mesh)
  agent = driver.build_agent(config, env_core.num_actions)
  step = make_anakin_step(agent, env_core, config, mesh=mesh)
  carry = init_carry(agent, env_core, config, config.seed, device,
                     mesh=mesh)
  return env_core, agent, step, carry


def _to_host(metrics):
  return {k: (v if k == 'batch' else float(v)) for k, v in metrics.items()}


def run(config: Config, num_steps: int, device='cuda', mesh=None):
  """Build the run and take `num_steps` fused steps; returns (carry,
  list of metric dicts of floats, env_frames_per_sec). The first step
  (kernel builds, cuDNN set-up) is not timed; num_steps=1 has no timed
  window and reports nan. Under `mesh`, frames are the global batch's."""
  if num_steps < 1:
    raise ValueError(f'num_steps must be >= 1, got {num_steps}')
  _, _, step, carry = build_run(config, device=device, mesh=mesh)

  carry, metrics = step(carry)
  history = [metrics]
  float(metrics['total_loss'])  # warm-up barrier
  t0 = time.perf_counter()
  for _ in range(num_steps - 1):
    carry, metrics = step(carry)
    history.append(metrics)  # no per-step readback
  float(history[-1]['total_loss'])  # one readback as the timing barrier
  dt = time.perf_counter() - t0
  frames = (num_steps - 1) * config.frames_per_step
  fps = frames / dt if num_steps > 1 and dt > 0 else float('nan')
  return carry, [_to_host(m) for m in history], fps


def train(config: Config, max_steps: Optional[int] = None, device='cuda',
          mesh=None):
  """Operator-facing Anakin training (`python -m
  scalable_agent_tpu_torch.experiment --mode=anakin`): fused steps until
  total_environment_frames (or `max_steps` more), with config.json, JSONL
  summaries (total_loss, mean_reward, learning_rate,
  env_frames_per_sec) and checkpoint and resume in the TrainState layout
  of driver.train: the newest restorable step under `<logdir>/checkpoints`
  is restored at start (steps, frames and summary steps count on from
  it), `maybe_save` runs after every fused step, and the tail save after
  a good restore. Returns the final AnakinCarry.

  The carry's env and agent state is not checkpointed, as in the JAX
  module: actor-local state is not saved (the reference's rule). In a
  process group every rank trains; rank 0 writes the logdir and the
  checkpoints, its save decision is read every
  checkpoint_check_every_steps steps, and the tail save (a collective)
  runs on a clean exit only. The health ladder and the drain are
  driver.train_anakin's (`--mode=train --runtime=anakin`)."""
  _, _, step, carry = build_run(config, device=device, mesh=mesh)
  grouped = mesh is not None and mesh.size > 1
  checkpointer = driver.make_checkpointer(config, mesh)
  # A restore that raises (a config mismatch) ends the call before the
  # tail save could write a fresh state next to the old steps.
  carry = carry._replace(train_state=driver.restore_at_start(
      checkpointer, carry.train_state))
  base_steps = carry.train_state.update_steps
  writer = None
  if distributed.rank() == 0:
    os.makedirs(config.logdir, exist_ok=True)
    with open(os.path.join(config.logdir, 'config.json'), 'w') as f:
      json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    writer = observability.SummaryWriter(config.logdir)
  fps_meter = observability.FpsMeter()
  metrics = None

  def flush(step_num):
    if writer is None:
      return
    writer.scalars(
        {'total_loss': float(metrics['total_loss']),
         'mean_reward': float(metrics['mean_reward']),
         'learning_rate': float(metrics['learning_rate']),
         'env_frames_per_sec': fps_meter.fps()}, step=step_num)

  steps_done = 0
  flushed = base_steps
  try:
    last_summary = time.monotonic()
    while True:
      if (base_steps + steps_done) * config.frames_per_step >= (
          config.total_environment_frames):
        break
      if max_steps is not None and steps_done >= max_steps:
        break
      carry, metrics = step(carry)
      steps_done += 1
      fps_meter.update(config.frames_per_step)
      now = time.monotonic()
      if now - last_summary >= config.summary_secs:
        flushed = base_steps + steps_done
        flush(flushed)
        last_summary = now
      if not grouped:
        checkpointer.maybe_save(carry.train_state)
      elif steps_done % config.checkpoint_check_every_steps == 0:
        checkpointer.maybe_save(carry.train_state,
                                decision=checkpointer.group_should_save())
    if base_steps + steps_done > flushed:
      # A short run can finish inside one summary window.
      flush(base_steps + steps_done)
  finally:
    try:
      if sys.exc_info()[0] is None or not grouped:
        checkpointer.save(carry.train_state)
    finally:
      if writer is not None:
        writer.close()
  return carry
