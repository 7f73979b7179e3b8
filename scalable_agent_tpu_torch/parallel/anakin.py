"""Anakin: acting and learning in one device step, ported from
scalable_agent_tpu/parallel/anakin.py.

The environment is a batched state machine on the device (ENV_CORES:
the bandit, cue memory, and envs/jittable.py's gridworld and procgen),
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
the ranks. Every rank draws the env's randomness and the acting noise at
the global batch shape from the same generators and keeps its own
columns, so a D-rank run follows the 1-rank run up to the order of the
gradient sum. Frames are counted globally; only rank 0 writes the logdir.
Unlike the JAX module, whose fused step builds its train step without
the mesh, the train step runs the sharded V-trace kernel (K1b) on each
rank's columns: the same function, since each column is its own
recursion.

The level curriculum (population.py) rides in the fused step of the
procgen core: the unroll's TD errors score the levels each transition was
played in, and the core draws new levels from the scores. Under a mesh
the segment sums and counts are summed over the ranks before the EMA, so
every rank keeps the same table.

The learner extensions pass through as in the JAX module: PopArt with
one task (the batch's task ids are zeros), pixel control on the core's
frames, the instruction encoder on its all-pad ids.

Also here: the population's lockstep step (`make_vectorized_anakin_step`,
JAX's vmap of the fused step over members) and the fleet's hybrid filler
(`HybridFiller`, Anakin self-play on the fleet's idle learner).
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
from scalable_agent_tpu_torch import population
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.envs import jittable
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.models.agent import make_step_fn
from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.parallel.sharding import (DATA_AXIS,
                                                       MODEL_AXIS,
                                                       shard_range)
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)


class EnvCoreState(NamedTuple):
  """Batched env state (all [B] unless noted)."""
  rng: Any              # torch.Generator on the env's device
  context: Any          # int64 [B] — the bandit target / memory cue
  step_in_episode: Any  # int32 [B]
  episode_return: Any   # f32 [B] — flow-style carried stats
  episode_frames: Any   # int32 [B]


def _frame_from_channel(channel, batch, height, width, visible=None):
  """uint8 [B, H, W, 3] with `channel`'s plane at 255 (masked per env by
  `visible`)."""
  plane = F.one_hot(channel, 3).float() * 255.0
  if visible is not None:
    plane = plane * visible[:, None].float()
  plane = plane.to(torch.uint8)
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


class CueMemoryCore(BanditCore):
  """The cue-memory task (envs/fake.py CueMemoryEnv) as batched tensors:
  two-step episodes, the cue (a colour channel) visible only on the
  first frame, 2.0 for action 0 on the first step, and 1 on the second
  for the action that names the cue. A 3-action task."""

  def __init__(self, height=16, width=16, episode_length=2,
               num_action_repeats=1, num_actions=3, shard=(0, 1)):
    del episode_length  # fixed two-step episodes, as the host env's
    if num_actions != 3:
      raise ValueError('CueMemoryCore is a 3-action task (one action '
                       'per RGB cue channel); got num_actions='
                       f'{num_actions}')
    super().__init__(height=height, width=width, episode_length=2,
                     num_action_repeats=num_action_repeats, num_actions=3,
                     shard=shard)

  def _observation(self, state):
    b = state.context.shape[0]
    visible = state.step_in_episode == 0  # the cue before the 1st action
    frame = _frame_from_channel(state.context, b, self.height, self.width,
                                visible)
    instr = torch.zeros((b, MAX_INSTRUCTION_LEN), dtype=torch.int32,
                        device=state.context.device)
    return (frame, instr)

  def step(self, state: EnvCoreState, action
           ) -> Tuple[EnvCoreState, StepOutput]:
    first = state.step_in_episode == 0
    reward = torch.where(first, torch.where(action == 0, 2.0, 0.0),
                         (action == state.context).float())
    done = ~first
    ep_return = state.episode_return + reward
    ep_frames = state.episode_frames + self.num_action_repeats
    info = StepOutputInfo(ep_return, ep_frames)
    fresh = self._sample_context(state.rng, action.shape[0])
    new_state = EnvCoreState(
        rng=state.rng,
        context=torch.where(done, fresh, state.context),
        step_in_episode=torch.where(done, 0, 1).to(torch.int32),
        episode_return=torch.where(done, 0.0, ep_return),
        episode_frames=torch.where(done, 0, ep_frames))
    output = StepOutput(reward=reward, info=info, done=done,
                        observation=self._observation(new_state))
    return new_state, output


# The on-device cores: the two CI cores and envs/jittable.py's family,
# whose cores are also the fleet's gridworld and procgen host envs.
# config.JITTABLE_BACKENDS holds these names.
ENV_CORES = {'bandit': BanditCore, 'cue_memory': CueMemoryCore,
             **jittable.JITTABLE_CORES}


def _check_divisible(config: Config, mesh):
  if mesh is not None and config.batch_size % mesh.shape[DATA_AXIS]:
    raise ValueError(
        f'batch_size={config.batch_size} not divisible by the data axis '
        f'({mesh.shape[DATA_AXIS]} ranks)')


def _shard(mesh):
  return (0, 1) if mesh is None else (mesh.rank, mesh.shape[DATA_AXIS])


def make_env_core(config: Config, mesh=None,
                  num_actions: Optional[int] = None):
  """The env core a config names; with `mesh`, this rank's block of the
  batch. Its head width is `num_actions` (the filler passes the fleet
  task's), else config.num_actions, else the core's default; a core that
  cannot take the width raises (CueMemoryCore is fixed at 3, the
  gridworld needs >= 4). Procgen takes the level-set and curriculum
  fields."""
  if config.env_backend not in ENV_CORES:
    raise ValueError(
        f'anakin needs an on-device env core, got {config.env_backend!r} '
        f'(the port has: {", ".join(sorted(ENV_CORES))}); real simulators '
        'use the fleet runtime')
  kwargs = dict(height=config.height, width=config.width,
                episode_length=config.episode_length,
                num_action_repeats=config.num_action_repeats,
                shard=_shard(mesh))
  if config.env_backend == 'procgen':
    kwargs.update(num_levels=config.procgen_num_levels,
                  wall_density=config.procgen_wall_density,
                  curriculum=config.curriculum,
                  curriculum_temperature=config.curriculum_temperature,
                  curriculum_eps=config.curriculum_eps)
  width = num_actions if num_actions is not None else config.num_actions
  if width is not None:
    kwargs['num_actions'] = width
  return ENV_CORES[config.env_backend](**kwargs)


class AnakinCarry(NamedTuple):
  """Everything that persists across fused steps (all on the device)."""
  train_state: Any   # learner.TrainState
  env_state: Any     # EnvCoreState
  env_output: Any    # StepOutput [B] — the pending overlap timestep
  agent_output: Any  # AgentOutput [B] — ditto
  core_state: Any    # LSTM carry (c, h) [B, hidden]
  rng: Any           # torch.Generator for action sampling


class EnvCarry(NamedTuple):
  """AnakinCarry less the train state: what the fused loop threads
  besides it. The hybrid filler keeps its own across fill steps and
  borrows the fleet's live train state for each."""
  env_state: Any
  env_output: Any
  agent_output: Any
  core_state: Any
  rng: Any


def init_env_carry(agent, env_core, config: Config, seeder: torch.Generator,
                   device, mesh=None) -> EnvCarry:
  """The initial env and agent-side carry: the env's generator and the
  action sampler's, on `device`, each seeded from the CPU generator
  `seeder` in that order; under `mesh` this rank's columns of the env
  state, pending outputs and LSTM carry."""
  _check_divisible(config, mesh)
  device = torch.device(device)

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
  return EnvCarry(env_state, env_output, agent_output, core_state,
                  generator())


def init_carry(agent, env_core, config: Config, seed: int,
               device, mesh=None) -> AnakinCarry:
  """Initial params/optimizer/env/agent state for `make_anakin_step`.

  Initialises `agent` in place from a CPU generator seeded with `seed`
  (so the params do not depend on the device), moves it to `device`, and
  seeds the env's and the action sampler's generators on `device` from
  the same stream (`init_env_carry`).

  With `mesh` (whose env core is `make_env_core(config, mesh)`), the env
  state, pending outputs and LSTM carry are this rank's B/D columns, and
  the params are rank 0's (train_parallel.make_sharded_train_state)."""
  _check_divisible(config, mesh)
  seeder = torch.Generator().manual_seed(seed)
  init_params(agent, seeder)
  agent.to(torch.device(device))
  env = init_env_carry(agent, env_core, config, seeder, device, mesh=mesh)
  if mesh is None:
    train_state = learner.make_train_state(agent, config)
  else:
    train_state = train_parallel.make_sharded_train_state(agent, config,
                                                          mesh)
  return AnakinCarry(train_state, *env)


def _uses_curriculum(config: Config, env_core) -> bool:
  """Whether the fused step updates level scores: a curriculum mode and
  a core with a finite level set (procgen)."""
  return config.curriculum != 'uniform' and hasattr(env_core, 'num_levels')


def _act(act, env_core, carry, t: int, track_levels: bool):
  """T acting steps from `carry` with the pre-update params: the [T+1, B]
  batch with the overlap frame, the final env carry, and with
  `track_levels` the pre-step level id of each transition ([T] of [B]:
  the level it was played in; the step resamples at done)."""
  env_state, env_output, agent_output, core_state = (
      carry.env_state, carry.env_output, carry.agent_output,
      carry.core_state)
  env_outputs, agent_outputs, level_ids = [env_output], [agent_output], []
  for _ in range(t):
    # The T=1 call of the same agent the learner unrolls — one model.
    agent_output, core_state = act(carry.rng, agent_output.action,
                                   env_output, core_state)
    if track_levels:
      level_ids.append(env_state.level_id)
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
  env = EnvCarry(env_state, env_output, agent_output, core_state, carry.rng)
  return batch, env, level_ids


def _curriculum_update(config: Config, batch, env_state, level_ids,
                       mesh=None):
  """The per-level score update from this unroll's TD errors (JAX's
  alignment): baseline[i] = V(o_{i-1}) and reward[i]/done[i] describe
  the o_{i-1} -> o_i transition, so the T-1 transitions i in [1, T) have
  delta_i = r[i] + gamma (1 - d[i]) V(o_i) - V(o_{i-1}), with V(o_i) =
  baseline[i+1], played in level_ids[i-1]. Returns (env_state, the
  curriculum metrics)."""
  t = config.unroll_length
  v = batch.agent_outputs.baseline                        # [T+1, B]
  r = batch.env_outputs.reward
  d = batch.env_outputs.done.float()
  delta = (r[1:t] + config.discounting * (1.0 - d[1:t]) * v[2:]
           - v[1:t])                                      # [T-1, B]
  signal = population.score_signal(delta, config.curriculum)
  ids = (torch.stack(level_ids[:t - 1]) if t > 1 else
         torch.zeros((0,) + delta.shape[1:], dtype=torch.int64,
                     device=delta.device))
  scores, visits = population.update_scores(
      env_state.level_scores, env_state.level_visits, ids, signal,
      config.curriculum_alpha, config.curriculum_decay,
      all_reduce=None if mesh is None else mesh.all_reduce_sum_)
  env_state = env_state._replace(level_scores=scores, level_visits=visits)
  return env_state, population.curriculum_metrics(
      scores, visits, config.curriculum_temperature, config.curriculum_eps)


def _mean_reward(config: Config, batch, mesh=None):
  rewards = batch.env_outputs.reward[1:]
  if mesh is None:
    return torch.mean(rewards)
  return mesh.all_reduce_sum_(rewards.sum().reshape(1))[0] / (
      config.unroll_length * config.batch_size)


def _freeze_clocks(new_state, old_state):
  """`new_state` with `old_state`'s update_steps and RMSProp count: an
  update that moves no clock (the filler's)."""
  return new_state._replace(
      update_steps=old_state.update_steps,
      opt_state=new_state.opt_state._replace(
          count=old_state.opt_state.count))


def make_anakin_step(agent, env_core, config: Config,
                     return_batch: bool = False, train_step_fn=None,
                     mesh=None, advance_steps: bool = True):
  """One fused step: act T steps, then the SGD update.

  Returns `f(carry) -> (carry, metrics)`; metrics are 0-d device tensors,
  of the global batch under `mesh`. With `return_batch` the assembled
  [T+1, B] ActorOutput (this rank's columns) is added to the metrics
  under 'batch'. With a curriculum on a procgen core the metrics hold
  the `curriculum_*` scalars.

  `train_step_fn` (the hybrid filler): a train step built elsewhere — the
  fleet config's, so its losses, its IMPACT target and its schedule stay
  the fleet's while `config` only shapes the rollout.
  `advance_steps=False` keeps update_steps and the RMSProp count (the
  schedule's clock) where they were: the filler's updates move none of
  the fleet's clocks."""
  if train_step_fn is None:
    train_step_fn = learner.make_train_step_fn(agent, config, mesh=mesh)
  act = make_step_fn(agent, sample_shard=_shard(mesh))
  t = config.unroll_length
  use_curriculum = _uses_curriculum(config, env_core)

  def anakin_step(carry: AnakinCarry):
    batch, env, level_ids = _act(act, env_core, carry, t, use_curriculum)
    # Fault site 'nan_burst' (runtime/faults.py): NaN rewards for the
    # learner, as the fleet's staged batch gets them.
    learn_batch, _ = faults.maybe_poison_batch(batch)
    train_state, metrics = train_step_fn(carry.train_state, learn_batch)
    if not advance_steps:
      train_state = _freeze_clocks(train_state, carry.train_state)
    metrics['mean_reward'] = _mean_reward(config, batch, mesh)
    if use_curriculum:
      env_state, curriculum = _curriculum_update(
          config, batch, env.env_state, level_ids, mesh)
      env = env._replace(env_state=env_state)
      metrics.update(curriculum)
    if return_batch:
      metrics['batch'] = batch
    return AnakinCarry(train_state, *env), metrics

  return anakin_step


def make_vectorized_anakin_step(agents, env_core, config: Config,
                                return_batch: bool = False):
  """The population's lockstep step (JAX's vmap of the fused step over a
  member axis): `f(carries, hypers) -> (carries, metrics)` over P
  members, each with its own agent (`agents[k]`), carry and generators,
  and `hypers` {'learning_rate', 'entropy_cost'} of [P] float32 tensors
  (changing them rebuilds nothing). Each member acts T steps; then one
  train step of every member (learner.make_vectorized_train_step_fn: one
  V-trace launch over the members' [T, P*B] columns); metrics are {name:
  [P] tensor}. Member k's result is a fused step of member k alone with
  its hypers."""
  acts = [make_step_fn(agent) for agent in agents]
  train_step = learner.make_vectorized_train_step_fn(agents, config)
  t = config.unroll_length
  use_curriculum = _uses_curriculum(config, env_core)

  def step(carries, hypers):
    acted = [_act(act, env_core, carry, t, use_curriculum)
             for act, carry in zip(acts, carries)]
    batches = [batch for batch, _, _ in acted]
    states, metrics = train_step([c.train_state for c in carries],
                                 batches, hypers)
    out = []
    for k, (batch, env, level_ids) in enumerate(acted):
      metrics[k]['mean_reward'] = _mean_reward(config, batch)
      if use_curriculum:
        env_state, curriculum = _curriculum_update(config, batch,
                                                   env.env_state, level_ids)
        env = env._replace(env_state=env_state)
        metrics[k].update(curriculum)
      out.append(AnakinCarry(states[k], *env))
    stacked = {name: torch.stack([m[name] for m in metrics])
               for name in metrics[0]}
    if return_batch:
      stacked['batch'] = batches
    return out, stacked

  return step


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


def init_members(config: Config, env_core, seeds, device):
  """A population's members: one agent each (`driver.build_agent`) and
  its initial carry from its seed (`init_carry`). Returns (agents,
  carries)."""
  agents, carries = [], []
  for seed in seeds:
    agent = driver.build_agent(config, env_core.num_actions)
    carries.append(init_carry(agent, env_core, config, seed, device))
    agents.append(agent)
  return agents, carries


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


def supports_filler(config: Config, mesh=None) -> Tuple[bool, str]:
  """Whether this topology can run the hybrid filler: (ok, reason). A
  topology it cannot run on parks idle slices with a warning (the run
  stays correct, just unfilled); a bad knob raises at the filler's
  construction instead."""
  if distributed.world_size() > 1:
    # Idle slices are per process, but a filler step under a group
    # would be a collective: unsynchronised calls deadlock,
    # synchronised ones stall the busy ranks.
    return False, ('multi-process topology: filler steps are '
                   'collectives but idle slices are per-host')
  if mesh is None:
    return True, ''
  if mesh.shape[MODEL_AXIS] > 1:
    return False, 'the anakin filler is data-parallel only (model-' \
                  'axis mesh in use)'
  data = mesh.shape[DATA_AXIS]
  if config.resolved_filler_batch_size % data != 0:
    return False, (f'filler batch {config.resolved_filler_batch_size} '
                   f'not divisible by the data axis ({data} devices)')
  return True, ''


class HybridFiller:
  """Anakin self-play on the fleet's idle learner: when the prefetcher
  has no staged batch (`BatchPrefetcher.ready()`), the fleet loop
  (driver.train) runs `fill_one`, one fused step on the live train state,
  and probes again, so a staged batch waits for at most one filler step
  (`fill_one` returns after the step has finished). IMPACT's tolerance of
  stale data (arXiv 1912.00167) is why off-cadence updates from another
  stream are legal, and why validate_runtime warns without it.

  The clocks: the train step is built from the fleet's config (its
  losses, IMPACT target and schedule) and runs with advance_steps=False,
  so update_steps, the LR's count, the frame budget and the checkpoint
  numbering stay on the fleet's fresh frames; the filler's updates and
  frames are counted here, apart. Its env, pending outputs, LSTM carry
  and generators persist here across fill steps, seeded from
  config.seed + 7777. Data-parallel only: a model-axis mesh raises. Its
  updates also count on the registry's `driver/filler_updates`, which
  close() unregisters."""

  def __init__(self, agent, config: Config, num_actions: int, device,
               mesh=None):
    backend = config.resolved_filler_backend
    if backend not in ENV_CORES:
      raise ValueError(
          f'filler backend {backend!r} is not an on-device env core '
          f'(available: {sorted(ENV_CORES)})')
    if mesh is not None and mesh.shape[MODEL_AXIS] > 1:
      raise ValueError('the anakin filler is data-parallel only '
                       '(model-axis mesh in use)')
    self._config = dataclasses.replace(
        config, env_backend=backend,
        batch_size=config.resolved_filler_batch_size,
        unroll_length=config.resolved_filler_unroll_length,
        num_actions=None)
    core = make_env_core(self._config, mesh, num_actions=num_actions)
    train_fn = learner.make_train_step_fn(agent, config, mesh=mesh)
    self._step = make_anakin_step(agent, core, self._config,
                                  train_step_fn=train_fn, mesh=mesh,
                                  advance_steps=False)
    self._env = init_env_carry(
        agent, core, self._config,
        torch.Generator().manual_seed(config.seed + 7777), device, mesh=mesh)
    self.backend = backend
    self.updates = 0
    self.skipped = 0
    self._counter = telemetry.counter('driver/filler_updates')
    self.frames_per_update = (self._config.batch_size *
                              self._config.unroll_length *
                              config.num_action_repeats)

  @property
  def frames(self) -> int:
    """The filler's env frames, never counted in the fleet's budget."""
    return self.updates * self.frames_per_update

  def fill_one(self, train_state):
    """One fused self-play step on `train_state` (updated in place, its
    clocks kept); returns after the step has finished, with the new
    train state. A step the watchdog withheld (non-finite) counts in
    `skipped`."""
    carry, metrics = self._step(AnakinCarry(train_state, *self._env))
    if 'step_ok' in metrics:
      if float(metrics['step_ok']) < 0.5:
        self.skipped += 1
    else:
      float(metrics['total_loss'])  # the step's completion
    self.updates += 1
    self._counter.inc()
    self._env = EnvCarry(*carry[1:])
    return carry.train_state

  def stats(self):
    return {'updates': self.updates, 'frames': self.frames,
            'skipped': self.skipped, 'backend': self.backend,
            'batch_size': self._config.batch_size,
            'unroll_length': self._config.unroll_length}

  def close(self):
    """Unregister the per-run counter (identity-checked: closing an old
    filler never evicts a newer one's registration), so a later run in
    the process does not snapshot this run's tally."""
    telemetry.registry().unregister(self._counter.name, self._counter)
