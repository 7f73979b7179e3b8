"""On-device environment family, ported from
scalable_agent_tpu/envs/jittable.py: the gridworld and the procgen-style
level generator as batched tensor state machines.

- `GridworldCore`: a G x G navigation task. The agent spawns at the
  origin, a goal cell is drawn per episode, four movement actions, +1 at
  the goal. The simplest task whose policy must read the observation
  spatially (the bandit's is a one-pixel colour lookup).
- `ProcgenCore`: each episode plays a level id from a finite level set,
  and the level's walls are a fixed function of its id, so one config
  spans `num_levels` layouts as procgen's level sets do. Walls block
  movement; start and goal are fixed corners. A level's walls are
  `bernoulli(fold_in(PRNGKey(layout_seed), level_id), density, (G, G))`
  of JAX's default PRNG with both corners cleared, computed here by a
  numpy copy of threefry2x32 (`level_walls`), so level k is the same maze
  in both packages. The table of every level is built once, on the
  core's device, and gathered by level id.

Both follow the port's core protocol (parallel/anakin.py BanditCore):
`init(generator, batch)` and `step(state, action)` over a NamedTuple
state whose `rng` is the core's torch.Generator, flow-style episode
stats, and `shard=(index, count)`: the batch is block `index` of `count`
of a global batch, and every draw is made at the global batch from the
shared generator, keeping this block. The draws (goals, level ids) come
from explicit torch generators: JAX's distributions, not its streams.

The procgen state also carries the curriculum's per-level tables
(`level_scores`, `level_visits`, [num_levels], the same on every rank);
with `curriculum` other than 'uniform' a new episode's level is drawn
from population.sample_levels over the scores.

The dual registration: `GridworldEnv` and `ProcgenEnv` wrap the same
cores at batch 1 on the CPU as host environments (envs/base.py), which
envs/factory.py registers for the fleet runtime. They never touch CUDA,
so they run in the fleet's env processes, each on one torch thread.
"""

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from scalable_agent_tpu_torch import population
from scalable_agent_tpu_torch.envs import base
from scalable_agent_tpu_torch.models.instruction import MAX_INSTRUCTION_LEN
from scalable_agent_tpu_torch.parallel.sharding import shard_range
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

# --------------------------------------------------------------------
# JAX's default PRNG (threefry2x32, jax_threefry_partitionable=True), in
# numpy: what ProcgenCore's level layouts are defined by.
# --------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
  return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
  """The Threefry-2x32 block cipher (20 rounds) of JAX's PRNG on uint32
  arrays `x0`, `x1` under `key` (two uint32 words)."""
  k0, k1 = np.uint32(key[0]), np.uint32(key[1])
  ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
  x0 = np.asarray(x0, np.uint32) + ks[0]
  x1 = np.asarray(x1, np.uint32) + ks[1]
  for i in range(5):
    for r in _ROTATIONS[i % 2]:
      x0 = x0 + x1
      x1 = _rotl(x1, r) ^ x0
    x0 = x0 + ks[(i + 1) % 3]
    x1 = x1 + ks[(i + 2) % 3]
    x1 = x1 + np.uint32(i + 1)
  return x0, x1


def prng_key(seed: int) -> np.ndarray:
  """jax.random.PRNGKey(seed) for 0 <= seed < 2**32: [0, seed]."""
  return np.asarray([0, seed], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
  """jax.random.fold_in(key, data): threefry over the words [0, data]."""
  y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                        np.asarray([data], np.uint32))
  return np.concatenate([y0, y1])


def bernoulli(key, p: float, shape) -> np.ndarray:
  """jax.random.bernoulli(key, p, shape): uniform float32 from the bits
  `x0 ^ x1` of threefry over each flat index's (hi, lo) words, then
  `uniform < p`."""
  n = int(np.prod(shape))
  x0, x1 = threefry2x32(key, np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
  bits = (x0 ^ x1) >> np.uint32(9) | np.uint32(0x3F800000)
  uniform = bits.view(np.float32) - np.float32(1.0)
  return (uniform < np.float32(p)).reshape(shape)


def level_walls(layout_seed: int, level_id: int, grid: int,
                density: float) -> np.ndarray:
  """The procgen level's [grid, grid] wall mask, JAX's
  `bernoulli(fold_in(PRNGKey(layout_seed), level_id), density)` with the
  start and goal corners cleared."""
  walls = bernoulli(fold_in(prng_key(layout_seed), level_id), density,
                    (grid, grid))
  walls[0, 0] = False
  walls[grid - 1, grid - 1] = False
  return walls


# --------------------------------------------------------------------
# The cores.
# --------------------------------------------------------------------


def _zero_instr(batch, device):
  return torch.zeros((batch, MAX_INSTRUCTION_LEN), dtype=torch.int32,
                     device=device)


class GridworldState(NamedTuple):
  """Batched gridworld state ([B]-leading except rng)."""
  rng: Any              # torch.Generator on the env's device
  agent_yx: Any         # int64 [B, 2]
  goal_yx: Any          # int64 [B, 2]
  step_in_episode: Any  # int32 [B]
  episode_return: Any   # f32 [B]
  episode_frames: Any   # int32 [B]


class GridworldCore:
  """The G x G gridworld: reach the per-episode goal cell.

  Actions 0..3 move up/down/left/right (clamped at the borders); actions
  >= 4 are no-ops, so the head can be any width >= 4 (the hybrid filler
  runs the core under the main task's action space). Reaching the goal
  pays +1 and ends the episode; `episode_length` caps wandering.
  Observation: channel 0 the agent's cell, channel 1 the goal's, at 255
  (uint8 [B, H, W, 3])."""

  def __init__(self, height=24, width=32, episode_length=12,
               num_action_repeats=1, num_actions=4, grid_size=4,
               shard=(0, 1)):
    if num_actions < 4:
      raise ValueError('GridworldCore needs num_actions >= 4 (four '
                       f'movement actions), got {num_actions}')
    if grid_size < 2:
      raise ValueError(f'grid_size must be >= 2, got {grid_size}')
    self.height, self.width = height, width
    self.episode_length = episode_length
    self.num_action_repeats = num_action_repeats
    self.num_actions = num_actions
    self.grid = grid_size
    self.shard = shard
    moves = np.zeros((num_actions, 2), np.int64)
    moves[:4] = [(-1, 0), (1, 0), (0, -1), (0, 1)]  # rows past 3: no-ops
    rows = (np.arange(height) * grid_size) // max(height, 1)
    cols = (np.arange(width) * grid_size) // max(width, 1)
    self._host_tables = (rows, cols, moves)
    self._device_tables = {}

  def _on(self, device, name, host_value):
    """`host_value` as a tensor on `device`, made once per device."""
    key = (name, torch.device(device))
    if key not in self._device_tables:
      self._device_tables[key] = torch.as_tensor(host_value, device=device)
    return self._device_tables[key]

  def _tables(self, device):
    """(pixel -> cell row [H], pixel -> cell col [W], moves [A, 2]) on
    `device`."""
    return tuple(self._on(device, name, value) for name, value in
                 zip(('rows', 'cols', 'moves'), self._host_tables))

  def _draw(self, rng, batch, draw):
    """`draw(global_batch)` from `rng`, this shard's block."""
    index, count = self.shard
    start, stop = shard_range(batch * count, index, count)
    return draw(batch * count)[start:stop]

  def _sample_goal(self, rng, batch):
    """Uniform over the cells other than the spawn cell (0, 0)."""
    flat = self._draw(rng, batch, lambda n: torch.randint(
        1, self.grid * self.grid, (n,), generator=rng, device=rng.device))
    return torch.stack([flat // self.grid, flat % self.grid], dim=-1)

  def _cell_plane(self, yx):
    """[B, H, W] bool: the pixels of each env's cell `yx`."""
    rows, cols, _ = self._tables(yx.device)
    return ((rows[None, :, None] == yx[:, 0, None, None]) &
            (cols[None, None, :] == yx[:, 1, None, None]))

  def _third_plane(self, state):
    return torch.zeros_like(self._cell_plane(state.agent_yx))

  def _observation(self, state):
    planes = (self._cell_plane(state.agent_yx),
              self._cell_plane(state.goal_yx), self._third_plane(state))
    frame = torch.stack(planes, dim=-1).to(torch.uint8) * 255
    return (frame, _zero_instr(frame.shape[0], frame.device))

  def _initial(self, rng, batch):
    device = rng.device
    return GridworldState(
        rng=rng,
        agent_yx=torch.zeros((batch, 2), dtype=torch.int64, device=device),
        goal_yx=self._sample_goal(rng, batch),
        step_in_episode=torch.zeros((batch,), dtype=torch.int32,
                                    device=device),
        episode_return=torch.zeros((batch,), device=device),
        episode_frames=torch.zeros((batch,), dtype=torch.int32,
                                   device=device))

  def init(self, rng: torch.Generator, batch: int):
    state = self._initial(rng, batch)
    device = rng.device
    # The actor's priming output: done=True, zero reward and stats.
    output = StepOutput(
        reward=torch.zeros((batch,), device=device),
        info=StepOutputInfo(
            torch.zeros((batch,), device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device)),
        done=torch.ones((batch,), dtype=torch.bool, device=device),
        observation=self._observation(state))
    return state, output

  def _blocked(self, state, proposed):
    """Movement veto (ProcgenCore's walls)."""
    del state
    return torch.zeros(proposed.shape[:1], dtype=torch.bool,
                       device=proposed.device)

  def step(self, state, action) -> Tuple[Any, StepOutput]:
    _, _, moves = self._tables(action.device)
    proposed = torch.clamp(state.agent_yx + moves[action.long()], 0,
                           self.grid - 1)
    blocked = self._blocked(state, proposed)
    agent = torch.where(blocked[:, None], state.agent_yx, proposed)

    at_goal = torch.all(agent == state.goal_yx, dim=-1)
    reward = at_goal.float()
    step_count = state.step_in_episode + 1
    done = at_goal | (step_count >= self.episode_length)

    ep_return = state.episode_return + reward
    ep_frames = state.episode_frames + self.num_action_repeats
    info = StepOutputInfo(ep_return, ep_frames)  # emitted: incl. done
    fresh_goal, fresh_extra = self._fresh_episode(state.rng,
                                                  action.shape[0], state)
    new_state = self._replace_episode(
        state,
        agent_yx=torch.where(done[:, None], 0, agent),
        goal_yx=torch.where(done[:, None], fresh_goal, state.goal_yx),
        step_in_episode=torch.where(done, 0, step_count),
        episode_return=torch.where(done, 0.0, ep_return),
        episode_frames=torch.where(done, 0, ep_frames),
        done=done, fresh_extra=fresh_extra)
    output = StepOutput(reward=reward, info=info, done=done,
                        observation=self._observation(new_state))
    return new_state, output

  def _fresh_episode(self, rng, batch, state):
    """New-episode draws: (goal, extra), extra the subclass's. `state` is
    the pre-step state (the curriculum sampler reads its scores)."""
    del state
    return self._sample_goal(rng, batch), None

  def _replace_episode(self, state, done, fresh_extra, **fields):
    del done, fresh_extra
    return state._replace(**fields)


class ProcgenState(NamedTuple):
  """GridworldState, the per-env level id, and the curriculum's per-level
  tables ([num_levels], not [B]-leading: the same on every rank)."""
  rng: Any
  agent_yx: Any
  goal_yx: Any
  step_in_episode: Any
  episode_return: Any
  episode_frames: Any
  level_id: Any      # int64 [B] — index into the finite level set
  level_scores: Any  # f32 [num_levels] — curriculum priority EMAs
  level_visits: Any  # f32 [num_levels] — cumulative transition counts


class ProcgenCore(GridworldCore):
  """The procgen-style level set over the gridworld: per-episode level
  ids index `num_levels` wall layouts (`level_walls`); walls veto
  movement (the agent stays put); the goal is the far corner; channel 2
  of the frame draws the walls."""

  def __init__(self, height=24, width=32, episode_length=16,
               num_action_repeats=1, num_actions=4, grid_size=5,
               num_levels=8, wall_density=0.25, layout_seed=1234,
               curriculum='uniform', curriculum_temperature=1.0,
               curriculum_eps=0.1, shard=(0, 1)):
    super().__init__(height=height, width=width,
                     episode_length=episode_length,
                     num_action_repeats=num_action_repeats,
                     num_actions=num_actions, grid_size=grid_size,
                     shard=shard)
    if num_levels < 1:
      raise ValueError(f'num_levels must be >= 1, got {num_levels}')
    if curriculum not in population.CURRICULUM_MODES:
      raise ValueError(
          f'unknown curriculum {curriculum!r} '
          f'(modes: {", ".join(population.CURRICULUM_MODES)})')
    self.num_levels = num_levels
    self.wall_density = wall_density
    self.layout_seed = layout_seed
    self.curriculum = curriculum
    self.curriculum_temperature = curriculum_temperature
    self.curriculum_eps = curriculum_eps
    self._walls_np = np.stack([
        level_walls(layout_seed, k, grid_size, wall_density)
        for k in range(num_levels)])

  def wall_table(self, device) -> torch.Tensor:
    """bool [num_levels, G, G]: every level's walls, on `device`."""
    return self._on(device, 'walls', self._walls_np)

  def _goal_corner(self, batch, device):
    return torch.full((batch, 2), self.grid - 1, dtype=torch.int64,
                      device=device)

  def _uniform_levels(self, rng, batch):
    return self._draw(rng, batch, lambda n: torch.randint(
        0, self.num_levels, (n,), generator=rng, device=rng.device))

  def _third_plane(self, state):
    rows, cols, _ = self._tables(state.level_id.device)
    walls = self.wall_table(state.level_id.device)[state.level_id]
    return walls[:, rows[:, None], cols[None, :]]

  def _initial(self, rng, batch):
    base_state = super()._initial(rng, batch)
    device = rng.device
    zeros = torch.zeros((self.num_levels,), device=device)
    return ProcgenState(
        *base_state, level_id=self._uniform_levels(rng, batch),
        level_scores=zeros, level_visits=zeros.clone())

  def _sample_goal(self, rng, batch):
    # The base init draws a goal; the procgen goal is the fixed corner
    # and draws nothing.
    return self._goal_corner(batch, rng.device)

  def _blocked(self, state, proposed):
    walls = self.wall_table(proposed.device)[state.level_id]
    return walls[torch.arange(proposed.shape[0], device=proposed.device),
                 proposed[:, 0], proposed[:, 1]]

  def _fresh_episode(self, rng, batch, state):
    """The new-episode level: uniform, or the curriculum's draw over the
    pre-step scores."""
    if self.curriculum == 'uniform':
      fresh = self._uniform_levels(rng, batch)
    else:
      fresh = self._draw(rng, batch, lambda n: population.sample_levels(
          rng, state.level_scores, n, self.curriculum_temperature,
          self.curriculum_eps))
    return self._goal_corner(batch, rng.device), fresh

  def _replace_episode(self, state, done, fresh_extra, **fields):
    return state._replace(
        level_id=torch.where(done, fresh_extra, state.level_id), **fields)


# The on-device registry parallel/anakin.ENV_CORES extends; the host
# wrappers below resolve through it too.
JITTABLE_CORES = {'gridworld': GridworldCore, 'procgen': ProcgenCore}


class _JittableHostEnv(base.Environment):
  """A host environment over an on-device core at batch 1 on the CPU:
  the fleet runtime's half of the dual registration, with the core's own
  dynamics, auto-reset and flow-style stats, squeezed to the host
  protocol's scalar shapes."""

  _CORE_NAME = None  # subclasses pin it (py_process pickles classes)

  def __init__(self, height, width, num_actions, episode_length, seed=0,
               level_name='', num_action_repeats=1, num_levels=None,
               wall_density=None):
    del level_name  # the actor stamps the level id
    extra = {} if num_levels is None else {'num_levels': num_levels}
    if wall_density is not None:
      extra['wall_density'] = wall_density
    self._core = JITTABLE_CORES[self._CORE_NAME](
        height=height, width=width, episode_length=episode_length,
        num_action_repeats=num_action_repeats, num_actions=num_actions,
        **extra)
    self._state, out = self._core.init(torch.Generator().manual_seed(seed),
                                       1)
    self._obs = self._host_obs(out)

  @staticmethod
  def _process_setup():
    """Hosted in a process of its own (runtime/py_process.py), the env is
    that process's only torch work, on [1, ...] tensors: one intra-op
    thread. With a pool per process, 32 env processes on 8 cores ran a
    step in 225 ms instead of 1.5 ms."""
    torch.set_num_threads(1)

  @staticmethod
  def _host_obs(out):
    frame, instr = out.observation
    return (frame[0].numpy().copy(), instr[0].numpy().copy())

  def initial(self):
    return self._obs

  def step(self, action):
    self._state, out = self._core.step(
        self._state, torch.tensor([int(action)], dtype=torch.int64))
    self._obs = self._host_obs(out)
    return (np.float32(out.reward[0].item()), np.bool_(out.done[0].item()),
            self._obs)

  @staticmethod
  def _tensor_specs(method_name, unused_kwargs, constructor_kwargs):
    h = constructor_kwargs.get('height', 24)
    w = constructor_kwargs.get('width', 32)
    if method_name == 'initial':
      return base.observation_specs(h, w, MAX_INSTRUCTION_LEN)
    if method_name == 'step':
      return base.step_output_specs(h, w, MAX_INSTRUCTION_LEN)
    return None


class GridworldEnv(_JittableHostEnv):
  _CORE_NAME = 'gridworld'


class ProcgenEnv(_JittableHostEnv):
  _CORE_NAME = 'procgen'


HOST_ENVS = {'gridworld': GridworldEnv, 'procgen': ProcgenEnv}

# The factory's head-size default per backend (config.num_actions=None).
DEFAULT_NUM_ACTIONS = {'gridworld': 4, 'procgen': 4}
