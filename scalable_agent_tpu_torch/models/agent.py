"""The IMPALA agent network, ported from scalable_agent_tpu/models/agent.py.

- The torso runs over the merged [T*B] batch: one large conv batch.
- The core input is concat[torso, clip(r, -1, 1), one_hot(a_prev)], and
  the instruction encoding (models/instruction.py) with use_instruction.
- The LSTM-256 core walks time in an eager loop. Its carry is zeroed where
  `done` is set, *before* the step (`done[t]` marks the first observation
  of a new episode). The carry is `(c, h)` as in Flax; `nn.LSTMCell`
  takes and returns `(h, c)`, and the loop swaps at the boundary.
- Flax's OptimizedLSTMCell has one bias (on the hidden kernels);
  `nn.LSTMCell` has two. `bias_ih` is therefore a zero *buffer*, not a
  parameter, so the trainable parameters are exactly Flax's.
- Heads (policy logits, baseline) run over the merged [T*B] batch. With
  PopArt the baseline head has one column per task and `level_ids`
  selects each trajectory's. The pixel-control Q-head (unreal.py) runs
  on the same [T*B] core output when the learner asks for it, and its
  Q-map is returned to the caller (JAX sows it).
- `dtype` is Flax's compute dtype. In bfloat16 the torso, the core input,
  the LSTM step and the heads compute in bf16; the carry is cast to bf16
  on entry and back to float32 on exit, and logits and baseline come out
  float32. The bf16 LSTM step is OptimizedLSTMCell's arithmetic written
  out (`_lstm_step`), since `nn.LSTMCell`'s fused CUDA cell computes its
  gates in float32 and rounds only c and h. The float32 path keeps
  `nn.LSTMCell`.
- Tensor parallelism (`tp`, models.torsos.TensorParallel): with the
  parameters swapped for this rank's blocks, the torso's blocked layers
  run as torsos.py says, and the LSTM computes this rank's block of the
  hidden units of each gate: the cell state stays a block through the
  time loop, and each step's hidden state is gathered over the model
  group (the next step's hidden product needs all of it). The heads stay
  whole on every rank.
- With no generator the action is argmax; with one it is sampled
  (Gumbel-max, drawn from that generator on the logits' device). A rank
  holding block `index` of `count` of a batch draws the noise of the
  whole batch and keeps its block's columns (`sample_shard`), so a
  sharded run samples as the unsharded one does.

`scan_unroll` is an XLA loop knob in the JAX package; the eager loop here
has nothing to unroll, so the port accepts the field and ignores it.
"""

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from scalable_agent_tpu_torch import unreal
from scalable_agent_tpu_torch.models.instruction import InstructionEncoder
from scalable_agent_tpu_torch.models.lstm import unroll_lstm
from scalable_agent_tpu_torch.models.torsos import TORSOS, Dense
from scalable_agent_tpu_torch.parallel.sharding import shard_range
from scalable_agent_tpu_torch.structs import AgentOutput, map_structure


class ImpalaAgent(nn.Module):
  """IMPALA agent: torso -> LSTM core -> policy/baseline heads.

  `frame_shape` is (H, W, C): the torso's Dense layer and the
  pixel-control head's grid are sized from it, where Flax sizes them
  lazily at init.

  The JAX agent's extensions: `use_instruction` concatenates the
  instruction encoding (models/instruction.py) into the core input;
  `num_popart_tasks` > 0 gives the value head one normalized column per
  task, selected by the forward's `level_ids` (None: task 0, the act
  time path); `use_pixel_control` builds the UNREAL Q-head (unreal.py),
  which runs only when the forward is asked for it.
  """

  def __init__(self, num_actions: int, frame_shape=(72, 96, 3),
               torso: str = 'deep', hidden_size: int = 256,
               dtype: torch.dtype = torch.float32,
               use_instruction: bool = False, num_popart_tasks: int = 0,
               use_pixel_control: bool = False,
               pixel_control_cell_size: int = 4,
               pixel_control_head_impl: str = 'deconv',
               pixel_control_q_f32: bool = True):
    super().__init__()
    self.num_actions = num_actions
    self.hidden_size = hidden_size
    self.dtype = dtype
    self.num_popart_tasks = num_popart_tasks
    self.torso = TORSOS[torso](tuple(frame_shape), dtype=dtype)
    core_input = self.torso.linear.out_features + 1 + num_actions
    self.instruction = None
    if use_instruction:
      self.instruction = InstructionEncoder(dtype=dtype)
      core_input += self.instruction.lstm_size
    self.core = nn.LSTMCell(core_input, hidden_size)
    del self.core.bias_ih
    self.core.register_buffer('bias_ih', torch.zeros(4 * hidden_size))
    self.policy_logits = Dense(hidden_size, num_actions, compute_dtype=dtype)
    self.baseline = Dense(hidden_size, max(num_popart_tasks, 1),
                          compute_dtype=dtype)
    self.pixel_control = None
    if use_pixel_control:
      cell = pixel_control_cell_size
      self.pixel_control = unreal.PixelControlHead(
          hidden_size, num_actions,
          (frame_shape[0] // cell, frame_shape[1] // cell), dtype=dtype,
          head_impl=pixel_control_head_impl, out_f32=pixel_control_q_f32)

  def initial_state(self, batch_size: int, device=None):
    """Zeroed float32 LSTM carry (c, h), each [B, hidden]."""
    shape = (batch_size, self.hidden_size)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))

  def forward(self, prev_actions, env_outputs, core_state,
              sample_generator: Optional[torch.Generator] = None,
              sample_shard: Tuple[int, int] = (0, 1), tp=None,
              level_ids=None, compute_pixel_control: bool = False):
    """Unroll over a [T, B] trajectory.

    Args:
      prev_actions: int [T, B] — the action taken *before* each timestep.
      env_outputs: StepOutput of [T, B, ...] tensors; the observation is
        (frame uint8 [T, B, H, W, C], instruction ids int [T, B, L]).
      core_state: LSTM carry (c, h), each [B, hidden], at unroll start.
      sample_generator: a torch.Generator on the logits' device -> the
        action is sampled from the policy; None -> argmax.
      sample_shard: (index, count): the batch is block `index` of
        `count` equal blocks of the batch the noise is drawn for.
      tp: a TensorParallel when the parameters are this rank's blocks
        (see the module docstring).
      level_ids: int [B] task ids selecting each trajectory's PopArt
        value column; None -> task 0.
      compute_pixel_control: run the pixel-control head (the learner).

    Returns:
      (AgentOutput of [T, B, ...] tensors, final carry (c, h)), and with
      `compute_pixel_control` a third item, the head's Q-map
      [T, B, Hc, Wc, A].
    """
    reward, _, done, (frame, instr_ids) = env_outputs
    t, b = reward.shape[0], reward.shape[1]

    torso_out = self.torso(frame.reshape((t * b,) + frame.shape[2:]), tp)
    clipped_reward = torch.clamp(reward, -1.0, 1.0).reshape(t * b, 1)
    one_hot_action = F.one_hot(prev_actions.reshape(t * b).long(),
                               self.num_actions).to(torso_out.dtype)
    parts = [torso_out, clipped_reward.to(torso_out.dtype), one_hot_action]
    if self.instruction is not None:
      flat_ids = instr_ids.reshape((t * b,) + instr_ids.shape[2:])
      parts.append(self.instruction(flat_ids, tp).to(torso_out.dtype))
    core_input = torch.cat(parts, dim=-1).reshape(t, b, -1)

    c, h = (s.to(self.dtype) for s in core_state)
    core_out, c, h = unroll_lstm(self.core, core_input, c, h, self.dtype,
                                 tp=tp, resets=done)
    flat_core = core_out.reshape(t * b, -1)
    c, h = c.float(), h.float()

    policy_logits = self.policy_logits(flat_core).float().reshape(
        t, b, self.num_actions)
    num_values = max(self.num_popart_tasks, 1)
    baseline = self.baseline(flat_core).float().reshape(t, b, num_values)
    if self.num_popart_tasks:
      if level_ids is None:
        level_ids = torch.zeros((b,), dtype=torch.int64,
                                device=baseline.device)
      index = level_ids.long().reshape(1, b, 1).expand(t, b, 1)
      baseline = torch.gather(baseline, 2, index)
    baseline = baseline[..., 0]

    if sample_generator is not None:
      index, count = sample_shard
      start, stop = shard_range(b * count, index, count)
      uniform = torch.rand((t, b * count, self.num_actions),
                           generator=sample_generator,
                           device=policy_logits.device)[:, start:stop]
      gumbel = -torch.log(-torch.log(uniform.clamp_min(1e-20)))
      action = torch.argmax(policy_logits + gumbel, dim=-1)
    else:
      action = torch.argmax(policy_logits, dim=-1)
    out = (AgentOutput(action, policy_logits, baseline), (c, h))
    if not compute_pixel_control:
      return out
    if self.pixel_control is None:
      raise ValueError('compute_pixel_control needs an agent built with '
                       'use_pixel_control')
    q = self.pixel_control(flat_core)
    return out + (q.reshape((t, b) + q.shape[1:]),)


def make_step_fn(agent: ImpalaAgent,
                 sample_shard: Tuple[int, int] = (0, 1)):
  """Single-step (T=1) policy for actors: batch-shaped, no time axis.

  Returns f(generator, prev_action [B], env_output of [B, ...],
  core_state) -> (AgentOutput of [B, ...], new carry). It runs without
  autograd: acting records no graph. `sample_shard` is the forward's.
  """

  def step(generator, prev_action, env_output, core_state):
    with torch.no_grad():
      out, new_state = agent(
          prev_action[None], map_structure(lambda x: x[None], env_output),
          core_state, sample_generator=generator,
          sample_shard=sample_shard)
    return map_structure(lambda x: x[0], out), new_state

  return step


def _lecun_normal_(weight, fan_in: int, generator: torch.Generator):
  # Flax's lecun_normal: a normal truncated at two standard deviations,
  # rescaled so that the variance is 1/fan_in.
  std = math.sqrt(1.0 / fan_in) / .87962566103423978
  nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                        generator=generator)


@torch.no_grad()
def init_params(agent: ImpalaAgent, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
  """(Re)initialise `agent` in place with Flax's initialisers and return
  its parameters by name.

  Conv, ConvTranspose and Dense kernels are lecun-normal and biases
  zero; the instruction embedding is Flax Embed's variance-scaling
  normal (lecun-normal over its 20 features); the LSTM input kernels are
  lecun-normal, the recurrent kernels orthogonal per gate, and the one
  bias zero — OptimizedLSTMCell's defaults. `generator` is a CPU
  generator: build and initialise on the CPU, then move the agent.
  """
  for module in agent.modules():
    if isinstance(module, (nn.Conv2d, nn.Linear, unreal.Deconv)):
      _lecun_normal_(module.weight, module.weight[0].numel(), generator)
      nn.init.zeros_(module.bias)
    elif isinstance(module, nn.Embedding):
      _lecun_normal_(module.weight, module.weight.shape[1], generator)
  cells = [agent.core]
  if agent.instruction is not None:
    cells.append(agent.instruction.cell)
  for cell in cells:
    hidden = cell.weight_hh.shape[1]
    for gate in range(4):
      rows = slice(gate * hidden, (gate + 1) * hidden)
      _lecun_normal_(cell.weight_ih[rows], cell.weight_ih.shape[1],
                     generator)
      nn.init.orthogonal_(cell.weight_hh[rows], generator=generator)
    nn.init.zeros_(cell.bias_hh)
  return dict(agent.named_parameters())
