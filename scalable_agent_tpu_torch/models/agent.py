"""The IMPALA agent network, ported from scalable_agent_tpu/models/agent.py.

- The torso runs over the merged [T*B] batch: one large conv batch.
- The core input is concat[torso, clip(r, -1, 1), one_hot(a_prev)].
- The LSTM-256 core walks time in an eager loop. Its carry is zeroed where
  `done` is set, *before* the step (`done[t]` marks the first observation
  of a new episode). The carry is `(c, h)` as in Flax; `nn.LSTMCell`
  takes and returns `(h, c)`, and the loop swaps at the boundary.
- Flax's OptimizedLSTMCell has one bias (on the hidden kernels);
  `nn.LSTMCell` has two. `bias_ih` is therefore a zero *buffer*, not a
  parameter, so the trainable parameters are exactly Flax's.
- Heads (policy logits, baseline) run over the merged [T*B] batch.
- `dtype` is Flax's compute dtype. In bfloat16 the torso, the core input,
  the LSTM step and the heads compute in bf16; the carry is cast to bf16
  on entry and back to float32 on exit, and logits and baseline come out
  float32. The bf16 LSTM step is OptimizedLSTMCell's arithmetic written
  out (`_lstm_step`), since `nn.LSTMCell`'s fused CUDA cell computes its
  gates in float32 and rounds only c and h. The float32 path keeps
  `nn.LSTMCell`.
- With no generator the action is argmax; with one it is sampled
  (Gumbel-max, drawn from that generator on the logits' device).

`scan_unroll` is an XLA loop knob in the JAX package; the eager loop here
has nothing to unroll, so the port accepts the field and ignores it.
"""

import math
from typing import Dict, Optional

import torch
from torch import nn
from torch.nn import functional as F

from scalable_agent_tpu_torch.models.torsos import TORSOS, Dense
from scalable_agent_tpu_torch.structs import AgentOutput, map_structure


def _lstm_step(cell: nn.LSTMCell, input_product, c, h, dtype):
  """One step of Flax's OptimizedLSTMCell in `dtype` on the port's
  LSTMCell parameters: `input_product` (x @ W_ih, no bias, precomputed
  for all steps at once: a row's product does not depend on the others)
  plus the hidden product with its bias, then i, f, g, o,
  `c' = f*c + i*g` and `h' = o*tanh(c')`, every op rounding in `dtype`.
  Returns (c', h')."""
  hidden = F.linear(h, cell.weight_hh.to(dtype)) + cell.bias_hh.to(dtype)
  i, f, g, o = (hidden + input_product).chunk(4, dim=-1)
  c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
  return c, torch.sigmoid(o) * torch.tanh(c)


class ImpalaAgent(nn.Module):
  """IMPALA agent: torso -> LSTM core -> policy/baseline heads.

  `frame_shape` is (H, W, C): the torso's Dense layer is sized from it,
  where Flax sizes it lazily at init.
  """

  def __init__(self, num_actions: int, frame_shape=(72, 96, 3),
               torso: str = 'deep', hidden_size: int = 256,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.num_actions = num_actions
    self.hidden_size = hidden_size
    self.dtype = dtype
    self.torso = TORSOS[torso](tuple(frame_shape), dtype=dtype)
    core_input = self.torso.linear.out_features + 1 + num_actions
    self.core = nn.LSTMCell(core_input, hidden_size)
    del self.core.bias_ih
    self.core.register_buffer('bias_ih', torch.zeros(4 * hidden_size))
    self.policy_logits = Dense(hidden_size, num_actions, compute_dtype=dtype)
    self.baseline = Dense(hidden_size, 1, compute_dtype=dtype)

  def initial_state(self, batch_size: int, device=None):
    """Zeroed float32 LSTM carry (c, h), each [B, hidden]."""
    shape = (batch_size, self.hidden_size)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))

  def forward(self, prev_actions, env_outputs, core_state,
              sample_generator: Optional[torch.Generator] = None):
    """Unroll over a [T, B] trajectory.

    Args:
      prev_actions: int [T, B] — the action taken *before* each timestep.
      env_outputs: StepOutput of [T, B, ...] tensors; the observation is
        (frame uint8 [T, B, H, W, C], instruction ids int [T, B, L]).
      core_state: LSTM carry (c, h), each [B, hidden], at unroll start.
      sample_generator: a torch.Generator on the logits' device -> the
        action is sampled from the policy; None -> argmax.

    Returns:
      (AgentOutput of [T, B, ...] tensors, final carry (c, h)).
    """
    reward, _, done, (frame, _) = env_outputs
    t, b = reward.shape[0], reward.shape[1]

    torso_out = self.torso(frame.reshape((t * b,) + frame.shape[2:]))
    clipped_reward = torch.clamp(reward, -1.0, 1.0).reshape(t * b, 1)
    one_hot_action = F.one_hot(prev_actions.reshape(t * b).long(),
                               self.num_actions).to(torso_out.dtype)
    core_input = torch.cat(
        [torso_out, clipped_reward.to(torso_out.dtype), one_hot_action],
        dim=-1).reshape(t, b, -1)

    c, h = (s.to(self.dtype) for s in core_state)
    if self.dtype != torch.float32:
      input_product = F.linear(core_input, self.core.weight_ih.to(self.dtype))
    outputs = []
    for step in range(t):
      reset = done[step].reshape(b, 1)
      c = c.masked_fill(reset, 0.0)
      h = h.masked_fill(reset, 0.0)
      if self.dtype == torch.float32:
        h, c = self.core(core_input[step], (h, c))
      else:
        c, h = _lstm_step(self.core, input_product[step], c, h, self.dtype)
      outputs.append(h)
    flat_core = torch.stack(outputs).reshape(t * b, -1)
    c, h = c.float(), h.float()

    policy_logits = self.policy_logits(flat_core).float().reshape(
        t, b, self.num_actions)
    baseline = self.baseline(flat_core).float().reshape(t, b, 1)[..., 0]

    if sample_generator is not None:
      uniform = torch.rand(policy_logits.shape, generator=sample_generator,
                           device=policy_logits.device)
      gumbel = -torch.log(-torch.log(uniform.clamp_min(1e-20)))
      action = torch.argmax(policy_logits + gumbel, dim=-1)
    else:
      action = torch.argmax(policy_logits, dim=-1)
    return AgentOutput(action, policy_logits, baseline), (c, h)


def make_step_fn(agent: ImpalaAgent):
  """Single-step (T=1) policy for actors: batch-shaped, no time axis.

  Returns f(generator, prev_action [B], env_output of [B, ...],
  core_state) -> (AgentOutput of [B, ...], new carry). It runs without
  autograd: acting records no graph.
  """

  def step(generator, prev_action, env_output, core_state):
    with torch.no_grad():
      out, new_state = agent(
          prev_action[None], map_structure(lambda x: x[None], env_output),
          core_state, sample_generator=generator)
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

  Conv and Dense kernels are lecun-normal and biases zero; the LSTM input
  kernels are lecun-normal, the recurrent kernels orthogonal per gate, and
  the one bias zero — OptimizedLSTMCell's defaults. `generator` is a CPU
  generator: build and initialise on the CPU, then move the agent.
  """
  for module in agent.modules():
    if isinstance(module, (nn.Conv2d, nn.Linear)):
      _lecun_normal_(module.weight, module.weight[0].numel(), generator)
      nn.init.zeros_(module.bias)
  core = agent.core
  hidden = agent.hidden_size
  for gate in range(4):
    rows = slice(gate * hidden, (gate + 1) * hidden)
    _lecun_normal_(core.weight_ih[rows], core.weight_ih.shape[1],
                   generator)
    nn.init.orthogonal_(core.weight_hh[rows], generator=generator)
  nn.init.zeros_(core.bias_hh)
  return dict(agent.named_parameters())
