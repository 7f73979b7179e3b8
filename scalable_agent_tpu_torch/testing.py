"""Synthetic trajectory batches, the port's copy of the JAX package's
testing.py: one constructor of a random learner batch for the tests, the
memory-fit tool and chip_smoke.py, with the JAX batch's dtypes (int32
actions, uint8 frames, int32 instruction ids)."""

import numpy as np
import torch

from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)


def make_example_batch(t1, b, h, w, num_actions, instr_len, seed=0,
                       done_prob=0.05, hidden_size=256, device='cpu',
                       num_tasks=1):
  """A random [T+1=t1, B=b] time-major ActorOutput on `device`, drawn
  from a numpy seed as the JAX constructor draws it; level ids are
  zeros, or `i % num_tasks` for column i."""
  rng = np.random.RandomState(seed)

  def tensor(x):
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)

  return ActorOutput(
      level_name=tensor((np.arange(b) % num_tasks).astype(np.int32)),
      agent_state=(tensor(np.zeros((b, hidden_size), np.float32)),
                   tensor(np.zeros((b, hidden_size), np.float32))),
      env_outputs=StepOutput(
          reward=tensor(rng.randn(t1, b).astype(np.float32)),
          info=StepOutputInfo(tensor(np.zeros((t1, b), np.float32)),
                              tensor(np.zeros((t1, b), np.int32))),
          done=tensor(rng.rand(t1, b) < done_prob),
          observation=(
              tensor(rng.randint(0, 255, (t1, b, h, w, 3)).astype(np.uint8)),
              tensor(rng.randint(0, 1000, (t1, b, instr_len)).astype(
                  np.int32)))),
      agent_outputs=AgentOutput(
          action=tensor(rng.randint(0, num_actions, (t1, b)).astype(
              np.int32)),
          policy_logits=tensor(rng.randn(t1, b, num_actions).astype(
              np.float32)),
          baseline=tensor(rng.randn(t1, b).astype(np.float32))))
