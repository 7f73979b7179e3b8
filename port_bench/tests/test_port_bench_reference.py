"""The plain reference against the port at a tiny size on the CPU."""

import pytest
import torch

from port_bench.reference import agent as ref_agent
from port_bench.reference import bandit
from port_bench.reference import learner as ref_learner
from port_bench.tests import tiny


@pytest.mark.parametrize('name', ['deep.anakin.b32', 'shallow.anakin.b32'])
def test_the_reference_forward_is_the_ports(name):
  from scalable_agent_tpu_torch import driver
  from scalable_agent_tpu_torch.config import Config
  from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo
  cell = tiny.cell(name)
  config = Config(**cell['fields'])
  port = driver.build_agent(config, config.num_actions)
  weights = ref_agent.make_weights(cell['model'], 7, 'cpu')
  assert {k: tuple(v.shape) for k, v in port.named_parameters()} == {
      k: tuple(v.shape) for k, v in weights.items()}
  with torch.no_grad():
    for k, p in port.named_parameters():
      p.copy_(weights[k] + 0.01)  # biases off zero too
  weights = {k: v + 0.01 for k, v in weights.items()}
  t, b = 6, 3
  gen = torch.Generator().manual_seed(3)
  frames = torch.randint(0, 256, (t, b, 24, 32, 3), generator=gen,
                         dtype=torch.uint8)
  rewards = torch.randn(t, b, generator=gen) * 2
  dones = torch.rand(t, b, generator=gen) < 0.3
  actions = torch.randint(0, 9, (t, b), generator=gen)
  carry = (torch.randn(b, 256, generator=gen), torch.randn(b, 256,
                                                          generator=gen))
  env = StepOutput(rewards, StepOutputInfo(rewards, rewards), dones,
                   (frames, torch.zeros(t, b, 1, dtype=torch.int32)))
  with torch.no_grad():
    (_, logits, baseline), (c, h) = port(actions, env, carry)
    ref_logits, ref_baseline, (rc, rh) = ref_agent.unroll(
        weights, cell['model'], frames, rewards, dones, actions, carry)
  for got, want in ((logits, ref_logits), (baseline, ref_baseline),
                    (c, rc), (h, rh)):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_vtrace_by_hand():
  # One column, T=2, on-policy: vs is the discounted return bootstrapped.
  zeros = torch.zeros(2, 1)
  vs, pg = ref_learner.vtrace(zeros, torch.full((2, 1), 0.5),
                              torch.tensor([[1.0], [2.0]]), zeros,
                              torch.tensor([4.0]))
  torch.testing.assert_close(vs, torch.tensor([[3.0], [4.0]]))
  torch.testing.assert_close(pg, torch.tensor([[3.0], [4.0]]))


def test_bandit_guarantees_are_checked():
  plane = torch.zeros(2, 1, 4, 4, 3, dtype=torch.uint8)
  plane[..., 1] = 255
  batch = {'frames': plane, 'reward': torch.tensor([[0.0], [1.0]]),
           'done': torch.tensor([[True], [False]]),
           'action': torch.tensor([[0], [1]])}
  assert bandit.env_errors([batch], episode_length=5) == 0
  batch['reward'] = torch.tensor([[0.0], [0.0]])  # action 1 hit context 1
  assert bandit.env_errors([batch], episode_length=5) == 1
