"""ROADMAP C4's repair, on the CPU: the sharded TP train step
(parallel/train_parallel.py) runs its convolutions under cuDNN's
deterministic algorithms in the forward and in the backward
(`train_parallel.pinned_cudnn`), and leaves the global cuDNN flags as it
found them, after a step and after a step that raises; the gathered TP
step and the one-rank step run under the flags as the caller set them.

Two spawned gloo ranks of a {data 1, model 2} mesh, the shallow agent at
T=3, B=4, 24x32. Each rank wraps every convolution of its agent in a
forward hook, and each convolution's output in a gradient hook, that
read `torch.backends.cudnn.deterministic` when they run. A spawned rank
re-imports this module, which imports no JAX. The card's half, one
sharded step twice from the same state in equal bits, is
tests/test_torch_cuda.py::test_the_sharded_tp_step_repeats_bit_for_bit.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.models.torsos import Conv
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

T, B, A, H, W = 3, 4, 3, 24, 32
SPAWN_TIMEOUT_SECS = 120
_KW = dict(torso='shallow', batch_size=B, unroll_length=T,
           num_action_repeats=1, total_environment_frames=10**6,
           use_instruction=False, height=H, width=W)


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.zeros(B, np.int32),
      agent_state=(rng.randn(B, 256).astype(np.float32) * 0.3,
                   rng.randn(B, 256).astype(np.float32) * 0.3),
      env_outputs=StepOutput(
          rng.randn(T + 1, B).astype(np.float32),
          StepOutputInfo(np.zeros((T + 1, B), np.float32),
                         np.zeros((T + 1, B), np.int32)),
          rng.rand(T + 1, B) > 0.8,
          (rng.randint(0, 256, (T + 1, B, H, W, 3)).astype(np.uint8),
           np.zeros((T + 1, B, 16), np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, A, (T + 1, B)),
          rng.randn(T + 1, B, A).astype(np.float32),
          rng.randn(T + 1, B).astype(np.float32)))


def _hooked_agent(seen, fail=None):
  """The seeded agent, each conv's forward and backward recording the
  cuDNN flag into `seen`; `fail` (a mutable flag) makes the forward
  hook raise while set."""
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  init_params(agent, torch.Generator().manual_seed(0))

  def forward_hook(module, inputs, output):
    seen.append(('forward', torch.backends.cudnn.deterministic))
    if fail is not None and fail[0]:
      raise RuntimeError('injected failure inside the step')
    if output.requires_grad:
      output.register_hook(lambda grad: seen.append(
          ('backward', torch.backends.cudnn.deterministic)))

  convs = [m for m in agent.modules() if isinstance(m, Conv)]
  assert convs
  for conv in convs:
    conv.register_forward_hook(forward_hook)
  return agent


def _flags():
  cudnn = torch.backends.cudnn
  return cudnn.deterministic, cudnn.benchmark


def _rank(rank, world, port, outdir):
  torch.set_num_threads(1)
  batch = map_structure(torch.from_numpy, _batch())
  result = {}
  mesh = None
  for mode in ('sharded', 'gathered'):
    config = Config(**_KW, model_parallelism=2, tp_compute=mode,
                    coordinator_address=f'localhost:{port}',
                    num_processes=world, process_id=rank)
    if mesh is None:
      device = distributed.maybe_initialize(config, backend='gloo',
                                            device='cpu', timeout_secs=60)
      mesh = mesh_lib.make_mesh(device, model_parallelism=2)
    seen, fail = [], [False]
    agent = _hooked_agent(seen, fail)
    state = train_parallel.make_sharded_train_state(agent, config, mesh)
    step, place = train_parallel.make_sharded_train_step(agent, config,
                                                         mesh, batch)
    local = place(batch)
    # The caller's flags: not deterministic, autotuning on.
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    state, _ = step(state, local)
    after_step = _flags()
    raised = None
    if mode == 'sharded':
      # A raise inside the step (on every rank, before any collective of
      # the forward's first conv completes its gather) leaves the flags
      # as the caller set them.
      fail[0] = True
      try:
        step(state, local)
      except RuntimeError as e:
        raised = str(e)
      fail[0] = False
    result[mode] = {'seen': seen, 'after_step': after_step,
                    'after_raise': _flags(), 'raised': raised}
  torch.backends.cudnn.deterministic = False
  torch.backends.cudnn.benchmark = True
  seen = []
  one = _hooked_agent(seen)
  one_config = Config(**_KW)
  one_step = learner.make_train_step_fn(one, one_config)
  one_step(learner.make_train_state(one, one_config), batch)
  result['one_rank'] = {'seen': seen, 'after_step': _flags()}
  torch.save(result, f'{outdir}/rank{rank}.pt')
  distributed.shutdown()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  outdir = tmp_path_factory.mktemp('tp_pin')
  context = mp.spawn(_rank, args=(2, _free_port(), str(outdir)), nprocs=2,
                     join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail(f'ranks still running after {SPAWN_TIMEOUT_SECS} s')
  return [torch.load(outdir / f'rank{r}.pt') for r in range(2)]


@pytest.mark.parametrize('rank', [0, 1])
def test_the_sharded_step_pins_cudnn_forward_and_backward(ranks, rank):
  got = ranks[rank]['sharded']
  kinds = {kind for kind, _ in got['seen']}
  assert kinds == {'forward', 'backward'}
  assert all(flag for _, flag in got['seen']), got['seen']


@pytest.mark.parametrize('rank', [0, 1])
def test_the_pin_restores_the_flags_after_a_step_and_a_raise(ranks, rank):
  got = ranks[rank]['sharded']
  assert got['after_step'] == (False, True)
  assert got['raised'] == 'injected failure inside the step'
  assert got['after_raise'] == (False, True)


@pytest.mark.parametrize('path', ['gathered', 'one_rank'])
def test_the_other_steps_run_under_the_callers_flags(ranks, path):
  for result in ranks:
    got = result[path]
    assert got['seen'] and not any(flag for _, flag in got['seen'])
    assert got['after_step'] == (False, True)


def test_pinned_cudnn_alone_restores_on_a_raise():
  cudnn = torch.backends.cudnn
  saved = _flags()
  try:
    cudnn.deterministic, cudnn.benchmark = False, True
    with pytest.raises(ValueError):
      with train_parallel.pinned_cudnn():
        assert _flags() == (True, False)
        raise ValueError('inside')
    assert _flags() == (False, True)
  finally:
    cudnn.deterministic, cudnn.benchmark = saved
