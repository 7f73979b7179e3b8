"""Tests of the port that need an NVIDIA card (marker `requires_cuda`).

On a machine without CUDA they skip. On the card they build the CUDA
kernels with nvcc and hold each against its plain twin. This file imports
no JAX, so it also runs where JAX is not installed:

  python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda.py

Tolerances: the V-trace kernel against its twin on the card, bit-equal
(torch.equal: the kernel rounds each product and sum where the twin's
PyTorch ops round). The fused conv+pool kernel against its twin,
max|kernel - plain| <= 2**-7 * max|plain|: one bf16 ulp at the output's
scale, since the tensor cores sum the float32 products in another order
before rounding to bf16. The inference server on the card against the
same server on the CPU: rtol 1e-4 / atol 1e-5 (float32 convolutions summed
in another order); a batch staged through pinned memory arrives
bit-equal.
"""

import threading

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.ops import conv_pool_cuda
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.runtime.actor import batch_unrolls
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.scripts import conv_pool as conv_pool_script
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip('needs CUDA: torch.cuda.is_available() is False')
  return torch.device('cuda')


def _inputs(shape, device, seed=0):
  rng = np.random.RandomState(seed)
  arrays = dict(
      log_rhos=rng.randn(*shape) * 0.8,
      discounts=0.99 * (rng.rand(*shape) > 0.1),
      rewards=rng.randn(*shape),
      values=rng.randn(*shape),
      bootstrap_value=rng.randn(*shape[1:]))
  return {k: torch.tensor(v, dtype=torch.float32, device=device)
          for k, v in arrays.items()}


@pytest.mark.parametrize('clips', [(1.0, 1.0), (None, None), (3.7, 2.2)],
                         ids=str)
@pytest.mark.parametrize('shape', [(100, 32), (7, 300), (6, 70, 3), (1, 1),
                                   (257, 45), (1000, 32), (100, 16)],
                         ids=str)
def test_vtrace_kernel_matches_twin(cuda, shape, clips):
  x = _inputs(shape, cuda)
  before = vtrace_cuda.from_importance_weights.launches
  vs, pg = vtrace_cuda.from_importance_weights(
      **x, clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
  torch.cuda.synchronize()
  assert vtrace_cuda.from_importance_weights.launches == before + 1
  ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(
      **x, clip_rho_threshold=clips[0], clip_pg_rho_threshold=clips[1])
  assert torch.equal(vs, ref_vs)
  assert torch.equal(pg, ref_pg)


def test_vtrace_kernel_keeps_nan_like_the_twin(cuda):
  x = _inputs((5, 4), cuda)
  x['log_rhos'][2, 1] = float('nan')
  vs, pg = vtrace_cuda.from_importance_weights(**x)
  ref_vs, ref_pg = vtrace_cuda.plain_from_importance_weights(**x)
  torch.testing.assert_close(vs, ref_vs, rtol=1e-5, atol=1e-6,
                             equal_nan=True)
  torch.testing.assert_close(pg, ref_pg, rtol=1e-5, atol=1e-6,
                             equal_nan=True)
  assert torch.isnan(vs[:3, 1]).all()


def test_vtrace_wrapper_refuses_mixed_devices(cuda):
  x = _inputs((4, 3), cuda)
  x['values'] = x['values'].cpu()
  with pytest.raises(ValueError, match='expected cuda'):
    vtrace_cuda.from_importance_weights(**x)


@pytest.mark.parametrize('shards', [1, 2, 4])
def test_sharded_vtrace_kernel_is_k1_per_rank(cuda, shards):
  """K1b on each rank's block of columns, the blocks together: bit-equal
  to K1 on the whole batch, and counted on K1b's own counter."""
  x = _inputs((100, 32), cuda, seed=shards)
  before = (vtrace_cuda.from_importance_weights.launches,
            vtrace_cuda.sharded_from_importance_weights.launches)
  parts = []
  for rank in range(shards):
    local = {k: (v[rank * 32 // shards:(rank + 1) * 32 // shards]
                 if k == 'bootstrap_value'
                 else v[:, rank * 32 // shards:(rank + 1) * 32 // shards]
                 ).contiguous() for k, v in x.items()}
    mesh = mesh_lib.Mesh(rank=rank, size=shards, device=cuda)
    parts.append(vtrace_cuda.sharded_from_importance_weights(
        mesh, **local, batch_size=32))
  vs, pg = vtrace_cuda.from_importance_weights(**x)
  torch.cuda.synchronize()
  assert torch.equal(torch.cat([p[0] for p in parts], dim=1), vs)
  assert torch.equal(torch.cat([p[1] for p in parts], dim=1), pg)
  assert (vtrace_cuda.from_importance_weights.launches,
          vtrace_cuda.sharded_from_importance_weights.launches) == (
              before[0] + 1, before[1] + shards)


def test_nccl_refuses_more_ranks_than_cards(cuda):
  count = torch.cuda.device_count()
  topology = distributed.Topology(0, count + 1, 0, count + 1)
  with pytest.raises(RuntimeError, match='one card per rank'):
    distributed.rank_device(topology, 'nccl')
  assert distributed.rank_device(distributed.Topology(0, count, 0, count),
                                 'nccl') == torch.device('cuda', 0)


def test_anakin_on_card_launches_the_kernel_once_per_step(cuda):
  cfg = Config(env_backend='bandit', batch_size=4, unroll_length=5,
               num_action_repeats=1, episode_length=4, height=24,
               width=32, torso='shallow', use_instruction=False,
               use_pallas_vtrace=True, seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  carry, history, _ = anakin.run(cfg, 3)
  assert vtrace_cuda.from_importance_weights.launches == 3
  assert carry.train_state.update_steps == 3
  assert all(np.isfinite(h['total_loss']) for h in history)


@pytest.mark.parametrize('shape', [(3232, 72, 96), (32, 72, 96), (5, 21, 27),
                                   (1, 1, 1), (7, 72, 96), (3, 1, 1),
                                   (2, 20, 150)], ids=str)
def test_conv_pool_kernel_matches_twin(cuda, shape):
  frames, weight, bias = conv_pool_script.make_inputs(*shape, cuda, seed=1)
  before = conv_pool_cuda.fused_conv_pool.launches
  out = conv_pool_cuda.fused_conv_pool(frames, weight, bias)
  torch.cuda.synchronize()
  assert conv_pool_cuda.fused_conv_pool.launches == before + 1
  assert out.dtype == torch.bfloat16
  assert out.shape == conv_pool_cuda.output_shape(*shape)
  ref = conv_pool_cuda.plain_conv_pool(frames, weight, bias)
  conv_pool_script.parity(out, ref)  # raises past 2**-7 * max|plain|


def test_refused_launches_raise(cuda, monkeypatch):
  """A geometry the kernel cannot run comes back as a CUDA error, and the
  wrapper raises; nothing falls back to the twin."""
  x = _inputs((100, 32), cuda)
  geometry = vtrace_cuda.launch_geometry(100, 32)
  monkeypatch.setattr(vtrace_cuda, 'launch_geometry', lambda t, n: (
      geometry._replace(smem_bytes=geometry.smem_bytes + 4)))
  with pytest.raises(RuntimeError, match='vtrace kernel launch failed'):
    vtrace_cuda.from_importance_weights(**x)
  frames, weight, bias = conv_pool_script.make_inputs(2, 72, 96, cuda)
  k2 = conv_pool_cuda.launch_geometry(2, 72, 96)
  monkeypatch.setattr(conv_pool_cuda, 'launch_geometry', lambda n, h, w: (
      k2._replace(smem_bytes=300000)))
  with pytest.raises(RuntimeError, match='conv_pool kernel launch failed'):
    conv_pool_cuda.fused_conv_pool(frames, weight, bias)


def test_bf16_anakin_on_card_keeps_float32_state(cuda):
  cfg = Config(env_backend='bandit', batch_size=4, unroll_length=5,
               num_action_repeats=1, episode_length=4, height=24,
               width=32, torso='deep', use_instruction=False,
               use_pallas_vtrace=True, compute_dtype='bfloat16', seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  carry, history, _ = anakin.run(cfg, 3)
  assert vtrace_cuda.from_importance_weights.launches == 3
  assert carry.train_state.update_steps == 3
  assert all(np.isfinite(h['total_loss']) for h in history)
  assert all(p.dtype == torch.float32 and p.is_cuda
             for p in carry.train_state.params.values())
  assert all(s.dtype == torch.float32 for s in carry.core_state)


def _server_calls(num, hidden, seed=0):
  rng = np.random.RandomState(seed)
  return [(np.int32(rng.randint(4)),
           StepOutput(np.float32(rng.randn()),
                      StepOutputInfo(np.float32(0), np.int32(0)),
                      np.bool_(rng.rand() < 0.3),
                      (rng.randint(0, 256, (24, 32, 3)).astype(np.uint8),
                       np.zeros(16, np.int32))),
           tuple(rng.randn(1, hidden).astype(np.float32) * 0.3
                 for _ in range(2)))
          for _ in range(num)]


def _serve_concurrently(server, calls):
  outs = [None] * len(calls)

  def call(i):
    outs[i] = server.policy(*calls[i])

  threads = [threading.Thread(target=call, args=(i,))
             for i in range(len(calls))]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=120)
    assert not t.is_alive()
  return outs


@pytest.fixture
def no_tf32():
  """float32 convolutions and matmuls without TF32 (held to the CPU's
  float32, as chip_smoke.py runs them)."""
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  yield
  (torch.backends.cudnn.allow_tf32,
   torch.backends.cuda.matmul.allow_tf32) = saved


def test_inference_server_on_card_matches_cpu(cuda, no_tf32):
  agent = ImpalaAgent(4, (24, 32, 3), torso='deep')
  params = init_params(agent, torch.Generator().manual_seed(0))
  config = Config(inference_timeout_ms=2000, use_instruction=False)
  calls = _server_calls(5, agent.hidden_size)
  results = {}
  for device in ('cpu', cuda):
    server = InferenceServer(agent, {k: v.to(device)
                                     for k, v in params.items()},
                             config, seed=1, fleet_size=5)
    try:
      results[str(device)] = _serve_concurrently(server, calls)
      assert all(p.is_cuda == (device != 'cpu')
                 for p in server.live_params().values())
    finally:
      server.close()
  for (out, carry), (ref, ref_carry) in zip(results['cuda'],
                                            results['cpu']):
    for got, want in ((out.policy_logits, ref.policy_logits),
                      (out.baseline, ref.baseline), (carry[0], ref_carry[0]),
                      (carry[1], ref_carry[1])):
      np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert 0 <= int(out.action) < 4


def test_a_batch_staged_through_pinned_memory_arrives_equal(cuda):
  rng = np.random.RandomState(0)
  t1, hidden = 4, 8

  def unroll(i):
    return ActorOutput(
        level_name=np.int32(i),
        agent_state=tuple(rng.randn(1, hidden).astype(np.float32)
                          for _ in range(2)),
        env_outputs=StepOutput(
            rng.randn(t1).astype(np.float32),
            StepOutputInfo(rng.randn(t1).astype(np.float32),
                           rng.randint(0, 9, t1).astype(np.int32)),
            rng.rand(t1) > 0.5,
            (rng.randint(0, 256, (t1, 6, 5, 3)).astype(np.uint8),
             rng.randint(0, 9, (t1, 16)).astype(np.int32))),
        agent_outputs=AgentOutput(
            rng.randint(0, 4, t1).astype(np.int32),
            rng.randn(t1, 4).astype(np.float32),
            rng.randn(t1).astype(np.float32)))

  host = batch_unrolls([unroll(i) for i in range(3)],
                       empty=learner.pinned_empty)
  assert torch.from_numpy(host.env_outputs.reward).is_pinned()
  side = torch.cuda.Stream(cuda)
  placed = learner.place_batch(host, cuda, copy_stream=side)
  assert placed.agent_outputs.action.dtype == torch.int64
  back = map_structure(lambda t: t.cpu(), placed)
  for got, want in zip(back.env_outputs.observation,
                       host.env_outputs.observation):
    assert torch.equal(got, torch.from_numpy(want))
  assert torch.equal(back.env_outputs.done,
                     torch.from_numpy(host.env_outputs.done))
  assert torch.equal(back.agent_outputs.action,
                     torch.from_numpy(host.agent_outputs.action).long())
  assert torch.equal(back.agent_state[1],
                     torch.from_numpy(host.agent_state[1]))


def test_fleet_on_card_launches_the_kernel_once_per_step(cuda, tmp_path):
  cfg = Config(logdir=str(tmp_path), env_backend='bandit', num_actors=4,
               batch_size=4, unroll_length=5, num_action_repeats=1,
               episode_length=4, height=24, width=32, torso='shallow',
               use_py_process=False, use_instruction=False,
               use_pallas_vtrace=True, inference_timeout_ms=5,
               summary_secs=0, seed=0)
  vtrace_cuda.from_importance_weights.launches = 0
  run = driver.train(cfg, max_steps=3, stall_timeout_secs=120)
  assert vtrace_cuda.from_importance_weights.launches == 3
  assert run.state.update_steps == 3
  assert all(p.is_cuda for p in run.server.live_params().values())
  assert all(p.is_cuda for p in run.state.params.values())


def test_a_checkpoint_restored_on_the_card_is_the_live_state(cuda, tmp_path):
  """Saved on the card, restored on the card: params and RMSProp's nu
  bit-equal to the saved ones, copied into the agent's own tensors; the
  health sentinels reach the host through pinned memory behind an
  event."""
  from scalable_agent_tpu_torch import health
  from scalable_agent_tpu_torch.checkpoint import Checkpointer
  cfg = Config(torso='shallow', batch_size=2, unroll_length=3,
               num_action_repeats=1, use_instruction=False)

  def state_on_card(seed):
    agent = ImpalaAgent(4, (24, 32, 3), torso='shallow')
    init_params(agent, torch.Generator().manual_seed(seed))
    agent.to(cuda)
    return agent, learner.make_train_state(agent, cfg)

  _, state = state_on_card(0)
  with torch.no_grad():
    for v in state.opt_state.nu.values():
      v.uniform_()
  state = state._replace(update_steps=5)
  ckpt = Checkpointer(str(tmp_path), save_interval_secs=0)
  assert ckpt.save(state)
  agent2, target = state_on_card(1)
  restored = ckpt.restore_latest(target)
  assert restored.update_steps == 5
  for k, p in agent2.named_parameters():
    assert restored.params[k] is p and p.is_cuda
    assert torch.equal(p, state.params[k]), k
  for k, v in restored.opt_state.nu.items():
    assert v is target.opt_state.nu[k] and v.is_cuda
    assert torch.equal(v, state.opt_state.nu[k]), k

  metrics = {'step_ok': torch.tensor(0.0, device=cuda),
             'total_loss': torch.tensor(float('nan'), device=cuda),
             'grad_norm': torch.tensor(2.5, device=cuda)}
  handle = health.stack_sentinels(metrics)
  assert handle.values.is_pinned() and handle.ready is not None
  values = health.read_handle(handle)
  assert values['step_ok'] == 0.0 and values['grad_norm'] == 2.5
  assert values['total_loss'] != values['total_loss']  # NaN


# --- process groups on the card (gloo: two ranks share one card) ----------

def _free_port():
  import socket
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _spawn_on_card(worker, world, *args):
  import torch.multiprocessing as mp
  mp.spawn(worker, args=(world, _free_port()) + args, nprocs=world)


_TP_KW = dict(torso='shallow', batch_size=8, unroll_length=5,
              num_action_repeats=1, total_environment_frames=10**6,
              use_pallas_vtrace=True, use_instruction=False, height=24,
              width=32, grad_clip_norm=5.0)


def _tp_card_rank(rank, world, port, outdir, mode):
  """A gloo rank on cuda:0 of a {data 1, model 2} mesh: two TP steps of
  `mode` on its rows of a fixed batch; rank 0 also the one-rank step."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  from scalable_agent_tpu_torch.parallel import train_parallel
  config = Config(**_TP_KW, model_parallelism=2, tp_compute=mode,
                  coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cuda:0', timeout_secs=120)
  mesh = mesh_lib.make_mesh(device, model_parallelism=2)
  batch = map_structure(torch.from_numpy, _small_batch())

  def agent():
    a = ImpalaAgent(4, (24, 32, 3), torso='shallow')
    init_params(a, torch.Generator().manual_seed(0))
    return a.to(device)

  tp_agent = agent()
  state = train_parallel.make_sharded_train_state(tp_agent, config, mesh)
  step, place = train_parallel.make_sharded_train_step(tp_agent, config,
                                                       mesh, batch)
  vtrace_cuda.sharded_from_importance_weights.launches = 0
  for _ in range(2):
    state, metrics = step(state, place(batch))
  full = train_parallel.gather_state(state, step.layout)
  result = {'launches': vtrace_cuda.sharded_from_importance_weights.launches,
            'mode': step.tp_compute, 'loss': float(metrics['total_loss']),
            'params': {k: v.detach().cpu() for k, v in full.params.items()}}
  if rank == 0:
    one = agent()
    one_config = Config(**_TP_KW)
    one_state = learner.make_train_state(one, one_config)
    one_step = learner.make_train_step_fn(one, one_config)
    for _ in range(2):
      one_state, one_metrics = one_step(
          one_state, map_structure(lambda x: x.to(device), batch))
    result['one'] = {'loss': float(one_metrics['total_loss']),
                     'params': {k: v.detach().cpu()
                                for k, v in one_state.params.items()}}
  torch.save(result, f'{outdir}/rank{rank}.pt')
  distributed.shutdown()


def _small_batch(t=5, b=8, seed=0):
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.zeros(b, np.int32),
      agent_state=(rng.randn(b, 256).astype(np.float32) * 0.3,
                   rng.randn(b, 256).astype(np.float32) * 0.3),
      env_outputs=StepOutput(
          rng.randn(t + 1, b).astype(np.float32),
          StepOutputInfo(np.zeros((t + 1, b), np.float32),
                         np.zeros((t + 1, b), np.int32)),
          rng.rand(t + 1, b) > 0.8,
          (rng.randint(0, 256, (t + 1, b, 24, 32, 3)).astype(np.uint8),
           np.zeros((t + 1, b, 16), np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, 4, (t + 1, b)),
          rng.randn(t + 1, b, 4).astype(np.float32),
          rng.randn(t + 1, b).astype(np.float32)))


@pytest.mark.parametrize('mode', ['gathered', 'sharded'])
def test_tp_step_on_card_through_gloo_matches_one_rank(cuda, tmp_path, mode):
  """Two gloo ranks on the card, the TP step's collectives (the blocks'
  all-gather, the gradient all-reduce; in `sharded` the activations' too)
  on CUDA tensors: the same numbers as the one-rank step on the card
  (loss rtol 2e-4, params rtol 5e-4 / atol 5e-6, the data-parallel
  gates), and K1b once per step per rank."""
  _spawn_on_card(_tp_card_rank, 2, str(tmp_path), mode)
  ranks = [torch.load(tmp_path / f'rank{r}.pt') for r in range(2)]
  one = ranks[0]['one']
  for result in ranks:
    assert result['mode'] == mode and result['launches'] == 2
    np.testing.assert_allclose(result['loss'], one['loss'], rtol=2e-4)
    for k, v in one['params'].items():
      np.testing.assert_allclose(result['params'][k].numpy(), v.numpy(),
                                 rtol=5e-4, atol=5e-6, err_msg=k)


def _dp_fleet_card_rank(rank, world, port, outdir):
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  config = Config(logdir=outdir, env_backend='bandit', num_actors=2,
                  batch_size=4, unroll_length=5, num_action_repeats=1,
                  episode_length=4, height=24, width=32, torso='shallow',
                  use_py_process=False, use_instruction=False,
                  use_pallas_vtrace=True, inference_timeout_ms=5,
                  summary_secs=0, seed=0,
                  coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cuda:0', timeout_secs=120)
  vtrace_cuda.from_importance_weights.launches = 0
  vtrace_cuda.sharded_from_importance_weights.launches = 0
  run = driver.train(config, max_steps=3, device=device,
                     stall_timeout_secs=120)
  torch.save({'k1': vtrace_cuda.from_importance_weights.launches,
              'k1b': vtrace_cuda.sharded_from_importance_weights.launches,
              'steps': run.state.update_steps,
              'params': {k: v.detach().cpu()
                         for k, v in run.state.params.items()}},
             f'{outdir}/rank{rank}.pt')
  distributed.shutdown()


def test_dp_fleet_on_card_launches_k1b_once_per_step(cuda, tmp_path):
  """The fleet's learner under a group of two gloo ranks on the card runs
  the sharded V-trace kernel (K1b), once per learner step per rank, and
  the ranks' params stay bit-equal."""
  _spawn_on_card(_dp_fleet_card_rank, 2, str(tmp_path))
  ranks = [torch.load(tmp_path / f'rank{r}.pt') for r in range(2)]
  for result in ranks:
    assert (result['k1'], result['k1b'], result['steps']) == (0, 3, 3)
  for k, v in ranks[0]['params'].items():
    assert torch.equal(v, ranks[1]['params'][k]), k


def _tp_repeat_rank(rank, world, port, outdir):
  """A gloo rank on cuda:0 of a {data 1, model 2} mesh: one sharded TP
  step at the deep torso's full frame (72x96, T=20, B=8: chip_smoke's
  cut of the sharded step), twice, each from the same seeded state, with
  cuDNN free to pick as training runs it; this rank's blocks after each."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  from scalable_agent_tpu_torch.parallel import train_parallel
  kw = dict(_TP_KW, torso='deep', height=72, width=96, unroll_length=20,
            batch_size=8)
  config = Config(**kw, model_parallelism=2, tp_compute='sharded',
                  coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cuda:0', timeout_secs=120)
  mesh = mesh_lib.make_mesh(device, model_parallelism=2)
  rng = np.random.RandomState(0)
  batch = map_structure(torch.from_numpy, _small_batch(t=20, b=8))
  frames = rng.randint(0, 256, (21, 8, 72, 96, 3)).astype(np.uint8)
  batch = batch._replace(env_outputs=batch.env_outputs._replace(
      observation=(torch.from_numpy(frames),
                   batch.env_outputs.observation[1])))
  runs = []
  for _ in range(2):
    agent = ImpalaAgent(4, (72, 96, 3), torso='deep')
    init_params(agent, torch.Generator().manual_seed(0))
    agent.to(device)
    state = train_parallel.make_sharded_train_state(agent, config, mesh)
    step, place = train_parallel.make_sharded_train_step(agent, config,
                                                         mesh, batch)
    state, _ = step(state, place(batch))
    runs.append({k: v.detach().cpu() for k, v in state.params.items()})
  torch.save({'runs': runs,
              'deterministic': torch.backends.cudnn.deterministic},
             f'{outdir}/rank{rank}.pt')
  distributed.shutdown()


def test_the_sharded_tp_step_repeats_bit_for_bit(cuda, tmp_path):
  """ROADMAP C4: the sharded TP step as training runs it (no cuDNN flag
  set by the caller) gives equal bits from the same state; the step's
  pin leaves cudnn.deterministic as it found it."""
  _spawn_on_card(_tp_repeat_rank, 2, str(tmp_path))
  for r in range(2):
    result = torch.load(tmp_path / f'rank{r}.pt')
    assert result['deterministic'] is False
    first, second = result['runs']
    for k, v in first.items():
      assert torch.equal(v, second[k]), (r, k)
