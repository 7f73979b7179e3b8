"""The six transport fault sites of the port (runtime/faults.py, fired by
runtime/remote.py and driver.train): their helpers against the JAX
package's on the same inputs and seeds (bit-equal frames and param trees,
the same bytes on the wire, the same delays), the storm's schedule, and
each site through the real code path: a transport fault the ingest
survives and quarantines, a partition the idle reaper reaps, a delay it
tolerates, a bit flip the actor host's CRC probation ladder handles, and
a learner_crash that SIGKILLs the learner's CLI."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.runtime import codec
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.runtime import remote, ring_buffer
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)

# The autouse check that no ingest thread or socket outlives a test.
from test_torch_remote import _no_leaked_threads_or_sockets  # noqa: F401

torch.set_num_threads(1)

_TRANSPORT_SITES = ('transport_send', 'conn_partition', 'conn_delay',
                    'learner_crash', 'wire_bitflip', 'publish_corrupt')


@pytest.fixture(autouse=True)
def _clear_plan():
  yield
  faults.clear()


def _unroll(seed=0, t1=3):
  rng = np.random.RandomState(seed)
  return ActorOutput(
      level_name=np.int32(0),
      agent_state=(np.zeros((1, 4), np.float32),
                   np.ones((1, 4), np.float32)),
      env_outputs=StepOutput(
          reward=rng.randn(t1).astype(np.float32),
          info=StepOutputInfo(np.zeros(t1, np.float32),
                              np.zeros(t1, np.int32)),
          done=np.zeros(t1, bool),
          observation=(rng.randint(0, 255, (t1, 24, 32, 3)).astype(np.uint8),
                       np.zeros((t1, 16), np.int32))),
      agent_outputs=AgentOutput(
          action=rng.randint(0, 3, t1).astype(np.int32),
          policy_logits=rng.randn(t1, 3).astype(np.float32),
          baseline=rng.randn(t1).astype(np.float32)))


def test_every_jax_site_is_ported():
  from scalable_agent_tpu.runtime import faults as jax_faults
  assert sorted(faults.PORTED_SITES) == sorted(jax_faults.SITES)
  assert len(faults.PORTED_SITES) == 14
  assert set(_TRANSPORT_SITES) <= set(faults.PORTED_SITES)


def test_the_transport_storm_installs_with_jax_s_schedule():
  from scalable_agent_tpu.runtime import faults as jax_faults
  kw = dict(seed=4, transport=['garbage', 'truncate', 'drop'],
            conn_partition_at=2, conn_partition_secs=1.5,
            conn_delay=[1, 3], conn_delay_secs=0.25, learner_crash_at=2,
            wire_bitflip=[0, 5], publish_corrupt_at=1,
            publish_corrupt_len=2)
  plan = faults.FaultPlan.storm(**kw)
  assert plan.to_json() == jax_faults.FaultPlan.storm(**kw).to_json()
  faults.install(plan)
  assert faults.active() is plan
  fired = [faults.fire('transport_send') for _ in range(12)]
  assert [(f.index, f.kind) for f in fired if f is not None] == [
      (3, 'garbage'), (7, 'truncate'), (11, 'drop')]


@pytest.mark.parametrize('seed,index', [(0, 0), (3, 1), (17, 6)])
def test_wire_bitflip_is_jax_s(seed, index):
  from scalable_agent_tpu.runtime import faults as jax_faults
  from scalable_agent_tpu.runtime import remote as jax_remote
  segments = remote._oob_frame_segments(('unroll', _unroll(seed)))
  fault = faults.Fault('wire_bitflip', index, 'flip')
  port = faults.apply_wire_bitflip(fault, segments, seed=seed)
  ref = jax_faults.apply_wire_bitflip(
      jax_faults.Fault('wire_bitflip', index, 'flip'),
      jax_remote._oob_frame_segments(('unroll', _unroll(seed))),
      seed=seed)
  assert [bytes(s) for s in port] == [bytes(s) for s in ref]
  # A copy was damaged; the frame still parses, with a stale CRC.
  assert [bytes(s) for s in segments] != [bytes(s) for s in port]
  assert remote._segments_crc(port) != remote._segments_crc(segments)
  assert faults.apply_wire_bitflip(fault, segments[:1]) == segments[:1]


def _params(seed=0):
  rng = np.random.RandomState(seed)
  return {'torso': {'w': rng.randn(16, 3).astype(np.float32),
                    'b': np.zeros(16, np.float32)},
          'head': rng.randn(9, 32).astype(np.float32),
          'steps': np.int64(3)}


@pytest.mark.parametrize('form', ['f32', 'bf16', 'int8'])
def test_corrupt_params_tree_is_jax_s(form):
  """One seeded bit of the largest leaf, in JAX's flatten order, on each
  wire form; the digest then catches it in both packages."""
  import ml_dtypes
  from scalable_agent_tpu import integrity as jax_integrity
  from scalable_agent_tpu.runtime import codec as jax_codec
  from scalable_agent_tpu.runtime import faults as jax_faults
  params = _params()
  if form == 'bf16':
    port_tree = codec.to_bf16_np(params)
    ref_tree = {'torso': {k: v.astype(ml_dtypes.bfloat16)
                          for k, v in params['torso'].items()},
                'head': params['head'].astype(ml_dtypes.bfloat16),
                'steps': params['steps']}
  elif form == 'int8':
    port_tree = codec.quantize_np(params)
    ref_tree = jax_codec.quantize_np(params)
  else:
    port_tree = ref_tree = params
  port = faults.corrupt_params_tree(
      faults.Fault('publish_corrupt', 2, 'flip'), port_tree, seed=9)
  ref = jax_faults.corrupt_params_tree(
      jax_faults.Fault('publish_corrupt', 2, 'flip'), ref_tree, seed=9)
  port_leaves = codec.wire_leaves(port)
  ref_leaves = [np.asarray(x) for x in
                __import__('jax').tree_util.tree_leaves(ref)]
  assert len(port_leaves) == len(ref_leaves)
  for a, b in zip(port_leaves, ref_leaves):
    a, b = np.asarray(a), np.asarray(b)
    assert a.tobytes() == b.tobytes() and a.shape == b.shape
  assert remote._wire_digest(port) == jax_integrity.tree_digest(ref)
  assert remote._wire_digest(port) != remote._wire_digest(port_tree)


@pytest.mark.parametrize('kind', ['delay', 'jitter'])
def test_conn_delay_sleeps_as_jax(kind, monkeypatch):
  from scalable_agent_tpu.runtime import faults as jax_faults
  slept = []
  monkeypatch.setattr(time, 'sleep', slept.append)
  for index in range(4):
    faults.apply_conn_delay(faults.Fault('conn_delay', index, kind,
                                         param=0.5), seed=7)
    jax_faults.apply_conn_delay(jax_faults.Fault('conn_delay', index, kind,
                                                 param=0.5), seed=7)
  assert slept[0::2] == slept[1::2]
  assert len(set(slept)) == (1 if kind == 'delay' else 4)
  faults.apply_conn_partition(faults.Fault('conn_partition', 0,
                                           'blackhole', param=1.5))
  assert slept[-1] == 1.5


@pytest.mark.parametrize('kind', ['garbage', 'truncate', 'drop'])
def test_transport_fault_bytes_are_jax_s(kind):
  from scalable_agent_tpu.runtime import faults as jax_faults
  got = []
  for module in (faults, jax_faults):
    a, b = socket.socketpair()
    b.settimeout(5)
    with pytest.raises(ConnectionError, match=kind):
      module.apply_transport_fault(module.Fault('transport_send', 3, kind),
                                   a, seed=5)
    data = b''
    while True:
      chunk = b.recv(4096)
      if not chunk:
        break
      data += chunk
    b.close()
    got.append(data)
  assert got[0] == got[1]
  assert (len(got[0]) > 0) == (kind != 'drop')


@pytest.mark.parametrize('kind', ['garbage', 'truncate', 'drop'])
def test_transport_send_fault_is_survived(kind):
  """The client's rpc ships the damage and raises ConnectionError; the
  ingest quarantines the unparseable frame (random bytes where the tag
  belongs, whole or truncated), keeps serving, and the buffer never sees
  any of it."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = remote.TrajectoryIngestServer(buffer, {'w': np.zeros(1)})
  client = remote.RemoteActorClient(f'127.0.0.1:{server.port}',
                                    connect_timeout_secs=10,
                                    io_timeout_secs=10)
  try:
    assert client.send_unroll(_unroll(0)) == 1
    faults.install(faults.FaultPlan([faults.Fault('transport_send', 0,
                                                  kind)], seed=2))
    with pytest.raises(ConnectionError, match='injected transport'):
      client.send_unroll(_unroll(1))
    faults.clear()
    deadline = time.monotonic() + 10
    while server.stats()['live'] and time.monotonic() < deadline:
      time.sleep(0.05)
    stats = server.stats()
    assert stats['live'] == 0
    assert stats['quarantined'] == (0 if kind == 'drop' else 1)
    assert stats['unrolls'] == 1 and len(buffer) == 1
    fresh = remote.RemoteActorClient(f'127.0.0.1:{server.port}',
                                     connect_timeout_secs=10)
    try:
      assert fresh.send_unroll(_unroll(2)) == 1
    finally:
      fresh.close()
  finally:
    client.close()
    server.close()
    buffer.close()


@pytest.mark.parametrize('site', ['conn_partition', 'conn_delay'])
def test_partition_is_reaped_and_delay_is_not(site):
  """A blackhole longer than the idle window gets the connection reaped
  (the healed client finds it dead); a delay inside the window is
  tolerated."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = remote.TrajectoryIngestServer(
      buffer, {'w': np.zeros(1)}, heartbeat_secs=0.1, idle_timeout_secs=0.5)
  client = remote.RemoteActorClient(f'127.0.0.1:{server.port}',
                                    connect_timeout_secs=10,
                                    io_timeout_secs=5)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    kind, secs = (('blackhole', 1.5) if site == 'conn_partition'
                  else ('delay', 0.3))
    faults.install(faults.FaultPlan([faults.Fault(site, 0, kind,
                                                  param=secs)], seed=0))
    t0 = time.monotonic()
    if site == 'conn_partition':
      with pytest.raises(OSError):
        client.ping()
      assert server.stats()['conns_reaped'] >= 1
    else:
      assert client.ping() == 1
      assert server.stats()['conns_reaped'] == 0
    assert time.monotonic() - t0 >= secs
  finally:
    client.close()
    server.close()
    buffer.close()


@pytest.mark.parametrize('flips,quarantined', [([0], False),
                                               ([0, 1], False),
                                               ([0, 1, 2], True)])
def test_the_actor_host_s_crc_ladder(flips, quarantined, caplog):
  """run_remote_actor under wire_bitflip: one refusal resends, two take
  the probation probe (acked: the host stays), three self-quarantine; the
  buffer only ever holds clean unrolls."""
  from scalable_agent_tpu_torch.envs import factory
  from scalable_agent_tpu_torch.models import init_params
  cfg = Config(env_backend='bandit', num_actors=1, batch_size=1,
               unroll_length=3, num_action_repeats=1, episode_length=4,
               height=24, width=32, torso='shallow', use_py_process=False,
               use_instruction=False, inference_timeout_ms=5, seed=3,
               actor_reconnect_secs=0.0, fleet_probation_secs=0.0)
  spec0 = factory.make_env_spec(cfg, factory.level_names(cfg)[0], seed=1)
  agent = driver.build_agent(cfg, spec0.num_actions)
  init_params(agent, torch.Generator().manual_seed(cfg.seed))
  buffer = ring_buffer.TrajectoryBuffer(8)
  server = remote.TrajectoryIngestServer(
      buffer, driver.host_params(dict(agent.named_parameters())),
      contract=remote.trajectory_contract(cfg, agent, spec0.num_actions))
  faults.install(faults.FaultPlan(
      [faults.Fault('wire_bitflip', i, 'flip') for i in flips], seed=1))
  try:
    with caplog.at_level('WARNING', logger='scalable_agent_tpu_torch'):
      sent = remote.run_remote_actor(
          cfg, f'127.0.0.1:{server.port}', stop_after_unrolls=2,
          device='cpu', connect_timeout_secs=10)
    stats = server.stats()
  finally:
    faults.clear()
    server.close()
    buffer.close()
  assert stats['wire_crc_rejected'] == len(flips)
  assert sent == (0 if quarantined else 2)
  assert stats['unrolls'] == sent
  assert ('SELF-QUARANTINED' in caplog.text) == quarantined
  assert ('probe ACCEPTED' in caplog.text) == (flips == [0, 1])
  assert 'INTEGRITY_REPORT' in caplog.text


def test_an_actor_host_on_the_state_arena_ships_host_carries():
  """With inference_state_cache, an actor host's carry lives in its
  server's arena; its unrolls ship the (c, h) snapshot as numpy [1, 256]
  as the carry path does, and pass the learner's contract."""
  from scalable_agent_tpu_torch.envs import factory
  from scalable_agent_tpu_torch.models import init_params
  cfg = Config(env_backend='bandit', num_actors=2, batch_size=2,
               unroll_length=3, num_action_repeats=1, episode_length=4,
               height=24, width=32, torso='shallow', use_py_process=False,
               use_instruction=False, inference_timeout_ms=5, seed=5,
               inference_state_cache=True, actor_reconnect_secs=0.0)
  spec0 = factory.make_env_spec(cfg, factory.level_names(cfg)[0], seed=1)
  agent = driver.build_agent(cfg, spec0.num_actions)
  init_params(agent, torch.Generator().manual_seed(cfg.seed))
  buffer = ring_buffer.TrajectoryBuffer(8)
  server = remote.TrajectoryIngestServer(
      buffer, driver.host_params(dict(agent.named_parameters())),
      contract=remote.trajectory_contract(cfg, agent, spec0.num_actions))
  try:
    sent = remote.run_remote_actor(cfg, f'127.0.0.1:{server.port}',
                                   stop_after_unrolls=4, device='cpu',
                                   connect_timeout_secs=10)
    stats = server.stats()
    landed = [buffer.get(timeout=5) for _ in range(4)]
  finally:
    server.close()
    buffer.close()
  assert sent == 4 and stats['unrolls'] == 4 and stats['rejected'] == 0
  for unroll in landed:
    c, h = unroll.agent_state
    assert isinstance(c, np.ndarray) and c.shape == h.shape == (1, 256)


def test_learner_crash_sigkills_the_learner_cli(tmp_path):
  """The learner's CLI, with the plan from the environment, dies by
  SIGKILL at the scheduled consumed batch: no unwind, no final save."""
  plan = faults.FaultPlan([faults.Fault('learner_crash', 1, 'kill')])
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS='1')
  env[faults.PLAN_ENV_VAR] = plan.to_json()
  code = ('import sys; from scalable_agent_tpu_torch.runtime import faults; '
          'faults.install_from_env(); '
          'from scalable_agent_tpu_torch import experiment; '
          'experiment.main(sys.argv[1:])')
  args = [sys.executable, '-c', code, '--mode=train', '--device=cpu',
          '--env_backend=bandit', '--torso=shallow', '--height=24',
          '--width=32', '--batch_size=2', '--num_actors=2',
          '--unroll_length=3', '--num_action_repeats=1',
          '--use_instruction=false', '--use_py_process=false',
          '--total_environment_frames=1000', '--summary_secs=0',
          f'--logdir={tmp_path}']
  proc = subprocess.run(args, cwd=repo, env=env, capture_output=True,
                        text=True, timeout=30)
  assert proc.returncode == -9, proc.stderr[-3000:]
  assert 'learner_crash fault firing (index 1)' in proc.stderr
  assert not os.path.exists(os.path.join(tmp_path, 'checkpoints',
                                         'LAST_GOOD'))
