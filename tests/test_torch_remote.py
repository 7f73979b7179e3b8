"""The port's remote actors (scalable_agent_tpu_torch/runtime/remote.py).

Two halves. The parity tests hold the port against the JAX package's
runtime/remote.py on the same inputs, made from numpy seeds: the wire
frames and their CRCs byte for byte, the trajectory contract of six
configs, the validators' messages, Backoff and CrcProbation, the bf16 and
int8 param wire forms and their digests, and a learner step fed over the
wire against JAX's step on the same unrolls (loss rtol 2e-4, params rtol
5e-4 / atol 5e-6: the bar of tests/test_torch_learner.py).

The behaviour tests mirror tests/test_remote.py one behaviour each, on the
port's classes (repeats merged as parametrised cases), and end with the
port's CLI as an actor-host child process feeding driver.train. Every
socket wait is bounded; no test waits more than 30 s on anything, and the
autouse fixture fails a test that leaves an ingest thread behind.
"""

import dataclasses
import json
import os
import pickle
import random
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.runtime import codec
from scalable_agent_tpu_torch.runtime import faults as faults_lib
from scalable_agent_tpu_torch.runtime import remote, ring_buffer
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)

torch.set_num_threads(1)

_SERVICE_THREADS = ('ingest', 'param-lane')


def _open_sockets() -> int:
  fd_dir = '/proc/self/fd'
  if not os.path.isdir(fd_dir):
    return 0
  count = 0
  for name in os.listdir(fd_dir):
    try:
      count += os.readlink(os.path.join(fd_dir, name)).startswith('socket:')
    except OSError:
      pass
  return count


@pytest.fixture(autouse=True)
def _no_leaked_threads_or_sockets():
  """Every ingest reader, worker, reaper and param lane a test started is
  gone once the test closed its server, and so is every socket it
  opened (counted against those open before the test)."""
  import gc
  before = {t.ident for t in threading.enumerate()}
  sockets_before = _open_sockets()
  yield
  faults_lib.clear()
  deadline = time.monotonic() + 10.0
  while True:
    leaked = [t.name for t in threading.enumerate()
              if t.ident not in before and t.is_alive()
              and t.name.startswith(_SERVICE_THREADS)]
    sockets = _open_sockets()
    if sockets > sockets_before:
      gc.collect()  # sockets only a collected cycle still holds
      sockets = _open_sockets()
    if (not leaked and sockets <= sockets_before) or (
        time.monotonic() > deadline):
      break
    time.sleep(0.05)
  assert not leaked, leaked
  assert sockets <= sockets_before, (sockets, sockets_before)


def _tiny_unroll(seed=0, t1=3, num_actions=3, structs=None):
  """A small unroll of numpy leaves in `structs`' NamedTuples (the
  port's by default; the JAX package's for the parity tests)."""
  s = structs
  rng = np.random.RandomState(seed)
  return (s.ActorOutput if s else ActorOutput)(
      level_name=np.int32(0),
      agent_state=(np.zeros((1, 4), np.float32),
                   np.ones((1, 4), np.float32)),
      env_outputs=(s.StepOutput if s else StepOutput)(
          reward=rng.randn(t1).astype(np.float32),
          info=(s.StepOutputInfo if s else StepOutputInfo)(
              np.zeros(t1, np.float32), np.zeros(t1, np.int32)),
          done=np.zeros(t1, bool),
          observation=(
              rng.randint(0, 255, (t1, 4, 6, 3)).astype(np.uint8),
              np.zeros((t1, 5), np.int32))),
      agent_outputs=(s.AgentOutput if s else AgentOutput)(
          action=rng.randint(0, num_actions, t1).astype(np.int32),
          policy_logits=rng.randn(t1, num_actions).astype(np.float32),
          baseline=rng.randn(t1).astype(np.float32)))


def _leaves(tree):
  return [x for _, x in remote._flatten_with_path(tree)]


def _assert_trees_equal(a, b):
  la, lb = remote._flatten_with_path(a), remote._flatten_with_path(b)
  assert [p for p, _ in la] == [p for p, _ in lb]
  for (_, x), (_, y) in zip(la, lb):
    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert np.asarray(x).dtype == np.asarray(y).dtype


_H, _W = 24, 32  # the shallow torso's smallest frames are 20x20


def _contract_setup(num_actions=3, **overrides):
  """(config, agent, contract) for the handshake tests."""
  cfg = Config(env_backend='bandit', unroll_length=2, height=_H, width=_W,
               torso='shallow', use_instruction=False,
               num_actions=num_actions, **overrides)
  agent = driver.build_agent(cfg, num_actions)
  return cfg, agent, remote.trajectory_contract(cfg, agent, num_actions)


def _conforming_unroll(cfg, agent, num_actions, seed=0, structs=None):
  """An unroll matching `trajectory_contract(cfg, agent, ...)`."""
  s = structs
  t1 = cfg.unroll_length + 1
  rng = np.random.RandomState(seed)
  hidden = agent.hidden_size
  return (s.ActorOutput if s else ActorOutput)(
      level_name=np.int32(0),
      agent_state=(np.zeros((1, hidden), np.float32),
                   np.zeros((1, hidden), np.float32)),
      env_outputs=(s.StepOutput if s else StepOutput)(
          reward=rng.randn(t1).astype(np.float32),
          info=(s.StepOutputInfo if s else StepOutputInfo)(
              np.zeros(t1, np.float32), np.zeros(t1, np.int32)),
          done=rng.rand(t1) < 0.05,
          observation=(
              rng.randint(0, 255, (t1, cfg.height, cfg.width, 3)).astype(
                  np.uint8),
              rng.randint(0, 1000, (t1, 16)).astype(np.int32))),
      agent_outputs=(s.AgentOutput if s else AgentOutput)(
          action=rng.randint(0, num_actions, t1).astype(np.int32),
          policy_logits=rng.randn(t1, num_actions).astype(np.float32),
          baseline=rng.randn(t1).astype(np.float32)))


def _server(buffer, params=None, **kw):
  return remote.TrajectoryIngestServer(
      buffer, {'w': np.zeros(1)} if params is None else params,
      host='127.0.0.1', **kw)


def _client(server, **kw):
  kw.setdefault('connect_timeout_secs', 10)
  return remote.RemoteActorClient(f'127.0.0.1:{server.port}', **kw)


def _poll_until(predicate, timeout=8.0, interval=0.05):
  deadline = time.monotonic() + timeout
  while time.monotonic() < deadline:
    if predicate():
      return True
    time.sleep(interval)
  return predicate()


# ---------------------------------------------------------------------
# Parity with the JAX package's runtime/remote.py.
# ---------------------------------------------------------------------


def _frame_objects():
  rng = np.random.RandomState(7)
  return [
      ('ack', 7),
      {'empty': np.zeros((0, 4), np.float32), 'scalar': np.float64(1.5),
       'text': 'plain python rides in the skeleton'},
      ('unroll', (rng.randn(3, 5).astype(np.float32),
                  rng.randint(0, 255, (3, 24, 32, 3)).astype(np.uint8),
                  {'b': np.arange(300000, dtype=np.int32), 'a': 'x'}),
       3, 12345),
  ]


@pytest.mark.parametrize('case', range(3))
def test_frames_and_crcs_are_byte_equal_to_jax(case):
  from scalable_agent_tpu.runtime import remote as jax_remote
  obj = _frame_objects()[case]
  payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
  for crc in (False, True):
    assert (remote._plain_frame(payload, crc=crc)
            == jax_remote._plain_frame(payload, crc=crc))
  port = remote._oob_frame_segments(obj)
  ref = jax_remote._oob_frame_segments(obj)
  assert len(port) == len(ref)
  assert b''.join(bytes(s) for s in port) == b''.join(bytes(s) for s in ref)
  assert remote._segments_crc(port) == jax_remote._segments_crc(ref)


def _contract_configs():
  return {
      'bandit': dict(env_backend='bandit', num_actions=3),
      'instruction': dict(env_backend='bandit', num_actions=3,
                          use_instruction=True),
      'popart': dict(env_backend='bandit', num_actions=3, use_popart=True),
      'pixel_control': dict(env_backend='bandit', num_actions=3,
                            pixel_control_cost=0.01),
      'bfloat16': dict(env_backend='bandit', num_actions=3,
                       compute_dtype='bfloat16'),
      'dmlab30': dict(env_backend='fake', level_name='dmlab30',
                      use_instruction=True),
  }


@pytest.mark.parametrize('name', sorted(_contract_configs()))
def test_the_contract_is_jax_s(name):
  """`fields` and the keystr-keyed `signature` equal JAX's on the same
  config, each side from its own agent."""
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.envs import factory as jax_factory
  from scalable_agent_tpu.runtime import remote as jax_remote
  from scalable_agent_tpu_torch.envs import factory
  kw = dict(_contract_configs()[name], unroll_length=4, height=_H,
            width=_W, torso='shallow')
  kw.setdefault('use_instruction', False)
  cfg, jcfg = Config(**kw), JaxConfig(**kw)
  levels = factory.level_names(cfg)
  num_actions = factory.make_env_spec(cfg, levels[0], seed=1).num_actions
  jlevels = jax_factory.level_names(jcfg)
  assert jax_factory.make_env_spec(jcfg, jlevels[0],
                                   seed=1).num_actions == num_actions
  port = remote.trajectory_contract(
      cfg, driver.build_agent(cfg, num_actions, len(levels)), num_actions)
  ref = jax_remote.trajectory_contract(
      jcfg, jax_driver.build_agent(jcfg, num_actions,
                                   num_tasks=len(jlevels)), num_actions)
  assert port['fields'] == ref['fields']
  assert port['signature'] == ref['signature']
  assert port['protocol'] == ref['protocol'] == 10
  assert remote.contract_mismatch_message(port, port) is None


def _damaged(good, kind):
  if kind == 'shape':
    return good._replace(env_outputs=good.env_outputs._replace(
        observation=(np.zeros((3, 48, _W, 3), np.uint8),
                     good.env_outputs.observation[1])))
  if kind == 'dtype':
    return good._replace(agent_outputs=good.agent_outputs._replace(
        baseline=good.agent_outputs.baseline.astype(np.float64)))
  if kind == 'level_high':
    return good._replace(level_name=np.int32(5))
  if kind == 'level_negative':
    return good._replace(level_name=np.int32(-1))
  if kind == 'action':
    return good._replace(agent_outputs=good.agent_outputs._replace(
        action=np.array([0, 1, 9], np.int32)))
  if kind == 'structure':
    return good._replace(agent_state=good.agent_state[0])
  return good


@pytest.mark.parametrize('kind', ['shape', 'dtype', 'level_high',
                                  'level_negative', 'action', 'structure',
                                  'clean'])
def test_validation_messages_are_jax_s(kind):
  """unroll_violations and FastUnrollValidator give JAX's messages on
  the same damaged unroll, each built in its own package's structs."""
  from scalable_agent_tpu import structs as jax_structs
  from scalable_agent_tpu.runtime import remote as jax_remote
  cfg, agent, contract = _contract_setup()
  jax_contract = dict(contract, signature_tree=None)
  port = _damaged(_conforming_unroll(cfg, agent, 3, seed=4), kind)
  ref = _damaged(_conforming_unroll(cfg, agent, 3, seed=4,
                                    structs=jax_structs), kind)
  want = jax_remote.unroll_violations(ref, jax_contract)
  assert remote.unroll_violations(port, contract) == want
  assert remote.FastUnrollValidator(contract)(port) == want
  assert (want == []) == (kind == 'clean')


def test_backoff_and_probation_are_jax_s():
  from scalable_agent_tpu.runtime import remote as jax_remote
  for base, cap in ((0.2, 5.0), (0.3, 3.0), (1.0, 1.0)):
    port = remote.Backoff(base=base, cap=cap, rng=random.Random(3))
    ref = jax_remote.Backoff(base=base, cap=cap, rng=random.Random(3))
    assert ([port.next_delay() for _ in range(12)]
            == [ref.next_delay() for _ in range(12)])
    assert port.attempt == ref.attempt
  script = ['refuse', 'refuse', 'ack', 'next', 'refuse', 'refuse', 'ack',
            'next', 'refuse', 'ack', 'next', 'refuse', 'refuse', 'refuse']
  port = remote.CrcProbation(cooldown_secs=0.0)
  ref = jax_remote.CrcProbation(cooldown_secs=0.0)
  for event in script:
    if event == 'refuse':
      assert port.on_refusal() == ref.on_refusal()
    elif event == 'ack':
      assert port.on_ack() == ref.on_ack()
    else:
      port.next_unroll()
      ref.next_unroll()
  assert ((port.crc_resends, port.probations, port.recoveries)
          == (ref.crc_resends, ref.probations, ref.recoveries))
  with pytest.raises(ValueError):
    remote.Backoff(base=0)


def _param_tree(seed=0):
  rng = np.random.RandomState(seed)
  return {'torso': {'w': rng.randn(64, 3).astype(np.float32) * 3,
                    'b': np.zeros(64, np.float32)},
          'head': rng.randn(9, 256).astype(np.float32),
          'steps': np.int64(123), 'mask': np.array([True, False])}


def test_the_param_wire_forms_are_jax_s():
  """bf16 bits equal ml_dtypes' cast (specials too), int8 q and scales
  equal JAX's quantize_np and decode alike, and the publish digest of
  each wire form equals JAX's integrity.tree_digest of its own."""
  import ml_dtypes
  from scalable_agent_tpu import integrity as jax_integrity
  from scalable_agent_tpu.runtime import codec as jax_codec
  params = _param_tree()
  special = dict(params, head=params['head'].copy())
  special['head'][0, :6] = [np.inf, -np.inf, 3.4e38, 1e-40, -0.0, 1e-45]
  np.testing.assert_array_equal(
      codec.to_bf16_np(special)['head'].bits,
      special['head'].astype(ml_dtypes.bfloat16).view(np.uint16))
  bf16 = codec.to_bf16_np(params)
  jax_bf16 = {k: v.astype(ml_dtypes.bfloat16)
              if getattr(v, 'dtype', None) == np.float32 else v
              for k, v in params.items() if k != 'torso'}
  jax_bf16['torso'] = {k: v.astype(ml_dtypes.bfloat16)
                       for k, v in params['torso'].items()}
  np.testing.assert_array_equal(
      bf16['head'].bits, jax_bf16['head'].view(np.uint16))
  np.testing.assert_array_equal(
      bf16['torso']['w'].bits, jax_bf16['torso']['w'].view(np.uint16))
  up = codec.from_bf16_np(bf16)
  np.testing.assert_array_equal(up['head'],
                                jax_bf16['head'].astype(np.float32))
  assert up['steps'] == 123 and up['steps'].dtype == np.int64
  assert remote._wire_digest(bf16) == jax_integrity.tree_digest(jax_bf16)

  int8, jax_int8 = codec.quantize_np(params), jax_codec.quantize_np(params)
  for port_leaf, ref_leaf in ((int8['head'], jax_int8['head']),
                              (int8['torso']['w'], jax_int8['torso']['w'])):
    np.testing.assert_array_equal(port_leaf.q, ref_leaf.q)
    assert port_leaf.scale == ref_leaf.scale
  np.testing.assert_array_equal(codec.dequantize_np(int8)['head'],
                                jax_codec.dequantize_np(jax_int8)['head'])
  assert remote._wire_digest(int8) == jax_integrity.tree_digest(jax_int8)
  assert remote._wire_digest(params) == jax_integrity.tree_digest(params)
  # Int8Leaf pickles as q and scale (q out of band under protocol 5).
  again = pickle.loads(pickle.dumps(int8['head'], protocol=5))
  np.testing.assert_array_equal(again.q, int8['head'].q)


T, B, A = 5, 3, 9


def _learner_unrolls(seed=0):
  """B unrolls of the learner parity batch's shape, numpy leaves."""
  rng = np.random.RandomState(seed)
  unrolls = []
  for _ in range(B):
    unrolls.append(ActorOutput(
        level_name=np.int32(0),
        agent_state=((rng.randn(1, 256) * 0.3).astype(np.float32),
                     (rng.randn(1, 256) * 0.3).astype(np.float32)),
        env_outputs=StepOutput(
            reward=rng.randn(T + 1).astype(np.float32),
            info=StepOutputInfo(np.zeros(T + 1, np.float32),
                                np.zeros(T + 1, np.int32)),
            done=rng.rand(T + 1) > 0.8,
            observation=(
                rng.randint(0, 256, (T + 1, _H, _W, 3)).astype(np.uint8),
                np.zeros((T + 1, 16), np.int32))),
        agent_outputs=AgentOutput(
            action=rng.randint(0, A, T + 1).astype(np.int32),
            policy_logits=rng.randn(T + 1, A).astype(np.float32),
            baseline=rng.randn(T + 1).astype(np.float32))))
  return unrolls


def test_a_wire_fed_learner_step_matches_jax():
  """Seeded unrolls: RemoteActorClient -> TrajectoryIngestServer ->
  TrajectoryBuffer -> batch, bit-exact against the same unrolls batched
  straight; then the port's learner step on it, on converted weights,
  against JAX's step on the same batch."""
  import jax
  import jax.numpy as jnp
  from scalable_agent_tpu import learner as jax_learner
  from scalable_agent_tpu import structs as jax_structs
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.models import agent as jax_agent
  from scalable_agent_tpu.models import init_params as jax_init_params
  from scalable_agent_tpu_torch import convert, learner
  from scalable_agent_tpu_torch.runtime.actor import batch_unrolls

  kw = dict(torso='shallow', batch_size=B, unroll_length=T,
            num_action_repeats=1, total_environment_frames=60,
            use_instruction=False, height=_H, width=_W, num_actions=A,
            env_backend='bandit')
  cfg, jcfg = Config(**kw), JaxConfig(**kw)
  agent = driver.build_agent(cfg, A)
  contract = remote.trajectory_contract(cfg, agent, A)
  unrolls = _learner_unrolls()
  buffer = ring_buffer.TrajectoryBuffer(B)
  server = _server(buffer, contract=contract)
  client = _client(server)
  try:
    client.handshake(contract)
    for u in unrolls:
      assert client.send_unroll(u, params_version=1) == 1
    landed = [buffer.get(timeout=10) for _ in range(B)]
  finally:
    client.close()
    server.close()
    buffer.close()
  for got, sent in zip(landed, unrolls):
    _assert_trees_equal(got, sent)
  batch = batch_unrolls(landed)
  _assert_trees_equal(batch, batch_unrolls(unrolls))

  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (_H, _W, 3), 'instr_len': 16})
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  state = learner.make_train_state(agent, cfg)
  state, metrics = learner.make_train_step_fn(agent, cfg)(
      state, learner.place_batch(batch, 'cpu'))
  j = jax.tree_util.tree_map(jnp.asarray, batch)
  jbatch = jax_structs.ActorOutput(
      level_name=j.level_name, agent_state=tuple(j.agent_state),
      env_outputs=jax_structs.StepOutput(
          j.env_outputs.reward,
          jax_structs.StepOutputInfo(*j.env_outputs.info),
          j.env_outputs.done, tuple(j.env_outputs.observation)),
      agent_outputs=jax_structs.AgentOutput(*j.agent_outputs))
  jstate = jax_learner.make_train_state(params, jcfg)
  jstate, jmetrics = jax_learner.make_train_step(jagent, jcfg)(jstate,
                                                               jbatch)
  np.testing.assert_allclose(float(metrics['total_loss']),
                             float(jmetrics['total_loss']), rtol=2e-4)
  ref = convert.params_from_jax(jax.device_get(jstate.params))
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=k)


# ---------------------------------------------------------------------
# Behaviour, one test per behaviour of tests/test_remote.py.
# ---------------------------------------------------------------------


def test_oob_frame_roundtrip():
  a, b = socket.socketpair()
  try:
    unroll = _tiny_unroll(3)
    remote._send_oob(a, ('unroll', unroll))
    kind, got = remote._recv_msg(b)
    assert kind == 'unroll'
    _assert_trees_equal(got, unroll)
    remote._send_msg(a, ('ack', 7))
    assert remote._recv_msg(b) == ('ack', 7)
    weird = {'empty': np.zeros((0, 4), np.float32),
             'scalar': np.float64(1.5),
             'text': 'plain python rides in the skeleton'}
    remote._send_oob(a, weird)
    got = remote._recv_msg(b)
    assert got['empty'].shape == (0, 4)
    assert got['scalar'] == 1.5
    assert got['text'] == weird['text']
  finally:
    a.close()
    b.close()


def test_version_skewed_peer_dropped_cleanly():
  """An untagged (pre-v4) frame drops just that connection; the client
  side raises a terminal ProtocolError on an untagged reply."""
  buffer = ring_buffer.TrajectoryBuffer(2)
  server = _server(buffer)
  try:
    legacy = socket.create_connection(('127.0.0.1', server.port))
    legacy.settimeout(10)
    payload = pickle.dumps(('hello', None),
                           protocol=pickle.HIGHEST_PROTOCOL)
    legacy.sendall(remote._LEN.pack(len(payload)) + payload)  # no tag
    try:
      assert legacy.recv(1) == b''
    except ConnectionResetError:
      pass
    legacy.close()
    healthy = _client(server)
    try:
      assert healthy.fetch_params()[0] == 1
    finally:
      healthy.close()
    assert server.stats()['quarantined'] == 1
  finally:
    server.close()
    buffer.close()

  with socket.create_server(('127.0.0.1', 0)) as srv:
    port = srv.getsockname()[1]
    srv.settimeout(10)

    def serve_legacy():
      main_conn, _ = srv.accept()
      param_conn, _ = srv.accept()
      param_conn.settimeout(10)
      remote._recv_msg(param_conn)      # 'hello_params'
      remote._recv_msg(param_conn)      # 'get_params'
      reply = pickle.dumps(('params', 1, {}),
                           protocol=pickle.HIGHEST_PROTOCOL)
      param_conn.sendall(remote._LEN.pack(len(reply)) + reply)  # no tag
      try:
        param_conn.recv(1)
      except OSError:
        pass
      param_conn.close()
      main_conn.close()

    t = threading.Thread(target=serve_legacy, daemon=True)
    t.start()
    client = remote.RemoteActorClient(f'127.0.0.1:{port}',
                                      connect_timeout_secs=10,
                                      io_timeout_secs=10)
    try:
      with pytest.raises(remote.ProtocolError, match='version'):
        client.fetch_params()
    finally:
      client.close()
      t.join(timeout=10)


def test_handshake_rejects_skewed_config():
  cfg, agent, learner_contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=learner_contract)
  try:
    skewed_cfg = dataclasses.replace(cfg, height=48, num_action_repeats=2)
    skewed = remote.trajectory_contract(skewed_cfg, agent, 3)
    client = _client(server)
    try:
      with pytest.raises(remote.ContractMismatch) as exc_info:
        client.handshake(skewed)
      msg = str(exc_info.value)
      assert 'config.height' in msg
      assert 'config.num_action_repeats' in msg
      assert f'learner={_H}' in msg and 'actor=48' in msg
    finally:
      client.close()
    assert len(buffer) == 0
  finally:
    server.close()
    buffer.close()


def test_unroll_validation_guards_the_buffer():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract)
  client = _client(server)
  try:
    assert client.handshake(contract)[0] == 1
    good = _conforming_unroll(cfg, agent, 3, seed=1)
    assert client.send_unroll(good) == 1
    assert len(buffer) == 1
    with pytest.raises(RuntimeError, match='observation'):
      client.send_unroll(_damaged(good, 'shape'))
    assert len(buffer) == 1
    assert server.stats()['rejected'] == 1
    with pytest.raises(RuntimeError, match='out of range'):
      client.send_unroll(good._replace(
          agent_outputs=good.agent_outputs._replace(
              action=np.array([0, 1, 7], np.int32))))
    assert len(buffer) == 1
    assert client.send_unroll(_conforming_unroll(cfg, agent, 3,
                                                 seed=2)) == 1
    assert len(buffer) == 2
    assert server.stats()['unrolls'] == 2
  finally:
    client.close()
    server.close()
    buffer.close()


def test_out_of_range_level_id_rejected():
  cfg, agent, contract = _contract_setup()
  assert contract['fields']['num_levels'] == 1
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract)
  client = _client(server)
  try:
    client.handshake(contract)
    good = _conforming_unroll(cfg, agent, 3, seed=1)
    with pytest.raises(RuntimeError, match='level_name 5 out of range'):
      client.send_unroll(_damaged(good, 'level_high'))
    with pytest.raises(RuntimeError, match='level_name -1 out of'):
      client.send_unroll(_damaged(good, 'level_negative'))
    assert len(buffer) == 0
    assert server.stats()['rejected'] == 2
    assert client.send_unroll(good) == 1
    assert len(buffer) == 1
  finally:
    client.close()
    server.close()
    buffer.close()


def test_fast_validator_matches_slow_path():
  cfg, agent, contract = _contract_setup()
  validator = remote.FastUnrollValidator(contract)
  assert validator._fast is not None
  good = _conforming_unroll(cfg, agent, 3, seed=3)
  cases = [_damaged(good, kind) for kind in
           ('clean', 'dtype', 'shape', 'structure', 'action',
            'level_high')] + ['garbage']
  for case in cases:
    assert validator(case) == remote.unroll_violations(case, contract)
  assert validator(good) == []
  assert validator(cases[-2]) != []
  from unittest import mock
  with mock.patch.object(
      remote, 'unroll_violations',
      side_effect=AssertionError('slow path taken for a clean unroll')):
    assert validator(good) == []
  legacy = {k: v for k, v in contract.items() if k != 'signature_tree'}
  legacy_validator = remote.FastUnrollValidator(legacy)
  assert legacy_validator._fast is None
  assert legacy_validator(good) == []
  assert legacy_validator(cases[2]) != []


def test_bf16_wire_dtype_halves_blob_and_upcasts():
  buffer = ring_buffer.TrajectoryBuffer(4)
  params = {'w': np.arange(4096, dtype=np.float32) / 7.0,
            'steps': np.int64(123), 'mask': np.array([True, False])}
  server = _server(buffer, params, wire_dtype='bfloat16')
  client = _client(server)
  try:
    version, got = client.fetch_params()
    assert version == 1
    assert got['w'].dtype == np.float32
    np.testing.assert_allclose(got['w'], params['w'], rtol=1e-2)
    assert got['steps'] == 123 and got['steps'].dtype == np.int64
    np.testing.assert_array_equal(got['mask'], params['mask'])
    exact_blob = pickle.dumps(('params', 1, params),
                              protocol=pickle.HIGHEST_PROTOCOL)
    assert server.snapshot_nbytes() < 0.65 * len(exact_blob)
    assert server.publish_params({'w': np.full(8, 2.5, np.float32),
                                  'steps': np.int64(124),
                                  'mask': params['mask']}) == 2
    version, got = client.fetch_params()
    assert version == 2
    np.testing.assert_allclose(got['w'], 2.5, rtol=1e-2)
  finally:
    client.close()
    server.close()
    buffer.close()


def test_int8_publisher_serves_int8_to_v10_and_bf16_to_older():
  """The v10 codec negotiation: one int8 and one bf16 blob per publish
  (one serialization counted), int8 to a v10 subscriber, bf16 to a v9."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  params = {'w': np.random.RandomState(0).randn(4096).astype(np.float32)}
  server = _server(buffer, params, wire_dtype='int8')
  client = _client(server)
  try:
    _, got = client.fetch_params()
    np.testing.assert_array_equal(
        got['w'], codec.dequantize_np(codec.quantize_np(params))['w'])
    assert server.snapshot_nbytes(10) < 0.3 * params['w'].nbytes
    v9 = socket.create_connection(('127.0.0.1', server.port))
    v9.settimeout(10)
    try:
      remote._send_msg(v9, ('hello_params', {'protocol': 9}))
      remote._send_msg(v9, ('get_params',))
      kind, version, tree, _ = remote._recv_msg(v9)
      assert (kind, version) == ('params_bf16', 1)
      assert isinstance(tree['w'], codec.Bf16Leaf)
    finally:
      v9.close()
    assert server.serializations == 1
  finally:
    client.close()
    server.close()
    buffer.close()


def test_param_lane_chunked_blob_roundtrip_and_concurrency():
  buffer = ring_buffer.TrajectoryBuffer(8)
  params = {'w': np.arange(1 << 20, dtype=np.float64)}  # 8 MB >> chunk
  server = _server(buffer, params)
  clients = [_client(server) for _ in range(3)]
  stop = threading.Event()
  drained = []
  try:
    for c in clients:
      version, got = c.fetch_params()
      assert version == 1
      np.testing.assert_array_equal(got['w'], params['w'])
    stats = server.stats()
    assert stats['param_subscribers'] == 3
    assert stats['param_blobs'] == 3
    assert stats['connections'] == 3
    assert server.publish_params({'w': np.full(4, 2.0)}) == 2
    for c in clients:
      version, got = c.fetch_params()
      assert version == 2
      np.testing.assert_array_equal(got['w'], np.full(4, 2.0))

    def drain():
      while not stop.is_set():
        try:
          drained.append(buffer.get(timeout=0.2))
        except (TimeoutError, ring_buffer.Closed):
          continue

    fetches = [0]

    def fetch_loop():
      while not stop.is_set():
        clients[1].fetch_params()
        fetches[0] += 1

    threads = [threading.Thread(target=drain, daemon=True),
               threading.Thread(target=fetch_loop, daemon=True)]
    for t in threads:
      t.start()
    pumped = 0
    deadline = time.monotonic() + 0.8
    while time.monotonic() < deadline:
      clients[0].send_unroll(_tiny_unroll(pumped))
      pumped += 1
    stop.set()
    for t in threads:
      t.join(timeout=10)
    assert pumped > 0 and fetches[0] > 0
    assert server.stats()['unrolls'] == pumped
  finally:
    stop.set()
    for c in clients:
      c.close()
    server.close()
    buffer.close()


def test_multi_connection_ingest_preserves_per_conn_order():
  buffer = ring_buffer.TrajectoryBuffer(4)  # << total: puts block
  server = _server(buffer, ingest_workers=2)
  n_conns, per_conn = 3, 15
  landed = []
  landed_done = threading.Event()

  def drain():
    while len(landed) < n_conns * per_conn:
      try:
        landed.append(buffer.get(timeout=10))
      except (TimeoutError, ring_buffer.Closed):
        return
    landed_done.set()

  drainer = threading.Thread(target=drain, daemon=True)
  drainer.start()

  def pump(conn_id, errors):
    client = _client(server)
    try:
      for seq in range(per_conn):
        unroll = _tiny_unroll(seq)
        unroll.env_outputs.reward[0] = conn_id * 1000 + seq  # tag
        client.send_unroll(unroll)
    except Exception as e:
      errors.append(e)
    finally:
      client.close()

  errors: list = []
  pumps = [threading.Thread(target=pump, args=(i, errors), daemon=True)
           for i in range(n_conns)]
  try:
    for t in pumps:
      t.start()
    for t in pumps:
      t.join(timeout=30)
    assert not errors, errors
    assert landed_done.wait(30)
    tags = [int(u.env_outputs.reward[0]) for u in landed]
    assert len(tags) == n_conns * per_conn
    assert len(set(tags)) == len(tags)  # exactly once
    for conn_id in range(n_conns):
      seqs = [t % 1000 for t in tags if t // 1000 == conn_id]
      assert seqs == sorted(seqs), (conn_id, seqs)  # per-conn FIFO
    stats = server.stats()
    assert stats['unrolls'] == n_conns * per_conn
    assert stats['ack_p99_ms'] > 0.0
  finally:
    server.close()
    buffer.close()
    drainer.join(timeout=10)


def test_publish_codec_resolution_and_rounding():
  assert Config().resolved_wire_dtype == 'bfloat16'
  assert Config(publish_codec='f32').resolved_wire_dtype == ''
  assert Config(publish_codec='int8').resolved_wire_dtype == 'int8'
  assert Config(publish_codec='f32',
                remote_params_dtype='bfloat16'
                ).resolved_wire_dtype == 'bfloat16'
  with pytest.raises(ValueError, match='publish_codec'):
    _ = Config(publish_codec='zstd').resolved_wire_dtype
  buffer = ring_buffer.TrajectoryBuffer(2)
  params = {'w': np.random.RandomState(0).randn(4096).astype(np.float32)}
  server = _server(buffer, params,
                   wire_dtype=Config().resolved_wire_dtype)
  client = _client(server)
  try:
    _, got = client.fetch_params()
    assert got['w'].dtype == np.float32
    rel = np.abs(got['w'] - params['w']) / np.maximum(
        np.abs(params['w']), 1e-30)
    assert float(rel.max()) <= 2.0 ** -8
  finally:
    client.close()
    server.close()
    buffer.close()


def test_publish_swap_is_version_guarded():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer)
  client = _client(server)
  gate = threading.Event()
  orig_make_blob = server._make_blob

  def slow_make_blob(version, params):
    blob = orig_make_blob(version, params)
    if version == 2:
      assert gate.wait(10)  # hold v2's swap until v3 has landed
    return blob

  server._make_blob = slow_make_blob
  try:
    t = threading.Thread(
        target=lambda: server.publish_params({'w': np.full(1, 2.0)}),
        daemon=True)
    t.start()
    assert _poll_until(lambda: server._version >= 2, timeout=10)
    assert server.publish_params({'w': np.full(1, 3.0)}) == 3
    gate.set()
    t.join(timeout=10)
    assert not t.is_alive()
    version, params = client.fetch_params()
    assert version == 3
    np.testing.assert_array_equal(params['w'], np.full(1, 3.0))
  finally:
    gate.set()
    client.close()
    server.close()
    buffer.close()


def test_unroll_before_handshake_rejected():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract)
  client = _client(server)
  try:
    with pytest.raises(RuntimeError, match='handshake'):
      client.send_unroll(_conforming_unroll(cfg, agent, 3))
    assert len(buffer) == 0
    client.handshake(contract)
    assert client.send_unroll(_conforming_unroll(cfg, agent, 3)) == 1
    assert len(buffer) == 1
  finally:
    client.close()
    server.close()
    buffer.close()


def test_one_serialization_per_version_under_many_clients():
  buffer = ring_buffer.TrajectoryBuffer(4)
  params = {'w': np.arange(10000.0)}
  server = _server(buffer, params)
  n_clients = 8
  clients = [_client(server) for _ in range(n_clients)]
  try:
    assert server.serializations == 1
    barrier = threading.Barrier(n_clients)
    results = [None] * n_clients

    def fetch(i):
      barrier.wait(timeout=10)
      results[i] = clients[i].fetch_params()

    threads = [threading.Thread(target=fetch, args=(i,), daemon=True)
               for i in range(n_clients)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=30)
    assert all(r is not None and r[0] == 1 for r in results)
    _assert_trees_equal(results[0][1], params)
    assert server.serializations == 1
    server.publish_params({'w': np.zeros(3)})
    assert server.serializations == 2
    for c in clients:
      assert c.fetch_params()[0] == 2
    assert server.serializations == 2
  finally:
    for c in clients:
      c.close()
    server.close()
    buffer.close()


def test_ingest_protocol_roundtrip_and_stats_request():
  """Unrolls land bit-identical, version bumps ride the acks, and the
  'stats' request returns the registry and the ingest stats; 'infer'
  with nothing attached answers 'serving not attached'."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  params_v1 = {'w': np.arange(6.0).reshape(2, 3)}
  server = _server(buffer, params_v1)
  client = _client(server)
  try:
    version, got = client.fetch_params()
    assert version == 1
    _assert_trees_equal(got, params_v1)
    unroll = _tiny_unroll(7)
    assert client.send_unroll(unroll) == 1
    _assert_trees_equal(buffer.get(timeout=5), unroll)
    params_v2 = {'w': np.full((2, 3), 9.0)}
    assert server.publish_params(params_v2) == 2
    assert client.send_unroll(_tiny_unroll(8)) == 2
    version, got = client.fetch_params()
    assert version == 2
    _assert_trees_equal(got, params_v2)
    stats = client.fetch_stats()
    assert stats['ingest']['unrolls'] == 2
    assert stats['registry']['ingest/unrolls'] >= 2
    assert server.stats()['connections'] == 1
    with pytest.raises(RuntimeError, match='serving not attached'):
      client._rpc(('infer', {'x': np.zeros(2)}), oob=True)
  finally:
    client.close()
    server.close()
  buffer.close()


def test_ingest_backpressure_blocks_ack():
  buffer = ring_buffer.TrajectoryBuffer(1)
  server = _server(buffer)
  client = _client(server)
  done = threading.Event()

  def pump():
    client.send_unroll(_tiny_unroll(1))
    client.send_unroll(_tiny_unroll(2))  # blocks: the buffer is full
    done.set()

  t = threading.Thread(target=pump, daemon=True)
  try:
    t.start()
    assert not done.wait(0.6)
    buffer.get(timeout=5)
    assert done.wait(10)
    buffer.get(timeout=5)
  finally:
    client.close()
    server.close()
    t.join(timeout=5)
  buffer.close()


def test_remote_actor_reconnects_after_learner_restart():
  """An actor host (run_remote_actor on the CPU, in a thread) survives
  its learner's crash: reconnects to the restarted server on the same
  port, reattaches under the new epoch and feeds it."""
  from scalable_agent_tpu_torch.envs import factory
  from scalable_agent_tpu_torch.models import init_params
  cfg = Config(env_backend='bandit', num_actors=1, batch_size=1,
               unroll_length=3, num_action_repeats=1, episode_length=4,
               height=_H, width=_W, torso='shallow', use_py_process=False,
               use_instruction=False, inference_timeout_ms=5, seed=21,
               actor_reconnect_secs=30.0)
  spec0 = factory.make_env_spec(cfg, factory.level_names(cfg)[0], seed=1)
  agent = driver.build_agent(cfg, spec0.num_actions)
  init_params(agent, torch.Generator().manual_seed(cfg.seed))
  params = driver.host_params(dict(agent.named_parameters()))
  buffer_a = ring_buffer.TrajectoryBuffer(2)
  server_a = _server(buffer_a, params)
  port = server_a.port
  result = {}

  def actor_main():
    result['sent'] = remote.run_remote_actor(
        cfg, f'127.0.0.1:{port}', task=0, stop_after_unrolls=6,
        device='cpu', connect_timeout_secs=20)

  t = threading.Thread(target=actor_main, daemon=True)
  t.start()
  server_b = None
  buffer_b = ring_buffer.TrajectoryBuffer(8)
  try:
    got_a = [buffer_a.get(timeout=30) for _ in range(2)]
    assert len(got_a) == 2
    epoch_a = server_a.session_epoch
    server_a.close(graceful=False)  # a crash: no 'bye'
    buffer_a.close()
    deadline = time.monotonic() + 30
    while server_b is None:
      try:
        server_b = _server(buffer_b, params, port=port)
      except OSError:
        assert time.monotonic() < deadline, 'port never freed'
        time.sleep(0.2)
    got_b = []
    deadline = time.monotonic() + 30
    while t.is_alive() and time.monotonic() < deadline:
      try:
        got_b.append(buffer_b.get(timeout=1))
      except TimeoutError:
        pass
    t.join(timeout=10)
    assert not t.is_alive()
    while True:
      try:
        got_b.append(buffer_b.get(timeout=0.2))
      except TimeoutError:
        break
    assert result['sent'] == 6
    assert len(got_b) >= 2, len(got_b)
    stats = server_b.stats()
    assert stats['reattached'] == 1 and stats['stale_epoch_rejected'] == 0
    assert server_b.session_epoch != epoch_a
  finally:
    if server_b is not None:
      server_b.close()
    buffer_b.close()
    t.join(timeout=10)


def test_half_open_peer_reaped_within_deadline():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, idle_timeout_secs=0.5)
  try:
    raw = socket.create_connection(('127.0.0.1', server.port))
    t0 = time.monotonic()
    raw.sendall(remote._LEN.pack(1000) + b'\x00' + b'x' * 20)
    assert _poll_until(lambda: server.stats()['conns_reaped'] >= 1)
    assert time.monotonic() - t0 < 5.0
    raw.settimeout(5.0)
    try:
      assert raw.recv(1) == b''
    except ConnectionResetError:
      pass
    raw.close()
    assert _poll_until(lambda: server.stats()['live'] == 0)
    assert server.stats()['ingest_threads_wedged'] == 0
    healthy = _client(server)
    try:
      assert healthy.fetch_params()[0] == 1
    finally:
      healthy.close()
  finally:
    server.close()
    buffer.close()
  assert server.stats()['unjoined_threads'] == 0


def test_reaped_partial_unroll_discarded_without_buffer_corruption():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract, idle_timeout_secs=0.5)
  try:
    raw = socket.create_connection(('127.0.0.1', server.port))
    raw.settimeout(10)
    remote._send_msg(raw, ('hello', contract))
    assert remote._recv_msg(raw)[0] in ('params', 'params_bf16')
    partial = _conforming_unroll(cfg, agent, 3, seed=5)
    segments = remote._oob_frame_segments(('unroll', partial))
    raw.sendall(bytes(segments[0]))
    raw.sendall(bytes(segments[1][:10]))
    assert _poll_until(lambda: server.stats()['conns_reaped'] >= 1)
    raw.close()
    assert len(buffer) == 0
    assert server.stats()['discarded_frames'] == 1
    client = _client(server)
    try:
      client.handshake(contract)
      good = _conforming_unroll(cfg, agent, 3, seed=6)
      assert client.send_unroll(good) == 1
      _assert_trees_equal(buffer.get(timeout=5), good)
      assert len(buffer) == 0
      assert server.stats()['unrolls'] == 1
      assert server.stats()['rejected'] == 0
    finally:
      client.close()
  finally:
    server.close()
    buffer.close()


def test_heartbeat_v6_interop_with_v5_client():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract, heartbeat_secs=0.15,
                   idle_timeout_secs=5.0)
  client = _client(server)
  try:
    assert client.handshake(dict(contract, protocol=5))[0] == 1
    client.session_epoch = None  # the v5 wire shape
    assert client.send_unroll(_conforming_unroll(cfg, agent, 3, seed=7),
                              params_version=1) == 1
    buffer.get(timeout=5)
    time.sleep(0.6)
    assert server.stats()['heartbeat_misses'] == 0
    v6 = _client(server)
    try:
      v6.handshake(contract)
      assert v6.session_epoch == server.session_epoch
      assert _poll_until(
          lambda: server.stats()['heartbeat_misses'] >= 1, timeout=5)
    finally:
      v6.close()
  finally:
    client.close()
    server.close()
    buffer.close()


def test_idle_client_pings_survive_reaping_window():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, heartbeat_secs=0.1, idle_timeout_secs=0.5)
  client = _client(server, io_timeout_secs=5.0)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    assert client.ping() == 1
    server.publish_params({'w': np.ones(2)})
    deadline = time.monotonic() + 1.5  # 3x the idle window
    while time.monotonic() < deadline:
      assert client.ping() == 2
      time.sleep(0.1)
    stats = server.stats()
    assert stats['conns_reaped'] == 0
    assert stats['live'] == 1
  finally:
    client.close()
    server.close()
    buffer.close()


@pytest.mark.parametrize('window', ['busy_keepalive', 'not_reaped'])
def test_backpressure_holds_the_ack_without_a_drop(window):
  """While backpressure holds an ack: ('busy',) keepalives keep a
  client whose I/O deadline is shorter than the wait connected, and a
  peer parked past the idle window is not reaped or counted as missing
  its heartbeats; the one unroll lands once."""
  buffer = ring_buffer.TrajectoryBuffer(1)
  if window == 'busy_keepalive':
    server = _server(buffer, heartbeat_secs=0.1, idle_timeout_secs=5.0)
    client = _client(server, io_timeout_secs=0.6)
  else:
    server = _server(buffer, heartbeat_secs=0.1, idle_timeout_secs=0.4)
    client = _client(server, io_timeout_secs=2.0)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    buffer.put(_tiny_unroll(0))  # full: the next ack is held back
    acked = threading.Event()

    def pump():
      client.send_unroll(_tiny_unroll(1))
      acked.set()

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    time.sleep(1.2)
    assert not acked.is_set()
    assert server.stats()['conns_reaped'] == 0
    assert server.stats()['heartbeat_misses'] == 0
    buffer.get(timeout=5)
    assert acked.wait(10)
    t.join(timeout=5)
    assert client.busy_frames >= 2, client.busy_frames
    assert server.stats()['unrolls'] == 1
    assert len(buffer) == 1
  finally:
    client.close()
    server.close()
    buffer.close()


def test_graceful_close_reaches_peers_caught_mid_send():
  """Clients streaming large unrolls when the learner closes gracefully
  all end on the 'bye' (LearnerShutdown): the close drains what a peer
  still sends before closing, so no RST drops the bye or breaks a send
  in flight (without the drain some end in BrokenPipeError and would
  wait out their reconnect window). The drain itself: a peer blocked in
  a send larger than the socket buffers completes it."""
  a, b = socket.socketpair()
  sent = threading.Event()

  def send():
    b.sendall(b'x' * (8 << 20))
    sent.set()

  sender = threading.Thread(target=send, daemon=True)
  sender.start()
  try:
    remote._drain_until_quiet(a, time.monotonic() + 20.0)
    assert sent.is_set()
  finally:
    a.close()
    b.close()
    sender.join(timeout=10)
  rng = np.random.RandomState(0)
  big = _tiny_unroll(0)._replace(env_outputs=_tiny_unroll(0).env_outputs._replace(
      observation=(rng.randint(0, 255, (101, 256, 256, 3)).astype(np.uint8),
                   np.zeros((3, 5), np.int32))))
  for _ in range(3):
    buffer = ring_buffer.TrajectoryBuffer(64)
    server = _server(buffer, heartbeat_secs=10.0, idle_timeout_secs=60.0)
    stop = threading.Event()
    outcomes = []

    def drain():
      while not stop.is_set():
        try:
          buffer.get(timeout=0.1)
        except (TimeoutError, ring_buffer.Closed):
          pass

    def pump():
      client = _client(server, io_timeout_secs=20.0)
      try:
        client.handshake({'protocol': remote.PROTOCOL_VERSION})
        while True:
          client.send_unroll(big, params_version=1)
      except Exception as e:
        outcomes.append(type(e).__name__)
      finally:
        client.close()

    threads = [threading.Thread(target=drain, daemon=True)] + [
        threading.Thread(target=pump, daemon=True) for _ in range(3)]
    for t in threads:
      t.start()
    try:
      assert _poll_until(lambda: server.stats()['unrolls'] >= 6, timeout=20)
      server.close(graceful=True)
      for t in threads[1:]:
        t.join(timeout=20)
    finally:
      stop.set()
      server.close()
      buffer.close()
      threads[0].join(timeout=10)
    assert outcomes == ['LearnerShutdown'] * 3, outcomes


@pytest.mark.parametrize('wire_crc', [True, False])
def test_an_idle_client_reads_the_bye_before_its_next_send(wire_crc):
  """A client between requests when the learner closes gracefully finds
  the 'bye' before it sends its next unroll (LearnerShutdown), instead
  of a broken pipe into the closed socket and the reconnect window; a
  late 'busy' that crossed an ack is skipped."""
  rng = np.random.RandomState(1)
  big = _tiny_unroll(0)._replace(env_outputs=_tiny_unroll(0).env_outputs._replace(
      observation=(rng.randint(0, 255, (3, 1024, 1024, 3)).astype(np.uint8),
                   np.zeros((3, 5), np.int32))))
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, heartbeat_secs=10.0, idle_timeout_secs=60.0,
                   wire_crc=wire_crc)
  client = _client(server, io_timeout_secs=20.0)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    assert client._crc == wire_crc
    assert client.send_unroll(big, params_version=1) == 1
    server._conns[0].send(('busy',))  # a keepalive that crossed the ack
    server.close(graceful=True)
    with pytest.raises(remote.LearnerShutdown):
      client.send_unroll(big, params_version=1)
  finally:
    client.close()
    server.close()
    buffer.close()


def test_session_epoch_reattach_and_stale_epoch_refusal():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server_a = _server(buffer, heartbeat_secs=0.2, idle_timeout_secs=5.0)
  client = _client(server_a)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    epoch_a = client.session_epoch
    assert epoch_a == server_a.session_epoch
  finally:
    client.close()
    server_a.close(graceful=False)
  server_b = _server(buffer, heartbeat_secs=0.2, idle_timeout_secs=5.0)
  assert server_b.session_epoch != epoch_a
  client_b = _client(server_b)
  try:
    client_b.handshake({'protocol': remote.PROTOCOL_VERSION},
                       prior_epoch=epoch_a)
    stats = server_b.stats()
    assert (stats['reattached'], stats['reconnected']) == (1, 0)
    assert stats['reattach_latency_secs'] >= 0.0
    client_b.session_epoch = epoch_a
    with pytest.raises(remote.SessionEpochMismatch):
      client_b.send_unroll(_tiny_unroll(1))
    assert len(buffer) == 0
    assert server_b.stats()['stale_epoch_rejected'] == 1
    client_b.session_epoch = server_b.session_epoch
    assert client_b.send_unroll(_tiny_unroll(2)) == 1
    assert len(buffer) == 1
    client_c = _client(server_b)
    try:
      client_c.handshake({'protocol': remote.PROTOCOL_VERSION},
                         prior_epoch=server_b.session_epoch)
      assert server_b.stats()['reconnected'] == 1
      assert server_b.stats()['reattached'] == 1
    finally:
      client_c.close()
  finally:
    client_b.close()
    server_b.close()
    buffer.close()


def test_param_lane_drop_counter_and_graceful_bye():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer)
  try:
    bad = socket.create_connection(('127.0.0.1', server.port))
    remote._send_msg(bad, ('hello_params',))
    bad.sendall(remote._LEN.pack(8) + b'garbage!')
    assert _poll_until(lambda: server.stats()['param_subs_dropped'] >= 1)
    bad.close()
  finally:
    server.close()
    buffer.close()
  buffer2 = ring_buffer.TrajectoryBuffer(4)
  server2 = _server(buffer2, heartbeat_secs=0.1, idle_timeout_secs=0.4)
  try:
    quiet = socket.create_connection(('127.0.0.1', server2.port))
    remote._send_msg(quiet, ('hello_params',))
    assert _poll_until(
        lambda: server2.stats()['param_subs_reaped'] >= 1, timeout=5)
    quiet.close()
  finally:
    server2.close()
    buffer2.close()
  buffer3 = ring_buffer.TrajectoryBuffer(4)
  server3 = _server(buffer3)
  client = _client(server3)
  try:
    assert client.fetch_params()[0] == 1
    server3.close(graceful=True)
    with pytest.raises(remote.LearnerShutdown):
      client.fetch_params()
  finally:
    client.close()
    buffer3.close()


def test_fetch_params_retries_once_on_reaped_lane():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, {'w': np.arange(8.0)}, heartbeat_secs=0.1,
                   idle_timeout_secs=0.4)
  client = _client(server)
  try:
    assert client.fetch_params()[0] == 1
    assert _poll_until(
        lambda: server.stats()['param_subs_reaped'] >= 1, timeout=5)
    version, params = client.fetch_params()
    assert version == 1
    np.testing.assert_array_equal(params['w'], np.arange(8.0))
  finally:
    client.close()
    server.close()
    buffer.close()


@pytest.mark.parametrize('knobs', [
    {}, dict(actor_reconnect_secs=10.0),
    dict(remote_heartbeat_secs=30.0, remote_conn_idle_timeout_secs=5.0),
    dict(remote_heartbeat_secs=0.0),
    dict(remote_conn_idle_timeout_secs=0.0),
    dict(remote_heartbeat_secs=-1.0), dict(actor_reconnect_secs=-5.0),
    dict(remote_conn_idle_timeout_secs=-1.0)])
def test_validate_transport_is_jax_s(knobs):
  """The same warnings, or the same hard error, as JAX's."""
  from scalable_agent_tpu import config as jax_config
  from scalable_agent_tpu_torch import config as config_lib
  try:
    want = jax_config.validate_transport(jax_config.Config(**knobs))
  except ValueError as e:
    with pytest.raises(ValueError, match=str(e).split(' ')[0]):
      config_lib.validate_transport(Config(**knobs))
    return
  assert config_lib.validate_transport(Config(**knobs)) == want
  assert (Config().actor_reconnect_secs
          >= config_lib.LEARNER_RESTART_BUDGET_SECS)


@pytest.mark.parametrize('knobs', [
    {}, dict(sdc_check=True, health_watchdog=False),
    dict(wire_crc=False, remote_actor_port=1234),
    dict(wire_crc=False, replay_ratio=0.5)])
def test_validate_integrity_is_jax_s(knobs):
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.config import validate_integrity as jax_validate
  from scalable_agent_tpu_torch.config import validate_integrity
  assert validate_integrity(Config(**knobs)) == jax_validate(
      JaxConfig(**knobs))


def test_close_counts_unjoined_threads_clean_case():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, heartbeat_secs=0.2, idle_timeout_secs=1.0)
  client = _client(server)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    assert client.send_unroll(_tiny_unroll(0)) == 1
  finally:
    client.close()
    server.close()
    buffer.close()
  assert server.stats()['unjoined_threads'] == 0
  assert server.stats()['ingest_threads_wedged'] == 0


def test_v7_crc_negotiation_and_clean_roundtrip():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, {'w': np.arange(64, dtype=np.float32)},
                   contract=contract, wire_crc=True)
  client = _client(server)
  try:
    assert client.handshake(contract)[0] == 1
    assert client._crc
    assert client.server_info.get('wire_crc') is True
    assert 'params_digest' in client.server_info
    unroll = _conforming_unroll(cfg, agent, 3, seed=3)
    assert client.send_unroll(unroll, params_version=1) == 1
    _assert_trees_equal(buffer.get(timeout=5), unroll)
    assert client.ping() == 1
    server.publish_params({'w': np.full(8, 2.0, np.float32)})
    v2, tree2 = client.fetch_params()
    assert v2 == 2
    np.testing.assert_array_equal(tree2['w'], np.full(8, 2.0, np.float32))
    stats = server.stats()
    assert stats['wire_crc_rejected'] == 0 and stats['quarantined'] == 0
    assert client.crc_rejected == 0 and client.digest_rejected == 0
  finally:
    client.close()
    server.close()
    buffer.close()


def test_wire_bitflip_refused_before_put_then_resent_clean():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract)
  client = _client(server)
  plan = faults_lib.FaultPlan(
      [faults_lib.Fault('wire_bitflip', 0, 'flip')], seed=3)
  try:
    client.handshake(contract)
    unroll = _conforming_unroll(cfg, agent, 3, seed=5)
    faults_lib.install(plan)
    try:
      with pytest.raises(remote.UnrollCorrupt):
        client.send_unroll(unroll, params_version=1)
    finally:
      faults_lib.clear()
    assert client.crc_rejected == 1
    assert len(buffer) == 0, 'corrupt unroll reached the buffer'
    stats = server.stats()
    assert stats['wire_crc_rejected'] == 1
    assert stats['quarantined'] == 0 and stats['unrolls'] == 0
    assert client.send_unroll(unroll, params_version=1) == 1
    _assert_trees_equal(buffer.get(timeout=5), unroll)
    assert server.stats()['connections'] == 1
  finally:
    client.close()
    server.close()
    buffer.close()


def test_v7_v6_interop_crc_negotiated_off_both_directions():
  cfg, agent, contract = _contract_setup()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract, wire_crc=True)
  client = _client(server)
  try:
    client.handshake(dict(contract, protocol=6))
    assert not client._crc
    client.session_epoch = None  # the v6 wire shape
    unroll = _conforming_unroll(cfg, agent, 3, seed=7)
    assert client.send_unroll(unroll, params_version=1) == 1
    _assert_trees_equal(buffer.get(timeout=5), unroll)
    assert server.stats()['wire_crc_rejected'] == 0
    assert server.stats()['quarantined'] == 0
  finally:
    client.close()
    server.close()
    buffer.close()
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, contract=contract, wire_crc=False)
  client = _client(server)
  try:
    client.handshake(contract)
    assert not client._crc
    unroll = _conforming_unroll(cfg, agent, 3, seed=9)
    assert client.send_unroll(unroll, params_version=1) == 1
    _assert_trees_equal(buffer.get(timeout=5), unroll)
    server.publish_params({'w': np.ones(2)})
    assert client.fetch_params()[0] == 2
    # Digests verify whatever the lane's CRC, and the nack reaches a
    # wire_crc=False server too.
    faults_lib.install(faults_lib.FaultPlan(
        [faults_lib.Fault('publish_corrupt', 0, 'flip')], seed=11))
    try:
      server.publish_params({'w': np.arange(64, dtype=np.float32)})
    finally:
      faults_lib.clear()
    with pytest.raises(remote.ParamsCorrupt):
      client.fetch_params()
    with pytest.raises(remote.ParamsCorrupt):
      client.fetch_params()  # the retry carries the nack
    assert server.stats()['publish_digest_rejected'] >= 1
    assert server.stats()['quarantined'] == 0
  finally:
    client.close()
    server.close()
    buffer.close()


@pytest.mark.parametrize('wire_dtype', ['', 'bfloat16', 'int8'])
def test_publish_digest_rejected_before_install_with_nack(wire_dtype):
  """A publish corrupted after its digest is refused before install in
  every wire form; the retry carries the nack; a clean publish then
  installs."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer, {'w': np.arange(128, dtype=np.float32)},
                   wire_dtype=wire_dtype)
  client = _client(server)
  try:
    client.handshake({'protocol': remote.PROTOCOL_VERSION})
    assert client._crc
    faults_lib.install(faults_lib.FaultPlan(
        [faults_lib.Fault('publish_corrupt', 0, 'flip')], seed=5))
    try:
      server.publish_params({'w': np.arange(128, dtype=np.float32)})
    finally:
      faults_lib.clear()
    with pytest.raises(remote.ParamsCorrupt):
      client.fetch_params()
    assert client.digest_rejected == 1
    with pytest.raises(remote.ParamsCorrupt):
      client.fetch_params()
    assert server.stats()['publish_digest_rejected'] >= 1
    server.publish_params({'w': np.full(4, 3.0, np.float32)})
    v, tree = client.fetch_params()
    assert v == 3
    np.testing.assert_allclose(tree['w'], np.full(4, 3.0, np.float32),
                               rtol=1e-2)
  finally:
    client.close()
    server.close()
    buffer.close()


def test_quarantine_reports_discarded_bytes_and_frames():
  buffer = ring_buffer.TrajectoryBuffer(2)
  server = _server(buffer)
  try:
    rogue = socket.create_connection(('127.0.0.1', server.port))
    rogue.settimeout(10)
    payload = b'\xee' + b'x' * 499
    rogue.sendall(remote._LEN.pack(len(payload)) + payload)
    try:
      assert rogue.recv(1) == b''
    except ConnectionResetError:
      pass
    rogue.close()
    assert _poll_until(lambda: server.stats()['quarantined'] >= 1)
    stats = server.stats()
    assert stats['quarantined'] == 1 and stats['discarded_frames'] == 1
    assert stats['discarded_bytes'] >= remote._LEN.size + 1
    rogue2 = socket.create_connection(('127.0.0.1', server.port))
    rogue2.settimeout(10)
    remote._send_msg(rogue2, ('ping',))
    assert remote._recv_msg(rogue2)[0] == 'pong'
    rogue2.sendall(remote._LEN.pack(remote._MAX_MSG + 1))
    try:
      while rogue2.recv(4096):
        pass
    except ConnectionResetError:
      pass
    rogue2.close()
    assert _poll_until(lambda: server.stats()['quarantined'] >= 2)
    delta = server.stats()['discarded_bytes'] - stats['discarded_bytes']
    assert delta == remote._LEN.size, delta
  finally:
    server.close()
    buffer.close()


@pytest.mark.parametrize('probe_acked', [True, False])
def test_crc_probation_ladder(probe_acked):
  p = remote.CrcProbation(cooldown_secs=0.0)
  assert p.on_refusal() == remote.CrcProbation.RESEND
  assert p.on_refusal() == remote.CrcProbation.PROBE
  assert (p.crc_resends, p.probations) == (1, 1)
  if probe_acked:
    assert p.on_ack() is True
    assert p.recoveries == 1
    p.next_unroll()
    assert p.on_refusal() == remote.CrcProbation.RESEND
    assert p.on_refusal() == remote.CrcProbation.QUARANTINE
  else:
    assert p.on_refusal() == remote.CrcProbation.QUARANTINE
    assert p.recoveries == 0
    assert p.on_ack() is False


def test_membership_join_reconnect_and_drain():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer)
  host_id = 'hostA:111:task0'
  try:
    c1 = _client(server)
    c1.handshake({'protocol': remote.PROTOCOL_VERSION}, host=host_id)
    assert server.live_hosts() == 1
    assert server.membership() == [host_id]
    assert server.drain_membership_events() == [
        {'kind': 'host_joined', 'host': host_id, 'reattach': False}]
    assert server.drain_membership_events() == []
    c2 = _client(server)
    c2.handshake({'protocol': remote.PROTOCOL_VERSION}, host=host_id)
    assert server.live_hosts() == 1
    assert server.drain_membership_events() == []
    c1.close()
    time.sleep(0.3)
    assert server.live_hosts() == 1
    assert server.drain_membership_events() == []
    assert c2.send_leave() is True
    c2.close()
    assert _poll_until(lambda: server.live_hosts() == 0, timeout=5)
    assert server.drain_membership_events() == [
        {'kind': 'host_left', 'host': host_id, 'reason': 'drain'}]
    stats = server.stats()
    assert (stats['live_hosts'], stats['hosts_joined'],
            stats['hosts_left']) == (0, 1, 1)
  finally:
    server.close()
    buffer.close()


def test_membership_unannounced_death_is_lost():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer)
  try:
    c = _client(server)
    c.handshake({'protocol': remote.PROTOCOL_VERSION},
                host='hostB:222:task1')
    assert server.live_hosts() == 1
    c.close()
    assert _poll_until(lambda: server.live_hosts() == 0, timeout=5)
    events = server.drain_membership_events()
    assert [e['kind'] for e in events] == ['host_joined', 'host_left']
    assert events[1]['reason'] == 'lost'
  finally:
    server.close()
    buffer.close()


def test_membership_hostless_hello_and_legacy_leave():
  buffer = ring_buffer.TrajectoryBuffer(4)
  server = _server(buffer)
  try:
    c = _client(server)
    c.handshake({'protocol': remote.PROTOCOL_VERSION})
    assert server.live_hosts() == 0
    assert server.drain_membership_events() == []
    c.close()
  finally:
    server.close()
    buffer.close()
  lis = socket.create_server(('127.0.0.1', 0))
  lis.settimeout(10)
  port = lis.getsockname()[1]

  def _legacy_server():
    conn, _ = lis.accept()
    conn.settimeout(10)
    try:
      kind, _ = remote._recv_msg(conn)
      assert kind == 'leave'
      remote._send_msg(conn, ('error', "unknown message kind 'leave'"))
    finally:
      conn.close()

  t = threading.Thread(target=_legacy_server, daemon=True)
  t.start()
  c = remote.RemoteActorClient(f'127.0.0.1:{port}',
                               connect_timeout_secs=10)
  try:
    assert c.send_leave() is False
  finally:
    c.close()
    lis.close()
    t.join(timeout=10)


@pytest.mark.parametrize('flags,message', [
    ([], 'needs --learner_address'),
    (['--learner_address=h:1', '--coordinator_address=c:2'],
     'joins no process group'),
    (['--learner_address=h:1', '--mode=test'], 'only makes sense'),
    (['--job_name=ps'], 'unknown --job_name')])
def test_the_cli_s_actor_role(flags, message):
  """The A7.3 flags reach the config; the actor role's usage errors are
  the JAX CLI's."""
  import threading as th
  from scalable_agent_tpu_torch import experiment
  args = vars(experiment._parser().parse_args(
      ['--job_name=actor', '--task=3', '--remote_actor_port=5',
       '--wire_crc=false', '--remote_publish_secs=0.5'] + flags))
  device = args.pop('device')
  config = Config(**args)
  assert (config.task, config.remote_actor_port, config.wire_crc,
          config.remote_publish_secs) == (3, 5, False, 0.5)
  with pytest.raises(ValueError, match=message):
    experiment._run(config, device, th.Event())


# ---------------------------------------------------------------------
# The slice end to end: the port's CLI as an actor-host child process
# feeding driver.train.
# ---------------------------------------------------------------------


def test_remote_actor_feeds_training(tmp_path):
  """`python -m scalable_agent_tpu_torch.experiment --job_name=actor
  --device=cpu` feeds a learner with no local fleet: every consumed
  unroll came over the wire, the summaries carry the remote counters,
  the integrity counters read zero, and the child exits 0 when the
  learner ends."""
  base = dict(
      env_backend='bandit', batch_size=2, unroll_length=5,
      num_action_repeats=1, episode_length=4, height=_H, width=_W,
      torso='shallow', use_py_process=False, use_instruction=False,
      total_environment_frames=10**6, inference_timeout_ms=5,
      checkpoint_secs=0, summary_secs=0, seed=11)
  with socket.create_server(('127.0.0.1', 0)) as s:
    port = s.getsockname()[1]
  args = ([sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
           '--job_name=actor', '--task=0', '--device=cpu',
           f'--learner_address=127.0.0.1:{port}', '--num_actors=2',
           f'--logdir={tmp_path}/actor']
          + [f'--{k}={v}' for k, v in base.items()])
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS='1')
  env.pop(faults_lib.PLAN_ENV_VAR, None)
  child = subprocess.Popen(args, cwd=repo, env=env, text=True,
                           stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT)
  try:
    learner_cfg = Config(logdir=str(tmp_path), num_actors=0,
                         remote_actor_port=port, **base)
    run = driver.train(learner_cfg, max_steps=3, device='cpu',
                       stall_timeout_secs=30)
    assert run.state.update_steps == 3
    stats = run.stats['ingest']
    assert stats['unrolls'] >= 3 * learner_cfg.batch_size
    assert run.stats['fleet']['unrolls'] == 0
    for key in ('stale_epoch_rejected', 'ingest_threads_wedged',
                'wire_crc_rejected', 'publish_digest_rejected',
                'discarded_frames', 'unjoined_threads'):
      assert stats[key] == 0, key
    with open(tmp_path / 'summaries.jsonl') as f:
      tags = {json.loads(line)['tag'] for line in f if '"tag"' in line}
    for tag in ('remote_unrolls', 'remote_conns_reaped',
                'remote_heartbeat_misses', 'param_subs_dropped',
                'ingest_threads_wedged', 'remote_reattached',
                'remote_stale_epoch_rejected', 'actors_wedged',
                'wire_crc_rejected', 'publish_digest_rejected',
                'ckpt_digest_fallbacks', 'ingest_discarded_frames',
                'ingest_discarded_bytes', 'remote_live_hosts',
                'remote_ack_p99_ms', 'remote_unrolls_per_sec'):
      assert tag in tags, tag
    with open(tmp_path / 'incidents.jsonl') as f:
      kinds = [json.loads(line)['kind'] for line in f if line.strip()]
    assert 'host_joined' in kinds
    out, _ = child.communicate(timeout=30)
    assert child.returncode == 0, out[-3000:]
    assert 'learner finished training' in out, out[-3000:]
  finally:
    if child.poll() is None:
      child.kill()
      child.communicate()
