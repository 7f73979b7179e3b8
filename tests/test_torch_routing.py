"""Routed serving in the port: runtime/routing.py's ServingRouter, the
client's side of 'infer' in runtime/remote.py and
InferenceServer.serve_remote, each against the JAX package's.

- The router: JAX's TestServingRouter cases (tests/test_serving.py) run
  through the JAX router and the port's router over the same fake
  channels and a shared fake clock (so the fed latencies are equal):
  the same sequence of picks, the same probation and draining
  behaviour, the same `stats()`.
- 'infer' over localhost against the port's ingest: refused until
  something is attached, then served with the drain notice; and two
  ingest replicas behind a ServingRouter (`connect_serving`), one closed
  without a 'bye' mid-pump, every later batch served by the survivor.
- `serve_remote` against JAX's on the same payload with converted params:
  logits, baseline and core_c/core_h at rtol 1e-5 / atol 1e-5 (float32),
  the version label equal. A remote call on a state-arena server leaves
  every slot and carry as it was, and interleaved remote calls leave the
  local fleet's actions unchanged for the same seed.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from scalable_agent_tpu.config import Config as JaxConfig
from scalable_agent_tpu.models import agent as jax_agent
from scalable_agent_tpu.models import init_params as jax_init_params
from scalable_agent_tpu.runtime import inference as jax_inference
from scalable_agent_tpu.runtime import routing as jax_routing
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.runtime import remote, ring_buffer, routing
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

torch.set_num_threads(1)

A, H, W = 5, 24, 32
_SERVICE_THREADS = ('ingest', 'param-lane')


@pytest.fixture(autouse=True)
def _no_leaked_service_threads():
  before = {t.ident for t in threading.enumerate()}
  yield
  deadline = time.monotonic() + 10.0
  while True:
    leaked = [t.name for t in threading.enumerate()
              if t.ident not in before and t.is_alive()
              and t.name.startswith(_SERVICE_THREADS)]
    if not leaked or time.monotonic() > deadline:
      break
    time.sleep(0.05)
  assert not leaked, leaked


# --------------------------------------------------------------------
# The router against JAX's, over fake channels.
# --------------------------------------------------------------------


class _FakeChannel:

  def __init__(self, name, fail=False, draining=False):
    self.name = name
    self.fail = fail
    self.draining = draining
    self.closed = False

  def supports_infer(self):
    return True

  def remote_infer(self, payload):
    if self.fail:
      raise ConnectionError(f'{self.name} down')
    return {'who': self.name}, {'draining': self.draining}

  def close(self):
    self.closed = True


def _router(module, names, t, **kw):
  chans = {n: _FakeChannel(n, **kw.pop(n, {})) for n in 'abc'}
  router = module.ServingRouter(names, lambda a: chans[a], clock=lambda: t[0],
                                **kw)
  return router, chans


def _picks(router, n):
  return [router.infer({})[0]['who'] for _ in range(n)]


def _round_robin(module):
  t = [0.0]
  router, _ = _router(module, ['a', 'b'], t)
  return [_picks(router, 6), router.stats()]


def _failover_and_probation(module):
  t = [0.0]
  router, chans = _router(module, ['a', 'b'], t, probation_secs=5.0,
                          a={'fail': True})
  out = [_picks(router, 1), router.stats(), _picks(router, 4)]
  chans['a'].fail = False
  t[0] = 4.0
  out += [_picks(router, 2), router.stats()]
  t[0] = 6.0
  out += [_picks(router, 6), router.stats()]
  return out


def _poisoned_ewma(module):
  t = [0.0]
  router, _ = _router(module, ['a', 'b'], t)
  with router._lock:
    router._replicas['a'].ewma_ms = 470.0
    router._replicas['a'].weight = 1.0 / 470.0
    router._replicas['b'].ewma_ms = 2.5
    router._replicas['b'].weight = 1.0 / 2.5
  return [_picks(router, 44), router.stats()]


def _all_down(module):
  t = [0.0]
  router, _ = _router(module, ['a'], t, a={'fail': True})
  try:
    router.infer({})
  except module.NoReplicasAvailable as e:
    return [type(e).__name__, str(e), router.stats()]
  return ['no raise']


def _draining(module):
  t = [0.0]
  router, _ = _router(module, ['a', 'b'], t, a={'draining': True})
  return [_picks(router, 6), router.stats()]


def _membership(module):
  t = [0.0]
  router, chans = _router(module, ['a'], t)
  router.apply_membership([{'kind': 'host_joined', 'host': 'b'}])
  out = [_picks(router, 4)]
  router.apply_membership([{'kind': 'host_left', 'host': 'a'},
                           {'kind': 'host_joined', 'host': None},
                           {'kind': 'host_joined', 'host': 'c'}])
  out += [_picks(router, 4), router.stats(), chans['a'].closed]
  router.apply_membership([{'kind': 'host_joined', 'host': 'a'}],
                          address_of=lambda h: None if h == 'c' else h)
  out += [_picks(router, 6), router.stats()]
  router.close()
  out += [sorted(n for n, c in chans.items() if c.closed)]
  return out


def _timed_weights(module):
  """Latencies fed through the clock: 'a' answers in 3 ms, 'b' in 30 ms;
  the inverse-EWMA weights give 'a' ~10x the picks."""
  t = [0.0]
  router, chans = _router(module, ['a', 'b'], t)
  for name, ms in (('a', 3.0), ('b', 30.0)):
    chan = chans[name]
    real = chan.remote_infer

    def slow(payload, real=real, ms=ms):
      t[0] += ms / 1000.0
      return real(payload)
    chan.remote_infer = slow
  return [_picks(router, 40), router.stats()]


_CASES = {'round_robin': _round_robin,
          'failover_and_probation': _failover_and_probation,
          'poisoned_ewma': _poisoned_ewma, 'all_down': _all_down,
          'draining': _draining, 'membership': _membership,
          'timed_weights': _timed_weights}


@pytest.mark.parametrize('case', sorted(_CASES))
def test_the_router_routes_as_jax_s(case):
  got, ref = _CASES[case](routing), _CASES[case](jax_routing)
  assert got == ref
  if case == 'round_robin':
    assert got[0] == ['a', 'b'] * 3
  elif case == 'failover_and_probation':
    assert got[0] == ['b'] and got[1]['route_failovers'] == 1
    assert set(got[2]) == {'b'} and set(got[3]) == {'b'}
    assert 'a' in got[5]
  elif case == 'poisoned_ewma':
    assert got[0].count('a') >= 3
  elif case == 'all_down':
    assert got[0] == 'NoReplicasAvailable'
  elif case == 'draining':
    assert got[0][0] == 'a' and set(got[0][1:]) == {'b'}
    assert {r['address']: r['draining'] for r in got[1]['replicas']} == {
        'a': True, 'b': False}
  elif case == 'membership':
    assert set(got[0]) == {'a', 'b'} and set(got[1]) == {'b', 'c'}
    assert got[2]['available'] == 2 and got[3]
  elif case == 'timed_weights':
    assert got[0].count('a') > 3 * got[0].count('b')


# --------------------------------------------------------------------
# 'infer' over localhost.
# --------------------------------------------------------------------


def _contract(cfg, agent):
  return remote.trajectory_contract(cfg, agent, A)


def _small_config(**kw):
  return Config(env_backend='bandit', unroll_length=2, height=H, width=W,
                torso='shallow', use_instruction=False, num_actions=A,
                inference_timeout_ms=1, **kw)


def test_infer_requires_attach_then_serves_with_the_drain_notice():
  cfg = _small_config()
  agent = driver.build_agent(cfg, A)
  buffer = ring_buffer.TrajectoryBuffer(2)
  server = remote.TrajectoryIngestServer(
      buffer, {'w': np.zeros(1, np.float32)}, host='127.0.0.1',
      contract=_contract(cfg, agent))
  client = None
  try:
    client = remote.RemoteActorClient(f'127.0.0.1:{server.port}',
                                      connect_timeout_secs=10)
    client.handshake(_contract(cfg, agent))
    assert client.supports_infer()
    with pytest.raises(RuntimeError, match='serving not attached'):
      client.remote_infer({'x': np.ones((2,), np.float32)})
    server.attach_serving(lambda payload: {'echo': payload['x'] + 1})
    result, notice = client.remote_infer({'x': np.ones((2,), np.float32)})
    np.testing.assert_array_equal(result['echo'],
                                  np.full((2,), 2.0, np.float32))
    assert not notice.get('draining')
    server.set_draining()
    _, notice = client.remote_infer({'x': np.ones((2,), np.float32)})
    assert notice.get('draining')
    client.server_info['protocol'] = 9
    assert not client.supports_infer()
  finally:
    if client is not None:
      client.close()
    server.close()
    buffer.close()


def _payload(batch, hidden, seed):
  rng = np.random.RandomState(seed)
  return {
      'prev_action': rng.randint(0, A, batch).astype(np.int32),
      'reward': rng.randn(batch).astype(np.float32),
      'done': rng.rand(batch) < 0.3,
      'frame': rng.randint(0, 256, (batch, H, W, 3)).astype(np.uint8),
      'instr': rng.randint(0, 100, (batch, 16)).astype(np.int32),
      'core_c': (rng.randn(batch, hidden) * 0.3).astype(np.float32),
      'core_h': (rng.randn(batch, hidden) * 0.3).astype(np.float32),
  }


def test_a_router_fails_over_between_two_ingest_replicas():
  """Two ingest servers, each serving an InferenceServer's serve_remote;
  a router pumps batches through both, one replica closes without a
  'bye' mid-pump, every later batch is served by the survivor, and the
  survivor's drain notice empties the rotation."""
  cfg = _small_config()
  agent = driver.build_agent(cfg, A)
  params = init_params(agent, torch.Generator().manual_seed(0))
  replicas = []
  for seed in (1, 2):
    buffer = ring_buffer.TrajectoryBuffer(2)
    ingest = remote.TrajectoryIngestServer(
        buffer, {'w': np.zeros(1, np.float32)}, host='127.0.0.1',
        contract=_contract(cfg, agent))
    server = InferenceServer(agent, params, cfg, seed=seed, fleet_size=1)
    ingest.attach_serving(server.serve_remote)
    replicas.append((buffer, ingest, server))
  addresses = [f'127.0.0.1:{ingest.port}' for _, ingest, _ in replicas]
  # A frozen clock: every reply reads 0 ms, the weights stay equal and the
  # picks alternate, so the closed replica is picked again after the kill
  # (on the real clock a slow first reply can keep it out of the next 6).
  router = routing.ServingRouter(
      addresses, lambda a: routing.connect_serving(
          a, _contract(cfg, agent), connect_timeout_secs=10),
      probation_secs=60.0, clock=lambda: 0.0)
  served, closed = [], False
  try:
    for i in range(12):
      if i == 6:
        replicas[0][1].close(graceful=False)
        closed = True
      result, _ = router.infer(_payload(4, agent.hidden_size, i))
      assert result['logits'].shape == (4, A)
      served.append((closed, router.stats()))
    before = {r['address']: r['serves'] for r in served[5][1]['replicas']}
    assert all(before[a] > 0 for a in addresses)
    after = {r['address']: r['serves'] for r in served[-1][1]['replicas']}
    assert after[addresses[0]] == before[addresses[0]]
    assert after[addresses[1]] == before[addresses[1]] + 6
    assert served[-1][1]['route_failovers'] == 1
    replicas[1][1].set_draining()
    router.infer(_payload(2, agent.hidden_size, 99))  # valid; drains it
    assert router.stats()['available'] == 0
    with pytest.raises(routing.NoReplicasAvailable):
      router.infer(_payload(2, agent.hidden_size, 100))
  finally:
    router.close()
    for buffer, ingest, server in replicas:
      ingest.close(graceful=False)
      server.close()
      buffer.close()


# --------------------------------------------------------------------
# serve_remote against JAX's.
# --------------------------------------------------------------------


@pytest.fixture(scope='module')
def converted():
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  jparams = jax_init_params(jagent, jax.random.PRNGKey(0),
                            {'frame': (H, W, 3), 'instr_len': 16})
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  agent.load_state_dict(convert.params_from_jax(jax.device_get(jparams)))
  return jagent, jparams, agent


@pytest.mark.parametrize('setting', ['seed', 'published', 'state_cache'])
def test_serve_remote_matches_jax_s(converted, setting):
  jagent, jparams, agent = converted
  kw = dict(inference_timeout_ms=1, use_instruction=False)
  if setting == 'state_cache':
    kw.update(inference_state_cache=True, inference_state_slots=4)
  jserver = jax_inference.InferenceServer(jagent, jparams, JaxConfig(**kw),
                                          seed=1, fleet_size=1)
  server = InferenceServer(agent, dict(agent.named_parameters()),
                           Config(**kw), seed=1, fleet_size=1)
  try:
    if setting == 'published':
      jserver.update_params(jparams, version=7)
      server.update_params(dict(agent.named_parameters()), version=7)
    for batch, seed in ((3, 0), (5, 1)):
      payload = _payload(batch, agent.hidden_size, seed)
      ref = jserver.serve_remote(payload)
      got = server.serve_remote(payload)
      assert got['version'] == ref['version']
      assert got['version'] == (7 if setting == 'published' else '<seed>')
      for key in ('logits', 'baseline', 'core_c', 'core_h'):
        np.testing.assert_allclose(got[key], np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
      assert got['action'].shape == (batch,)
      assert got['action'].dtype == np.int32
      assert ((got['action'] >= 0) & (got['action'] < A)).all()
  finally:
    jserver.close()
    server.close()


def _policy(server, step, state):
  rng = np.random.RandomState(step)
  env = StepOutput(np.float32(rng.randn()), StepOutputInfo(np.float32(0),
                                                           np.int32(0)),
                   np.bool_(step % 4 == 0),
                   (rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
                    np.zeros(16, np.int32)))
  return server.policy(np.int32(step % A), env, state)


def test_a_remote_call_leaves_the_state_arena_as_it_was():
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  params = init_params(agent, torch.Generator().manual_seed(0))
  server = InferenceServer(agent, params, _small_config(
      inference_state_cache=True, inference_state_slots=4), seed=1,
                           fleet_size=1)
  try:
    handles = [server.initial_core_state() for _ in range(2)]
    rng = np.random.RandomState(3)
    for h in handles:
      h.write(tuple(rng.randn(1, agent.hidden_size).astype(np.float32)
                    for _ in range(2)))
    _, handles[0] = _policy(server, 1, handles[0])
    arena = [a.clone() for a in server._arena]
    free = server.slots_free()
    snaps = [h.snapshot() for h in handles]
    for batch in (3, 6, 1):
      server.serve_remote(_payload(batch, agent.hidden_size, batch))
    assert server.slots_free() == free
    for got, ref in zip(server._arena, arena):
      assert torch.equal(got, ref)
    for h, snap in zip(handles, snaps):
      for x, y in zip(h.snapshot(), snap):
        np.testing.assert_array_equal(x, y)
    assert server.stats()['acquires'] == 2
  finally:
    server.close()


def test_interleaved_remote_calls_leave_the_local_actions_unchanged():
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  params = init_params(agent, torch.Generator().manual_seed(0))
  cfg = _small_config()
  servers = [InferenceServer(agent, params, cfg, seed=4, fleet_size=1)
             for _ in range(3)]
  try:
    traces, remote_actions = [], []
    for k, server in enumerate(servers):
      state = server.initial_core_state()
      trace, remotes = [], []
      for step in range(12):
        if k and step % 3 == 0:
          remotes.append(server.serve_remote(
              _payload(4, agent.hidden_size, step))['action'])
        out, state = _policy(server, step, state)
        trace.append((int(out.action), np.asarray(out.policy_logits).copy()))
      traces.append(trace)
      remote_actions.append(remotes)
    for other in traces[1:]:
      for (a, la), (b, lb) in zip(traces[0], other):
        assert a == b
        np.testing.assert_array_equal(la, lb)
    # The routed draws come from a generator of their own: the same seed,
    # the same routed actions, whatever the local traffic between them.
    for x, y in zip(remote_actions[1], remote_actions[2]):
      np.testing.assert_array_equal(x, y)
  finally:
    for server in servers:
      server.close()
