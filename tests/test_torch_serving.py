"""The serving version table of the port's inference server
(runtime/inference.py), mirroring the JAX package's tests/test_serving.py
(TestVersionTable, TestServingTraffic, TestShadowAndAot): LRU eviction,
a pinned version's survival, the byte budget, dedup of the live version
and the first publish's copy, a flip without a copy for a resident
version, A/B serve counts, shadow divergence, int8-resident entries and
the serving_aot flip. Beyond JAX: shadow traffic does not move the
sampling generator (the same seed gives the same live actions with
shadow 0 and 0.5), and the int8 version's logits stay within the
first-order bound its per-tensor max_abs_error gives. Routed serving
(JAX's :375-533: routing.py and serve_remote) waits for ROADMAP A7.3b;
the ingest's 'infer' seam it plugs into is runtime/remote.py's
(tests/test_torch_remote.py)."""

import threading
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.runtime import codec
from scalable_agent_tpu_torch.runtime.inference import InferenceServer
from scalable_agent_tpu_torch.structs import StepOutput, StepOutputInfo

torch.set_num_threads(1)

H, W, A = 24, 32, 3
OBS = {'frame': (H, W, 3), 'instr_len': 16}
_AGENT = ImpalaAgent(A, (H, W, 3), torso='shallow')
_PARAMS = {k: v.detach().clone() for k, v in init_params(
    _AGENT, torch.Generator().manual_seed(0)).items()}
_PARAMS_B = {k: v.detach().clone() for k, v in init_params(
    _AGENT, torch.Generator().manual_seed(1)).items()}


def _server(seed=7, **kw):
  config = Config(**dict(dict(inference_max_batch=8, inference_timeout_ms=5,
                              use_instruction=False), **kw))
  return InferenceServer(_AGENT, _PARAMS, config, seed=seed, fleet_size=1,
                         pad_batch_to=1)


def _fresh(tree=None):
  return {k: v.clone() for k, v in (tree or _PARAMS).items()}


def _labels(server):
  return {label for label, _, _, _ in server.resident_versions()}


def _drive(server, n, seed=3):
  """n policy calls of one actor on fixed inputs; its actions."""
  frame = np.random.RandomState(seed).randint(0, 255, (H, W, 3)).astype(
      np.uint8)
  state = server.initial_core_state()
  prev, actions = np.int32(0), []
  for _ in range(n):
    env = StepOutput(np.float32(0.0), StepOutputInfo(np.float32(0),
                                                     np.int32(0)),
                     np.bool_(False), (frame, np.zeros(16, np.int32)))
    out, state = server.policy(prev, env, state)
    prev = np.int32(out.action)
    actions.append(int(out.action))
  return actions


def _wait_shadow(server, count, timeout=10.0):
  deadline = time.monotonic() + timeout
  while (server.stats()['shadow_calls'] < count
         and time.monotonic() < deadline):
    time.sleep(0.01)
  assert server.stats()['shadow_calls'] >= count


def test_resident_lru_eviction():
  server = _server(serving_resident_versions=2)
  try:
    for v in (1, 2, 3):
      server.update_params(_fresh(), version=v)
    assert _labels(server) == {2, 3}
    stats = server.stats()
    assert stats['resident_versions'] == 2 and stats['live_version'] == 3
    assert stats['evictions'] >= 2  # the seed entry, then v1
  finally:
    server.close()


def test_pinned_version_survives_eviction():
  server = _server(serving_resident_versions=2)
  try:
    server.update_params(_fresh(), version=1)
    assert server.pin_version(1)
    assert not server.pin_version(99)
    server.update_params(_fresh(), version=2)
    server.update_params(_fresh(), version=3)
    assert 1 in _labels(server) and 2 not in _labels(server)
    server.set_live(1)
    assert server.stats()['live_version'] == 1
    with pytest.raises(KeyError):
      server.set_live(99)
  finally:
    server.close()


def test_hbm_budget_evicts_down_to_live():
  server = _server(serving_resident_versions=4, serving_hbm_budget_mb=0.001)
  try:
    for v in (1, 2, 3):
      server.update_params(_fresh(), version=v)
    assert _labels(server) == {3}
  finally:
    server.close()


def test_same_version_dedup_and_none_always_publishes():
  server = _server(serving_resident_versions=4)
  try:
    server.update_params(_fresh(), version=1)
    before = server.stats()
    server.update_params(_fresh(), version=1)
    stats = server.stats()
    assert stats['params_version'] == before['params_version']
    assert stats['publishes_skipped'] == before['publishes_skipped'] + 1
    server.update_params(_fresh())
    server.update_params(_fresh())
    stats = server.stats()
    assert stats['params_version'] == before['params_version'] + 2
    anon = [l for l in _labels(server)
            if isinstance(l, str) and l.startswith('anon-')]
    assert len(anon) == 2
  finally:
    server.close()


def test_the_first_publish_copies_and_the_copy_is_owned():
  """The constructor's params and every publish are copies: a later
  in-place update of the learner's tensors does not reach them."""
  params = _fresh()
  server = InferenceServer(_AGENT, params, Config(use_instruction=False),
                           seed=7)
  try:
    server.update_params(params, version=7)
    assert server.stats()['publishes_skipped'] == 0
    with torch.no_grad():
      for p in params.values():
        p.add_(1.0)
    live = server.live_params()
    assert all(torch.equal(live[k], _PARAMS[k]) for k in live)
  finally:
    server.close()


def test_resident_version_flip_without_copy():
  server = _server(serving_resident_versions=3)
  try:
    server.update_params(_fresh(), version=1)
    server.update_params(_fresh(), version=2)
    before = server.stats()
    server.update_params(_fresh(_PARAMS_B), version=1)
    stats = server.stats()
    assert stats['live_version'] == 1
    assert stats['version_flips'] == before['version_flips'] + 1
    assert stats['params_version'] == before['params_version'] + 1
    assert stats['resident_versions'] == before['resident_versions']
    assert stats['snapshots'] == before['snapshots']  # no copy
    live = server.live_params()
    assert all(torch.equal(live[k], _PARAMS[k]) for k in live)
  finally:
    server.close()


def test_concurrent_update_params_vs_stats():
  server = _server(serving_resident_versions=3)
  errors, stop = [], threading.Event()

  def publisher(base):
    try:
      for k in range(10):
        server.update_params(_fresh(), version=base + k)
    except Exception as e:  # the assertion below
      errors.append(e)

  def reader():
    try:
      while not stop.is_set():
        server.stats()
        server.resident_versions()
    except Exception as e:
      errors.append(e)

  try:
    pubs = [threading.Thread(target=publisher, args=(100 * i,))
            for i in range(4)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in pubs + readers:
      t.start()
    for t in pubs:
      t.join(timeout=60)
    stop.set()
    for t in readers:
      t.join(timeout=10)
    assert not errors
    assert server.stats()['params_version'] == 40
    assert server.stats()['resident_versions'] <= 3
  finally:
    stop.set()
    server.close()


def test_serve_counts_and_ab_assignment():
  server = _server(serving_resident_versions=3, serving_ab_fraction=0.5)
  try:
    server.update_params(_fresh(), version=1)
    server.update_params(_fresh(), version=2)
    _drive(server, 8)
    stats = server.stats()
    counts = stats['serve_counts']
    assert sum(counts.values()) == 8
    assert counts['1'] == 4 and counts['2'] == 4
    assert stats['ab_calls'] == 4
    by_label = {label: serves for label, serves, _, _
                in server.resident_versions()}
    assert by_label[1] == 4 and by_label[2] == 4
    server.set_ab(1, 0.25)
    _drive(server, 8)
    assert server.stats()['ab_calls'] == 6
    with pytest.raises(ValueError):
      server.set_ab(None, 1.5)
  finally:
    server.close()


def test_shadow_divergence_zero_then_positive():
  server = _server(serving_resident_versions=3, serving_shadow_fraction=1.0)
  try:
    server.update_params(_fresh(), version=1)
    server.update_params(_fresh(), version=2)  # shadow = v1, equal
    _drive(server, 8)
    _wait_shadow(server, 8)
    assert server.stats()['shadow_divergence'] == 0.0
    server.update_params(_fresh(_PARAMS_B), version=3)
    calls = 0
    while server.stats()['shadow_divergence'] == 0.0 and calls < 64:
      _drive(server, 8, seed=calls)
      calls += 8
    assert server.stats()['shadow_divergence'] > 0.0
    with pytest.raises(ValueError):
      server.set_shadow(None, -0.1)
  finally:
    server.close()


def test_shadow_traffic_does_not_move_the_generator():
  """The same seed gives the same live actions with shadow 0 and 0.5:
  the shadow step is greedy and draws nothing."""
  actions, shadows = [], []
  for fraction in (0.0, 0.5):
    server = _server(seed=11, serving_resident_versions=3,
                     serving_shadow_fraction=fraction)
    try:
      server.update_params(_fresh(_PARAMS_B), version=1)
      server.update_params(_fresh(), version=2)
      actions.append(_drive(server, 16))
      shadows.append(server.stats()['shadow_calls'])
    finally:
      server.close()
  assert shadows[0] == 0 and shadows[1] >= 1
  assert actions[0] == actions[1]


def _logits(server, calls):
  out = []
  for prev, env, state in calls:
    out.append(server.policy(prev, env, state)[0].policy_logits)
  return np.stack(out)


def _calls(n, seed=0):
  rng = np.random.RandomState(seed)
  return [(np.int32(rng.randint(A)),
           StepOutput(np.float32(rng.randn()),
                      StepOutputInfo(np.float32(0), np.int32(0)),
                      np.bool_(rng.rand() < 0.3),
                      (rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
                       np.zeros(16, np.int32))),
           tuple(rng.randn(1, 256).astype(np.float32) * 0.3
                 for _ in range(2)))
          for _ in range(n)]


def test_int8_resident_entries_serve_within_the_first_order_bound():
  """publish_codec='int8': the resident bytes are ~1/4 of float32, the
  entry holds JAX's quantization of the params, the int8 server's logits
  equal a float32 server's on the dequantized params (float32 rounding)
  and differ from the float32 params' (the forward really reads the int8
  entry), each by at most the first-order bound
  sum |d logit / d param| x the param tensor's max_abs_error."""
  calls = _calls(6)
  quantized = codec.quantize_np({k: v.numpy() for k, v in _PARAMS.items()})
  want = codec.dequantize_tree(quantized)
  f32 = _server()
  int8 = _server(publish_codec='int8')
  deq = _server()
  try:
    int8.update_params(_fresh(), version=1)
    deq.update_params({k: torch.from_numpy(v) for k, v in want.items()},
                      version=1)
    got, ref = _logits(int8, calls), _logits(f32, calls)
    plain = _logits(deq, calls)
    ratio = int8.stats()['resident_bytes'] / f32.stats()['resident_bytes']
    live = int8.live_params()
  finally:
    f32.close()
    int8.close()
    deq.close()
  for k in live:
    np.testing.assert_array_equal(live[k].numpy(), want[k])
  np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
  assert np.abs(got - ref).max() > 0
  assert 0.25 <= ratio < 0.26
  agent = ImpalaAgent(A, (H, W, 3), torso='shallow')
  agent.load_state_dict(_PARAMS, strict=False)
  errors = {k: codec.max_abs_error({k: quantized[k]}) for k in quantized}
  for row, (prev, env, carry) in enumerate(calls):
    frame, instr = env.observation
    out, _ = agent(torch.tensor([[prev]]), StepOutput(
        torch.tensor([[env.reward]]), None, torch.tensor([[env.done]]),
        (torch.from_numpy(frame)[None, None],
         torch.from_numpy(instr)[None, None])),
        tuple(torch.from_numpy(c) for c in carry))
    for a in range(A):
      grads = torch.autograd.grad(out.policy_logits[0, 0, a],
                                  list(agent.parameters()),
                                  retain_graph=True, allow_unused=True)
      bound = sum(float(g.abs().sum()) * errors[k] for (k, _), g in zip(
          agent.named_parameters(), grads) if g is not None)
      assert abs(got[row, a] - ref[row, a]) <= bound, (row, a)
  assert codec.greedy_agreement(got, ref) >= 0.5


def test_aot_flip_serves_without_a_miss():
  """int8 publishes change the parameter structure; serving_aot runs a
  warm forward per warmed bucket at publish, so no serve misses."""
  server = _server(publish_codec='int8', serving_aot=True)
  try:
    server.warmup(OBS, sizes=[1])
    server.update_params(_fresh(), version=1)
    _drive(server, 3)
    server.update_params(_fresh(), version=2)
    _drive(server, 3)
    stats = server.stats()
    assert stats['aot_misses'] == 0 and stats['aot_compiled'] >= 2
  finally:
    server.close()
  # Without the warm forward at publish, the int8 serves are misses.
  server = _server(publish_codec='int8', serving_aot=True)
  try:
    server.update_params(_fresh(), version=1)
    _drive(server, 2)
    assert server.stats()['aot_misses'] == 2
  finally:
    server.close()
