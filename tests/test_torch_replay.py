"""Sample reuse and IMPACT in the port (runtime/ring_buffer.py's replay
tier and prefetcher, learner.py's surrogate and target network), against
the JAX package's, and the extensions under a 2-rank process group.

- The replay tier and the composed buffer: the behaviours JAX's
  tests/test_replay.py pins, each scenario driven through both packages'
  classes with the same unrolls; the served unrolls (by identity) and the
  stats dicts must be equal. The prefetcher's re-serves, reserve_fn, the
  fresh-slot clock and set_replay_k; the unroll stager with a tier.
- validate_replay: the same hard errors and warnings as JAX's.
- IMPACT against JAX's over several steps (target_update_interval 3, with
  PopArt: the target's statistics snapshot), params rtol 5e-4 / atol
  5e-6 (the learner-step bar of tests/test_torch_learner.py), the
  target's PopArt statistics rtol 1e-5. The parity point: with
  target_update_interval=1 and replay_k=1 the IMPACT step's update is
  the V-trace step's (port against port, rtol 1e-6 / atol 1e-9: the
  same ops but for the surrogate's ratio of exactly 1), and the target
  is the params after every step.
- 2 gloo ranks sharing one batch: the data-parallel step with PopArt,
  pixel control and IMPACT, and the TP steps (gathered and sharded) with
  the full-feature agent, equal the one-rank step on the global batch
  (loss and metrics rtol 2e-4, params rtol 5e-4 / atol 5e-6: gradients
  summed in another order); the data-parallel replicas' params, PopArt
  statistics and SDC fingerprints are bit-equal after every step.
  Spawned ranks import no JAX (this module imports it only in tests).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import integrity
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config, validate_replay
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.runtime import ring_buffer
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo,
                                              map_structure)
from tests.test_torch_parallel import (GROUP_TIMEOUT_SECS, _loaded_jax,
                                       _spawn, _start_rank)

torch.set_num_threads(1)

H, W, A, T = 24, 32, 4, 4


def _unroll(seed):
  """One host unroll ([T+1] numpy, batch dim 1 on the carry), as the
  JAX package's testing.make_example_unroll draws it."""
  rng = np.random.RandomState(seed)
  t1 = T + 1
  return ActorOutput(
      level_name=np.int32(seed % 3),
      agent_state=(np.zeros((1, 256), np.float32),
                   np.zeros((1, 256), np.float32)),
      env_outputs=StepOutput(
          reward=rng.randn(t1).astype(np.float32),
          info=StepOutputInfo(np.zeros(t1, np.float32),
                              np.zeros(t1, np.int32)),
          done=np.zeros(t1, bool),
          observation=(rng.randint(0, 255, (t1, H, W, 3)).astype(np.uint8),
                       np.zeros((t1, 16), np.int32))),
      agent_outputs=AgentOutput(
          action=rng.randint(0, A, t1).astype(np.int32),
          policy_logits=rng.randn(t1, A).astype(np.float32),
          baseline=rng.randn(t1).astype(np.float32)))


# --- the replay tier and the composed buffer, scenario by scenario -------

def _scenario(name, lib, unrolls):
  """Drive `lib` (either package's ring_buffer) through one of JAX's
  pinned behaviours; returns what was served (unroll indices) and the
  stats, for comparison across packages."""
  index = {id(u): i for i, u in enumerate(unrolls)}
  ids = lambda items: [index[id(u)] for u in items]  # noqa: E731
  out = []
  if name == 'age_eviction':
    tier = lib.ReplayTier(3)
    for u in unrolls[:5]:
      tier.add(u)
    return out, tier.stats()
  if name == 'circular_cursor':
    tier = lib.ReplayTier(4)
    for u in unrolls[:3]:
      tier.add(u)
    out += [ids(tier.sample(5)), ids(tier.sample(2))]
    return out, tier.stats()
  if name == 'version_eviction':
    tier = lib.ReplayTier(8, max_staleness=2)
    tier.note_param_version(10)
    tier.add(unrolls[0])
    tier.note_param_version(11)
    tier.add(unrolls[1])
    tier.note_param_version(13)
    out.append(ids(tier.sample(2)))
    return out, tier.stats()
  if name == 'unsample_last':
    tier = lib.ReplayTier(4)
    tier.note_param_version(5)
    for u in unrolls[:3]:
      tier.add(u)
    tier.note_param_version(7)
    out.append(ids(tier.sample(2)))
    tier.unsample_last()
    out.append(tier.stats())
    tier.unsample_last()
    out.append(ids(tier.sample(2)))
    return out, tier.stats()
  if name == 'unbounded':
    tier = lib.ReplayTier(4, max_staleness=0)
    tier.add(unrolls[0])
    tier.note_param_version(10**6)
    out.append(ids(tier.sample(1)))
    return out, tier.stats()
  tier = lib.ReplayTier(8)
  if name == 'timeout_gives_back':
    buf = lib.TrajectoryBuffer(4, replay=lib.ReplayTier(4),
                               replay_ratio=0.5)
    buf.put(unrolls[0])
    buf.get()
    with pytest.raises(TimeoutError):
      buf.get_unrolls(4, 0.05)
    return out, buf.stats()
  buf = lib.TrajectoryBuffer(8, replay=tier, replay_ratio=(
      0.75 if name == 'short_tier' else 0.5))
  if name == 'compose':
    for u in unrolls[:4]:
      buf.put(u)
    items, n_fresh = buf.get_unrolls(4, 1)
    out.append((ids(items), n_fresh))
    for u in unrolls[10:12]:
      buf.put(u)
    items, n_fresh = buf.get_unrolls(4, 1)
    out.append((ids(items), n_fresh))
  elif name == 'short_tier':
    buf.put(unrolls[0])
    out.append(buf.get_unrolls(1, 1)[1])
    for u in unrolls[1:5]:
      buf.put(u)
    items, n_fresh = buf.get_unrolls(4, 1)
    out.append((len(items), n_fresh))
  elif name == 'get_retains':
    buf.put(unrolls[0])
    out.append(ids([buf.get(timeout=1)]))
  return out, buf.stats()


@pytest.mark.parametrize('name', [
    'age_eviction', 'circular_cursor', 'version_eviction', 'unsample_last',
    'unbounded', 'timeout_gives_back', 'compose', 'short_tier',
    'get_retains'])
def test_replay_behaviour_matches_jax(name):
  from scalable_agent_tpu.runtime import ring_buffer as jax_ring_buffer
  unrolls = [_unroll(i) for i in range(12)]
  want = _scenario(name, jax_ring_buffer, unrolls)
  got = _scenario(name, ring_buffer, unrolls)
  assert got == want


def test_buffer_refusals_and_plain_stats():
  with pytest.raises(ValueError, match='ReplayTier'):
    ring_buffer.TrajectoryBuffer(4, replay_ratio=0.5)
  with pytest.raises(ValueError, match=r'\[0, 1\)'):
    ring_buffer.TrajectoryBuffer(4, replay=ring_buffer.ReplayTier(2),
                                 replay_ratio=1.0)
  stats = ring_buffer.TrajectoryBuffer(4).stats()
  assert 'fresh_unrolls' in stats and 'replay_occupancy' not in stats


def test_crc_evicts_a_rotted_entry():
  tier = ring_buffer.ReplayTier(4)
  kept, rotted = _unroll(0), _unroll(1)
  tier.add(kept)
  tier.add(rotted)
  rotted.env_outputs.observation[0].reshape(-1)[7] ^= 1   # host-memory rot
  assert [u is kept for u in tier.sample(2)] == [True]
  stats = tier.stats()
  assert stats['replay_evictions_crc'] == 1
  assert stats['replay_occupancy'] == 1
  assert stats['replay_reused_unrolls'] == 1
  off = ring_buffer.ReplayTier(4, verify_crc=False)
  off.add(rotted)
  assert off.sample(1)[0] is rotted


def test_tree_digest_matches_jax():
  from scalable_agent_tpu import integrity as jax_integrity
  unroll = _unroll(3)
  assert integrity.tree_digest(unroll) == jax_integrity.tree_digest(unroll)
  assert integrity.tree_digest(unroll) != integrity.tree_digest(_unroll(4))


@pytest.mark.parametrize('bad', [
    dict(surrogate='ppo'), dict(replay_k=0), dict(replay_ratio=1.0),
    dict(replay_ratio=-0.1), dict(target_update_interval=0),
    dict(impact_epsilon=0.0), dict(replay_capacity_unrolls=-1),
    dict(replay_max_staleness=-1)], ids=str)
def test_validate_replay_hard_errors_match_jax(bad):
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.config import validate_replay as jax_validate
  with pytest.raises(ValueError) as want:
    jax_validate(JaxConfig(**bad))
  with pytest.raises(ValueError) as got:
    validate_replay(Config(**bad))
  assert str(got.value) == str(want.value)


def test_validate_replay_warnings_and_resolution_match_jax():
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.config import validate_replay as jax_validate
  for kw in ({}, dict(replay_k=2), dict(max_unroll_staleness=7),
             dict(max_unroll_staleness=7, replay_max_staleness=3),
             dict(batch_size=8), dict(replay_capacity_unrolls=5),
             dict(replay_ratio=0.5, replay_capacity_unrolls=1,
                  batch_size=4, surrogate='impact')):
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    assert validate_replay(cfg) == jax_validate(jcfg), kw
    assert cfg.resolved_replay_capacity == jcfg.resolved_replay_capacity
    assert (cfg.resolved_replay_max_staleness ==
            jcfg.resolved_replay_max_staleness)


# --- the prefetcher's sample reuse ---------------------------------------

def _prefetcher(buf, replay_k, **kw):
  return ring_buffer.BatchPrefetcher(buf, 2, stack_fn=list, depth=2,
                                     replay_k=replay_k, **kw)


def test_prefetcher_reserves_the_staged_batch():
  buf = ring_buffer.TrajectoryBuffer(8)
  for i in range(4):
    buf.put(i)
  reserved = []
  prefetcher = _prefetcher(buf, 3, reserve_fn=lambda item: reserved.append(
      item) or ('again', item))
  try:
    first = prefetcher.get(timeout=5)
    assert first == [0, 1]
    assert prefetcher.get(timeout=5) == ('again', first)
    assert prefetcher.get(timeout=5)[1] is first   # the same object
    assert prefetcher.get(timeout=5) == [2, 3]
    stats = prefetcher.stats()
    assert (stats['serves'], stats['batch_reserves'],
            stats['fresh_slots_served']) == (4, 2, 4)
    assert prefetcher.fresh_slots_served() == 4
    assert len(reserved) == 2
  finally:
    prefetcher.close()


def test_set_replay_k_applies_to_batches_staged_after():
  buf = ring_buffer.TrajectoryBuffer(16)
  prefetcher = _prefetcher(buf, 2)
  try:
    for i in range(2):
      buf.put(i)
    assert prefetcher.get(timeout=5) == [0, 1]
    prefetcher.set_replay_k(1)
    assert prefetcher.replay_k == 1
    assert prefetcher.get(timeout=5) == [0, 1]   # still its K of 2
    for i in range(2, 6):
      buf.put(i)
    assert prefetcher.get(timeout=5) == [2, 3]
    assert prefetcher.get(timeout=5) == [4, 5]
    with pytest.raises(ValueError, match='replay_k'):
      prefetcher.set_replay_k(0)
  finally:
    prefetcher.close()


def test_prefetcher_passes_the_fresh_count_with_a_tier():
  tier = ring_buffer.ReplayTier(8, verify_crc=False)
  buf = ring_buffer.TrajectoryBuffer(8, replay=tier, replay_ratio=0.5)
  placed = []
  prefetcher = ring_buffer.BatchPrefetcher(
      buf, 4, stack_fn=list, depth=1,
      place_fn=lambda batch, n_fresh: placed.append(n_fresh) or batch)
  try:
    for i in range(6):
      buf.put(i)
    assert prefetcher.get(timeout=5) == [0, 1, 2, 3]
    assert prefetcher.get(timeout=5) == [4, 5, 0, 1]
    assert placed[:2] == [4, 2]
    assert prefetcher.fresh_slots_served() == 6
  finally:
    prefetcher.close()


def test_unroll_stager_with_a_tier_peels_fresh_views_only():
  tier = ring_buffer.ReplayTier(8)
  buf = ring_buffer.TrajectoryBuffer(8, replay=tier, replay_ratio=0.5)
  views = []
  stager = ring_buffer.UnrollBatchStager(
      4, host_view_fn=lambda u: int(u.level_name),
      finalize_fn=lambda v, batch: (views.append(v) or batch))
  prefetcher = ring_buffer.BatchPrefetcher(buf, 4, stager=stager)
  unrolls = [_unroll(i) for i in range(6)]
  try:
    for u in unrolls:
      buf.put(u)
    first = prefetcher.get(timeout=5)
    second = prefetcher.get(timeout=5)
    assert views == [[0, 1, 2, 0], [1, 2]]   # level ids: seed % 3
    # The replayed slots hold the first batch's first two unrolls.
    torch.testing.assert_close(second.env_outputs.reward[:, 2:],
                               first.env_outputs.reward[:, :2])
    assert prefetcher.stats()['fresh_slots_served'] == 6
  finally:
    prefetcher.close()


# --- IMPACT ---------------------------------------------------------------

_IMPACT = dict(batch_size=2, unroll_length=T, num_action_repeats=1,
               total_environment_frames=10**6, num_actions=A, height=H,
               width=W, torso='shallow', use_instruction=False)


def _jax_pair(cfg_kw, num_tasks=0):
  import jax
  from scalable_agent_tpu import learner as jax_learner
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.models import ImpalaAgent as JaxAgent
  from scalable_agent_tpu.models import init_params as jax_init_params
  from scalable_agent_tpu_torch import convert, driver
  jcfg, cfg = JaxConfig(**cfg_kw), Config(**cfg_kw)
  jagent = JaxAgent(num_actions=A, torso='shallow', use_instruction=False,
                    num_popart_tasks=num_tasks)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (H, W, 3), 'instr_len': 16})
  jstate = jax_learner.make_train_state(params, jcfg, num_tasks)
  agent = driver.build_agent(cfg, A, max(num_tasks, 1))
  agent.load_state_dict(convert.params_from_jax(jax.device_get(params)))
  state = learner.make_train_state(agent, cfg, num_tasks)
  return (jax_learner.make_train_step(jagent, jcfg), jstate,
          learner.make_train_step_fn(agent, cfg), state)


def _jax_batch(seed, level_name=None):
  import jax.numpy as jnp
  from scalable_agent_tpu.testing import make_example_batch
  batch = make_example_batch(T + 1, 2, H, W, A, 16, seed=seed,
                             done_prob=0.2)
  if level_name is not None:
    batch = batch._replace(level_name=jnp.asarray(level_name))
  return batch, map_structure(lambda x: torch.from_numpy(np.array(x)),
                              batch)


def _port(tree):
  import jax
  from scalable_agent_tpu_torch import convert
  return {k: v.numpy() for k, v in convert.params_from_jax(
      jax.device_get(tree)).items() if not k.endswith('bias_ih')}


def test_impact_with_popart_matches_jax():
  """interval 3 with PopArt: the target holds still between refreshes,
  and its statistics snapshot refreshes with it (JAX's
  test_popart_anchor_stats_snapshot_with_target)."""
  kw = dict(_IMPACT, use_popart=True, popart_beta=0.3, surrogate='impact',
            target_update_interval=3, impact_epsilon=0.05)
  jstep, jstate, step, state = _jax_pair(kw, num_tasks=2)
  popart_after = {0: state.popart}
  for k in range(1, 6):
    jbatch, batch = _jax_batch(k, level_name=np.array([0, 1], np.int32))
    jstate, jm = jstep(jstate, jbatch)
    state, m = step(state, batch)
    popart_after[k] = state.popart
    np.testing.assert_allclose(float(m['total_loss']),
                               float(jm['total_loss']), rtol=2e-4)
    np.testing.assert_allclose(float(m['impact_clip_fraction']),
                               float(jm['impact_clip_fraction']))
    anchor = popart_after[(k // 3) * 3]
    assert torch.equal(state.target_popart.mu, anchor.mu)
    np.testing.assert_allclose(state.target_popart.mu.numpy(),
                               np.asarray(jstate.target_popart.mu),
                               rtol=1e-5, atol=1e-7)
  ref, ref_target = _port(jstate.params), _port(jstate.target_params)
  for k, p in state.params.items():
    np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=5e-4,
                               atol=5e-6, err_msg=k)
    np.testing.assert_allclose(state.target_params[k].numpy(),
                               ref_target[k], rtol=5e-4, atol=5e-6,
                               err_msg=f'target {k}')


def test_impact_at_the_parity_point_is_the_vtrace_step():
  """target_update_interval=1, replay_k=1: the update is V-trace's, the
  clip never binds, and the target entering each step is the params."""
  kw = dict(_IMPACT, surrogate='impact', target_update_interval=1)
  _, _, step_i, state_i = _jax_pair(kw)
  _, _, step_v, state_v = _jax_pair(dict(_IMPACT))
  for seed in range(3):
    _, batch = _jax_batch(seed)
    state_i, m_i = step_i(state_i, batch)
    state_v, m_v = step_v(state_v, batch)
    assert float(m_i['impact_clip_fraction']) == 0.0
    np.testing.assert_allclose(float(m_i['grad_norm']),
                               float(m_v['grad_norm']), rtol=1e-6)
    for k, p in state_i.params.items():
      assert torch.equal(state_i.target_params[k], p.detach()), k
      assert state_i.target_params[k].data_ptr() != p.data_ptr()
  for k, p in state_i.params.items():
    np.testing.assert_allclose(p.detach().numpy(),
                               state_v.params[k].detach().numpy(),
                               rtol=1e-6, atol=1e-9, err_msg=k)


# --- a 2-rank group's step with the extensions ---------------------------

B2 = 4
_GROUP = dict(torso='shallow', batch_size=B2, unroll_length=T,
              num_action_repeats=1, total_environment_frames=10**6,
              height=H, width=W, num_actions=A, use_popart=True,
              popart_beta=0.2, pixel_control_cost=0.05,
              use_pallas_vtrace=True)
_CASES = {
    'dp': dict(_GROUP, use_instruction=False, surrogate='impact',
               target_update_interval=2, impact_epsilon=0.05),
    'tp_gathered': dict(_GROUP, use_instruction=True, model_parallelism=2,
                        tp_compute='gathered'),
    'tp_sharded': dict(_GROUP, use_instruction=True, model_parallelism=2,
                       tp_compute='sharded'),
}
_STEPS = 3


def _group_batch(seed):
  rng = np.random.RandomState(seed)
  t1 = T + 1
  return ActorOutput(
      level_name=np.array([0, 3, 1, 3], np.int32),
      agent_state=(rng.randn(B2, 256).astype(np.float32) * 0.3,
                   rng.randn(B2, 256).astype(np.float32) * 0.3),
      env_outputs=StepOutput(
          rng.randn(t1, B2).astype(np.float32),
          StepOutputInfo(np.zeros((t1, B2), np.float32),
                         np.zeros((t1, B2), np.int32)),
          rng.rand(t1, B2) > 0.8,
          (rng.randint(0, 256, (t1, B2, H, W, 3)).astype(np.uint8),
           rng.randint(0, 1001, (t1, B2, 16)).astype(np.int32))),
      agent_outputs=AgentOutput(
          rng.randint(0, A, (t1, B2)),
          rng.randn(t1, B2, A).astype(np.float32),
          rng.randn(t1, B2).astype(np.float32)))


def _group_agent(cfg):
  from scalable_agent_tpu_torch import driver
  agent = driver.build_agent(cfg, A, 4)
  init_params(agent, torch.Generator().manual_seed(3))
  return agent


def _record(state, metrics, layout=None):
  from scalable_agent_tpu_torch.parallel import train_parallel
  if layout is not None:
    state = train_parallel.gather_state(state, layout)
  out = {'metrics': {k: float(v) for k, v in metrics.items()},
         'params': {k: v.detach().numpy().copy()
                    for k, v in state.params.items()},
         'popart': state.popart.mu.numpy().copy(),
         'fingerprint': int(learner.param_fingerprint(state.params))}
  if state.target_params is not None:
    out['target'] = {k: v.numpy().copy()
                     for k, v in state.target_params.items()}
  return out


def _group_rank(rank, world, port, outdir):
  """Every case's steps on this rank's rows of the shared batches; rank
  0 also takes the one-rank steps on the global batches."""
  _start_rank()
  from scalable_agent_tpu_torch.parallel import distributed
  from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
  from scalable_agent_tpu_torch.parallel import train_parallel
  results = {}
  device = None
  for name, kw in _CASES.items():
    cfg = Config(**kw, coordinator_address=f'localhost:{port}',
                 num_processes=world, process_id=rank)
    if device is None:
      device = distributed.maybe_initialize(
          cfg, backend='gloo', device='cpu', timeout_secs=GROUP_TIMEOUT_SECS)
    mesh = mesh_lib.make_mesh(device, model_parallelism=cfg.model_parallelism)
    agent = _group_agent(cfg)
    state = train_parallel.make_sharded_train_state(agent, cfg, mesh)
    step, place = train_parallel.make_sharded_train_step(agent, cfg, mesh,
                                                         None)
    history, single = [], []
    for s in range(_STEPS):
      host = map_structure(torch.from_numpy, _group_batch(s))
      state, metrics = step(state, place(host))
      history.append(_record(state, metrics, step.layout))
    results[name] = history
    if rank == 0:
      one = dataclasses.replace(cfg, coordinator_address='',
                                num_processes=1, process_id=-1,
                                model_parallelism=1)
      agent1 = _group_agent(one)
      step1 = learner.make_train_step_fn(agent1, one)
      state1 = learner.make_train_state(agent1, one)
      for s in range(_STEPS):
        state1, metrics1 = step1(state1, map_structure(
            torch.from_numpy, _group_batch(s)))
        single.append(_record(state1, metrics1))
      results[name + '/single'] = single
  results['jax_modules'] = _loaded_jax()
  torch.save(results, os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def test_group_step_with_the_extensions_equals_the_one_rank_step(tmp_path):
  _spawn(_group_rank, 2, str(tmp_path))
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  for r in ranks:
    assert r['jax_modules'] == []
  for name in _CASES:
    for s in range(_STEPS):
      single = ranks[0][name + '/single'][s]
      for r, result in enumerate(ranks):
        got = result[name][s]
        what = f'{name} step {s} rank {r}'
        for key in ('total_loss', 'grad_norm', 'pixel_control_loss',
                    'popart_sigma_max', 'popart_sigma_min'):
          np.testing.assert_allclose(got['metrics'][key],
                                     single['metrics'][key], rtol=2e-4,
                                     err_msg=f'{what} {key}')
        np.testing.assert_allclose(got['popart'], single['popart'],
                                   rtol=2e-4, atol=1e-7, err_msg=what)
        for k, p in single['params'].items():
          np.testing.assert_allclose(got['params'][k], p, rtol=5e-4,
                                     atol=5e-6, err_msg=f'{what} {k}')
        if 'target' in single:
          np.testing.assert_allclose(
              got['metrics']['impact_clip_fraction'],
              single['metrics']['impact_clip_fraction'], atol=1e-6)
          for k, p in single['target'].items():
            np.testing.assert_allclose(got['target'][k], p, rtol=5e-4,
                                       atol=5e-6, err_msg=f'{what} {k}')
      # The replicas agree bit for bit: the PopArt moments and the
      # gradients were summed once for both.
      a, b = ranks[0][name][s], ranks[1][name][s]
      assert a['fingerprint'] == b['fingerprint'], (name, s)
      np.testing.assert_array_equal(a['popart'], b['popart'])
      for k in a['params']:
        np.testing.assert_array_equal(a['params'][k], b['params'][k])
