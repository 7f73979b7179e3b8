"""The port's checkpointer (scalable_agent_tpu_torch/checkpoint.py), held to
the JAX package's (scalable_agent_tpu/checkpoint.py, Orbax): every test of
tests/test_checkpoint.py but the sharded and params-only ones (ROADMAP
A5b.3, A7.1), the restore ladder against JAX's on the same damage, the
in-place restore, the structure-versus-corruption routing of a damaged
torch.save file, and a 2-rank gloo group.

The weights are the JAX agent's, converted (convert.params_from_jax).
Tolerance: none — restored state is bit-equal to the saved state, and the
port's restored params are bit-equal to JAX's restored params after
conversion. A spawned rank re-imports this module, so JAX is imported
inside the tests only.
"""

import json
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import checkpoint as ckpt_lib
from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.checkpoint import Checkpointer
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import ImpalaAgent, init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)

torch.set_num_threads(1)

T, B, A, H, W = 3, 2, 4, 24, 32
_KW = dict(batch_size=B, unroll_length=T, torso='shallow',
           total_environment_frames=10**6, use_instruction=False,
           num_action_repeats=1)


@pytest.fixture(autouse=True)
def _no_leftover_plan():
  yield
  faults.clear()


def _agent(seed=0, torso='shallow'):
  agent = ImpalaAgent(A, (H, W, 3), torso=torso)
  init_params(agent, torch.Generator().manual_seed(seed))
  return agent


def _state(seed=0, **kw):
  cfg = Config(**{**_KW, **kw})
  agent = _agent(seed, cfg.torso)
  return agent, cfg, learner.make_train_state(agent, cfg)


def _batch(seed=0):
  rng = np.random.RandomState(seed)
  t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
  return ActorOutput(
      level_name=torch.zeros(B, dtype=torch.int32),
      agent_state=(t(rng.randn(B, 256).astype(np.float32) * 0.3),
                   t(rng.randn(B, 256).astype(np.float32) * 0.3)),
      env_outputs=StepOutput(
          t(rng.randn(T + 1, B).astype(np.float32)),
          StepOutputInfo(torch.zeros(T + 1, B),
                         torch.zeros(T + 1, B, dtype=torch.int32)),
          t(rng.rand(T + 1, B) > 0.8),
          (t(rng.randint(0, 256, (T + 1, B, H, W, 3)).astype(np.uint8)),
           torch.zeros(T + 1, B, 16, dtype=torch.int32))),
      agent_outputs=AgentOutput(
          t(rng.randint(0, A, (T + 1, B))),
          t(rng.randn(T + 1, B, A).astype(np.float32)),
          t(rng.randn(T + 1, B).astype(np.float32))))


def _payload(state):
  return learner.state_to_payload(state)


def _assert_state_equal(got, want_payload):
  got = _payload(got)
  assert got['update_steps'] == want_payload['update_steps']
  assert torch.equal(got['opt_state']['count'],
                     want_payload['opt_state']['count'])
  for tree in ('params',):
    for k, v in want_payload[tree].items():
      assert torch.equal(got[tree][k], v), k
  for k, v in want_payload['opt_state']['nu'].items():
    assert torch.equal(got['opt_state']['nu'][k], v), k


def _save_steps(ckpt, state, steps):
  for step in steps:
    assert ckpt.save(state, step=step, force=True)


# --- tests/test_checkpoint.py, test for test -------------------------------


def test_save_restore_roundtrip(tmp_path):
  """The restored state is bit-equal to the saved one, and the next train
  step from it is bit-equal to the step from the never-saved state."""
  agent, cfg, state = _state(0)
  step = learner.make_train_step_fn(agent, cfg)
  batch = _batch()
  state, _ = step(state, batch)
  state, _ = step(state, batch)
  saved = _payload(state)

  ckpt = Checkpointer(str(tmp_path / 'ckpt'), save_interval_secs=0)
  assert ckpt.save(state)
  assert ckpt.latest_step() == 2

  agent2, _, target = _state(1)  # different values: the restore overwrites
  restored = ckpt.restore_latest(target)
  assert restored is not None
  _assert_state_equal(restored, saved)
  assert restored.update_steps == 2
  ckpt.close()

  resumed, _ = learner.make_train_step_fn(agent2, cfg)(restored, batch)
  again, _ = step(state, batch)
  for k, p in resumed.params.items():
    assert torch.equal(p, again.params[k]), k
  for k, v in resumed.opt_state.nu.items():
    assert torch.equal(v, again.opt_state.nu[k]), k


def test_restore_latest_none_when_empty(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'empty'))
  assert ckpt.restore_latest(state) is None
  assert ckpt.latest_step() is None
  ckpt.close()


def test_maybe_save_throttles(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'throttle'), save_interval_secs=3600)
  assert not ckpt.maybe_save(state)   # the first call starts the clock
  assert not ckpt.maybe_save(state)
  assert ckpt.latest_step() is None

  fast = Checkpointer(str(tmp_path / 'fast'), save_interval_secs=0)
  assert not fast.maybe_save(state)
  assert fast.maybe_save(state)
  assert fast.latest_step() == 0


def test_max_to_keep_prunes(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'keep'), max_to_keep=2)
  for step in (1, 2, 3):
    ckpt.save(state, step=step, force=True)
  assert ckpt.latest_step() == 3
  assert ckpt.all_steps() == [2, 3]
  assert ckpt.restore_latest(state) is not None


def test_save_same_step_twice_reports_skip(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'dup'))
  assert ckpt.save(state, step=5)
  assert not ckpt.save(state, step=5)
  assert not ckpt.save(state, step=5, force=True)
  assert not ckpt.save(state, step=4)  # not newer than the latest


def test_should_save_and_decision_override(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'decision'), save_interval_secs=10**6)
  assert not ckpt.should_save()
  assert not ckpt.maybe_save(state)
  assert ckpt.maybe_save(state, decision=True)
  state2 = state._replace(update_steps=state.update_steps + 1)
  assert not ckpt.maybe_save(state2, decision=False)
  assert ckpt.latest_step() == 0


def test_structure_mismatch_names_the_flag(tmp_path):
  """A shallow-torso checkpoint restored into a deep-torso state raises
  with the flag guidance and restores nothing."""
  _, _, shallow = _state(0)
  ckpt = Checkpointer(str(tmp_path / 'mismatch'))
  ckpt.save(shallow, step=1, force=True)
  _, _, deep = _state(0, torso='deep')
  before = {k: v.clone() for k, v in deep.params.items()}
  with pytest.raises(ckpt_lib.CheckpointStructureError,
                     match='use_instruction') as exc_info:
    ckpt.restore_latest(deep)
  assert '--torso' in str(exc_info.value)
  assert ckpt.restore_fallbacks == 0
  assert all(torch.equal(v, before[k]) for k, v in deep.params.items())


@pytest.mark.parametrize('saved,target', [('deep_fast', 'deep'),
                                           ('deep', 'deep_fast')])
def test_a_torso_mismatch_of_one_tree_names_the_flag(saved, target,
                                                     tmp_path):
  """deep and deep_fast share a parameter tree, so the payload carries
  the torso: a step saved under one refuses to restore under the other
  (as JAX's differently named trees do), and restores under its own."""
  _, _, state = _state(0, torso=saved)
  Checkpointer(str(tmp_path), torso=saved).save(state, step=1, force=True)
  _, _, other = _state(1, torso=target)
  before = {k: v.clone() for k, v in other.params.items()}
  with pytest.raises(ckpt_lib.CheckpointStructureError,
                     match='--torso') as exc_info:
    Checkpointer(str(tmp_path), torso=target).restore_latest(other)
  assert f"torso {saved!r}" in str(exc_info.value)
  assert all(torch.equal(v, before[k]) for k, v in other.params.items())
  _, _, same = _state(1, torso=saved)
  restored = Checkpointer(str(tmp_path), torso=saved).restore_latest(same)
  assert all(torch.equal(v, state.params[k])
             for k, v in restored.params.items())


def test_wrap_error_sniffs_structure_vs_corruption():
  structural = [
      ValueError('User-provided restore item and on-disk value '
                 'metadata tree structures do not match.'),
      KeyError('params/instruction/embed/kernel'),
      TypeError('Custom PyTree node mismatch'),
      ValueError("Dict key mismatch; expected keys: ['a']; dict: {}"),
  ]
  for e in structural:
    with pytest.raises(ckpt_lib.CheckpointStructureError,
                       match='use_instruction'):
      ckpt_lib._wrap_structure_error(e, '/ckpts', 7)
  corrupt_cases = [
      ValueError('zarr array data truncated at offset 18238'),
      ValueError('checkpoint incomplete: missing commit file for key'),
  ]
  for e in corrupt_cases:
    with pytest.raises(ckpt_lib.CheckpointStructureError) as exc_info:
      ckpt_lib._wrap_structure_error(e, '/ckpts', 7)
    msg = str(exc_info.value)
    assert 'use_instruction' not in msg
    assert 'corrupt' in msg and 'previous retained step' in msg


def _distinct(state, step):
  """`state` with params base + step, so a restored step shows in its
  values."""
  with torch.no_grad():
    for p in state.params.values():
      p.add_(1.0)
  return state._replace(update_steps=step)


def test_restore_latest_falls_back_past_truncated_newest(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'ladder'), save_interval_secs=0)
  state = _distinct(state, 1)
  ckpt.save(state, force=True)
  step1 = _payload(state)
  ckpt.save(_distinct(state, 2), force=True)
  assert ckpt.last_good_step() == 2
  faults.corrupt_checkpoint_step(str(tmp_path / 'ladder'), 2)
  _, _, target = _state(1)
  restored = ckpt.restore_latest(target)
  _assert_state_equal(restored, step1)
  assert ckpt.restore_fallbacks >= 1


def test_restore_latest_falls_back_past_deleted_step_files(tmp_path):
  _, _, state = _state()
  directory = str(tmp_path / 'deleted')
  ckpt = Checkpointer(directory, save_interval_secs=0)
  state = _distinct(state, 1)
  ckpt.save(state, force=True)
  step1 = _payload(state)
  ckpt.save(_distinct(state, 2), force=True)
  shutil.rmtree(os.path.join(directory, '2', 'default'))
  assert ckpt.latest_step() == 2  # the step still lists
  restored = ckpt.restore_latest(state)
  _assert_state_equal(restored, step1)


def test_restore_raises_corruption_guidance_when_all_steps_bad(tmp_path):
  _, _, state = _state()
  directory = str(tmp_path / 'allbad')
  ckpt = Checkpointer(directory, save_interval_secs=0)
  _save_steps(ckpt, state, (1, 2))
  for step in (1, 2):
    faults.corrupt_checkpoint_step(directory, step)
  with pytest.raises(ckpt_lib.CheckpointStructureError) as exc_info:
    ckpt.restore_latest(state)
  msg = str(exc_info.value)
  assert 'use_instruction' not in msg
  assert 'corrupt' in msg


def test_last_good_marker_roundtrip(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'marker'), max_to_keep=2,
                      save_interval_secs=0)
  assert ckpt.last_good_step() is None
  _save_steps(ckpt, state, (1,))
  assert ckpt.last_good_step() == 1
  _save_steps(ckpt, state, (2, 3))   # step 1 pruned
  assert ckpt.last_good_step() == 3
  saved = _payload(state)
  restored = ckpt.restore_last_good(_state(1)[2])
  _assert_state_equal(restored, saved)


def test_restore_last_good_none_when_empty(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'emptygood'))
  assert ckpt.restore_last_good(state) is None


def test_digest_ladder_refuses_bitrot_under_last_good(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'rot'), save_interval_secs=0)
  state = _distinct(state, 1)
  ckpt.save(state, force=True)
  step1 = _payload(state)
  ckpt.save(_distinct(state, 2), force=True)
  assert ckpt.last_good_step() == 2
  assert ckpt.verify_step_digests(2) is True
  faults.bitrot_checkpoint_step(str(tmp_path / 'rot'), 2, seed=3)
  with pytest.raises(ckpt_lib.CheckpointCorruption, match='digest'):
    ckpt.verify_step_digests(2)
  restored = ckpt.restore_latest(state)
  _assert_state_equal(restored, step1)
  assert ckpt.digest_fallbacks == 1
  assert ckpt.restore_fallbacks >= 1
  rolled = ckpt.restore_last_good(state)
  _assert_state_equal(rolled, step1)
  assert ckpt.digest_fallbacks >= 2


def test_digest_mismatch_classified_corruption_not_structural():
  e = ckpt_lib.CheckpointCorruption(
      "checkpoint step 7: content digest verification failed for "
      "'default/state.pt' (crc 0000beef differs from the recorded "
      '0000dead) — bit rot after commit; this step cannot be trusted')
  assert not ckpt_lib._looks_structural(e)


def test_ckpt_bitrot_fault_site_fires_after_commit(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'site'), save_interval_secs=0)
  faults.install(faults.FaultPlan([faults.Fault('ckpt_bitrot', 0, 'flip')],
                                  seed=9))
  assert ckpt.save(state, step=1, force=True)
  assert ckpt.last_good_step() == 1  # the marker believed the save
  with pytest.raises(ckpt_lib.CheckpointCorruption, match='digest'):
    ckpt.verify_step_digests(1)


def test_digests_disabled_skips_verification(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'off'), save_interval_secs=0,
                      verify_digests=False)
  _save_steps(ckpt, state, (1,))
  assert ckpt.verify_step_digests(1) is None
  assert not any(n.startswith('DIGEST_')
                 for n in os.listdir(str(tmp_path / 'off')))


def test_digest_ledgers_pruned_with_steps(tmp_path):
  _, _, state = _state()
  ckpt = Checkpointer(str(tmp_path / 'prune'), max_to_keep=2,
                      save_interval_secs=0)
  _save_steps(ckpt, state, (1, 2, 3))
  names = {n for n in os.listdir(str(tmp_path / 'prune'))
           if n.startswith('DIGEST_')}
  assert names == {'DIGEST_2.json', 'DIGEST_3.json'}


# --- the port's own -----------------------------------------------------------


def test_restore_copies_into_the_live_tensors(tmp_path):
  """The agent trains its own tensors: a restore must copy into them (a
  rebound dict would leave the agent training its old weights)."""
  agent, cfg, state = _state(0)
  ckpt = Checkpointer(str(tmp_path / 'live'))
  ckpt.save(_distinct(state, 3), force=True)
  saved = _payload(state)

  agent2, _, target = _state(1)
  live = dict(agent2.named_parameters())
  restored = ckpt.restore_latest(target)
  assert all(restored.params[k] is p for k, p in live.items())
  assert all(restored.opt_state.nu[k] is v
             for k, v in target.opt_state.nu.items())
  assert restored.opt_state.count is target.opt_state.count
  for k, p in agent2.named_parameters():
    assert torch.equal(p.detach(), saved['params'][k]), k
  # The payload is plain dicts of CPU tensors, loadable without pickled
  # classes.
  payload = torch.load(tmp_path / 'live' / '3' / 'default' / 'state.pt',
                       weights_only=True)
  assert set(payload) == {'params', 'opt_state', 'update_steps'}
  assert payload['opt_state']['trace'] is None


def test_a_damaged_payload_falls_back_and_a_shape_change_raises(tmp_path):
  """Any failure to load a step is damage to that step (the ladder falls
  back, no flag guidance); a payload that loads but differs from the
  target in shape is a config mismatch (the guidance, no fallback)."""
  _, _, state = _state()
  directory = tmp_path / 'routes'
  ckpt = Checkpointer(str(directory), max_to_keep=5, save_interval_secs=0,
                      verify_digests=False)
  state = _distinct(state, 1)
  ckpt.save(state, force=True)
  step1 = _payload(state)
  for step, damage in ((2, b''), (3, b'not a zip archive'),
                       (4, None)):
    ckpt.save(_distinct(state, step), force=True)
    path = directory / str(step) / 'default' / 'state.pt'
    if damage is None:   # a zip whose pickle is garbage
      good = path.read_bytes()
      start = good.index(b'data.pkl') + len(b'data.pkl')
      path.write_bytes(good[:start + 40] + b'\x00' * 64 + good[start + 104:])
    else:
      path.write_bytes(damage)
  restored = ckpt.restore_latest(_state(1)[2])
  _assert_state_equal(restored, step1)
  assert ckpt.restore_fallbacks == 3 and ckpt.digest_fallbacks == 0

  # A clean payload with a changed shape: structural, raised at once.
  payload = torch.load(directory / '1' / 'default' / 'state.pt',
                       weights_only=True)
  name = sorted(payload['params'])[0]
  payload['params'][name] = torch.zeros(3, 3)
  os.makedirs(directory / '9' / 'default')
  torch.save(payload, directory / '9' / 'default' / 'state.pt')
  fresh = Checkpointer(str(directory), max_to_keep=5, verify_digests=False)
  with pytest.raises(ckpt_lib.CheckpointStructureError,
                     match='use_instruction') as exc_info:
    fresh.restore_latest(state)
  assert name in str(exc_info.value)
  assert fresh.restore_fallbacks == 0


def test_checkpoint_save_fault_damages_the_step_and_keeps_last_good(tmp_path):
  _, _, state = _state()
  directory = str(tmp_path / 'interrupt')
  ckpt = Checkpointer(directory, save_interval_secs=0)
  faults.install(faults.FaultPlan.storm(seed=0, checkpoint_interrupt_at=1))
  state = _distinct(state, 1)
  assert ckpt.save(state, force=True)
  step1 = _payload(state)
  assert ckpt.save(_distinct(state, 2), force=True)
  assert ckpt.save_errors == 1
  assert isinstance(ckpt.last_save_error, faults.InjectedFault)
  assert ckpt.last_good_step() == 1 and ckpt.latest_step() == 2
  _assert_state_equal(ckpt.restore_latest(state), step1)
  assert ckpt.rollback_step_choice() == 1


# --- the ladder against JAX's, damage by damage -----------------------------

_DAMAGE = {
    # kind: (steps saved, checkpoint_save interrupt index, damage, restore,
    #        digests)
    'none': ((1, 2, 3), None, [], 'latest', True),
    'truncated_newest': ((1, 2, 3), None, [('truncate', 3)], 'latest', True),
    'default_deleted': ((1, 2, 3), None, [('delete', 3)], 'latest', True),
    'bitrot_newest': ((1, 2, 3), None, [('bitrot', 3)], 'latest', True),
    # Step 3's save is interrupted (LAST_GOOD stays 2), then step 2 rots:
    # the rollback tries 2, then 3, and lands on 1.
    'bitrot_last_good': ((1, 2, 3), 2, [('bitrot', 2)], 'last_good', True),
    'all_bad': ((1, 2), None, [('truncate', 1), ('truncate', 2)], 'latest',
                True),
    'digests_off': ((1, 2, 3), None, [('truncate', 3)], 'latest', False),
}


def _damage(fault_helpers, directory, actions):
  for kind, step in actions:
    if kind == 'truncate':
      fault_helpers.corrupt_checkpoint_step(directory, step)
    elif kind == 'bitrot':
      fault_helpers.bitrot_checkpoint_step(directory, step, seed=5)
    else:
      shutil.rmtree(os.path.join(directory, str(step), 'default'))


def _ladder_outcome(ckpt, restore, target):
  try:
    if restore == 'latest':
      restored = ckpt.restore_latest(target)
    else:
      restored = ckpt.restore_last_good(target)
    error = None
  except Exception as e:  # noqa: BLE001 -- compared across packages
    restored, error = None, type(e).__name__
  return restored, error, ckpt.restore_fallbacks, ckpt.digest_fallbacks


@pytest.mark.parametrize('kind', sorted(_DAMAGE))
def test_restore_ladder_matches_jax(kind, tmp_path):
  import jax
  import jax.numpy as jnp
  from scalable_agent_tpu import learner as jax_learner
  from scalable_agent_tpu.checkpoint import Checkpointer as JaxCheckpointer
  from scalable_agent_tpu.config import Config as JaxConfig
  from scalable_agent_tpu.models import agent as jax_agent
  from scalable_agent_tpu.models import init_params as jax_init_params
  from scalable_agent_tpu.runtime import faults as jax_faults

  steps, interrupt_at, actions, restore, digests = _DAMAGE[kind]
  jcfg = JaxConfig(**_KW)
  jagent = jax_agent.ImpalaAgent(num_actions=A, torso='shallow',
                                 use_instruction=False)
  params = jax_init_params(jagent, jax.random.PRNGKey(0),
                           {'frame': (H, W, 3), 'instr_len': 16})
  base = jax_learner.make_train_state(params, jcfg)
  agent, cfg, state = _state(0)
  converted = convert.params_from_jax(jax.device_get(params))
  outcomes = {}
  for package in ('jax', 'torch'):
    directory = str(tmp_path / package)
    helpers = jax_faults if package == 'jax' else faults
    make = JaxCheckpointer if package == 'jax' else Checkpointer
    ckpt = make(directory, save_interval_secs=0, verify_digests=digests)
    helpers.install(None if interrupt_at is None else
                    helpers.FaultPlan.storm(
                        seed=0, checkpoint_interrupt_at=interrupt_at))
    try:
      for step in steps:
        if package == 'jax':
          jstate = base._replace(
              params=jax.tree_util.tree_map(lambda p, s=step: p + s,
                                            base.params),
              update_steps=jnp.asarray(step, base.update_steps.dtype))
          assert ckpt.save(jstate, step=step, force=True)
          ckpt.wait_until_finished()
        else:
          with torch.no_grad():
            for k, p in state.params.items():
              p.copy_(converted[k] + step)
          assert ckpt.save(state._replace(update_steps=step), step=step,
                           force=True)
    finally:
      helpers.clear()
    _damage(helpers, directory, actions)
    if package == 'jax':
      target = base._replace(params=jax.tree_util.tree_map(
          jnp.zeros_like, base.params))
    else:
      target = _state(1)[2]
    restored, error, fallbacks, digest_fallbacks = _ladder_outcome(
        ckpt, restore, target)
    ckpt.close()
    if restored is None:
      params_out, step_out = None, None
    elif package == 'jax':
      params_out = convert.params_from_jax(jax.device_get(restored.params))
      step_out = int(restored.update_steps)
    else:
      params_out = {k: v.detach().clone() for k, v in restored.params.items()}
      step_out = restored.update_steps
    outcomes[package] = (step_out, error, fallbacks, digest_fallbacks,
                         params_out)
  jax_out, torch_out = outcomes['jax'], outcomes['torch']
  assert torch_out[:4] == jax_out[:4], (jax_out[:4], torch_out[:4])
  if jax_out[4] is not None:
    for k, v in torch_out[4].items():  # the port's params (no bias_ih)
      assert torch.equal(v, jax_out[4][k]), k


# --- a 2-rank group -----------------------------------------------------------

SPAWN_TIMEOUT_SECS = 120


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _group_rank(rank, world, port, directory):
  """One rank: a group of `world` over gloo; rank 0 alone writes, both
  take rank 0's save decision and restore the step rank 0 chose."""
  torch.set_num_threads(1)
  config = Config(**_KW, coordinator_address=f'localhost:{port}',
                  num_processes=world, process_id=rank)
  device = distributed.maybe_initialize(config, backend='gloo', device='cpu',
                                        timeout_secs=60)
  mesh = mesh_lib.make_mesh(device)
  agent, cfg, state = _state(0)
  # Rank 1's clock would never save: the decision must be rank 0's.
  ckpt = Checkpointer(directory, save_interval_secs=0 if rank == 0 else 10**6,
                      mesh=mesh)
  writes = []
  local_save = ckpt._save_local
  ckpt._save_local = lambda *a: writes.append(a[1]) or local_save(*a)
  decisions = [ckpt.group_should_save(), ckpt.group_should_save()]
  saved = [ckpt.maybe_save(_distinct(state, 1), decision=decisions[1]),
           ckpt.save(_distinct(state, 2), force=True)]
  step2 = _payload(state)
  rolled = ckpt.restore_last_good(_state(2)[2])
  mesh.all_reduce_sum_(torch.zeros(1))  # both ranks have read step 2
  if rank == 0:
    faults.corrupt_checkpoint_step(directory, 2)
  mesh.all_reduce_sum_(torch.zeros(1))  # the damage lands before the restore
  restored = ckpt.restore_latest(_state(1)[2])
  result = dict(rank=rank, decisions=decisions, saved=saved, writes=writes,
                restored=restored.update_steps, rolled=rolled.update_steps,
                fallbacks=ckpt.restore_fallbacks,
                restored_params={k: v.clone()
                                 for k, v in restored.params.items()},
                rolled_params={k: v.clone()
                               for k, v in rolled.params.items()},
                step2_params=step2['params'])
  torch.save(result, os.path.join(directory, f'rank{rank}.result'))
  distributed.shutdown()


def test_two_ranks_rank0_writes_and_both_restore_its_step(tmp_path):
  directory = str(tmp_path / 'group')
  os.makedirs(directory)
  context = mp.spawn(_group_rank, args=(2, _free_port(), directory),
                     nprocs=2, join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail('the ranks are still running')
  ranks = [torch.load(os.path.join(directory, f'rank{r}.result'),
                      weights_only=False) for r in range(2)]
  assert ranks[0]['decisions'] == ranks[1]['decisions'] == [False, True]
  assert ranks[0]['saved'] == ranks[1]['saved'] == [True, True]
  assert ranks[0]['writes'] == [1, 2] and ranks[1]['writes'] == []
  # The rollback restored LAST_GOOD (step 2) on both ranks. Then step 2
  # was damaged: rank 0's ladder fell back to step 1, and rank 1 restored
  # the step rank 0 chose.
  for r in ranks:
    assert r['rolled'] == 2 and r['restored'] == 1
    for k, v in r['rolled_params'].items():
      assert torch.equal(v, r['step2_params'][k]), k
  assert ranks[0]['fallbacks'] == 1 and ranks[1]['fallbacks'] == 0
  for k, v in ranks[0]['restored_params'].items():
    assert torch.equal(v, ranks[1]['restored_params'][k]), k
  assert sorted(n for n in os.listdir(directory) if n.isdigit()) == ['1', '2']
  with open(os.path.join(directory, 'LAST_GOOD')) as f:
    assert json.load(f)['step'] == 2
