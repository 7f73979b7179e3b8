"""Population-based training in the port (driver.train_population and
the lockstep step, parallel/anakin.make_vectorized_anakin_step): member
k of a lockstep step is a fused step of member k alone (loss rtol 2e-4,
params rtol 5e-4 / atol 5e-6, the learner's bar), with one V-trace call
over the members' [T, P*B] columns per step; the hypers are tensors, so
an explore rebuilds nothing; a member whose update is not finite skips it
alone. Then the driver: a serial two-suite population's record, the
in-process inheritance seam (train_anakin(initial_state=...): the donor's
params bit-equal in tensors of the loser's own), member directories that
the serial and the lockstep paths resume from each other, and the
cross-process inheritance that keeps the loser's ladder when a copy
fails. Last, the procgen curriculum over a 2-rank gloo group: one score
table on both ranks."""

import json
import os
import shutil
import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.checkpoint import Checkpointer
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models.agent import make_step_fn
from scalable_agent_tpu_torch.ops import vtrace_cuda
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel import distributed

torch.set_num_threads(1)

HYPERS = {'learning_rate': [2e-3, 2.4e-3, 1.6e-3],
          'entropy_cost': [3e-3, 2.5e-3, 3.6e-3]}


def _kw(**kw):
  base = dict(env_backend='procgen', curriculum='regret', batch_size=4,
              unroll_length=5, num_action_repeats=1, episode_length=6,
              height=24, width=32, torso='shallow', use_instruction=False,
              use_pallas_vtrace=True, learning_rate=2e-3, entropy_cost=3e-3,
              total_environment_frames=10**6, summary_secs=0,
              checkpoint_secs=10**6, seed=0)
  base.update(kw)
  return base


def _hypers(n=3):
  return {k: torch.tensor(v[:n], dtype=torch.float32)
          for k, v in HYPERS.items()}


def _serial_config(config, k):
  """Member k's config as the serial population builds it: HYPERS[k] in
  place of the configured hypers."""
  return driver._member_config(config, {
      'member': k, 'suite': config.env_backend,
      'hypers': {name: v[k] for name, v in HYPERS.items()}})


def _members(config, seeds=(11, 12, 13)):
  core = anakin.make_env_core(config)
  return core, anakin.init_members(config, core, list(seeds), 'cpu')


def _assert_member_equal(got_state, got_metrics, k, want_state,
                         want_metrics):
  for key in ('total_loss', 'grad_norm', 'learning_rate', 'mean_reward',
              'curriculum_entropy'):
    np.testing.assert_allclose(float(got_metrics[key][k]),
                               float(want_metrics[key]), rtol=2e-4,
                               err_msg=key)
  for name, p in got_state.params.items():
    np.testing.assert_allclose(p.detach().numpy(),
                               want_state.params[name].detach().numpy(),
                               rtol=5e-4, atol=5e-6, err_msg=name)
  assert got_state.update_steps == want_state.update_steps


def test_lockstep_member_is_its_serial_step(monkeypatch):
  """Two lockstep steps of 3 members against each member's own fused
  steps, the train step a serial population member runs (same seeds,
  its hypers in its member config); V-trace runs once per lockstep step,
  over [T, 3*B]."""
  config = Config(**_kw())
  core, (agents, carries) = _members(config)
  calls = []
  plain = vtrace_cuda.from_importance_weights

  def spy(log_rhos, *args, **kw):
    calls.append(tuple(log_rhos.shape))
    return plain(log_rhos, *args, **kw)

  monkeypatch.setattr(vtrace_cuda, 'from_importance_weights', spy)
  vstep = anakin.make_vectorized_anakin_step(agents, core, config)
  hypers = _hypers()
  for _ in range(2):
    carries, metrics = vstep(carries, hypers)
  assert calls == [(5, 12)] * 2
  assert all(v.shape == (3,) for v in metrics.values())

  for k, seed in enumerate((11, 12, 13)):
    _, (serial_agents, serial) = _members(config, seeds=(seed,))
    step = anakin.make_anakin_step(serial_agents[0], core,
                                   _serial_config(config, k))
    carry = serial[0]
    for _ in range(2):
      carry, m = step(carry)
    _assert_member_equal(carries[k].train_state, metrics, k,
                         carry.train_state, m)
    np.testing.assert_array_equal(
        carries[k].env_state.level_scores.numpy(),
        carry.env_state.level_scores.numpy())


def test_explore_changes_tensors_and_rebuilds_nothing():
  config = Config(**_kw(curriculum='uniform', env_backend='gridworld'))
  core, (agents, carries) = _members(config, seeds=(1, 2))
  vstep = anakin.make_vectorized_anakin_step(agents, core, config)
  hypers = _hypers(2)
  carries, m1 = vstep(carries, hypers)
  hypers['learning_rate'].mul_(torch.tensor([1.2, 1 / 1.2]))
  carries, m2 = vstep(carries, hypers)
  schedule = learner.make_schedule(Config(**_kw(learning_rate=1.0)))
  np.testing.assert_allclose(m2['learning_rate'].numpy(),
                             hypers['learning_rate'].numpy() *
                             float(schedule(1)), rtol=1e-6)
  assert m1['learning_rate'][0] != m2['learning_rate'][0]


def test_non_finite_member_skips_alone():
  """NaN rewards in member 1's batch: member 1 keeps its params and
  optimizer count; members 0 and 2 take their updates, equal to their
  steps alone."""
  config = Config(**_kw(curriculum='uniform'))
  core, (agents, carries) = _members(config)
  batches = [anakin._act(make_step_fn(a), core, c, config.unroll_length,
                         False)[0] for a, c in zip(agents, carries)]
  poisoned = batches[1]._replace(env_outputs=batches[1].env_outputs._replace(
      reward=torch.full_like(batches[1].env_outputs.reward, float('nan'))))
  before = [learner.state_to_payload(c.train_state) for c in carries]
  train = learner.make_vectorized_train_step_fn(agents, config)
  states, m = train([c.train_state for c in carries],
                    [batches[0], poisoned, batches[2]], _hypers())
  assert [float(x['step_ok']) for x in m] == [1.0, 0.0, 1.0]
  for name, p in states[1].params.items():
    assert torch.equal(p.detach(), before[1]['params'][name]), name
  assert int(states[1].opt_state.count) == 0
  for k in (0, 2):
    _, (alone_agents, alone) = _members(config, seeds=((11, 12, 13)[k],))
    state, want = learner.make_train_step_fn(
        alone_agents[0], _serial_config(config, k))(
            alone[0].train_state, batches[k])
    np.testing.assert_allclose(float(m[k]['total_loss']),
                               float(want['total_loss']), rtol=2e-4)
    for name, p in states[k].params.items():
      np.testing.assert_allclose(p.detach().numpy(),
                                 state.params[name].detach().numpy(),
                                 rtol=5e-4, atol=5e-6, err_msg=name)


def _jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_serial_two_suite_population_writes_its_record(tmp_path):
  config = Config(**_kw(curriculum='uniform', runtime='anakin',
                        pbt_population=2, pbt_suites='procgen,gridworld',
                        total_environment_frames=80, logdir=str(tmp_path)))
  run = driver.train(config, device='cpu')
  with open(tmp_path / 'PBT_LOG.json') as f:
    log = json.load(f)
  assert log['vectorized'] is False and log['num_rounds'] == 4
  assert [r['suites'] for r in log['rounds']] == [['procgen',
                                                   'gridworld']] * 4
  assert run.config.logdir.endswith(f'member_{log["winner"]["member"]:02d}')
  rows = _jsonl(tmp_path / 'population_summaries.jsonl')
  assert [(r['round'], r['member']) for r in rows] == [
      (r, k) for r in range(4) for k in range(2)]
  assert all('hyper_learning_rate' in r for r in rows)
  kinds = [e['kind'] for e in _jsonl(tmp_path / 'incidents.jsonl')]
  assert kinds == ['pbt_winner']  # one member per suite: no exploit
  for k in range(2):
    steps = Checkpointer(str(tmp_path / f'member_{k:02d}' /
                             'checkpoints')).all_steps()
    assert steps[-1] == 4  # 80 frames at 20 per step, round by round


def test_in_process_inheritance_copies_the_donor(tmp_path):
  """train_anakin(initial_state=donor): the run starts from the donor's
  params and optimizer state, bit-equal, in tensors of its own; the
  donor's tensors do not move."""
  donor = driver.train_anakin(
      Config(**_kw(logdir=str(tmp_path / 'donor'))), max_steps=2,
      device='cpu')
  held = learner.state_to_payload(donor.state)
  loser = driver.train_anakin(
      Config(**_kw(logdir=str(tmp_path / 'loser'), seed=5)), max_steps=0,
      device='cpu', initial_state=donor.state)
  assert loser.state.update_steps == donor.state.update_steps == 2
  for name, p in loser.state.params.items():
    assert torch.equal(p.detach(), held['params'][name]), name
    assert p.data_ptr() != donor.state.params[name].data_ptr()
    assert torch.equal(loser.state.opt_state.nu[name],
                       held['opt_state']['nu'][name])
  # The loser's ladder records the inherited state.
  assert Checkpointer(str(tmp_path / 'loser' / 'checkpoints')
                      ).all_steps() == [2]
  driver.train_anakin(Config(**_kw(logdir=str(tmp_path / 'loser'),
                                   seed=5)), max_steps=1, device='cpu',
                      initial_state=None)
  for name, p in donor.state.params.items():
    assert torch.equal(p.detach(), held['params'][name]), name


def test_serial_exploit_goes_through_initial_state(tmp_path):
  """Two gridworld members over 3 rounds: the loser of a round runs the
  next from the donor's state (a pbt_exploit incident, the donor's
  hypers explored)."""
  config = Config(**_kw(curriculum='uniform', env_backend='gridworld',
                        runtime='anakin', pbt_population=2,
                        total_environment_frames=120, pbt_round_frames=40,
                        logdir=str(tmp_path), seed=3))
  seen = []
  original = driver.train_anakin

  def spy(member_config, **kw):
    seen.append((member_config.logdir[-2:], kw['initial_state']))
    return original(member_config, **kw)

  driver.train_anakin = spy
  try:
    driver.train(config, device='cpu')
  finally:
    driver.train_anakin = original
  exploits = [e for e in _jsonl(tmp_path / 'incidents.jsonl')
              if e['kind'] == 'pbt_exploit']
  assert exploits, 'no exploit in this seeded run'
  inherited = [(m, s) for m, s in seen if s is not None]
  assert len(inherited) == len(exploits)
  assert {f'{e["member"]:02d}' for e in exploits} == {m for m, _ in
                                                       inherited}


def test_member_directories_resume_across_the_two_paths(tmp_path):
  """A lockstep population's member directories resume in the serial
  loop, and the serial loop's in the lockstep one: each member restores
  its own ladder's step and counts on from it."""
  kw = _kw(curriculum='uniform', runtime='anakin', pbt_population=2,
           logdir=str(tmp_path), pbt_round_frames=40)
  del kw['total_environment_frames']
  fused = driver.train(Config(**kw, pbt_vectorized=True,
                              total_environment_frames=40), device='cpu')
  assert fused.state.update_steps == 2
  assert json.load(open(tmp_path / 'PBT_LOG.json'))['vectorized'] is True
  saved = [Checkpointer(str(tmp_path / f'member_{k:02d}' / 'checkpoints'))
           .all_steps() for k in range(2)]
  assert saved == [[2], [2]]
  serial = driver.train(Config(**kw, total_environment_frames=80),
                        device='cpu')
  assert serial.state.update_steps == 4
  back = driver.train(Config(**kw, pbt_vectorized=True,
                             total_environment_frames=120), device='cpu')
  assert back.state.update_steps == 6
  assert all(c.train_state.update_steps == 6 for c in back.members)


def test_cli_runs_the_lockstep_population(tmp_path):
  carry = experiment.main([
      '--mode=train', '--runtime=anakin', '--device=cpu',
      '--env_backend=procgen', '--curriculum=regret', '--pbt_population=3',
      '--pbt_vectorized=true', '--torso=shallow', '--height=24',
      '--width=32', '--batch_size=2', '--unroll_length=4',
      '--num_action_repeats=1', '--use_instruction=false',
      '--use_pallas_vtrace', '--total_environment_frames=16',
      '--summary_secs=0', f'--logdir={tmp_path}'])
  assert carry.train_state.update_steps == 2
  log = json.load(open(tmp_path / 'PBT_LOG.json'))
  assert log['vectorized'] and log['population'] == 3
  assert os.path.exists(tmp_path / 'member_02' / 'summaries.jsonl')


def test_inherit_member_dir_keeps_the_losers_ladder(tmp_path, monkeypatch):
  donor, loser = tmp_path / 'donor', tmp_path / 'loser'
  for d, text in ((donor, 'donor'), (loser, 'loser')):
    os.makedirs(d / 'step_1')
    (d / 'step_1' / 'state.pt').write_text(text)
  original = shutil.copytree

  def failing(src, dst, *args, **kw):
    monkeypatch.setattr(shutil, 'copytree', original)
    original(src, dst, *args, **kw)  # the copy lands, then the disk fills
    monkeypatch.setattr(shutil, 'copytree', failing)
    raise OSError('disk full')

  monkeypatch.setattr(shutil, 'copytree', failing)
  with pytest.raises(OSError, match='disk full'):
    driver._inherit_member_dir(str(donor), str(loser))
  assert (loser / 'step_1' / 'state.pt').read_text() == 'loser'
  assert sorted(os.listdir(tmp_path)) == ['donor', 'loser']
  monkeypatch.setattr(shutil, 'copytree', original)
  driver._inherit_member_dir(str(donor), str(loser))
  assert (loser / 'step_1' / 'state.pt').read_text() == 'donor'
  assert sorted(os.listdir(tmp_path)) == ['donor', 'loser']


# --- the curriculum over a process group ---------------------------------

CURRICULUM_STEPS = 3


def _curriculum_rank(rank, world, port, outdir):
  """One rank of a 2-rank gloo group: the procgen curriculum's fused
  steps on its columns. (A spawned rank re-imports this module, which
  imports no JAX.)"""
  torch.set_num_threads(1)
  config = Config(**_kw(coordinator_address=f'localhost:{port}',
                        num_processes=world, process_id=rank))
  device = distributed.maybe_initialize(config, backend='gloo',
                                        device='cpu', timeout_secs=60)
  mesh = driver.choose_mesh(config, device)
  carry, history, _ = anakin.run(config, CURRICULUM_STEPS, device='cpu',
                                 mesh=mesh)
  env = carry.env_state
  torch.save({'scores': env.level_scores, 'visits': env.level_visits,
              'history': history},
             os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def test_curriculum_over_two_ranks_keeps_one_table(tmp_path):
  """Under a group each rank's segment sums and counts are summed before
  the EMA: the ranks' tables are bit-equal, their visits are the 1-rank
  run's, their scores and curriculum metrics within rtol 1e-5 of it."""
  carry, history, _ = anakin.run(Config(**_kw()), CURRICULUM_STEPS,
                                 device='cpu')
  context = mp.spawn(_curriculum_rank,
                     args=(2, _free_port(), str(tmp_path)), nprocs=2,
                     join=False)
  deadline = time.monotonic() + 150
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail('curriculum ranks still running after 150 s')
  ranks = [torch.load(tmp_path / f'rank{r}.pt', weights_only=False)
           for r in range(2)]
  assert torch.equal(ranks[0]['scores'], ranks[1]['scores'])
  assert torch.equal(ranks[0]['visits'], ranks[1]['visits'])
  np.testing.assert_array_equal(ranks[0]['visits'].numpy(),
                                carry.env_state.level_visits.numpy())
  np.testing.assert_allclose(ranks[0]['scores'].numpy(),
                             carry.env_state.level_scores.numpy(),
                             rtol=1e-5)
  for got, want in zip(ranks[0]['history'], history):
    for key in ('curriculum_entropy', 'curriculum_score_max',
                'curriculum_levels_visited', 'mean_reward'):
      np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                 err_msg=key)


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def test_cli_refuses_a_population_under_a_group(tmp_path):
  with pytest.raises(ValueError, match='one process'):
    experiment.main(['--mode=train', '--runtime=anakin', '--device=cpu',
                     '--env_backend=gridworld', '--pbt_population=2',
                     '--coordinator_address=localhost:1', '--num_processes=2',
                     '--process_id=0', f'--logdir={tmp_path}'])
