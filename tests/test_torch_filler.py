"""The hybrid filler in the port (parallel/anakin.HybridFiller and the
fleet loop's ready-probe slice in driver.train), after the JAX package's
tests/test_filler.py: the prefetcher's ready() probe consumes nothing; a
filler update moves the params but none of the fleet's clocks
(update_steps, the RMSProp count the LR reads); a filler core that cannot
take the task's head width fails the run at spin-up; a model-axis mesh
parks; and through driver.train the fresh-frame clock, the learner steps
and the LR are those of the same run without the filler, with the
filler's work summarised apart."""

import json
import os
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.parallel.mesh import Mesh
from scalable_agent_tpu_torch.runtime import ring_buffer

torch.set_num_threads(1)


def _filler_config(tmp_path, **kw):
  base = dict(logdir=str(tmp_path), env_backend='bandit', num_actors=2,
              batch_size=2, unroll_length=5, num_action_repeats=1,
              episode_length=4, height=24, width=32, torso='shallow',
              use_py_process=False, use_instruction=False,
              anakin_filler=True, filler_batch_size=2,
              filler_unroll_length=5, total_environment_frames=10**9,
              checkpoint_secs=10**6, summary_secs=0, seed=11)
  base.update(kw)
  return Config(**base)


def test_prefetcher_ready_probe():
  """ready() is a probe: False while nothing is staged, True once a batch
  is (twice, consuming nothing), True after close (get() then raises)."""
  buffer = ring_buffer.TrajectoryBuffer(4)
  prefetcher = ring_buffer.BatchPrefetcher(buffer, 2,
                                           stack_fn=lambda items: items)
  try:
    assert not prefetcher.ready()
    buffer.put('a')
    buffer.put('b')
    deadline = time.monotonic() + 5
    while not prefetcher.ready() and time.monotonic() < deadline:
      time.sleep(0.01)
    assert prefetcher.ready() and prefetcher.ready()
    stats = prefetcher.stats()
    assert (stats['gets'], stats['blocked_gets']) == (0, 0)
    assert prefetcher.get(timeout=1) == ['a', 'b']
  finally:
    prefetcher.close()
  assert prefetcher.ready()
  with pytest.raises((ring_buffer.Closed, TimeoutError)):
    prefetcher.get(timeout=0.1)


def _fleet_state(cfg, num_actions):
  agent = driver.build_agent(cfg, num_actions)
  init_params(agent, torch.Generator().manual_seed(0))
  return agent, learner.make_train_state(agent, cfg)


def test_hybrid_filler_freezes_the_fleet_clocks():
  """Three fill steps on a dmlab-width fleet's state: the params move,
  update_steps and the RMSProp count stay 0 (the LR reads the fleet's
  count), and the filler's own ledger counts them."""
  cfg = _filler_config('/unused', env_backend='dmlab', surrogate='impact')
  agent, state = _fleet_state(cfg, 9)
  filler = anakin.HybridFiller(agent, cfg, num_actions=9, device='cpu')
  assert filler.backend == 'bandit'  # dmlab falls back to bandit
  before = learner.state_to_payload(state)
  for _ in range(3):
    state = filler.fill_one(state)
    assert state.update_steps == 0 and int(state.opt_state.count) == 0
  assert any(not torch.equal(p.detach(), before['params'][k])
             for k, p in state.params.items())
  # IMPACT's target refreshed with the kept params (interval 1).
  for k, p in state.params.items():
    assert torch.equal(state.target_params[k], p.detach()), k
  assert filler.updates == 3 and filler.skipped == 0
  assert filler.frames == 3 * filler.frames_per_update == 3 * 2 * 5
  assert filler.stats()['batch_size'] == 2


def test_filler_width_mismatch_fails_at_spinup(tmp_path):
  """A filler core that cannot take the task's head width fails the run
  at spin-up: the gridworld needs >= 4 actions, the bandit task has 3."""
  cfg = _filler_config(tmp_path, filler_backend='gridworld')
  with pytest.raises(ValueError, match='num_actions'):
    driver.train(cfg, max_steps=1, device='cpu', stall_timeout_secs=30)


def test_model_axis_mesh_parks_the_filler():
  cfg = _filler_config('/unused')
  agent, _ = _fleet_state(cfg, 3)
  mesh = Mesh(rank=0, size=1, device=torch.device('cpu'), model_size=2)
  ok, reason = anakin.supports_filler(cfg, mesh)
  assert not ok and 'data-parallel' in reason
  with pytest.raises(ValueError, match='data-parallel'):
    anakin.HybridFiller(agent, cfg, num_actions=3, device='cpu', mesh=mesh)
  assert anakin.supports_filler(cfg, None) == (True, '')
  odd = Mesh(rank=0, size=3, device=torch.device('cpu'))
  assert not anakin.supports_filler(cfg, odd)[0]


def _summaries(logdir):
  out = {}
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    for line in f:
      e = json.loads(line)
      if 'value' in e:
        out.setdefault(e['tag'], []).append((e['step'], e['value']))
  return out


@pytest.mark.parametrize('filler_backend', ['bandit', 'procgen'])
def test_filler_keeps_the_fleet_clocks_through_train(tmp_path,
                                                     filler_backend):
  """driver.train with and without the filler, 3 learner steps each:
  the same fresh frames, update_steps, RMSProp count and LR per step;
  with it, the filler's updates (at least the one while the first batch
  is being staged) summarised apart as updates x B x T frames."""
  num_actions = 4 if filler_backend == 'procgen' else 3
  runs = {}
  for on in (True, False):
    cfg = _filler_config(tmp_path / str(on), anakin_filler=on,
                         filler_backend=filler_backend,
                         num_actions=num_actions, surrogate='impact')
    runs[on] = (driver.train(cfg, max_steps=3, device='cpu',
                             stall_timeout_secs=60), cfg)
  (run_on, cfg), (run_off, _) = runs[True], runs[False]
  for run in (run_on, run_off):
    assert run.frames == 3 * 2 * 5
    assert run.state.update_steps == 3
    assert int(run.state.opt_state.count) == 3
  on, off = _summaries(cfg.logdir), _summaries(str(tmp_path / 'False'))
  assert on['learning_rate'] == off['learning_rate']
  updates = on['filler_updates'][-1][1]
  assert updates >= 1
  assert on['filler_frames'][-1][1] == updates * 2 * 5
  assert on['filler_skipped_updates'][-1][1] == 0
  assert run_on.stats['filler']['updates'] == updates
  assert 'filler_updates' not in off
