"""Preemption drain and resume in the port (scalable_agent_tpu_torch/
driver.py `train` and `train_anakin`, parallel/anakin.py `train`, the CLI),
held to the JAX package's contract (tests/test_overload.py:392-460):

- a run drained mid-way (the deterministic `preempt_signal` fault) and
  resumed has the same learner step sequence as an uninterrupted run, with
  no step lost or counted twice; its manifest is written, verified and
  consumed; a set drain event ends the run through the drain, not an
  exception — for the fleet and for the Anakin runtime;
- a state restored by `anakin.train` takes a next train step on a fixed
  batch bit-equal to that of the never-saved state (the carry's env and
  LSTM state start fresh on resume, as in JAX, so whole runs are not
  compared bit for bit);
- the same FaultPlan fires the same sequence at the port's four sites in
  both packages, and a plan for a site the port does not fire raises;
- SIGTERM on the CLI drains and exits 0, and the rerun resumes;
- the CLI runs float32 with TF32 off.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.checkpoint import Checkpointer
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import anakin
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.structs import (ActorOutput, AgentOutput,
                                              StepOutput, StepOutputInfo)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL_STEPS = 6


@pytest.fixture(autouse=True)
def _no_leftover_plan():
  yield
  faults.clear()


def _config(tmp_path, **kw):
  """tests/test_overload.py's drain config."""
  base = dict(
      logdir=str(tmp_path), env_backend='bandit', num_actors=2,
      batch_size=2, unroll_length=5, num_action_repeats=1,
      episode_length=4, height=24, width=32, torso='shallow',
      use_py_process=False, use_instruction=False,
      total_environment_frames=10 ** 6, inference_timeout_ms=5,
      checkpoint_secs=0, summary_secs=0, seed=3)
  base.update(kw)
  return Config(**base)


def _jsonl(path):
  if not os.path.exists(path):
    return []
  with open(path) as f:
    return [json.loads(line) for line in f if line.strip()]


def _frame_steps(logdir):
  return [e['step'] for e in _jsonl(os.path.join(str(logdir),
                                                 'summaries.jsonl'))
          if e.get('tag') == 'env_frames_per_sec']


@pytest.mark.parametrize('runtime', ['fleet', 'anakin', 'fleet_filler'])
def test_drain_resume_parity_vs_uninterrupted(runtime, tmp_path):
  filler = runtime == 'fleet_filler'
  runtime = 'fleet' if filler else runtime
  kw = dict(runtime=runtime, batch_size=2 if runtime == 'fleet' else 4)
  if filler:
    kw.update(anakin_filler=True, surrogate='impact')
  budget = TOTAL_STEPS * Config(**kw).batch_size * 5
  plain = _config(tmp_path / 'plain', total_environment_frames=budget, **kw)
  run_a = driver.train(plain, device='cpu', stall_timeout_secs=60)
  assert run_a.state.update_steps == TOTAL_STEPS

  drained = _config(tmp_path / 'drained', total_environment_frames=budget,
                    **kw)
  faults.install(faults.FaultPlan([faults.Fault('preempt_signal', 3,
                                                'drain')]))
  run_b1 = driver.train(drained, device='cpu', stall_timeout_secs=60)
  faults.clear()
  steps_b1 = run_b1.state.update_steps
  incidents = _jsonl(tmp_path / 'drained' / 'incidents.jsonl')
  kinds = [e['kind'] for e in incidents]
  ckpt = Checkpointer(str(tmp_path / 'drained' / 'checkpoints'))
  assert ckpt.last_good_step() == steps_b1
  if runtime == 'fleet':
    # Drained at or after the fault's event 3: a loop iteration, which
    # with the filler may be a filler step, not a learner step.
    assert (1 if filler else 3) <= steps_b1 <= TOTAL_STEPS
    manifest = driver.read_resume_manifest(drained.logdir)
    assert manifest['update_steps'] == steps_b1
    assert manifest['frames'] == steps_b1 * drained.frames_per_step
    assert manifest['checkpoint_verified'] is True
    assert manifest['checkpoint_step'] == steps_b1
    assert manifest['drain_latency_secs'] >= 0
    assert manifest['drain_source'] == 'fault'
    assert manifest['health']['consecutive_bad'] == 0
    assert {'metrics', 'slo', 'controller', 'filler'} <= set(manifest)
    if filler:
      # The filler's ledger at the drain: its own updates and frames.
      assert manifest['filler']['updates'] >= 1
      assert manifest['filler']['frames'] == (
          manifest['filler']['updates'] * manifest['filler']['batch_size'] *
          manifest['filler']['unroll_length'])
      assert manifest['filler']['backend'] == 'bandit'
    else:
      assert manifest['filler'] is None
    assert 'preempt_drain_start' in kinds
    complete = [e for e in incidents
                if e['kind'] == 'preempt_drain_complete']
    assert complete and complete[0]['drain_latency_secs'] >= 0
  else:
    assert steps_b1 == 3  # the fused loop stops at the step boundary
    assert 'anakin_stop_requested' in kinds

  run_b2 = driver.train(drained, device='cpu', stall_timeout_secs=60)
  assert run_b2.state.update_steps == TOTAL_STEPS
  assert run_b2.frames == TOTAL_STEPS * drained.frames_per_step
  assert driver.read_resume_manifest(drained.logdir) is None
  if runtime == 'fleet':
    assert os.path.exists(os.path.join(drained.logdir,
                                       'resume_manifest.json.consumed'))
  # The concatenated (drain + resume) step sequence is the uninterrupted
  # one.
  assert _frame_steps(plain.logdir) == list(range(1, TOTAL_STEPS + 1))
  assert _frame_steps(drained.logdir) == _frame_steps(plain.logdir)


@pytest.mark.parametrize('runtime', ['fleet', 'anakin'])
def test_drain_event_triggers_graceful_drain(runtime, tmp_path):
  cfg = _config(tmp_path, runtime=runtime,
                batch_size=2 if runtime == 'fleet' else 4)
  event = threading.Event()
  event.set()  # preempted before the first step: still clean
  run = driver.train(cfg, device='cpu', stall_timeout_secs=60,
                     drain_event=event)
  assert Checkpointer(str(tmp_path / 'checkpoints')).last_good_step() == (
      run.state.update_steps)
  if runtime == 'fleet':
    # The loop still trains what the buffer held when the drain began.
    manifest = driver.read_resume_manifest(str(tmp_path))
    assert manifest['drain_source'] == 'signal'
    assert manifest['update_steps'] == run.state.update_steps
    assert run.stats['fleet_stop'] == {'unjoined_actors': []}
  else:
    assert run.state.update_steps == 0
    kinds = [e['kind'] for e in _jsonl(tmp_path / 'incidents.jsonl')]
    assert kinds == ['anakin_stop_requested']


def _anakin_config(logdir, **kw):
  base = dict(env_backend='bandit', batch_size=4, unroll_length=5,
              num_action_repeats=1, episode_length=4, height=24, width=32,
              torso='shallow', use_instruction=False, learning_rate=2e-3,
              total_environment_frames=10**6, seed=0, summary_secs=0,
              checkpoint_secs=0, logdir=str(logdir))
  base.update(kw)
  return Config(**base)


def _fixed_batch(cfg, seed=0):
  """A [T+1, B] bandit batch from a numpy seed."""
  t, b = cfg.unroll_length, cfg.batch_size
  rng = np.random.RandomState(seed)
  x = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
  return ActorOutput(
      level_name=torch.zeros(b, dtype=torch.int32),
      agent_state=(x(rng.randn(b, 256).astype(np.float32) * 0.3),
                   x(rng.randn(b, 256).astype(np.float32) * 0.3)),
      env_outputs=StepOutput(
          x(rng.randn(t + 1, b).astype(np.float32)),
          StepOutputInfo(torch.zeros(t + 1, b),
                         torch.zeros(t + 1, b, dtype=torch.int32)),
          x(rng.rand(t + 1, b) > 0.8),
          (x(rng.randint(0, 256, (t + 1, b, cfg.height, cfg.width, 3)
                         ).astype(np.uint8)),
           torch.zeros(t + 1, b, 16, dtype=torch.int32))),
      agent_outputs=AgentOutput(
          x(rng.randint(0, 3, (t + 1, b))),
          x(rng.randn(t + 1, b, 3).astype(np.float32)),
          x(rng.randn(t + 1, b).astype(np.float32))))


def test_anakin_train_resumes_and_its_restored_step_matches(tmp_path):
  cfg = _anakin_config(tmp_path)
  carry = anakin.train(cfg, max_steps=2, device='cpu')
  assert carry.train_state.update_steps == 2
  saved = learner.state_to_payload(carry.train_state)

  # The restored state's next step on a fixed batch is bit-equal to the
  # never-saved state's.
  _, agent, _, fresh = anakin.build_run(cfg, device='cpu')
  restored = Checkpointer(str(tmp_path / 'checkpoints')).restore_latest(
      fresh.train_state)
  assert restored.update_steps == 2
  batch = _fixed_batch(cfg)
  original_agent = anakin.build_run(cfg, device='cpu')[1]
  original = learner.make_train_state(original_agent, cfg)
  original = learner.load_state_(original, saved)
  a, ma = learner.make_train_step_fn(agent, cfg)(restored, batch)
  b, mb = learner.make_train_step_fn(original_agent, cfg)(original, batch)
  assert float(ma['total_loss']) == float(mb['total_loss'])
  for k, p in a.params.items():
    assert torch.equal(p, b.params[k]), k

  # A second call resumes at step 2: steps 3 and 4, and the summaries
  # count on.
  carry = anakin.train(cfg, max_steps=2, device='cpu')
  assert carry.train_state.update_steps == 4
  steps = [e['step'] for e in _jsonl(tmp_path / 'summaries.jsonl')
           if e['tag'] == 'total_loss']
  assert steps == [1, 2, 3, 4]
  assert Checkpointer(str(tmp_path / 'checkpoints')).last_good_step() == 4


def test_anakin_train_stops_at_the_frame_budget_after_a_resume(tmp_path):
  cfg = _anakin_config(tmp_path, total_environment_frames=3 * 20)
  assert anakin.train(cfg, max_steps=2, device='cpu'
                      ).train_state.update_steps == 2
  assert anakin.train(cfg, device='cpu').train_state.update_steps == 3


def test_fault_plans_fire_as_in_jax():
  from scalable_agent_tpu.runtime import faults as jax_faults
  kw = dict(seed=7, nan_burst_at=2, nan_burst_len=3,
            checkpoint_interrupt_at=1, preempt_at=4, ckpt_bitrot_at=0)
  ref, port = jax_faults.FaultPlan.storm(**kw), faults.FaultPlan.storm(**kw)
  assert port.to_json() == ref.to_json()
  assert faults.SITES == jax_faults.SITES
  for site in faults.PORTED_SITES:
    for _ in range(8):
      want, got = ref.fire(site), port.fire(site)
      assert (got and (got.site, got.index, got.kind)) == (
          want and (want.site, want.index, want.kind)), site
  assert port.stats() == ref.stats()
  # The process-wide plan: installed, fired through `fire`, cleared.
  faults.install(faults.FaultPlan.from_json(ref.to_json()))
  fired = [faults.fire('nan_burst') is not None for _ in range(6)]
  assert fired == [False, False, True, True, True, False]
  faults.clear()
  assert faults.fire('nan_burst') is None
  # The transport sites are fired too now: their storm installs, and
  # fires on JAX's schedule.
  transport = faults.FaultPlan.storm(seed=0, transport=['drop'])
  faults.install(transport)
  assert faults.active() is transport
  fired = [faults.fire('transport_send') for _ in range(5)]
  assert [(f.index, f.kind) for f in fired if f is not None] == [(3, 'drop')]
  faults.clear()
  with pytest.raises(ValueError, match='unknown fault site'):
    faults.Fault('no_such_site', 0, 'x')


def test_install_from_env(monkeypatch):
  plan = faults.FaultPlan.storm(seed=1, preempt_at=2)
  monkeypatch.setenv(faults.PLAN_ENV_VAR, plan.to_json())
  installed = faults.install_from_env()
  assert faults.active() is installed
  assert installed.faults() == plan.faults()
  monkeypatch.delenv(faults.PLAN_ENV_VAR)
  faults.clear()
  assert faults.install_from_env() is None


def test_cli_keeps_float32_precision_without_tf32(tmp_path):
  before = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = True
  torch.backends.cuda.matmul.allow_tf32 = True
  try:
    experiment.main(['--mode=anakin', '--device=cpu', '--env_backend=bandit',
                     '--torso=shallow', '--batch_size=2', '--unroll_length=4',
                     '--num_action_repeats=1', '--height=24', '--width=32',
                     '--use_instruction=false', '--summary_secs=0',
                     '--total_environment_frames=8', f'--logdir={tmp_path}'])
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = before


_CLI = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
        '--mode=train', '--runtime=fleet', '--device=cpu',
        '--env_backend=bandit', '--torso=shallow', '--batch_size=2',
        '--num_actors=2', '--unroll_length=5', '--num_action_repeats=1',
        '--height=24', '--width=32', '--use_instruction=false',
        '--use_py_process=false', '--inference_timeout_ms=5',
        '--summary_secs=0', '--checkpoint_secs=0', '--episode_length=4']


def test_sigterm_drains_the_cli_and_the_rerun_resumes(tmp_path):
  """The first SIGTERM drains (exit 0, a verified manifest); the same
  command again resumes, consumes the manifest and finishes the budget."""
  steps = 100
  cmd = _CLI + [f'--logdir={tmp_path}',
                f'--total_environment_frames={steps * 10}']
  env = dict(os.environ, OMP_NUM_THREADS='1')
  proc = subprocess.Popen(cmd, cwd=REPO, env=env, stderr=subprocess.PIPE,
                          text=True)
  deadline = time.monotonic() + 120
  while not any(s >= 2 for s in _frame_steps(tmp_path)):
    assert proc.poll() is None, proc.stderr.read()
    assert time.monotonic() < deadline
    time.sleep(0.05)
  proc.send_signal(signal.SIGTERM)
  _, stderr = proc.communicate(timeout=90)
  assert proc.returncode == 0, stderr
  assert driver.PRECISION_LINE in stderr
  manifest = driver.read_resume_manifest(str(tmp_path))
  assert manifest['drain_source'] == 'signal'
  assert manifest['checkpoint_verified'] is True
  first = manifest['update_steps']
  assert 2 <= first < steps

  done = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                        text=True, timeout=180)
  assert done.returncode == 0, done.stderr
  assert f'restored checkpoint at step {first}' in done.stderr
  assert os.path.exists(tmp_path / 'resume_manifest.json.consumed')
  assert _frame_steps(tmp_path) == list(range(1, steps + 1))
  ckpt = Checkpointer(str(tmp_path / 'checkpoints'))
  assert ckpt.last_good_step() == steps


def test_a_second_sigterm_raises_and_anakin_mode_raises_on_the_first():
  drain = threading.Event()
  previous = experiment._install_sigterm_handler(drain, drains=True)
  try:
    handler = signal.getsignal(signal.SIGTERM)
    handler(signal.SIGTERM, None)
    assert drain.is_set()
    with pytest.raises(KeyboardInterrupt):
      handler(signal.SIGTERM, None)
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_IGN
    experiment._install_sigterm_handler(threading.Event(), drains=False)
    with pytest.raises(KeyboardInterrupt):
      signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
  finally:
    signal.signal(signal.SIGTERM, previous)
