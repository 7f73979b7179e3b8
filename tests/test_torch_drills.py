"""Fault C11: the port's `train`, `train_anakin` and `train_population`
take `max_seconds`, and its `train` takes the `fleet_factory` seam, with
the JAX package's semantics and refusals (scalable_agent_tpu/driver.py
`train`).

- Both packages' fleet `train` and `train_anakin` on one CPU bandit
  config with max_seconds=3 return and leave the loop within one step
  of the deadline: the last step ends at or after the call's start + 3 s
  (the loop starts later still), and the step before it, when there is
  one, ends no later than the first step's end + 3 s (the loop started
  before that).
- Both packages refuse `fleet_factory` under runtime='anakin' and under
  PBT with the same ValueError text.
- A port `fleet_factory` wrapping `make_fleet` is the fleet the loop
  runs, built from the server's policy and `initial_core_state`.
- Under a 2-rank gloo group the port's `train(max_seconds=...)` raises
  JAX's ValueError before any fleet machinery starts.
- `train_population` hands `max_seconds` to each member run.
- Fault C12: `driver/remote_live_hosts` is registered at the first
  summary block, as JAX's driver does, not at 0 before it (the elastic
  drill's controller read a pod of 0 hosts at start-up and moved).
"""

import inspect
import json
import os
import re
import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import telemetry
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import distributed

torch.set_num_threads(1)

MAX_SECONDS = 3.0
# JAX's refusal of a time-bounded multi-process run (driver.py train).
MULTI_HOST_MESSAGE = ('max_seconds is single-host only; bound multi-host '
                      'runs by max_steps/total_environment_frames')

_FLEET = dict(env_backend='bandit', num_actors=2, batch_size=2,
              unroll_length=5, num_action_repeats=1, episode_length=4,
              height=24, width=32, torso='shallow', use_py_process=False,
              use_instruction=False, total_environment_frames=10**9,
              inference_timeout_ms=5, summary_secs=0, seed=3)
_ANAKIN = dict(_FLEET, runtime='anakin', batch_size=4)
del _ANAKIN['num_actors'], _ANAKIN['use_py_process']
del _ANAKIN['inference_timeout_ms']


def _step_end_times(logdir):
  """Each learner step's summary wall time (summary_secs=0: one block
  per step)."""
  ends = {}
  with open(os.path.join(logdir, 'summaries.jsonl')) as f:
    for line in f:
      row = json.loads(line)
      if row.get('tag') == 'env_frames_per_sec':
        ends[row['step']] = row['wall_time']
  return [ends[s] for s in sorted(ends)]


def _jax_train(kw, logdir, **call):
  from scalable_agent_tpu import driver as jax_driver
  from scalable_agent_tpu.config import Config as JaxConfig
  return jax_driver.train(JaxConfig(**kw, logdir=logdir), **call)


def _port_train(kw, logdir, **call):
  return driver.train(Config(**kw, logdir=logdir), device='cpu', **call)


@pytest.mark.parametrize('runtime', ['fleet', 'anakin'])
@pytest.mark.parametrize('package', ['jax', 'port'])
def test_max_seconds_leaves_within_one_step_of_the_deadline(
    tmp_path, package, runtime):
  kw = _FLEET if runtime == 'fleet' else _ANAKIN
  train = _jax_train if package == 'jax' else _port_train
  t0 = time.time()
  run = train(kw, str(tmp_path), max_seconds=MAX_SECONDS,
              stall_timeout_secs=30.0)
  assert run is not None
  ends = _step_end_times(str(tmp_path))
  assert ends[-1] >= t0 + MAX_SECONDS, (ends, t0)
  if len(ends) > 1:  # JAX's first step compiles, and may cross alone
    assert ends[-2] <= ends[0] + MAX_SECONDS, ends


_REFUSALS = [
    (dict(runtime='anakin'),
     'fleet_factory is a fleet-runtime seam; --runtime=anakin has no '
     'fleet'),
    (dict(runtime='anakin', pbt_population=2),
     'fleet_factory is a fleet-runtime seam; PBT members are fused-loop '
     'anakin replicas'),
]


@pytest.mark.parametrize('fields,message', _REFUSALS)
def test_both_packages_refuse_fleet_factory_off_the_fleet_runtime(
    tmp_path, fields, message):
  kw = dict(_ANAKIN, **fields)
  got = {}
  for name, train in (('jax', _jax_train), ('port', _port_train)):
    with pytest.raises(ValueError) as err:
      train(kw, str(tmp_path / name), max_steps=1,
            fleet_factory=lambda *args: None)
    got[name] = str(err.value)
  assert got == {'jax': message, 'port': message}


def test_jax_s_refusals_are_the_messages_held_here():
  from scalable_agent_tpu import driver as jax_driver
  # Adjacent string literals across a line break, joined.
  source = re.sub(r"'\s*\n\s*'", '', inspect.getsource(jax_driver.train))
  for text in [m for _, m in _REFUSALS] + [MULTI_HOST_MESSAGE]:
    assert text in source, text


def test_a_fleet_factory_s_fleet_is_the_fleet_the_loop_runs(tmp_path):
  built = []

  def fleet_factory(config, policy, buffer, levels, initial_state_fn):
    fleet = driver.make_fleet(config, policy, buffer, levels,
                              initial_state_fn)
    built.append((fleet, policy, initial_state_fn))
    return fleet

  run = _port_train(_FLEET, str(tmp_path), max_steps=2,
                    fleet_factory=fleet_factory, stall_timeout_secs=30.0)
  assert len(built) == 1
  fleet, policy, initial_state_fn = built[0]
  assert run.fleet is fleet
  assert policy == run.server.policy
  assert initial_state_fn == run.server.initial_core_state
  assert run.state.update_steps == 2
  assert fleet.stats()['unrolls'] >= 2 * _FLEET['batch_size'] // 2


def test_train_population_bounds_each_member_run_by_max_seconds(
    tmp_path, monkeypatch):
  seen = []

  def member_run(config, **kw):
    seen.append(kw['max_seconds'])
    raise RuntimeError('recorded')

  monkeypatch.setattr(driver, 'train_anakin', member_run)
  cfg = Config(**dict(_ANAKIN, pbt_population=2, logdir=str(tmp_path)))
  with pytest.raises(RuntimeError, match='recorded'):
    driver.train(cfg, device='cpu', max_seconds=7.5)
  assert seen == [7.5]


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _rank(rank, world, port, outdir):
  cfg = Config(**_FLEET, logdir=os.path.join(outdir, 'run'),
               coordinator_address=f'localhost:{port}',
               num_processes=world, process_id=rank)
  distributed.maybe_initialize(cfg, backend='gloo', device='cpu',
                               timeout_secs=60)
  made = []
  driver.make_fleet = lambda *a, **k: made.append(1)
  try:
    driver.train(cfg, device='cpu', max_seconds=5.0)
    result = {'error': None}
  except ValueError as e:
    result = {'error': str(e)}
  result['fleets'] = len(made)
  result['summaries'] = os.path.exists(
      os.path.join(outdir, 'run', 'summaries.jsonl'))
  with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
    json.dump(result, f)
  distributed.shutdown()


def test_max_seconds_under_a_group_raises_jax_s_message(tmp_path):
  mp.spawn(_rank, args=(2, _free_port(), str(tmp_path)), nprocs=2)
  for rank in range(2):
    with open(tmp_path / f'rank{rank}.json') as f:
      result = json.load(f)
    assert result == {'error': MULTI_HOST_MESSAGE, 'fleets': 0,
                      'summaries': False}


def test_c12_the_live_hosts_gauge_waits_for_the_first_block(
    tmp_path, monkeypatch):
  at_start, at_steps = [], []

  class Recording(driver._IngestSummaries):

    def __init__(self, ingest):
      super().__init__(ingest)
      at_start.append(telemetry.registry().get('driver/remote_live_hosts'))

  monkeypatch.setattr(driver, '_IngestSummaries', Recording)
  _port_train(
      dict(_FLEET, remote_actor_port=_free_port()), str(tmp_path),
      max_steps=2, stall_timeout_secs=30.0,
      on_step=lambda run, steps, metrics: at_steps.append(
          telemetry.registry().snapshot().get('driver/remote_live_hosts')))
  assert at_start == [None]
  assert at_steps == [0, 0]  # the first block's live count: no host
  assert telemetry.registry().get('driver/remote_live_hosts') is None
