"""The fleet runtime over a process group (driver.train under a mesh; the
CLI's `--mode=train --runtime=fleet` under torch.distributed.run's
environment) against the one-rank learner, on the CPU.

Two gloo ranks, each with its own small fleet of thread-hosted bandit
actors, train one model: the global batch of 4 is 2 rows per rank. The
spawned ranks import no JAX. One spawn runs three trainings in one
group: a plain one (each rank records the local batches it trained on,
its params after every step and its seeds), one where only rank 0 asks
to stop (the `preempt_signal` fault), and the SDC drill (the
`replica_divergence` fault with the rollback after one bad check).
A second spawn runs the CLI as two declared nodes (LOCAL_WORLD_SIZE=1).
A third has each rank bind its own ingest port, rank 0 fed by an
actor-host CLI process alone (JAX's test_remote_actor_feeds_sharded_training
over two ranks).

Tolerances: the ranks' params are bit-equal to each other after every
step (one all-reduced gradient, applied alike). Against the one-rank
learner stepped on the same global batches (the ranks' local batches in
rank order): losses rtol 2e-4, params rtol 5e-4 / atol 5e-6, the data-
parallel gates of tests/test_torch_parallel.py (gradients summed in
another order).
"""

import functools
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from scalable_agent_tpu_torch import driver
from scalable_agent_tpu_torch import experiment
from scalable_agent_tpu_torch import health
from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models import init_params
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import train_parallel
from scalable_agent_tpu_torch.runtime import faults
from scalable_agent_tpu_torch.structs import map_structure

WORLD = 2
STEPS = 3
SPAWN_TIMEOUT_SECS = 120
GROUP_TIMEOUT_SECS = 60

_KW = dict(runtime='fleet', env_backend='bandit', torso='shallow', height=24,
           width=32, batch_size=4, num_actors=2, unroll_length=5,
           num_action_repeats=1, episode_length=4, use_instruction=False,
           use_py_process=False, summary_secs=0, use_pallas_vtrace=True,
           inference_timeout_ms=5, total_environment_frames=10**6, seed=3)


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _spawn(worker, *args):
  context = mp.spawn(worker, args=(WORLD, _free_port()) + args,
                     nprocs=WORLD, join=False)
  deadline = time.monotonic() + SPAWN_TIMEOUT_SECS
  while not context.join(timeout=max(deadline - time.monotonic(), 1.0)):
    if time.monotonic() >= deadline:
      for process in context.processes:
        process.kill()
      pytest.fail(f'{worker.__name__} ranks still running after '
                  f'{SPAWN_TIMEOUT_SECS} s')


def _loaded_jax():
  return sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'scalable_agent_tpu'))


def _digest(params):
  digest = hashlib.sha256()
  for k, v in sorted(params.items()):
    digest.update(v.detach().numpy().tobytes())
  return digest.hexdigest()


def _incidents(logdir, rank):
  name = 'incidents.jsonl' if rank == 0 else f'incidents_p{rank}.jsonl'
  with open(os.path.join(logdir, name)) as f:
    return [json.loads(line)['kind'] for line in f]


def _recording(record):
  """driver.train's hooks, wrapped to record the fleet's seed base, the
  server's seed and each learner step's local batch."""
  make_fleet, server_cls = driver.make_fleet, driver.InferenceServer
  make_step = train_parallel.make_sharded_train_step

  def fleet(*args, **kwargs):
    record['seed_base'] = kwargs['seed_base']
    return make_fleet(*args, **kwargs)

  def server(*args, **kwargs):
    record['server_seed'] = kwargs['seed']
    return server_cls(*args, **kwargs)

  def step_fn(*args, **kwargs):
    step, place = make_step(*args, **kwargs)

    @functools.wraps(step)  # with its attributes (the layout)
    def recorded(state, batch):
      record['batches'].append(map_structure(
          lambda x: x.detach().numpy().copy(), batch))
      return step(state, batch)

    return recorded, place

  driver.make_fleet, driver.InferenceServer = fleet, server
  train_parallel.make_sharded_train_step = step_fn


def _group_rank(rank, world, port, outdir):
  torch.set_num_threads(1)
  base = dict(_KW, coordinator_address=f'localhost:{port}',
              num_processes=world, process_id=rank)
  distributed.maybe_initialize(Config(**base), backend='gloo', device='cpu',
                               timeout_secs=GROUP_TIMEOUT_SECS)
  result = {'jax_modules': _loaded_jax()}

  # A plain run.
  record = {'batches': [], 'params': [], 'digests': [], 'losses': []}
  _recording(record)

  def on_step(run, steps_done, metrics):
    record['params'].append({k: v.detach().numpy().copy()
                             for k, v in run.state.params.items()})
    record['digests'].append(_digest(run.state.params))
    record['losses'].append(float(metrics['total_loss']))

  run = driver.train(Config(**base, logdir=os.path.join(outdir, 'plain')),
                     max_steps=STEPS, device='cpu', on_step=on_step,
                     stall_timeout_secs=30)
  digests = [None] * world
  torch.distributed.all_gather_object(digests, record['digests'])
  record.update(all_digests=digests, update_steps=run.state.update_steps,
                sdc_mismatches=run.health.sdc_mismatches)
  result['plain'] = record
  # The fingerprint sentinel alone: agreement, then a probed lane.
  fingerprint_fn, replicas = train_parallel.make_sdc_fingerprint_fn(
      run.mesh)
  result['sdc_fn'] = {
      'replicas': replicas,
      'own': int(learner.param_fingerprint(run.state.params)),
      'plain': health.read_fingerprints(fingerprint_fn(run.state.params)),
      'probed': health.read_fingerprints(fingerprint_fn(
          run.state.params, np.array([0, 5], np.uint32)))}

  # Rank 0 alone asks to stop, at its second learner step.
  if rank == 0:
    faults.install(faults.FaultPlan.storm(seed=0, preempt_at=1))
  logdir = os.path.join(outdir, 'stop')
  try:
    run = driver.train(Config(**base, logdir=logdir), max_steps=5,
                       device='cpu', stall_timeout_secs=30)
  finally:
    faults.clear()
  result['stop'] = {'update_steps': run.state.update_steps,
                    'manifest': os.path.exists(
                        os.path.join(logdir, driver.RESUME_MANIFEST)),
                    'incidents': _incidents(logdir, rank),
                    'saved': run.checkpointer.latest_step()}

  # The SDC drill: one replica's probe lane perturbed at the third check;
  # one bad check rolls back.
  faults.install(faults.FaultPlan.storm(seed=0, replica_divergence_at=2,
                                        replica_divergence_len=1))
  logdir = os.path.join(outdir, 'sdc')
  try:
    run = driver.train(
        Config(**base, logdir=logdir, checkpoint_secs=0,
               checkpoint_check_every_steps=1, health_rollback_after=1),
        max_steps=5, device='cpu', stall_timeout_secs=30)
  finally:
    faults.clear()
  result['sdc'] = {'update_steps': run.state.update_steps,
                   'incidents': _incidents(logdir, rank),
                   'health': run.health.stats(),
                   'digest': _digest(run.state.params)}
  torch.save(result, os.path.join(outdir, f'rank{rank}.pt'))
  distributed.shutdown()


def _cli_rank(rank, world, port, outdir):
  """experiment.main under torch.distributed.run's environment of a
  2-node group: one rank per node."""
  torch.set_num_threads(1)
  os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                    RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK='0',
                    LOCAL_WORLD_SIZE='1')
  frames = STEPS * Config(**_KW).frames_per_step
  argv = ['--device=cpu', f'--logdir={outdir}',
          f'--total_environment_frames={frames}'] + [
              f'--{k}={v}' for k, v in _KW.items()
              if k != 'total_environment_frames']
  run = experiment.main(argv)
  torch.save({'update_steps': run.state.update_steps,
              'digest': _digest(run.state.params),
              'left_group': not distributed.is_initialized(),
              'num_nodes': distributed.declared_topology(
                  run.config).num_nodes},
             os.path.join(outdir, f'cli{rank}.pt'))


@pytest.fixture(scope='module')
def group(tmp_path_factory):
  outdir = tmp_path_factory.mktemp('dp_fleet')
  _spawn(_group_rank, str(outdir))
  return outdir, [torch.load(outdir / f'rank{r}.pt', weights_only=False)
                  for r in range(WORLD)]


def test_rank_seeds_and_files(group):
  outdir, ranks = group
  assert [r['jax_modules'] for r in ranks] == [[], []]
  bases = [r['plain']['seed_base'] for r in ranks]
  assert bases == [0, max(_KW['num_actors'], 1000)]
  seeds = [r['plain']['server_seed'] for r in ranks]
  assert seeds == [_KW['seed'] + 1000 + b for b in bases]
  files = set(os.listdir(outdir / 'plain'))
  assert {'summaries.jsonl', 'summaries_p1.jsonl', 'incidents.jsonl',
          'incidents_p1.jsonl', 'config.json', 'checkpoints'} <= files
  assert not any(f.startswith(('config_p', 'summaries_p0')) for f in files)


def test_params_are_bit_equal_across_ranks_after_every_step(group):
  _, ranks = group
  for r in ranks:
    plain = r['plain']
    assert plain['update_steps'] == STEPS
    digests = plain['all_digests']
    assert len(digests[0]) == STEPS and digests[0] == digests[1]
    assert len(set(digests[0])) == STEPS  # every step moved the params
    assert plain['sdc_mismatches'] == 0
  for k, v in ranks[0]['plain']['params'][-1].items():
    np.testing.assert_array_equal(v, ranks[1]['plain']['params'][-1][k])


def test_sdc_fingerprints_agree_and_a_probe_is_caught(group):
  """make_sdc_fingerprint_fn over the 2 ranks: one fingerprint per data
  replica, each learner.param_fingerprint of that rank's params, equal
  on bit-equal replicas; a probe on one lane is read as a mismatch."""
  _, ranks = group
  for r in ranks:
    sdc = r['sdc_fn']
    assert sdc['replicas'] == WORLD
    mismatch, fps = sdc['plain']
    assert mismatch == 0.0 and fps == [sdc['own']] * WORLD
    mismatch, fps = sdc['probed']
    assert mismatch == 1.0
    assert fps == [sdc['own'], (sdc['own'] + 5) & 0xFFFFFFFF]


def test_each_rank_trains_on_its_own_rows(group):
  _, ranks = group
  local = _KW['batch_size'] // WORLD
  for r in ranks:
    for batch in r['plain']['batches']:
      assert batch.level_name.shape == (local,)
      assert batch.env_outputs.reward.shape == (_KW['unroll_length'] + 1,
                                                local)
  # Distinct seeds: the two fleets' trajectories differ.
  first = [r['plain']['batches'][0].agent_outputs.policy_logits
           for r in ranks]
  assert not np.array_equal(first[0], first[1])


def test_step_sequence_matches_the_one_rank_learner(group):
  """The one-rank learner, stepped on the global batches the ranks
  trained on (their local batches in rank order), follows the group."""
  _, ranks = group
  config = Config(**_KW)
  agent = driver.build_agent(config, 3)
  init_params(agent, torch.Generator().manual_seed(config.seed))
  state = learner.make_train_state(agent, config)
  step = learner.make_train_step_fn(agent, config)
  for i in range(STEPS):
    parts = [r['plain']['batches'][i] for r in ranks]
    lead = lambda *xs: torch.from_numpy(np.concatenate(xs, 0))  # noqa: E731
    traj = lambda *xs: torch.from_numpy(np.concatenate(xs, 1))  # noqa: E731
    batch = parts[0]._replace(
        level_name=lead(*[p.level_name for p in parts]),
        agent_state=map_structure(lead, *[p.agent_state for p in parts]),
        env_outputs=map_structure(traj, *[p.env_outputs for p in parts]),
        agent_outputs=map_structure(traj, *[p.agent_outputs for p in parts]))
    state, metrics = step(state, batch)
    np.testing.assert_allclose(ranks[0]['plain']['losses'][i],
                               float(metrics['total_loss']), rtol=2e-4,
                               err_msg=f'step {i}')
    for k, v in state.params.items():
      np.testing.assert_allclose(ranks[0]['plain']['params'][i][k],
                                 v.detach().numpy(), rtol=5e-4, atol=5e-6,
                                 err_msg=f'step {i} {k}')


def test_a_stop_on_rank_0_alone_stops_every_rank_at_one_step(group):
  _, ranks = group
  for r, result in enumerate(ranks):
    stop = result['stop']
    # Rank 0's second stop check fired: one learner step was taken.
    assert stop['update_steps'] == 1, (r, stop)
    assert not stop['manifest']  # no drain save, no manifest
    assert 'preempt_group_stop' in stop['incidents']
    assert 'preempt_drain_start' not in stop['incidents']
    assert stop['saved'] == 1  # the tail save, a collective


def test_sdc_drill_gives_one_incident_and_one_rollback(group):
  _, ranks = group
  for r, result in enumerate(ranks):
    sdc = result['sdc']
    assert sdc['update_steps'] == 5
    kinds = sdc['incidents']
    assert kinds.count('fault_replica_divergence') == 1, kinds
    assert kinds.count('sdc_replica_mismatch') == 1, kinds
    assert kinds.count('rollback') == 1, kinds
    assert sdc['health']['sdc_mismatches'] == 1
    assert sdc['health']['rollbacks'] == 1
  assert ranks[0]['sdc']['digest'] == ranks[1]['sdc']['digest']


def test_the_cli_runs_a_two_node_group(tmp_path):
  """The fleet's CLI under a 2-node torch.distributed.run environment
  (one rank per node): it joins, trains and leaves the group."""
  _spawn(_cli_rank, str(tmp_path))
  ranks = [torch.load(tmp_path / f'cli{r}.pt', weights_only=False)
           for r in range(WORLD)]
  for result in ranks:
    assert result['update_steps'] == STEPS
    assert result['left_group'] and result['num_nodes'] == 2
  assert ranks[0]['digest'] == ranks[1]['digest']
  assert (tmp_path / 'summaries_p1.jsonl').exists()


# --- a remote actor host feeding rank 0 of the group -----------------


def _actor_host_cli(port, logdir):
  """The `--job_name=actor` CLI on the CPU, feeding the ingest at port."""
  flags = dict(_KW, num_actors=2)
  cmd = [sys.executable, '-m', 'scalable_agent_tpu_torch.experiment',
         '--job_name=actor', '--task=0', '--device=cpu',
         f'--learner_address=127.0.0.1:{port}', f'--logdir={logdir}'] + [
             f'--{k}={v}' for k, v in flags.items()
             if k not in ('runtime', 'use_pallas_vtrace')]
  return subprocess.Popen(cmd, cwd=os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def _ingest_rank(rank, world, port, outdir, ingest_ports):
  """Rank 0 trains on its actor host's wire alone (no local actors);
  rank 1 on its own local fleet. Each binds its own ingest port."""
  torch.set_num_threads(1)
  base = dict(_KW, batch_size=2, coordinator_address=f'localhost:{port}',
              num_processes=world, process_id=rank,
              remote_actor_port=ingest_ports[rank],
              num_actors=0 if rank == 0 else 2)
  distributed.maybe_initialize(Config(**base), backend='gloo', device='cpu',
                               timeout_secs=GROUP_TIMEOUT_SECS)
  digests = []
  run = driver.train(
      Config(**base, logdir=os.path.join(outdir, 'run')), max_steps=2,
      device='cpu', stall_timeout_secs=60,
      on_step=lambda run, steps, metrics: digests.append(
          _digest(run.state.params)))
  all_digests = [None] * world
  torch.distributed.all_gather_object(all_digests, digests)
  torch.save({'update_steps': run.state.update_steps,
              'all_digests': all_digests,
              'ingest_port': run.ingest.port,
              'ingest_unrolls': run.ingest.stats()['unrolls'],
              'fleet_unrolls': run.fleet.stats()['unrolls'],
              'sdc_mismatches': run.health.sdc_mismatches,
              'jax_modules': _loaded_jax()},
             os.path.join(outdir, f'ingest{rank}.pt'))
  distributed.shutdown()


def test_a_remote_actor_host_feeds_rank_0_of_a_group(tmp_path):
  """The 2-rank counterpart of JAX's
  test_remote_actor_feeds_sharded_training (tests/test_remote.py): an
  actor-host CLI child feeds rank 0's ingest, the global batch of 2 is
  one row per rank, and the group trains 2 steps with the params
  bit-equal across ranks after each step. Every row rank 0 trained on
  came over the wire; the child exits 0 on the learner's bye."""
  ingest_ports = [_free_port(), _free_port()]
  while ingest_ports[1] == ingest_ports[0]:
    ingest_ports[1] = _free_port()
  host = _actor_host_cli(ingest_ports[0], str(tmp_path / 'host'))
  try:
    _spawn(_ingest_rank, str(tmp_path), ingest_ports)
    out = host.communicate(timeout=60)[0]
  finally:
    if host.poll() is None:
      host.kill()
      host.communicate()
  assert host.returncode == 0, out[-3000:]
  ranks = [torch.load(tmp_path / f'ingest{r}.pt', weights_only=False)
           for r in range(WORLD)]
  for r, result in enumerate(ranks):
    assert result['jax_modules'] == []
    assert result['update_steps'] == 2
    assert result['ingest_port'] == ingest_ports[r]
    digests = result['all_digests']
    assert len(digests[0]) == 2 and digests[0] == digests[1]
    assert result['sdc_mismatches'] == 0
  assert ranks[0]['fleet_unrolls'] == 0
  assert ranks[0]['ingest_unrolls'] >= 2  # one row per step, over TCP
  assert ranks[1]['ingest_unrolls'] == 0 and ranks[1]['fleet_unrolls'] >= 2
