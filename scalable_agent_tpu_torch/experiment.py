"""Command line of the port. The fleet runtime (host actors, the batched
inference server on the card, the learner), the JAX CLI's default:

  python -m scalable_agent_tpu_torch.experiment --mode=train \\
      --runtime=fleet --env_backend=bandit --torso=deep --batch_size=32 \\
      --num_actors=32 --num_actions=9 --use_pallas_vtrace=true \\
      --use_instruction=false --logdir=/path/to/run

The fused on-device Anakin trainer (`--mode=anakin`, or `--mode=train
--runtime=anakin`):

  python -m scalable_agent_tpu_torch.experiment --mode=anakin \\
      --env_backend=bandit --torso=deep --batch_size=32 --num_actions=9 \\
      --use_pallas_vtrace=true --use_instruction=false \\
      --total_environment_frames=1000000 --logdir=/path/to/run

Population-based training over Anakin members (`--pbt_population=P`
with `--mode=train --runtime=anakin`; `--pbt_vectorized=true` advances
the members in lockstep, one suite), here on procgen with the level
curriculum:

  python -m scalable_agent_tpu_torch.experiment --mode=train \\
      --runtime=anakin --env_backend=procgen --curriculum=regret \\
      --pbt_population=4 --pbt_vectorized=true --torso=deep \\
      --batch_size=32 --use_pallas_vtrace=true --use_instruction=false \\
      --total_environment_frames=1000000 --logdir=/path/to/run

`--anakin_filler=true` on the fleet runtime fills its idle learner with
Anakin self-play (best with `--surrogate=impact`).

Data-parallel over N ranks of one host, one card each (NCCL), for
either runtime (`--model_parallelism=M` cuts the fleet's model over M of
them, tensor parallelism):

  python -m torch.distributed.run --standalone --nproc_per_node=N \\
      -m scalable_agent_tpu_torch.experiment --mode=anakin ...
  python -m torch.distributed.run --standalone --nproc_per_node=N \\
      -m scalable_agent_tpu_torch.experiment --mode=train --runtime=fleet ...

The flags are the JAX CLI's (experiment.py at the repo root), for the
config fields this slice reads; booleans take `--flag`, `--flag=true` or
`--flag=false`. `--device` (default cuda) is the port's own: with no
CUDA the run raises unless `--device=cpu` is given. A group is joined
when torch.distributed.run's environment or `--coordinator_address`
declares one (with `--num_processes` and `--process_id`); each rank then
trains its block of the batch, as the JAX CLI does over the devices of
one host (Anakin) or of every host (the fleet: each rank runs its own
actors and feeds its rows). Its backend follows the device: NCCL for
CUDA ranks, one card each, gloo for CPU ranks. Anakin stays on one host:
a group across nodes raises, as in the JAX CLI, and so does
`--model_parallelism` > 1 with it.

Evaluation (`--mode=test`, driver.evaluate) plays `--test_num_episodes`
episodes on every test level at once from the newest checkpoint under
`<logdir>/checkpoints` (params and step only) and writes
`<logdir>/eval_summaries.jsonl` (per-level mean returns, and a suite's
human-normalised scores); under a group the levels split over the ranks:

  python -m scalable_agent_tpu_torch.experiment --mode=test \\
      --level_name=dmlab30 --env_backend=dmlab --test_num_episodes=10 \\
      --logdir=/path/to/run

Both runtimes resume from `<logdir>/checkpoints` (the newest restorable
step; the format is the port's own, `torch.save` files, not the JAX
package's Orbax steps). Under `--mode=train` the first SIGTERM drains:
the run stops taking new data, trains what it holds, saves a verified
checkpoint, writes `<logdir>/resume_manifest.json` and exits 0; rerunning
the same command resumes. A second SIGTERM raises through the run's
final save; under `--mode=anakin` the first one does. Float32 layers run
with TF32 off (logged once as `float32 precision: tf32 off (cudnn,
matmul)`).

Remote actors (runtime/remote.py): a learner started with
`--remote_actor_port=PORT` (and `--num_actors=0` for no local fleet)
takes unrolls over TCP from actor-only hosts, each one

  python -m scalable_agent_tpu_torch.experiment --job_name=actor \
      --task=0 --learner_address=HOST:PORT --num_actors=16 [...same
      env and model flags as the learner...]

which runs its envs and its inference on `--device` (cuda by default,
`--device=cpu` for a host without a card) and exits 0 when the learner
ends training. It takes no process group (no `--coordinator_address`).
Its first SIGTERM drains: the fleet stops, the host announces its
departure to the learner and exits.

The env processes are forked from a forkserver, which `main` starts
before its first CUDA call (runtime/py_process.py).
"""

import argparse
import dataclasses
import logging
import signal
import sys
import threading
import typing
from typing import List, Optional

import torch

from scalable_agent_tpu_torch.config import INTERNAL_FIELDS, Config
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.runtime import py_process


def _bool(text: str) -> bool:
  lowered = text.lower()
  if lowered in ('true', '1', 'yes'):
    return True
  if lowered in ('false', '0', 'no'):
    return False
  raise argparse.ArgumentTypeError(f'expected true or false, got {text!r}')


def _optional(kind):
  def parse(text: str):
    return None if text.lower() == 'none' else kind(text)
  return parse


def _parser() -> argparse.ArgumentParser:
  parser = argparse.ArgumentParser(
      prog='python -m scalable_agent_tpu_torch.experiment',
      description=__doc__.split('\n\n')[0])
  defaults = Config()
  hints = typing.get_type_hints(Config)
  for field in dataclasses.fields(Config):
    if field.name in INTERNAL_FIELDS:
      continue
    hint = hints[field.name]
    default = getattr(defaults, field.name)
    optional = typing.get_origin(hint) is typing.Union
    kind = typing.get_args(hint)[0] if optional else hint
    if kind is bool:
      parser.add_argument(f'--{field.name}', type=_bool, nargs='?',
                          const=True, default=default)
    else:
      parser.add_argument(f'--{field.name}',
                          type=_optional(kind) if optional else kind,
                          default=default)
  parser.add_argument('--device', default='cuda',
                      help="torch device of the run (default cuda; 'cpu' "
                           'runs the kernels\' plain twins)')
  return parser


def _install_sigterm_handler(drain_event: threading.Event, drains: bool):
  """SIGTERM drains instead of killing the process mid-step: in a mode
  that `drains`, the first sets `drain_event`, and the run drains and
  returns; a second (or a first in a mode that does not drain) raises
  KeyboardInterrupt through the run's `finally`; later ones are ignored,
  so they cannot abort the final save. Returns the handler it replaced.
  Call it in the main thread, where Python delivers signals."""
  def terminate(signum, frame):
    del frame
    if drains and not drain_event.is_set():
      drain_event.set()
      return
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    raise KeyboardInterrupt(f'signal {signum}')

  previous = signal.signal(signal.SIGTERM, terminate)
  return signal.SIG_DFL if previous is None else previous


def main(argv: Optional[List[str]] = None):
  logging.basicConfig(
      level=logging.INFO,
      format='%(asctime)s %(name)s %(levelname)s %(message)s')
  # Before any CUDA call: env processes fork from this server, which has
  # this module's imports loaded.
  py_process.warm_forkserver(preload=[__spec__.name])
  from scalable_agent_tpu_torch import driver
  driver.set_float32_precision()
  args = vars(_parser().parse_args(argv))
  device = args.pop('device')
  config = Config(**args)
  drain_event = threading.Event()
  previous = None
  if threading.current_thread() is threading.main_thread():
    # Both runtimes of --mode=train drain on the first SIGTERM;
    # --mode=anakin keeps the first-SIGTERM-raises behaviour, as in the
    # JAX CLI.
    previous = _install_sigterm_handler(drain_event,
                                        drains=config.mode == 'train')
  try:
    return _run(config, device, drain_event)
  finally:
    if previous is not None:
      signal.signal(signal.SIGTERM, previous)


def _run(config: Config, device: str, drain_event: threading.Event):
  from scalable_agent_tpu_torch import driver
  if config.job_name == 'actor':
    return _remote_actor(config, device)
  if config.job_name != 'learner':
    raise ValueError(f'unknown --job_name={config.job_name!r} (learner | '
                     'actor)')
  if config.mode == 'train' and config.pbt_population >= 2:
    topology = distributed.declared_topology(config)
    if topology is not None and topology.world_size > 1:
      raise ValueError('a population runs in one process (its members are '
                       'one-device Anakin runs); drop the process group')
    run = driver.train_population(config, device=device,
                                  drain_event=drain_event)
    logging.info('population training done; the winner is %s',
                 run.config.logdir)
    return run.carry
  if config.mode == 'train' and config.runtime == 'fleet':
    return _train_fleet(config, device, drain_event)
  if config.mode == 'test':
    return _evaluate(config, device)
  if config.mode not in ('train', 'anakin'):
    raise ValueError(f'unknown --mode={config.mode!r} (train | test | '
                     'anakin)')
  topology = distributed.declared_topology(config)
  if topology is not None and topology.num_nodes > 1:
    # A rank here is a JAX device, and the JAX CLI's Anakin spans the
    # devices of one host.
    raise ValueError(
        f'--mode=anakin is single-host: the group spans '
        f'{topology.num_nodes} nodes; use --mode=train (the fleet runtime, '
        'ROADMAP Queue A) for more than one host')
  from scalable_agent_tpu_torch.parallel import anakin

  def train_on(rank_device, mesh):
    if config.mode == 'train':
      return driver.train_anakin(config, device=rank_device, mesh=mesh,
                                 drain_event=drain_event).carry
    return anakin.train(config, device=rank_device, mesh=mesh)

  backend = 'gloo' if torch.device(device).type == 'cpu' else 'nccl'
  rank_device = distributed.maybe_initialize(config, backend=backend,
                                             device=device)
  if rank_device is None:
    carry = train_on(device, None)
  else:
    try:
      carry = train_on(rank_device, driver.choose_mesh(config, rank_device))
    except BaseException:
      distributed.shutdown(wait=False)
      raise
    distributed.shutdown()
  logging.info('anakin training done at %d frames',
               carry.train_state.update_steps * config.frames_per_step)
  return carry


def _remote_actor(config: Config, device: str):
  """An actor-only host feeding the learner at --learner_address."""
  if config.coordinator_address:
    raise ValueError(
        '--job_name=actor joins no process group (actor hosts feed over '
        '--learner_address TCP ingest); drop --coordinator_address on '
        'actor hosts')
  if not config.learner_address:
    raise ValueError('--job_name=actor needs --learner_address')
  if config.mode != 'train':
    raise ValueError('--job_name=actor only makes sense with --mode=train '
                     '(--mode=test runs its own envs)')
  from scalable_agent_tpu_torch.runtime import remote
  return remote.run_remote_actor(config, config.learner_address,
                                 task=max(config.task, 0), device=device)


def _evaluate(config: Config, device: str):
  from scalable_agent_tpu_torch import driver
  backend = 'gloo' if torch.device(device).type == 'cpu' else 'nccl'
  rank_device = distributed.maybe_initialize(config, backend=backend,
                                             device=device)
  if rank_device is None:
    return driver.evaluate(config, device=device)
  try:
    returns = driver.evaluate(config, device=rank_device)
  except BaseException:
    distributed.shutdown(wait=False)
    raise
  distributed.shutdown()
  return returns


def _train_fleet(config: Config, device: str, drain_event: threading.Event):
  from scalable_agent_tpu_torch import driver
  backend = 'gloo' if torch.device(device).type == 'cpu' else 'nccl'
  rank_device = distributed.maybe_initialize(config, backend=backend,
                                             device=device)
  if rank_device is None:
    run = driver.train(config, device=device, drain_event=drain_event)
  else:
    try:
      run = driver.train(config, device=rank_device, drain_event=drain_event)
    except BaseException:
      distributed.shutdown(wait=False)
      raise
    distributed.shutdown()
  logging.info('fleet training done at %d frames', run.frames)
  if torch.device(device).type == 'cuda':
    logging.info('peak device memory: %d bytes',
                 torch.cuda.max_memory_allocated())
  return run


if __name__ == '__main__':
  main(sys.argv[1:])
