"""Joining a process group, the port's counterpart of
scalable_agent_tpu/parallel/distributed.py (`is_initialized`, `initialize`,
`maybe_initialize`).

The JAX package joins hosts into one runtime and then sees every chip of
every host as a device of one mesh. PyTorch has one process per device:
a rank. So here `num_processes` is the number of ranks, and a group is
joined in one of two ways:

- from the config's fields (`coordinator_address`, `num_processes`,
  `process_id`), over `tcp://coordinator_address`;
- from the environment that `torch.distributed.run` sets (`RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`,
  `MASTER_PORT`).

The backend is named by the caller, never guessed: NCCL puts rank r on
`cuda:{LOCAL_RANK}` (one card per rank, and it raises when the host's
ranks outnumber its cards); gloo runs where the caller says, which is how
the CPU tests run and how two ranks share one card. Every group gets a
timeout, so a rank that never arrives, or dies, fails the others instead
of hanging them.

`topology_delta` compares the mesh a checkpoint was saved on with the
live one (the driver's elastic restore gate). JAX's
`global_batch_from_local` has no counterpart: no array spans the ranks,
and each rank trains on the rows its own actors made.

The JAX module's XLA-only parts, the compile cache and the CPU
collectives flag, have no counterpart.
"""

import datetime
import logging
import os
from typing import Dict, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist

from scalable_agent_tpu_torch.config import (Config, resolve_process_id,
                                             validate_distributed)

log = logging.getLogger('scalable_agent_tpu_torch')

BACKENDS = ('nccl', 'gloo')
DEFAULT_TIMEOUT_SECS = 300.0


class Topology(NamedTuple):
  """Where this process sits in its group."""
  rank: int
  world_size: int
  local_rank: int         # rank among the ranks of this host
  local_world_size: int   # ranks on this host

  @property
  def num_nodes(self) -> int:
    return -(-self.world_size // self.local_world_size)


def is_initialized() -> bool:
  """Whether this process already joined a process group."""
  return dist.is_available() and dist.is_initialized()


def declared_topology(config: Config,
                      environ: Mapping[str, str] = os.environ
                      ) -> Optional[Topology]:
  """The group the config's fields, or else torch.distributed.run's
  environment, declare for this process; None when neither names one.
  Reads no device and joins nothing.

  Ranks declared by the config share one host unless `LOCAL_RANK` and
  `LOCAL_WORLD_SIZE` say otherwise."""
  if config.coordinator_address:
    rank, world = resolve_process_id(config), config.num_processes
  elif 'RANK' in environ and 'WORLD_SIZE' in environ:
    rank, world = int(environ['RANK']), int(environ['WORLD_SIZE'])
  else:
    return None
  return Topology(rank, world,
                  int(environ.get('LOCAL_RANK', rank)),
                  int(environ.get('LOCAL_WORLD_SIZE', world)))


def rank_device(topology: Topology, backend: str, device='cuda'
                ) -> torch.device:
  """The device of this rank. NCCL: `cuda:{local_rank}`, which must
  exist. gloo: `device` as given; a bare 'cuda' is `cuda:{local_rank}`."""
  if backend not in BACKENDS:
    raise ValueError(f'backend must be one of {BACKENDS}, got {backend!r}')
  device = torch.device(device)
  if backend == 'nccl' and device.type != 'cuda':
    raise ValueError(f'the NCCL backend runs on CUDA devices, got {device}')
  if device.type != 'cuda':
    return device
  if not torch.cuda.is_available():
    raise RuntimeError(
        f'{backend} rank on {device} requested but '
        'torch.cuda.is_available() is False')
  if backend == 'nccl' or device.index is None:
    count = torch.cuda.device_count()
    if topology.local_world_size > count:
      raise RuntimeError(
          f'{topology.local_world_size} ranks on this host but '
          f'{count} CUDA device(s): {backend} with a device per rank '
          'needs one card per rank')
    device = torch.device('cuda', topology.local_rank)
  return device


def initialize(topology: Topology, init_method: str, backend: str,
               device='cuda',
               timeout_secs: float = DEFAULT_TIMEOUT_SECS) -> torch.device:
  """Join the group as `topology` says, over `init_method`
  ('tcp://host:port' or 'env://'); returns this rank's device (CUDA:
  made the current device before the group exists)."""
  if is_initialized():
    raise RuntimeError('this process already joined a process group')
  device = rank_device(topology, backend, device)
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  dist.init_process_group(
      backend, init_method=init_method, world_size=topology.world_size,
      rank=topology.rank,
      timeout=datetime.timedelta(seconds=timeout_secs))
  log.info('process group (%s): rank %d of %d, local rank %d of %d, on %s',
           backend, topology.rank, topology.world_size, topology.local_rank,
           topology.local_world_size, device)
  return device


def maybe_initialize(config: Config, backend: str = 'nccl', device='cuda',
                     timeout_secs: float = DEFAULT_TIMEOUT_SECS
                     ) -> Optional[torch.device]:
  """Join the group the config or torch.distributed.run's environment
  declares, once. Returns this rank's device when this call joined, None
  when nothing declares a group or the process already joined one."""
  for warning in validate_distributed(config):
    log.warning('%s', warning)
  topology = declared_topology(config)
  if topology is None:
    return None
  if is_initialized():
    log.info('process group already joined: the config\'s coordinator '
             'fields are a no-op')
    return None
  init_method = (f'tcp://{config.coordinator_address}'
                 if config.coordinator_address else 'env://')
  return initialize(topology, init_method, backend, device=device,
                    timeout_secs=timeout_secs)


def rank() -> int:
  """This process's rank in the joined group (0 with no group)."""
  return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
  """Ranks in the joined group (1 with no group)."""
  return dist.get_world_size() if is_initialized() else 1


def shutdown(wait: bool = True):
  """Leave the group. With `wait` (a run that ended normally) first wait
  for every rank. A rank that failed leaves without the barrier: its
  peers may be inside a collective it never joins, and a barrier there
  would be a mismatched collective that holds it until the timeout."""
  if not is_initialized():
    return
  if wait:
    if dist.get_backend() == 'nccl':
      dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
      dist.barrier()
  dist.destroy_process_group()


def topology_delta(saved_mesh_shape: Optional[Mapping[str, int]], mesh
                   ) -> Optional[Dict]:
  """The elastic-restart detector: None when the mesh a checkpoint's
  sharding manifest recorded is the live mesh's shape (or nothing was
  recorded, or there is no mesh); else the change record the driver logs
  and writes as the `topology_resharded` incident, with this rank's
  place in the group."""
  if saved_mesh_shape is None or mesh is None:
    return None
  live = {str(axis): int(n) for axis, n in dict(mesh.shape).items()}
  saved = {str(axis): int(n) for axis, n in saved_mesh_shape.items()}
  if saved == live:
    return None
  return {'saved_mesh': saved, 'live_mesh': live,
          'processes': world_size(), 'process_index': rank()}

