"""Run construction shared by the port's entry points.

So far `build_agent` and `choose_mesh` (scalable_agent_tpu/driver.py) and
the device rule of the entry points: the fleet training loop and
evaluation are later slices (ROADMAP.md).
"""

import logging

import torch

from scalable_agent_tpu_torch.config import COMPUTE_DTYPES, Config
from scalable_agent_tpu_torch.models import ImpalaAgent
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel import mesh as mesh_lib

log = logging.getLogger('scalable_agent_tpu_torch')


def resolve_device(device) -> torch.device:
  """The device an entry point runs on. 'cuda' with no CUDA raises: the
  port never falls back to the CPU unless the caller asks for it."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'device {device} requested but torch.cuda.is_available() is '
        "False; pass device='cpu' to run on the CPU")
  return device


def build_agent(config: Config, num_actions: int) -> ImpalaAgent:
  """The config's agent, on the CPU with PyTorch's default init: callers
  initialise it (models.init_params) and move it to their device. Its
  parameters are float32 whatever `config.compute_dtype` says."""
  return ImpalaAgent(num_actions=num_actions,
                     frame_shape=(config.height, config.width, 3),
                     torso=config.torso,
                     dtype=COMPUTE_DTYPES[config.compute_dtype])


def choose_mesh(config: Config, device):
  """A mesh over the joined group's ranks, on this rank's `device`, when
  the batch can shard; None means one rank's plain training (the
  reference's single-machine mode).

  As in the JAX driver: one rank (and model_parallelism 1, the only
  width the port has) gives None; a batch the ranks do not divide warns
  and gives None on one host, where every rank then trains the same
  replica, and raises across hosts (as the group's declared topology
  says), where the replicas would never meet."""
  ranks = distributed.world_size()
  if ranks == 1 and config.model_parallelism == 1:
    return None
  if config.batch_size % ranks:
    topology = distributed.declared_topology(config)
    if topology is not None and topology.num_nodes > 1:
      raise ValueError(
          f'batch_size={config.batch_size} not divisible by the '
          f'{ranks} ranks; the unsharded fallback is only safe on one '
          'host')
    log.warning('batch_size %d not divisible by the %d ranks; falling '
                'back to unsharded training on each rank',
                config.batch_size, ranks)
    return None
  return mesh_lib.make_mesh(device, model_parallelism=config.model_parallelism)
