"""The port's mesh, the counterpart of scalable_agent_tpu/parallel/mesh.py
`make_mesh`.

A JAX mesh is a grid of devices with named axes, and one program runs
over all of them. In PyTorch each device is a rank of a process group
running its own copy of the program, so a `Mesh` here is this rank's
view of the grid: its group, its index on the data axis, the axes'
sizes and its device. Only the data axis is cut; the model axis has
size 1 (tensor parallelism is ROADMAP A5b).

A `Mesh` built with an explicit `rank` and `size` and no group runs only
what needs no collectives (the sharded V-trace kernel): that is how the
tests and chip_smoke.py call each rank's kernel in one process.
"""

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS


@dataclasses.dataclass(frozen=True)
class Mesh:
  rank: int                # this rank's index on the data axis
  size: int                # ranks on the data axis
  device: torch.device     # this rank's device
  group: Optional[dist.ProcessGroup] = None  # None: no collectives

  def __post_init__(self):
    if not 0 <= self.rank < self.size:
      raise ValueError(f'rank {self.rank} out of range for size '
                       f'{self.size}')

  @property
  def shape(self) -> Dict[str, int]:
    return {DATA_AXIS: self.size, MODEL_AXIS: 1}

  def _collective(self, what: str):
    if self.group is None and self.size > 1:
      raise RuntimeError(f'{what} needs the mesh\'s process group; this '
                         'mesh was built with an explicit rank only')
    return self.size > 1

  def all_reduce_sum_(self, tensor: torch.Tensor) -> torch.Tensor:
    """Sum `tensor` over the ranks, in place; returns it."""
    if self._collective('all_reduce'):
      dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=self.group)
    return tensor

  def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `tensor` on every rank, in place; returns it."""
    if self._collective('broadcast'):
      dist.broadcast(tensor, src=src, group=self.group)
    return tensor


def make_mesh(devices, model_parallelism: int = 1) -> Mesh:
  """The mesh over the joined process group, one rank per device;
  `devices` is this rank's device. Without a group the mesh is one
  rank."""
  if model_parallelism != 1:
    raise NotImplementedError(
        f'model_parallelism={model_parallelism}: tensor parallelism is '
        'not in the PyTorch port yet (ROADMAP A5b)')
  device = torch.device(devices)
  if not distributed.is_initialized():
    return Mesh(rank=0, size=1, device=device)
  return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
              device=device, group=dist.group.WORLD)
