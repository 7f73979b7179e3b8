"""The port's mesh, the counterpart of scalable_agent_tpu/parallel/mesh.py
`make_mesh`.

A JAX mesh is a grid of devices with named axes, and one program runs
over all of them. In PyTorch each device is a rank of a process group
running its own copy of the program, so a `Mesh` here is this rank's
view of the grid: its indices on the data and model axes, the axes'
widths, its device, and the process groups of the axes. Rank r of a
group of D*M ranks sits at data index r // M and model index r % M, as
JAX reshapes its device list into a [D, M] grid. Its data group holds
the ranks of its model index (the gradient sum), its model group the
ranks of its data index (the tensor-parallel collectives). An axis of
width 1 has no group: its collectives are no-ops.

A `Mesh` built with an explicit `rank` and `size` and no group runs only
what needs no collectives (the sharded V-trace kernel): that is how the
tests and chip_smoke.py call each rank's kernel in one process.
"""

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.parallel.sharding import DATA_AXIS, MODEL_AXIS


@dataclasses.dataclass(frozen=True)
class Mesh:
  rank: int                # this rank's index on the data axis
  size: int                # ranks on the data axis
  device: torch.device     # this rank's device
  group: Optional[dist.ProcessGroup] = None  # the data axis' group
  model_index: int = 0     # this rank's index on the model axis
  model_size: int = 1      # ranks on the model axis
  model_group: Optional[dist.ProcessGroup] = None
  # Every rank of the mesh (None: `group`, which holds them all when the
  # model axis has width 1).
  world_group: Optional[dist.ProcessGroup] = None

  def __post_init__(self):
    if not 0 <= self.rank < self.size:
      raise ValueError(f'rank {self.rank} out of range for size '
                       f'{self.size}')
    if not 0 <= self.model_index < self.model_size:
      raise ValueError(f'model index {self.model_index} out of range for '
                       f'model size {self.model_size}')

  @property
  def shape(self) -> Dict[str, int]:
    return {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}

  @property
  def world_rank(self) -> int:
    """This rank's place in the group: data index * M + model index."""
    return self.rank * self.model_size + self.model_index

  @property
  def world_size(self) -> int:
    return self.size * self.model_size

  def _group_of(self, axis):
    """(group, width) of `axis`: 'data', 'model' or None (every rank)."""
    if axis == DATA_AXIS:
      group, width = self.group, self.size
    elif axis == MODEL_AXIS:
      group, width = self.model_group, self.model_size
    elif axis is None:
      group, width = self.world_group or self.group, self.world_size
    else:
      raise ValueError(f'unknown mesh axis {axis!r}')
    if width > 1 and group is None:
      raise RuntimeError(f'a collective over {axis or "the mesh"} needs '
                         'the mesh\'s process group; this mesh was built '
                         'with an explicit rank only')
    return group, width

  def all_reduce_sum_(self, tensor: torch.Tensor,
                      axis: Optional[str] = DATA_AXIS) -> torch.Tensor:
    """Sum `tensor` over the ranks of `axis` (None: every rank), in
    place; returns it."""
    group, width = self._group_of(axis)
    if width > 1:
      dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor

  def all_gather(self, tensor: torch.Tensor,
                 axis: Optional[str] = MODEL_AXIS) -> List[torch.Tensor]:
    """Every rank's `tensor` along `axis`, in index order."""
    group, width = self._group_of(axis)
    if width == 1:
      return [tensor]
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(width)]
    dist.all_gather(parts, tensor, group=group)
    return parts

  def broadcast_(self, tensor: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `tensor` (a rank of the group) on every rank of the
    mesh, in place; returns it."""
    group, width = self._group_of(None)
    if width > 1:
      dist.broadcast(tensor, src=src, group=group)
    return tensor


def make_mesh(devices, model_parallelism: int = 1) -> Mesh:
  """The [D, M] mesh over the joined process group, one rank per
  device; `devices` is this rank's device. Every rank builds the axes'
  groups with `dist.new_group` in the same order: the data groups (one
  per model index), then the model groups (one per data index); an axis
  of width 1 builds none. Without a group the mesh is one rank, and a
  model axis wider than 1 raises, as a model_parallelism that does not
  divide the ranks does (JAX's ValueError)."""
  device = torch.device(devices)
  world = distributed.world_size()
  if model_parallelism < 1 or world % model_parallelism:
    raise ValueError(f'{world} devices not divisible by '
                     f'model_parallelism={model_parallelism}')
  if not distributed.is_initialized():
    return Mesh(rank=0, size=1, device=device)
  rank = dist.get_rank()
  width = model_parallelism
  data_size = world // width
  if width == 1:
    return Mesh(rank=rank, size=world, device=device,
                group=dist.group.WORLD)
  data_group = model_group = None
  if data_size > 1:
    for m in range(width):
      group = dist.new_group([d * width + m for d in range(data_size)])
      if m == rank % width:
        data_group = group
  for d in range(data_size):
    group = dist.new_group([d * width + m for m in range(width)])
    if d == rank // width:
      model_group = group
  return Mesh(rank=rank // width, size=data_size, device=device,
              group=data_group, model_index=rank % width, model_size=width,
              model_group=model_group, world_group=dist.group.WORLD)
