"""Which dim of a tensor is the batch, and this rank's block of it: the
data-axis subset of scalable_agent_tpu/parallel/sharding.py.

A spec is the JAX `PartitionSpec` as a plain tuple: one entry per dim,
the mesh axis the dim is split over or None. Time-major trajectory
tensors [T+1, B, ...] split dim 1, [B, ...] tensors dim 0. Each rank
holds one contiguous block of B / D columns, rank r the r-th, as JAX
lays out a dim sharded over a D-device axis.

The partition-rule registry and its `megatron` rule set cut parameters
over the model axis (tensor parallelism): they come with ROADMAP A5b.
"""

from typing import Optional, Tuple

from scalable_agent_tpu_torch.structs import ActorOutput, map_structure

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

Spec = Tuple[Optional[str], ...]


def spec_time_major(ndim: int, axis: str = DATA_AXIS) -> Spec:
  """[T, B, ...] tensors: batch dim 1 over `axis`."""
  return (None, axis) + (None,) * (ndim - 2)


def spec_batch_lead(ndim: int, axis: str = DATA_AXIS) -> Spec:
  """[B, ...] tensors: batch dim 0 over `axis`."""
  return (axis,) + (None,) * (ndim - 1)


def batch_specs(batch: ActorOutput, axis: str = DATA_AXIS) -> ActorOutput:
  """Specs of a learner batch, leaf by leaf: trajectory tensors
  [T+1, B, ...] on dim 1, `level_name` and `agent_state` [B, ...] on
  dim 0."""
  lead = lambda x: spec_batch_lead(x.ndim, axis)  # noqa: E731
  traj = lambda x: spec_time_major(x.ndim, axis)  # noqa: E731
  return ActorOutput(
      level_name=lead(batch.level_name),
      agent_state=map_structure(lead, batch.agent_state),
      env_outputs=map_structure(traj, batch.env_outputs),
      agent_outputs=map_structure(traj, batch.agent_outputs))


def shard_range(size: int, index: int, count: int) -> Tuple[int, int]:
  """[start, stop) of block `index` of `count` of a dim of `size`;
  raises ValueError when `count` does not divide `size`."""
  if size % count:
    raise ValueError(f'a dim of {size} does not split into {count} '
                     'equal blocks')
  block = size // count
  return index * block, (index + 1) * block


def local_shard(tree, specs, index: int, count: int, axis: str = DATA_AXIS):
  """Block `index` of `count` of every leaf of `tree` along the dim its
  spec (in `specs`, the same structure) puts on `axis`: a view, no copy.
  A leaf whose spec does not name `axis` is kept whole."""

  def take(x, spec):
    if axis not in spec:
      return x
    dim = spec.index(axis)
    start, stop = shard_range(x.shape[dim], index, count)
    return x[(slice(None),) * dim + (slice(start, stop),)]

  return map_structure(take, tree, specs)
