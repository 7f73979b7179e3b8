"""The data-parallel train step, the port's counterpart of
scalable_agent_tpu/parallel/train_parallel.py (`make_sharded_train_state`,
`make_sharded_train_step`).

In the JAX package one jit over the mesh runs the step: the batch is
sharded on the data axis, the parameters are replicated, and XLA inserts
the gradient psum. Here every rank runs the step on its own block of the
batch, with its own replica of the parameters, and the learner sums the
gradients over the group (learner.make_train_step_fn with a mesh). The
replicas start equal because rank 0's parameters are broadcast, and stay
equal because every rank applies the same summed gradient.

Not carried over: the jaxlib workarounds (the donation self-heal, the TP
`gathered` mode), and, until the fleet slice, the SDC fingerprint and the
unroll staging.
"""

import torch

from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.structs import map_structure


@torch.no_grad()
def make_sharded_train_state(agent, config: Config, mesh
                             ) -> learner.TrainState:
  """Rank 0's parameters on every rank (one broadcast of a flat buffer),
  then the train state on them: the optimizer state follows the
  parameters, as replicated as they are."""
  params = list(agent.parameters())
  flat = mesh.broadcast_(torch.cat([p.reshape(-1) for p in params]))
  for p, part in zip(params, torch.split(flat, [p.numel() for p in params])):
    p.copy_(part.view_as(p))
  return learner.make_train_state(agent, config)


def make_sharded_train_step(agent, config: Config, mesh, example_batch,
                            donate: bool = True):
  """The learner step over the mesh; returns (train_step, place_batch).

  `place_batch` puts this rank's block of columns of a global host
  batch (numpy arrays or tensors, an ActorOutput) on this rank's device.
  `example_batch` fixes the structure and the batch specs. `donate` is
  accepted for the JAX signature: the step already updates the
  parameters in place."""
  del donate
  specs = sharding.batch_specs(example_batch)

  def place_batch(host_batch):
    if host_batch.level_name.shape[0] != config.batch_size:
      raise ValueError(f'place_batch takes the global batch of '
                       f'{config.batch_size}, got '
                       f'{host_batch.level_name.shape[0]}')
    local = sharding.local_shard(host_batch, specs, mesh.rank, mesh.size)
    return map_structure(lambda x: torch.as_tensor(x).to(mesh.device), local)

  return learner.make_train_step_fn(agent, config, mesh=mesh), place_batch
