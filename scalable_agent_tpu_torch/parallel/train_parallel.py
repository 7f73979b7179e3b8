"""The sharded train step, the port's counterpart of
scalable_agent_tpu/parallel/train_parallel.py: the train state and step
over a [data, model] mesh, the SDC sentinel's fingerprints, and where
unroll staging serves.

In the JAX package one jit over the mesh runs the step and XLA inserts
the collectives. Here every rank runs the step on its own rows, and the
collectives are explicit:

- Data parallelism (model axis of width 1): every rank holds a replica
  of the parameters and B/D columns of the batch; the learner sums the
  gradients over the data group (learner.make_train_step_fn with a
  mesh). Replicas start equal because rank 0's parameters are broadcast
  and stay equal because every rank applies the same summed gradient.
- Tensor parallelism (model_parallelism = M > 1): the registry's rules
  (parallel/sharding.py) cut the parameters, and their RMSProp moments,
  over the model axis; at rest each rank holds its blocks (the
  TrainState's tensors). A rank of the port is a process, so this is
  always JAX's cross-process TP: each rank feeds B/(D*M) distinct rows
  (`sharding.shard_batch_over_model`). Two ways to compute, as in JAX
  (`resolve_tp_compute`; its 'auto' takes gathered everywhere):
  - gathered: all-gather the blocks over the model group into the full
    agent, run the replicated step on this rank's rows, sum the
    gradients over all D*M ranks, and apply RMSProp to this rank's
    blocks;
  - sharded: all-gather the rows over the model group (the model-axis
    all-gather of JAX's batch specs), run the forward with the blocks
    (models/torsos.py, models/agent.py: each cut layer computes its
    block of output features, then an all-gather), sum the gradients
    over the data group, and apply RMSProp to the blocks.
  Both give the numbers of the one-rank step on the same global batch.
  gloo has no reduce-scatter, so both are built from all-gather,
  all-reduce and broadcast.

Not carried over: the jaxlib workarounds (the donation self-heal).
"""

import logging
from typing import List

import torch

from scalable_agent_tpu_torch import learner
from scalable_agent_tpu_torch.config import Config
from scalable_agent_tpu_torch.models.torsos import TensorParallel
from scalable_agent_tpu_torch.parallel import sharding
from scalable_agent_tpu_torch.structs import map_structure

log = logging.getLogger('scalable_agent_tpu_torch')


def resolve_tp_compute(config: Config) -> str:
  """'gathered' | 'sharded': how the TP step computes. 'auto' is
  'gathered' on every device, an explicit value wins. This departs from
  JAX, whose 'auto' takes 'sharded' off the CPU: there XLA fuses the
  sharded layers' collectives, here two ranks sharing one card run
  every collective of the sharded forward through the host, and
  chip_smoke's tp phase measures the sharded step at tens of times the
  gathered one's time per row (PERF.md). The choice waits for a
  measurement of NCCL across separate cards."""
  return 'gathered' if config.tp_compute == 'auto' else config.tp_compute


def param_layout(agent, config: Config, mesh, registry=None
                 ) -> sharding.ParamLayout:
  """The agent's parameters laid out over `mesh`'s model axis by the
  config's registry (or `registry`)."""
  if registry is None:
    registry = sharding.from_config(config)
  shapes = {k: tuple(p.shape) for k, p in agent.named_parameters()}
  return sharding.ParamLayout(registry, shapes, mesh)


def _tensor_parallel(config: Config, mesh) -> bool:
  return mesh is not None and mesh.model_size > 1 and (
      config.model_parallelism > 1)


@torch.no_grad()
def make_sharded_train_state(agent, config: Config, mesh,
                             registry=None) -> learner.TrainState:
  """Rank 0's parameters on every rank (one broadcast of a flat buffer),
  then the train state on them. Without tensor parallelism the state
  holds the agent's own parameters, replicated. With it (a model axis
  wider than 1 and model_parallelism > 1) it holds this rank's blocks by
  the registry's rules, copies apart from the agent's (whose full
  tensors the gathered step computes with), and RMSProp's moments
  follow the blocks."""
  params = list(agent.parameters())
  flat = mesh.broadcast_(torch.cat([p.reshape(-1) for p in params]))
  for p, part in zip(params, torch.split(flat, [p.numel() for p in params])):
    p.copy_(part.view_as(p))
  if not _tensor_parallel(config, mesh):
    return learner.make_train_state(agent, config)
  layout = param_layout(agent, config, mesh, registry)
  blocks = {k: layout.local(k, p.detach()).clone().requires_grad_(True)
            for k, p in agent.named_parameters()}
  return learner.TrainState(blocks, learner.rmsprop_init(blocks, config), 0)


def _batch_axis(config: Config):
  return ((sharding.DATA_AXIS, sharding.MODEL_AXIS)
          if sharding.shard_batch_over_model(config) else sharding.DATA_AXIS)


def make_place_batch(config: Config, mesh):
  """`place_batch`: this rank's rows of a global host batch (numpy
  arrays or tensors, an ActorOutput), on its device. Its rows are its
  block of the batch dim over the data axis, or over both axes when
  the batch shards over the model axis too."""
  axis = _batch_axis(config)
  if isinstance(axis, tuple):
    index, count = mesh.world_rank, mesh.world_size
  else:
    index, count = mesh.rank, mesh.size

  def place_batch(host_batch):
    if host_batch.level_name.shape[0] != config.batch_size:
      raise ValueError(f'place_batch takes the global batch of '
                       f'{config.batch_size}, got '
                       f'{host_batch.level_name.shape[0]}')
    specs = sharding.batch_specs(host_batch, axis)
    local = sharding.local_shard(host_batch, specs, index, count, axis)
    return map_structure(lambda x: torch.as_tensor(x).to(mesh.device), local)

  return place_batch


def make_sharded_train_step(agent, config: Config, mesh, example_batch,
                            donate: bool = True, registry=None):
  """The learner step over the mesh; returns (train_step, place_batch).

  `train_step(state, batch)` takes this rank's rows (`place_batch` cuts
  them from a global host batch; a fleet's rank feeds its own) and the
  state of `make_sharded_train_state`. `example_batch` and `donate` are
  accepted for the JAX signature: the batch specs follow each batch's
  structure, and the step already updates the parameters in place. The
  step's `tp_compute` is the mode it runs and its `layout` the
  parameters' sharding.ParamLayout (both None without tensor
  parallelism)."""
  del example_batch, donate
  place_batch = make_place_batch(config, mesh)
  if not _tensor_parallel(config, mesh):
    step = learner.make_train_step_fn(agent, config, mesh=mesh)
    step.tp_compute = step.layout = None
    return step, place_batch
  layout = param_layout(agent, config, mesh, registry)
  mode = resolve_tp_compute(config)
  schedule = learner.make_schedule(config)
  over_model = sharding.shard_batch_over_model(config)
  full_params = dict(agent.named_parameters())
  tp = TensorParallel(mesh.model_index, mesh.model_size, mesh.model_group)
  if mode == 'gathered':
    log.info('TP compute mode: gathered (params stay model-sharded at '
             'rest; each step gathers, computes replicated, applies '
             'RMSProp to this rank\'s blocks)')
  elif mode != 'sharded':
    raise ValueError(f'tp_compute must be auto|sharded|gathered, got '
                     f'{config.tp_compute!r}')

  def gathered_step(state, batch):
    with torch.no_grad():
      for k, full in layout.gather_tree(state.params).items():
        full_params[k].copy_(full)
    total_loss, metrics = learner.loss_fn(
        agent, batch, config, mesh=mesh,
        vtrace_axis=_batch_axis(config))
    grads = dict(zip(full_params, torch.autograd.grad(
        total_loss, list(full_params.values()))))
    with torch.no_grad():
      grads, metrics = learner._all_reduce_sum(
          mesh, grads, metrics, axis=None if over_model else 'data')
      g_norm = learner.global_norm(grads)
      return learner.apply_gradients(state, layout.local_tree(grads),
                                     metrics, config, schedule,
                                     g_norm=g_norm)

  def sharded_step(state, batch):
    rows = gather_rows(mesh, batch) if over_model else batch
    params = state.params
    total_loss, metrics = learner.loss_fn(
        agent, rows, config, mesh=mesh, params=params, tp=tp,
        vtrace_axis=sharding.DATA_AXIS)
    grads = dict(zip(params, torch.autograd.grad(total_loss,
                                                 list(params.values()))))
    with torch.no_grad():
      grads, metrics = learner._all_reduce_sum(mesh, grads, metrics)
      # The global norm: the blocks' squares summed over the model
      # group, the whole tensors' once.
      zero = torch.zeros((), device=mesh.device)
      cut_sq = sum((torch.sum(torch.square(g)) for k, g in grads.items()
                    if layout.cuts[k] is not None), zero).reshape(1)
      whole_sq = sum((torch.sum(torch.square(g)) for k, g in grads.items()
                      if layout.cuts[k] is None), zero)
      mesh.all_reduce_sum_(cut_sq, axis=sharding.MODEL_AXIS)
      g_norm = torch.sqrt(cut_sq[0] + whole_sq)
      return learner.apply_gradients(state, grads, metrics, config,
                                     schedule, g_norm=g_norm)

  step = gathered_step if mode == 'gathered' else sharded_step
  step.tp_compute = mode
  step.layout = layout
  return step, place_batch


def gather_rows(mesh, batch):
  """This rank's rows and those of the other ranks of its model group,
  in model-index order: the data-axis shard the model group computes
  on (trajectory tensors join on dim 1, the rest on dim 0)."""
  specs = sharding.batch_specs(batch)

  def join(x, spec):
    dim = spec.index(sharding.DATA_AXIS)
    boolean = x.dtype == torch.bool
    parts = mesh.all_gather(x.to(torch.uint8) if boolean else x,
                            axis=sharding.MODEL_AXIS)
    out = torch.cat(parts, dim)
    return out.bool() if boolean else out

  return map_structure(join, batch, specs)


@torch.no_grad()
def gather_state(state: learner.TrainState, layout: sharding.ParamLayout
                 ) -> learner.TrainState:
  """The full TrainState from every rank's blocks (a collective over
  the model group): params and RMSProp's moments joined, the count and
  step as they are."""
  opt = state.opt_state
  return learner.TrainState(
      params=layout.gather_tree(state.params),
      opt_state=learner.RMSPropState(
          count=opt.count, nu=layout.gather_tree(opt.nu),
          trace=None if opt.trace is None else layout.gather_tree(opt.trace)),
      update_steps=state.update_steps)


# --- the SDC sentinel ----------------------------------------------------

def supports_sdc_check(config: Config, mesh) -> bool:
  """Whether the cross-replica fingerprint check can run: a mesh with at
  least two data replicas of params the rules do not cut, the batch not
  sharded over the model axis, and (every port mesh being multi-process)
  `sdc_allgather` on."""
  if mesh is None:
    return False
  if sharding.from_config(config).model_sharded:
    return False
  if sharding.shard_batch_over_model(config):
    return False
  if mesh.world_size > 1 and not config.sdc_allgather:
    return False
  return mesh.shape[sharding.DATA_AXIS] >= 2


def make_sdc_fingerprint_fn(mesh):
  """Per-replica param fingerprints for the SDC sentinel; returns
  (fingerprint_fn, num_replicas).

  `fingerprint_fn(params, probe_host=None)` computes
  `learner.param_fingerprint` of this rank's own copy of the params,
  adds this replica's lane of `probe_host` (a [replicas] uint32 vector,
  zeros but for the 'replica_divergence' drill: a replicated copy cannot
  be made to diverge on purpose, so the drill perturbs the detector's
  view instead), and all-gathers the one value per replica over the data
  group. The result, a [replicas] int64 tensor of uint32 values, is the
  same on every rank; the driver reads it one step late. A collective:
  every rank calls it at the same step."""
  num_replicas = int(mesh.shape[sharding.DATA_AXIS])

  def fingerprint_fn(params, probe_host=None):
    fp = learner.param_fingerprint(params)
    if probe_host is not None:
      fp = (fp + int(probe_host[mesh.rank])) & 0xFFFFFFFF
    parts = mesh.all_gather(fp.reshape(1), axis=sharding.DATA_AXIS)
    return torch.cat(parts)

  return fingerprint_fn, num_replicas


# --- unroll staging ------------------------------------------------------

def supports_unroll_staging(config: Config, mesh) -> bool:
  """Whether staging_mode='unroll' serves this topology: no model-axis
  cut of the batch (a rank's rows are then its own unrolls, in one
  arena on its one device). The driver falls back to batch staging
  otherwise."""
  return mesh is None or (not sharding.shard_batch_over_model(config) and
                          mesh.shape[sharding.MODEL_AXIS] == 1)


def unroll_slot_owners(local_devices: List, local_batch: int) -> List:
  """Slot -> owning device of this rank's local batch: slot s lives on
  local_devices[s // (local_batch / len(local_devices))], the contiguous
  layout of the data-axis shards (JAX's placement arithmetic; a rank of
  the port has one device, which owns every slot of its stager)."""
  n_local = len(local_devices)
  if n_local == 0 or local_batch % n_local != 0:
    raise ValueError(
        f'local batch {local_batch} does not divide over '
        f'{n_local} local device(s)')
  per_dev = local_batch // n_local
  return [local_devices[s // per_dev] for s in range(local_batch)]
