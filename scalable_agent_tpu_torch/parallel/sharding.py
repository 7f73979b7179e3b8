"""The sharding registry, the port of scalable_agent_tpu/parallel/
sharding.py: partition rules over the JAX package's parameter paths, the
specs they give each parameter, the optimizer state and the learner
batch, and where each rank's block of a tensor lies.

A spec is the JAX `PartitionSpec` as a plain tuple: one entry per dim,
the mesh axis (or tuple of axes) the dim is split over, or None;
`spec_str` spells it as JAX does, so the manifest a checkpoint records
and its digest are JAX's. A dim split over an axis of width n is n equal
contiguous blocks, block i on the rank at index i of that axis.

The rules are JAX's regexes, character for character, matched against
JAX's parameter paths ('params/DeepResNetTorso_0/Conv_0/kernel'). The
port's parameters have other names and layouts (OIHW convolutions,
[out, in] linear weights, the LSTM's four gates fused into one tensor):
`convert.jax_leaves` maps each port name back to the JAX leaves it
holds (the inverse of convert.params_from_jax), and a spec found on a
JAX leaf is moved onto the port tensor's dims (`port_spec`). This module
knows rules and dims, not the model's module names. A port tensor
fusing several JAX leaves (the LSTM gates) is cut gate by gate: each
gate's block is split as the JAX leaf is, and a rank holds its piece of
every gate (`Cut.blocks`).

`ParamLayout` binds the registry to a mesh and a model's full shapes:
which parameters are cut, how, and this rank's block of each; it also
gathers the blocks back over the mesh's model group.
"""

import math
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from scalable_agent_tpu_torch import convert
from scalable_agent_tpu_torch.parallel import distributed
from scalable_agent_tpu_torch.structs import ActorOutput, map_structure

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

Spec = Tuple  # entries: None, an axis name, or a tuple of axis names

REPLICATED: Spec = ()


class ShardingRuleError(ValueError):
  """A param path no rule matches: silence is never a sharding
  decision."""


class ShardingLayoutError(ShardingRuleError):
  """A resolved spec the target mesh cannot honor: the axis is not on
  the mesh, the cut dim is out of rank, or the dim does not divide the
  axis width. The strict cross-topology restore refuses with it."""


def spec_str(spec: Spec) -> str:
  """The spec as JAX's `str(PartitionSpec(...))` spells it."""
  return 'PartitionSpec' + repr(tuple(spec))


def _axes(entry) -> Tuple[str, ...]:
  if entry is None:
    return ()
  return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _mesh_shape(mesh) -> Dict[str, int]:
  """A mesh's {axis: width}; a plain dict stands for itself."""
  return dict(mesh if isinstance(mesh, dict) else mesh.shape)


def shard_batch_over_model(config) -> bool:
  """Whether the learner batch shards over the model axis too. In JAX:
  when TP spans processes. A rank of the port is a process, so: whenever
  model_parallelism > 1 and the group has more than one rank. Each rank
  then feeds B/(D*M) distinct rows."""
  return config.model_parallelism > 1 and distributed.world_size() > 1


def needs_host_local_params(config, mesh) -> bool:
  """Whether the inference server must serve a full copy of the params,
  gathered over the model group at each publish (a collective on the
  learner's lockstep path): whenever params are cut across ranks."""
  return mesh is not None and shard_batch_over_model(config)


# --- rule sets (JAX's, verbatim) ----------------------------------------

# Megatron-style cut: Dense kernels, the OptimizedLSTMCell gate kernels
# and Conv kernels on their output-feature dim, with their biases; the
# named heads (policy_logits, baseline) fall to the catch-all.
_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r'.*Dense_\d+/kernel$', (None, MODEL_AXIS)),
    (r'.*Dense_\d+/bias$', (MODEL_AXIS,)),
    (r'.*OptimizedLSTMCell_\d+/[ih][ifgo]/kernel$', (None, MODEL_AXIS)),
    (r'.*OptimizedLSTMCell_\d+/[ih][ifgo]/bias$', (MODEL_AXIS,)),
    (r'.*Conv_\d+/kernel$', (None, None, None, MODEL_AXIS)),
    (r'.*Conv_\d+/bias$', (MODEL_AXIS,)),
    (r'.*', REPLICATED),
)

RULE_SETS: Dict[str, Tuple[Tuple[str, Spec], ...]] = {
    'replicated': ((r'.*', REPLICATED),),
    'megatron': _TP_RULES,
}


def _shape(value) -> Tuple[int, ...]:
  return tuple(int(n) for n in getattr(value, 'shape', value))


def port_spec(spec: Spec, leaf: convert.JaxLeaf, ndim: int) -> Spec:
  """A JAX leaf's spec moved onto the port tensor's dims."""
  if not any(e is not None for e in spec):
    return REPLICATED
  out = [None] * ndim
  for jax_dim, entry in enumerate(spec):
    if entry is not None:
      out[leaf.dims[jax_dim]] = entry
  return tuple(out)


class Cut(NamedTuple):
  """How a port tensor splits over the model axis: along `dim`, each of
  its `blocks` equal gate blocks into `count` pieces."""
  dim: int
  blocks: int
  count: int


def take_block(full: torch.Tensor, cut: Optional[Cut], index: int):
  """Rank `index`'s block of `full` (a copy of it, contiguous); the whole
  tensor when `cut` is None."""
  if cut is None:
    return full
  parts = full.chunk(cut.blocks, cut.dim)
  return torch.cat([p.chunk(cut.count, cut.dim)[index] for p in parts],
                   cut.dim).contiguous()


def join_blocks(blocks: Sequence[torch.Tensor], cut: Optional[Cut]):
  """The full tensor from every rank's block, in rank order."""
  if cut is None:
    return blocks[0]
  per_rank = [b.chunk(cut.blocks, cut.dim) for b in blocks]
  return torch.cat([per_rank[m][g] for g in range(cut.blocks)
                    for m in range(cut.count)], cut.dim)


class ShardingRegistry:
  """Ordered partition rules and every sharding decision derived from
  them, after the JAX class. Resolution (`spec_for`, `param_specs`,
  `opt_specs`, `state_specs`) is mesh-independent; `describe`,
  `layout_violations`, `check_layout` and `cuts` take a mesh (or its
  {axis: width} dict) and apply the divisibility guard."""

  def __init__(self, rules: Sequence[Tuple[str, Spec]],
               rule_set: str = '<custom>'):
    if not rules:
      raise ValueError('a sharding registry needs at least one rule '
                       '(a catch-all (".*", PartitionSpec()) is the '
                       'minimal pure-DP set)')
    self.rule_set = rule_set
    self.rules = tuple((re.compile(pattern), tuple(spec))
                       for pattern, spec in rules)

  @property
  def model_sharded(self) -> bool:
    """Whether any rule cuts over the model axis."""
    return any(MODEL_AXIS in {a for e in spec for a in _axes(e)}
               for _, spec in self.rules)

  def spec_for(self, path: str, leaf) -> Spec:
    """The first matching rule's spec for one JAX leaf (a tensor or a
    shape). Scalars and one-element leaves are replicated before the
    rules run; an unmatched path raises ShardingRuleError."""
    shape = _shape(leaf)
    if len(shape) == 0 or math.prod(shape) == 1:
      return REPLICATED
    for pattern, spec in self.rules:
      if pattern.search(path):
        return spec
    raise ShardingRuleError(
        f'no partition rule matches param {path!r} (rule set '
        f'{self.rule_set!r}) — every param must resolve; add a rule '
        'or end the set with a catch-all (".*", PartitionSpec())')

  def _port_specs(self, params, mesh=None) -> Dict[str, Spec]:
    names = list(params)
    out = {}
    for name, value in params.items():
      shape = _shape(value)
      leaves, _ = convert.jax_leaves(name, shape, names)
      specs = set()
      for leaf in leaves:
        spec = self.spec_for(leaf.path, leaf.shape)
        if mesh is not None:
          spec = self._guard(spec, leaf.shape, mesh)
        specs.add(port_spec(spec, leaf, len(shape)))
      if len(specs) != 1:
        raise ShardingRuleError(
            f'the JAX leaves of port parameter {name!r} resolve '
            f'different specs {sorted(map(str, specs))}: the port holds '
            'them in one tensor')
      out[name] = specs.pop()
    return out

  def param_specs(self, params) -> Dict[str, Spec]:
    """{port name: spec over the port tensor's dims} of a port parameter
    dict ({name: tensor or shape})."""
    return self._port_specs(params)

  def opt_specs(self, opt_state, param_specs):
    """The RMSProp state's specs: the moments (nu, and the momentum
    trace) take their params' specs, the count is replicated."""
    return type(opt_state)(
        count=REPLICATED, nu=dict(param_specs),
        trace=None if opt_state.trace is None else dict(param_specs))

  def state_specs(self, state):
    """A TrainState of specs: params by the rules, the optimizer state
    by `opt_specs`, the step counter replicated."""
    pspecs = self.param_specs(state.params)
    return type(state)(params=pspecs,
                       opt_state=self.opt_specs(state.opt_state, pspecs),
                       update_steps=REPLICATED)

  def describe(self, params, mesh=None) -> Dict[str, str]:
    """{JAX path: spec string}: the manifest a checkpoint records. With a
    mesh the divisibility guard is applied first."""
    out = {}
    for path, shape in convert.jax_view(params).items():
      spec = self.spec_for(path, shape)
      if mesh is not None:
        spec = self._guard(spec, shape, mesh)
      out[path] = spec_str(spec)
    return out

  def _guard(self, spec: Spec, shape, mesh) -> Spec:
    """Replicated when a cut does not divide its dim (JAX's `_guard`)."""
    if not any(e is not None for e in spec):
      return spec
    width = int(_mesh_shape(mesh).get(MODEL_AXIS, 1))
    for dim, entry in enumerate(spec):
      if entry is not None and (dim >= len(shape) or shape[dim] % width):
        return REPLICATED
    return spec

  def layout_violations(self, params, mesh) -> List[Tuple[str, str]]:
    """[(JAX path, reason)] for every leaf whose resolved spec `mesh`
    cannot honor as resolved."""
    mesh_shape = _mesh_shape(mesh)
    out = []
    for path, shape in convert.jax_view(params).items():
      spec = self.spec_for(path, shape)
      for dim, entry in enumerate(spec):
        if entry is None:
          continue
        axes = _axes(entry)
        missing = sorted(set(axes) - set(mesh_shape))
        if missing:
          out.append((path, (
              f'spec {spec_str(spec)} names mesh axis {missing[0]!r} but '
              f'the target mesh only has {mesh_shape}')))
          continue
        width = 1
        for a in axes:
          width *= int(mesh_shape[a])
        if dim >= len(shape):
          out.append((path, (
              f'spec {spec_str(spec)} cuts dim {dim} but the leaf is rank '
              f'{len(shape)} {shape}')))
        elif shape[dim] % width:
          out.append((path, (
              f'dim {dim} (size {shape[dim]}) does not divide mesh axis '
              f'{"*".join(axes)} width {width} (spec {spec_str(spec)})')))
    return out

  def check_layout(self, params, mesh, what: str = 'state',
                   saved_specs: Optional[Dict[str, str]] = None) -> None:
    """Raise ShardingLayoutError unless every leaf's resolved spec binds
    on `mesh` as resolved; a leaf the save recorded as replicated
    (`saved_specs`, the manifest's table) is exempt."""
    replicated = spec_str(REPLICATED)
    violations = [
        (path, reason)
        for path, reason in self.layout_violations(params, mesh)
        if saved_specs is None or saved_specs.get(path) != replicated]
    if not violations:
      return
    shown = '\n'.join(f'  - {p}: {r}' for p, r in violations[:8])
    more = ('' if len(violations) <= 8
            else f'\n  ... and {len(violations) - 8} more')
    raise ShardingLayoutError(
        f'{len(violations)} {what} leaf/leaves cannot be laid out on the '
        f'target mesh {_mesh_shape(mesh)} under rule set '
        f'{self.rule_set!r}:\n{shown}{more}\n'
        'Fix the target topology (every cut dim must divide its axis '
        'width), pick a rule set the mesh can honor, or restore '
        'non-strict to accept replicated degradation.')

  def bound_specs(self, params, mesh) -> Dict[str, Spec]:
    """{port name: port spec} after the guard on `mesh`: what holds."""
    return self._port_specs(params, mesh)

  def cuts(self, params, mesh) -> Dict[str, Optional[Cut]]:
    """{port name: its Cut over the model axis of `mesh`, or None}."""
    names = list(params)
    width = int(_mesh_shape(mesh).get(MODEL_AXIS, 1))
    out = {}
    for name, spec in self.bound_specs(params, mesh).items():
      dims = [d for d, e in enumerate(spec) if MODEL_AXIS in _axes(e)]
      if not dims or width == 1:
        out[name] = None
        continue
      _, blocks = convert.jax_leaves(name, _shape(params[name]), names)
      out[name] = Cut(dims[0], blocks, width)
    return out

  def batch_specs(self, batch: ActorOutput,
                  shard_over_model: bool = False) -> ActorOutput:
    """Specs of a learner batch: trajectory tensors [T+1, B, ...] on dim
    1, `level_name` and `agent_state` [B, ...] on dim 0, over the data
    axis, or over both axes with `shard_over_model`."""
    axis = (DATA_AXIS, MODEL_AXIS) if shard_over_model else DATA_AXIS
    return batch_specs(batch, axis)


def from_config(config) -> ShardingRegistry:
  """The registry a config declares: `sharding_rules` names a RULE_SETS
  entry; 'auto' is 'megatron' when a model axis exists to cut
  (model_parallelism > 1), else 'replicated'."""
  name = config.sharding_rules
  if name == 'auto':
    name = 'megatron' if config.model_parallelism > 1 else 'replicated'
  if name not in RULE_SETS:
    raise ValueError(
        f'unknown sharding_rules {name!r}; known: '
        f"auto, {', '.join(sorted(RULE_SETS))}")
  return ShardingRegistry(RULE_SETS[name], rule_set=name)


class ParamLayout:
  """A model's parameters laid out over the model axis of a mesh: the
  registry's cuts for the full shapes (`full_shapes`, {name: shape}),
  this rank's model index, and the collectives that join the blocks.
  With a model axis of width 1 every cut is None."""

  def __init__(self, registry: ShardingRegistry, full_shapes, mesh):
    self.registry = registry
    self.mesh = mesh
    self.full_shapes = {k: _shape(v) for k, v in full_shapes.items()}
    self.cuts = registry.cuts(self.full_shapes, mesh)
    self.index = getattr(mesh, 'model_index', 0)
    self.count = int(_mesh_shape(mesh).get(MODEL_AXIS, 1))

  @property
  def cut_any(self) -> bool:
    return any(c is not None for c in self.cuts.values())

  def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's block of parameter `name` (or of a moment of it)."""
    return take_block(full, self.cuts[name], self.index)

  def local_tree(self, tree: Dict[str, torch.Tensor]):
    return {k: self.local(k, v) for k, v in tree.items()}

  @torch.no_grad()
  def gather_tree(self, tree: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Full tensors from every rank's blocks of `tree` ({name: block},
    this rank's), in one all-gather over the model group; the uncut
    tensors are this rank's own. A collective: every rank of the model
    group calls it."""
    cut = [k for k in tree if self.cuts[k] is not None]
    out = dict(tree)
    if not cut:
      return out
    flat = torch.cat([tree[k].reshape(-1) for k in cut])
    parts = self.mesh.all_gather(flat, axis=MODEL_AXIS)
    sizes = [tree[k].numel() for k in cut]
    per_rank = [torch.split(p, sizes) for p in parts]
    for i, k in enumerate(cut):
      out[k] = join_blocks([per_rank[m][i].view_as(tree[k])
                            for m in range(self.count)], self.cuts[k])
    return out


# --- batch specs and blocks ----------------------------------------------

def spec_time_major(ndim: int, axis=DATA_AXIS) -> Spec:
  """[T, B, ...] tensors: batch dim 1 over `axis`."""
  return (None, axis) + (None,) * (ndim - 2)


def spec_batch_lead(ndim: int, axis=DATA_AXIS) -> Spec:
  """[B, ...] tensors: batch dim 0 over `axis`."""
  return (axis,) + (None,) * (ndim - 1)


def batch_specs(batch: ActorOutput, axis=DATA_AXIS) -> ActorOutput:
  """Specs of a learner batch, leaf by leaf: trajectory tensors
  [T+1, B, ...] on dim 1, `level_name` and `agent_state` [B, ...] on
  dim 0, over `axis` (an axis name or a tuple of them)."""
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


def local_shard(tree, specs, index: int, count: int, axis=DATA_AXIS):
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
