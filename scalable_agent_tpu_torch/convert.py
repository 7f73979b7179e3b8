"""Flax parameters <-> the port's `state_dict`.

`params_from_jax` takes the JAX agent's parameter tree as nested dicts of
numpy arrays (`jax.device_get(params)` does that) and returns a state_dict
that `ImpalaAgent.load_state_dict` accepts:

- Conv kernels HWIO -> OIHW.
- Dense kernels [in, out] -> Linear weights [out, in]. The torso's Dense
  rows need no permutation: the port flattens NHWC, as Flax does.
- OptimizedLSTMCell (the core's and the instruction encoder's):
  `weight_ih = stack(ii, if, ig, io).T`, `weight_hh = stack(hi, hf, hg,
  ho).T`, `bias_hh` the hidden kernels' biases in the same gate order,
  `bias_ih = 0` (Flax has one bias).
- Embed: the [1001, 20] table as it is.
- ConvTranspose kernels [kh, kw, in, out] -> the OIHW weight of the
  correlation Flax computes (unreal.py), the conv kernels' rule.
- The PopArt value head `baseline` [256, K] -> [K, 256], a Dense.

`train_state_from_jax` carries the rest of a JAX TrainState (the PopArt
statistics, IMPACT's target network and its statistics) into a port
TrainState.

`jax_leaves` is the inverse, name by name: the JAX leaves (paths,
shapes, dim order) a port parameter holds. The sharding registry matches
JAX's rules against those paths. Both directions walk one table of the
torso's modules (`_torso_modules`).

This module imports numpy and torch only; the tests hand it the tree.
"""

from typing import Dict, Iterator, List, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

_GATES = ('i', 'f', 'g', 'o')


def _tensor(x) -> torch.Tensor:
  return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def conv_from_jax(kernel, bias) -> Tuple[torch.Tensor, torch.Tensor]:
  """A Flax conv's HWIO kernel and bias -> the port's OIHW weight and
  bias (float32 CPU tensors)."""
  return (_tensor(np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))),
          _tensor(bias))


def _conv(prefix: str, p: Mapping, out: Dict):
  out[prefix + '.weight'], out[prefix + '.bias'] = conv_from_jax(
      p['kernel'], p['bias'])


def _dense(prefix: str, p: Mapping, out: Dict):
  out[prefix + '.weight'] = _tensor(np.asarray(p['kernel']).T)
  out[prefix + '.bias'] = _tensor(p['bias'])


def _torso_modules(deep: bool, num_sections: int, per_section: int
                   ) -> Iterator[Tuple[str, str]]:
  """(port module, JAX module path inside the torso) of every torso
  layer: the deep torso's section convs and the two convs of each
  residual block (JAX numbers the blocks across sections), or the
  shallow torso's two convs; then the Dense."""
  if deep:
    for s in range(num_sections):
      yield f'torso.sections.{s}.conv', f'Conv_{s}'
      for j in range(per_section):
        block = f'ResidualBlock_{s * per_section + j}'
        prefix = f'torso.sections.{s}.blocks.{j}'
        yield prefix + '.conv0', block + '/Conv_0'
        yield prefix + '.conv1', block + '/Conv_1'
  else:
    yield 'torso.conv0', 'Conv_0'
    yield 'torso.conv1', 'Conv_1'
  yield 'torso.linear', 'Dense_0'


def _torso(name: str, p: Mapping, out: Dict):
  if name.startswith('DeepResNetTorso'):
    num_sections = sum(1 for k in p if k.startswith('Conv_'))
    blocks = sum(1 for k in p if k.startswith('ResidualBlock_'))
    modules = _torso_modules(True, num_sections, blocks // num_sections)
  elif name.startswith('ShallowTorso'):
    modules = _torso_modules(False, 0, 0)
  else:
    raise ValueError(f'unknown torso in the Flax tree: {name!r}')
  for prefix, path in modules:
    leaf = p
    for part in path.split('/'):
      leaf = leaf[part]
    (_dense if prefix == 'torso.linear' else _conv)(prefix, leaf, out)


def _lstm(prefix: str, cell: Mapping, out: Dict):
  out[prefix + '.weight_ih'] = _tensor(np.concatenate(
      [np.asarray(cell['i' + g]['kernel']) for g in _GATES], axis=1).T)
  out[prefix + '.weight_hh'] = _tensor(np.concatenate(
      [np.asarray(cell['h' + g]['kernel']) for g in _GATES], axis=1).T)
  out[prefix + '.bias_hh'] = _tensor(np.concatenate(
      [np.asarray(cell['h' + g]['bias']) for g in _GATES]))
  out[prefix + '.bias_ih'] = torch.zeros_like(out[prefix + '.bias_hh'])


# The pixel-control head's layers: (port module, Flax module, kind).
_PIXEL_CONTROL = (('pc_fc', 'dense'), ('pc_deconv', 'conv'),
                  ('pc_value', 'conv'), ('pc_advantage', 'conv'))


def params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
  """Map the Flax ImpalaAgent tree ({'params': {...}} or its inside) to
  the port's ImpalaAgent state_dict (float32 CPU tensors)."""
  tree = flax_params.get('params', flax_params)
  out = {}
  torsos = [k for k in tree if k.endswith('Torso_0')]
  if len(torsos) != 1:
    raise ValueError(f'expected one torso in the Flax tree, got {torsos}')
  _torso(torsos[0], tree[torsos[0]], out)
  if 'InstructionEncoder_0' in tree:
    encoder = tree['InstructionEncoder_0']
    out['instruction.embed.weight'] = _tensor(
        encoder['Embed_0']['embedding'])
    _lstm('instruction.cell', encoder['OptimizedLSTMCell_0'], out)
  _lstm('core', tree['_ResetCore_0']['OptimizedLSTMCell_0'], out)
  _dense('policy_logits', tree['policy_logits'], out)
  _dense('baseline', tree['baseline'], out)
  if 'pixel_control' in tree:
    for name, kind in _PIXEL_CONTROL:
      (_dense if kind == 'dense' else _conv)(
          f'pixel_control.{name}', tree['pixel_control'][name], out)
  return out


def _popart_from_jax(popart):
  """A JAX PopArtState (or None) as the port's, float32 CPU tensors."""
  if popart is None:
    return None
  from scalable_agent_tpu_torch import popart as popart_lib
  return popart_lib.PopArtState(*(_tensor(np.asarray(x)) for x in popart))


def train_state_from_jax(jax_state, state):
  """The port TrainState `state` (its structure: the same config) with
  a JAX TrainState's values (numpy leaves: `jax.device_get` of it):
  params, RMSProp's nu (and trace) and count, the step, the PopArt
  statistics and IMPACT's target network and statistics, copied into
  `state`'s own tensors (learner.load_state_). optax's rmsprop state is
  a chain of states with fields `nu`, `count` and `trace`."""
  from scalable_agent_tpu_torch import learner
  nu = trace = count = None
  for node in _flat(jax_state.opt_state):
    fields = getattr(node, '_fields', ())
    nu = node.nu if 'nu' in fields else nu
    trace = node.trace if 'trace' in fields else trace
    count = node.count if 'count' in fields else count
  if state.opt_state.trace is None:
    trace = None  # optax keeps a zero trace at momentum 0; the port none
  popart = _popart_from_jax(jax_state.popart)
  target_popart = _popart_from_jax(jax_state.target_popart)
  payload = {
      'params': params_from_jax(jax_state.params),
      'opt_state': {'count': torch.tensor(int(np.asarray(count)),
                                          dtype=torch.int32),
                    'nu': params_from_jax(nu),
                    'trace': None if trace is None
                    else params_from_jax(trace)},
      'update_steps': int(np.asarray(jax_state.update_steps))}
  if popart is not None:
    payload['popart'] = popart._asdict()
  if target_popart is not None:
    payload['target_popart'] = target_popart._asdict()
  if jax_state.target_params is not None:
    payload['target_params'] = params_from_jax(jax_state.target_params)
  payload['params'] = {k: payload['params'][k] for k in state.params}
  for part in ('nu', 'trace'):
    if payload['opt_state'][part] is not None:
      payload['opt_state'][part] = {k: payload['opt_state'][part][k]
                                    for k in state.params}
  if 'target_params' in payload:
    payload['target_params'] = {k: payload['target_params'][k]
                                for k in state.params}
  return learner.load_state_(state, payload)


def _flat(tree):
  """The NamedTuple/tuple/list nodes of an optax state, depth first."""
  if isinstance(tree, (tuple, list)):
    yield tree
    for child in tree:
      yield from _flat(child)


# --- the inverse: port names -> JAX leaves -------------------------------

class JaxLeaf(NamedTuple):
  path: str                  # the JAX parameter path
  shape: Tuple[int, ...]     # its shape in JAX's layout
  dims: Tuple[int, ...]      # dims[j]: the port dim of JAX dim j


# The port's LSTM cells by module: their JAX OptimizedLSTMCell paths.
_CELLS = {'core': 'params/_ResetCore_0/OptimizedLSTMCell_0',
          'instruction.cell':
              'params/InstructionEncoder_0/OptimizedLSTMCell_0'}


def _module_paths(names: Sequence[str]) -> Dict[str, str]:
  """{port module: JAX module path} of a model's parameter names."""
  deep = any(n.startswith('torso.sections.') for n in names)
  sections = {int(n.split('.')[2]) for n in names
              if n.startswith('torso.sections.')}
  blocks = {int(n.split('.')[4]) for n in names
            if n.startswith('torso.sections.') and '.blocks.' in n}
  torso = 'params/' + ('DeepResNetTorso_0' if deep else 'ShallowTorso_0')
  out = {prefix: f'{torso}/{path}' for prefix, path in _torso_modules(
      deep, len(sections), len(blocks))}
  out.update(policy_logits='params/policy_logits',
             baseline='params/baseline')
  out.update({f'pixel_control.{name}': f'params/pixel_control/{name}'
              for name, _ in _PIXEL_CONTROL})
  return out


def jax_leaves(name: str, shape: Sequence[int], names: Sequence[str]
               ) -> Tuple[List[JaxLeaf], int]:
  """The JAX leaves the port parameter `name` of `shape` holds (`names`:
  all of the model's parameter names) and the number of gate blocks its
  dim 0 fuses (4 for an LSTM, else 1). A name outside the agent maps
  to the path with '.' as '/' and the same layout."""
  shape = tuple(int(n) for n in shape)
  module, _, leaf = name.rpartition('.')
  if module in _CELLS:
    cell = _CELLS[module]
    hidden = shape[0] // 4
    if leaf == 'bias_hh':
      return [JaxLeaf(f'{cell}/h{g}/bias', (hidden,), (0,))
              for g in _GATES], 4
    prefix = 'i' if leaf == 'weight_ih' else 'h'
    return [JaxLeaf(f'{cell}/{prefix}{g}/kernel', (shape[1], hidden),
                    (1, 0)) for g in _GATES], 4
  if name == 'instruction.embed.weight':
    return [JaxLeaf('params/InstructionEncoder_0/Embed_0/embedding', shape,
                    (0, 1))], 1
  path = _module_paths(names).get(module)
  if path is None:
    return [JaxLeaf(name.replace('.', '/'), shape,
                    tuple(range(len(shape))))], 1
  if leaf == 'bias':
    return [JaxLeaf(f'{path}/bias', shape, (0,))], 1
  if len(shape) == 4:   # OIHW -> HWIO
    return [JaxLeaf(f'{path}/kernel', (shape[2], shape[3], shape[1],
                                        shape[0]), (2, 3, 1, 0))], 1
  return [JaxLeaf(f'{path}/kernel', (shape[1], shape[0]), (1, 0))], 1


def jax_view(shapes: Mapping) -> Dict[str, Tuple[int, ...]]:
  """{JAX path: JAX shape} of a port parameter dict ({name: tensor or
  shape})."""
  names = list(shapes)
  out = {}
  for name, value in shapes.items():
    for leaf in jax_leaves(name, tuple(getattr(value, 'shape', value)),
                           names)[0]:
      out[leaf.path] = leaf.shape
  return out
