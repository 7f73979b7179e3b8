"""Flax parameters -> the port's `state_dict`.

`params_from_jax` takes the JAX agent's parameter tree as nested dicts of
numpy arrays (`jax.device_get(params)` does that) and returns a state_dict
that `ImpalaAgent.load_state_dict` accepts:

- Conv kernels HWIO -> OIHW.
- Dense kernels [in, out] -> Linear weights [out, in]. The torso's Dense
  rows need no permutation: the port flattens NHWC, as Flax does.
- OptimizedLSTMCell: `weight_ih = stack(ii, if, ig, io).T`,
  `weight_hh = stack(hi, hf, hg, ho).T`, `bias_hh` the hidden kernels'
  biases in the same gate order, `bias_ih = 0` (Flax has one bias).

This module imports numpy and torch only; the tests hand it the tree.
"""

from typing import Dict, Mapping, Tuple

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


def _torso(name: str, p: Mapping, out: Dict):
  if name.startswith('DeepResNetTorso'):
    num_sections = sum(1 for k in p if k.startswith('Conv_'))
    blocks = sorted((k for k in p if k.startswith('ResidualBlock_')),
                    key=lambda k: int(k.split('_')[-1]))
    per_section = len(blocks) // num_sections
    for s in range(num_sections):
      _conv(f'torso.sections.{s}.conv', p[f'Conv_{s}'], out)
      for j in range(per_section):
        block = p[f'ResidualBlock_{s * per_section + j}']
        prefix = f'torso.sections.{s}.blocks.{j}'
        _conv(prefix + '.conv0', block['Conv_0'], out)
        _conv(prefix + '.conv1', block['Conv_1'], out)
  elif name.startswith('ShallowTorso'):
    _conv('torso.conv0', p['Conv_0'], out)
    _conv('torso.conv1', p['Conv_1'], out)
  else:
    raise ValueError(f'unknown torso in the Flax tree: {name!r}')
  _dense('torso.linear', p['Dense_0'], out)


def params_from_jax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
  """Map the Flax ImpalaAgent tree ({'params': {...}} or its inside) to
  the port's ImpalaAgent state_dict (float32 CPU tensors)."""
  tree = flax_params.get('params', flax_params)
  out = {}
  torsos = [k for k in tree if k.endswith('Torso_0')]
  if len(torsos) != 1:
    raise ValueError(f'expected one torso in the Flax tree, got {torsos}')
  _torso(torsos[0], tree[torsos[0]], out)

  cell = tree['_ResetCore_0']['OptimizedLSTMCell_0']
  out['core.weight_ih'] = _tensor(np.concatenate(
      [np.asarray(cell['i' + g]['kernel']) for g in _GATES], axis=1).T)
  out['core.weight_hh'] = _tensor(np.concatenate(
      [np.asarray(cell['h' + g]['kernel']) for g in _GATES], axis=1).T)
  out['core.bias_hh'] = _tensor(np.concatenate(
      [np.asarray(cell['h' + g]['bias']) for g in _GATES]))
  out['core.bias_ih'] = torch.zeros_like(out['core.bias_hh'])

  _dense('policy_logits', tree['policy_logits'], out)
  _dense('baseline', tree['baseline'], out)
  return out
