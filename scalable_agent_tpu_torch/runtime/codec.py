"""The int8 publish codec, the port's copy of the JAX package's
runtime/codec.py: absmax int8 parameter snapshots.

Each float32 leaf x becomes `Int8Leaf(q, scale)` with
`scale = float32(max|x| / QMAX)` (the division in float64, as numpy's)
and `q = clip(round(x / scale), -QMAX, QMAX)` in int8, of x's shape;
rounding is half-to-even in both `np.rint` and `torch.round`, so the
host form (`quantize_np`) and the device form (`quantize`) give the JAX
package's `quantize_np` values and scales bit for bit. An all-zero leaf
gets scale 0 (it dequantizes to exact zeros). Leaves that are not
float32 pass through.

The serving version table (runtime/inference.py) keeps int8-resident
entries in this form and dequantizes them inside the serving forward.
Quantization is lossy, by at most scale / 2 per element
(`max_abs_error`); `greedy_agreement` scores argmax-action agreement of
two policies' logits, the serving plane's parity measure. Trees are
(nested) dicts of numpy arrays or torch tensors, as the port's parameter
dicts are.

The wire forms of the remote actors' param lane (runtime/remote.py):
'params_int8' ships `quantize_np` trees (Int8Leaf pickles as its q and
scale, so pickle protocol 5 still hands q out of band) and the client
decodes with `dequantize_np`; 'params_bf16' ships `to_bf16_np` trees,
whose `Bf16Leaf`s hold the bfloat16 bit patterns as uint16 (numpy has no
bfloat16 without ml_dtypes), rounded to nearest even as
`tensor.to(torch.bfloat16)` and the JAX package's ml_dtypes cast round,
and the client upcasts with `from_bf16_np`. `wire_leaves` /
`wire_rebuild` flatten such a tree in the JAX package's order (dict keys
sorted; an Int8Leaf is its q then its scale; a Bf16Leaf is one leaf), for
the publish digest and the publish_corrupt fault site.
"""

from typing import Tuple

import numpy as np
import torch

# q = clip(round(x / scale), -QMAX, QMAX); scale = absmax / QMAX.
QMAX = 127


class Int8Leaf:
  """One quantized leaf: `q` (int8, the original leaf's shape) and
  `scale` (a float32 scalar: np.float32, or a 0-dim torch tensor)."""

  __slots__ = ('q', 'scale')

  def __init__(self, q, scale):
    self.q = q
    self.scale = scale

  def __repr__(self):
    return f'Int8Leaf(shape={tuple(self.q.shape)}, scale={self.scale!r})'

  # __slots__ classes need explicit pickle state; numpy still hands q's
  # buffer out of band under protocol 5.
  def __getstate__(self):
    return (self.q, self.scale)

  def __setstate__(self, state):
    self.q, self.scale = state


class Bf16Leaf:
  """One bfloat16 wire leaf: `bits`, the bfloat16 bit patterns as a
  uint16 array of the original leaf's shape."""

  __slots__ = ('bits',)

  def __init__(self, bits):
    self.bits = bits

  def __repr__(self):
    return f'Bf16Leaf(shape={tuple(self.bits.shape)})'

  def __getstate__(self):
    return (self.bits,)

  def __setstate__(self, state):
    (self.bits,) = state


def tree_map(fn, tree):
  """`fn` over the leaves of a (nested) dict; an Int8Leaf is a leaf."""
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  return fn(tree)


def tree_leaves(tree):
  """The leaves in tree order; an Int8Leaf counts as its q and scale."""
  out = []

  def visit(x):
    if isinstance(x, Int8Leaf):
      out.extend((x.q, x.scale))
    else:
      out.append(x)
  tree_map(visit, tree)
  return out


def _is_f32(x) -> bool:
  return getattr(x, 'dtype', None) in (np.float32, torch.float32)


def quantize_np(tree):
  """Host-side absmax int8 quantization: every float32 leaf (numpy, or a
  CPU tensor) -> Int8Leaf(np.int8 q, np.float32 scale); everything else
  passes through."""

  def one(x):
    if not _is_f32(x):
      return x
    x = np.asarray(x)
    absmax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = np.float32(absmax / QMAX)
    if scale == 0.0:
      return Int8Leaf(np.zeros(x.shape, np.int8), scale)
    q = np.clip(np.rint(x / scale), -QMAX, QMAX).astype(np.int8)
    return Int8Leaf(q, scale)

  return tree_map(one, tree)


@torch.no_grad()
def quantize_leaf_(x: torch.Tensor, out: Int8Leaf) -> Int8Leaf:
  """Quantize float32 tensor `x` into `out`'s q and scale tensors in
  place, on x's device and the current stream (no host read)."""
  absmax = x.abs().amax() if x.numel() else x.new_zeros(())
  scale = (absmax.double() / QMAX).float()
  safe = torch.where(scale > 0, scale, torch.ones_like(scale))
  out.q.copy_(torch.clamp(torch.round(x / safe), -QMAX, QMAX).to(torch.int8))
  out.scale.copy_(scale)
  return out


def quantize(tree):
  """Device-side quantization of a tree of torch tensors: the same
  values and scales as `quantize_np`, on each leaf's device."""

  def one(x):
    if not _is_f32(x):
      return x
    out = Int8Leaf(torch.empty(x.shape, dtype=torch.int8, device=x.device),
                   torch.empty((), dtype=torch.float32, device=x.device))
    return quantize_leaf_(x, out)

  return tree_map(one, tree)


def dequantize_tree(tree):
  """Int8Leaf leaves -> float32 (`q * scale` in float32: numpy leaves
  to numpy, tensors to tensors on their device). Identity on a tree
  with no quantized leaves."""

  def one(x):
    if not isinstance(x, Int8Leaf):
      return x
    if isinstance(x.q, torch.Tensor):
      return x.q.to(torch.float32) * x.scale
    return (np.asarray(x.q, np.float32) * np.float32(x.scale)).astype(
        np.float32)

  return tree_map(one, tree)


def dequantize_np(tree):
  """Host decode of a 'params_int8' blob: Int8Leaf -> np.float32
  (`q * scale` in float32, as the JAX package's dequantize_np)."""

  def one(x):
    if not isinstance(x, Int8Leaf):
      return x
    return (np.asarray(x.q, np.float32) * np.float32(x.scale)).astype(
        np.float32)

  return tree_map(one, tree)


def to_bf16_np(tree):
  """The 'params_bf16' wire form: every float32 leaf -> Bf16Leaf of its
  round-to-nearest-even bfloat16 bits; other leaves pass through."""

  def one(x):
    if not _is_f32(x):
      return x
    t = torch.as_tensor(np.ascontiguousarray(x)).to(torch.bfloat16)
    return Bf16Leaf(t.view(torch.int16).numpy().view(np.uint16))

  return tree_map(one, tree)


def from_bf16_np(tree):
  """Upcast a 'params_bf16' tree: Bf16Leaf -> np.float32 (exact)."""

  def one(x):
    if not isinstance(x, Bf16Leaf):
      return x
    bits = np.asarray(x.bits, np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)

  return tree_map(one, tree)


def wire_leaves(tree):
  """The leaves of a wire tree in the JAX package's flatten order (see
  the module docstring): a list of numpy arrays, Bf16Leaf bits as
  uint16."""
  out = []

  def visit(x):
    if isinstance(x, dict):
      for key in sorted(x):
        visit(x[key])
    elif isinstance(x, (tuple, list)):
      for child in x:
        visit(child)
    elif isinstance(x, Int8Leaf):
      out.extend((x.q, x.scale))
    elif isinstance(x, Bf16Leaf):
      out.append(x.bits)
    elif x is not None:
      out.append(x)
  visit(tree)
  return out


def wire_rebuild(tree, leaves):
  """`tree` with its `wire_leaves` replaced, in order, by `leaves`."""
  it = iter(leaves)

  def visit(x):
    if isinstance(x, dict):
      return {key: visit(x[key]) for key in sorted(x)}
    if isinstance(x, (tuple, list)):
      children = [visit(child) for child in x]
      return (type(x)(*children) if hasattr(x, '_fields')
              else type(x)(children))
    if isinstance(x, Int8Leaf):
      return Int8Leaf(next(it), next(it))
    if isinstance(x, Bf16Leaf):
      return Bf16Leaf(next(it))
    if x is None:
      return None
    return next(it)
  return visit(tree)


def is_quantized(tree) -> bool:
  """True if any leaf of `tree` is an Int8Leaf."""
  found = []
  tree_map(lambda x: found.append(isinstance(x, Int8Leaf)), tree)
  return any(found)


def _nbytes(leaf) -> int:
  if isinstance(leaf, torch.Tensor):
    return leaf.numel() * leaf.element_size()
  return int(np.asarray(leaf).nbytes)


def tree_nbytes(tree) -> int:
  """Total leaf bytes (an Int8Leaf counts q and scale): the version
  table's byte-budget accounting."""
  return sum(_nbytes(leaf) for leaf in tree_leaves(tree))


def max_abs_error(tree) -> float:
  """Upper bound on the per-element absolute quantization error of an
  encoded tree: the largest scale / 2 over its leaves."""
  worst = 0.0

  def one(x):
    nonlocal worst
    if isinstance(x, Int8Leaf):
      worst = max(worst, float(x.scale) / 2.0)

  tree_map(one, tree)
  return worst


def greedy_agreement(logits_a, logits_b) -> float:
  """Fraction of rows whose argmax action agrees. Greedy, not sampled:
  sampled actions differ by the generator alone."""
  a = np.argmax(np.asarray(logits_a), axis=-1)
  b = np.argmax(np.asarray(logits_b), axis=-1)
  if a.size == 0:
    return 1.0
  return float(np.mean(a == b))


def wire_sizes(params) -> Tuple[int, int, int]:
  """(f32, bf16, int8) leaf-byte totals of one tree."""
  f32 = tree_nbytes(params)
  bf16 = 0
  for leaf in tree_leaves(params):
    nbytes = _nbytes(leaf)
    bf16 += nbytes // 2 if _is_f32(leaf) else nbytes
  int8 = tree_nbytes(quantize_np(params))
  return f32, bf16, int8
