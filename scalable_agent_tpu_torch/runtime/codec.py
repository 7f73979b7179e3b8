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
dicts are. The wire form (the JAX package's 'params_int8' publish to
remote actors) waits for routed serving (ROADMAP A7.3).
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
