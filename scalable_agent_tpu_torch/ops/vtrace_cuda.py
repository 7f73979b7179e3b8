"""Fused V-trace: the hand-written CUDA kernel and its plain twin.

`from_importance_weights` is the port of
scalable_agent_tpu/ops/vtrace_pallas.py `from_importance_weights` (whose
Pallas kernel is `_vtrace_kernel`). Dispatch is by the tensors' device:

- CUDA tensors go to `csrc/vtrace.cu` (built by ops/build.py at first
  use), launched on the current stream. A launch that fails raises; there
  is no fallback.
- CPU tensors go to `plain_from_importance_weights`, the same arithmetic
  as a sequential reverse loop in PyTorch. The CPU tests use it, and
  chip_smoke.py holds the kernel to it on the card.

`sharded_from_importance_weights` is the port of the same module's
`sharded_from_importance_weights` (K1b), the kernel under `shard_map`
over the data axis. A rank holds only its own columns, so K1b is K1 on
this rank's [T, B/D, ...] shard, with no collectives: the same kernel and
the same source, launched from a wrapper of its own.

Each wrapper's `launches` counts its own kernel launches (plain-twin
calls do not count), so a run can show which of the two it went through.
The kernel's design and bound are described in csrc/vtrace.cu.

Rank-generic: inputs are [T, ...] and the trailing dims are flattened into
the kernel's N columns, each an independent recursion. No autograd: the
callers pass detached inputs and the outputs carry no graph.

`launch_geometry` chooses the kernel's columns per block, time chunk,
stages and shared memory in plain Python, so the CPU tests reach it; the
kernel checks what it is given and refuses what it cannot run.
"""

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from scalable_agent_tpu_torch.ops import build

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])

# A block stages its columns' [T, cols] slabs of the four inputs in one
# chunk up to this many steps (T=100 of the learner: one chunk), and in
# double-buffered chunks of LONG_CHUNK steps beyond it.
MAX_COLS = 32
ONE_CHUNK_MAX_T = 128
LONG_CHUNK = 64
THREADS = 512
_INPUTS, _OUTPUTS = 4, 2


class LaunchGeometry(NamedTuple):
  cols: int        # columns per block (a power of two, 4 to 32)
  chunk: int       # time steps per staged chunk
  stages: int      # input buffers in flight (1 or 2)
  threads: int     # threads per block; the first `cols` walk
  smem_bytes: int  # dynamic shared memory per block
  blocks: int      # ceil(n_cols / cols)


def launch_geometry(t_len: int, n_cols: int) -> LaunchGeometry:
  """The kernel's launch for [t_len, n_cols]: one thread per column walks
  time in chunks from the end, out of `stages` shared-memory buffers of
  the four inputs ([chunk, cols] floats each) and one of the two
  outputs. `cols` is a power of two, so that it divides `threads`: the
  passes map thread i to column i % cols."""
  if t_len < 1 or n_cols < 1:
    raise ValueError(f'V-trace needs T >= 1 and N >= 1, got [{t_len}, '
                     f'{n_cols}]')
  cols = min(MAX_COLS, max(4, 1 << (n_cols - 1).bit_length()))
  if t_len <= ONE_CHUNK_MAX_T:
    chunk, stages = t_len, 1
  else:
    chunk, stages = LONG_CHUNK, 2
  smem_bytes = 4 * (stages * _INPUTS + _OUTPUTS) * chunk * cols
  return LaunchGeometry(cols, chunk, stages, THREADS, smem_bytes,
                        -(-n_cols // cols))


def _threshold(x: Optional[float]) -> float:
  return math.inf if x is None else float(x)


def sequential_recursion(deltas, discounts_cs):
  """vs - V by the reverse loop acc_t = delta_t + (gamma_t c_t) acc_{t+1},
  adding in the order of the JAX package's lax.scan form."""
  acc = torch.zeros_like(deltas[0])
  out = []
  for t in range(deltas.shape[0] - 1, -1, -1):
    acc = deltas[t] + discounts_cs[t] * acc
    out.append(acc)
  return torch.stack(out[::-1])


def plain_from_importance_weights(log_rhos, discounts, rewards, values,
                                  bootstrap_value, clip_rho_threshold=1.0,
                                  clip_pg_rho_threshold=1.0,
                                  recursion=sequential_recursion
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kernel's arithmetic in plain PyTorch: returns (vs, pg_advantages).

  `recursion` computes vs - V from (deltas, gamma * c); the default
  reverse loop is the kernel's order. vtrace.py passes its doubling form
  for `use_associative_scan`."""
  rhos = torch.exp(log_rhos)
  clipped_rhos = torch.clamp(rhos, max=_threshold(clip_rho_threshold))
  cs = torch.clamp(rhos, max=1.0)
  values_t_plus_1 = torch.cat([values[1:], bootstrap_value[None]], dim=0)
  deltas = clipped_rhos * (rewards + discounts * values_t_plus_1 - values)
  vs = recursion(deltas, discounts * cs) + values
  vs_t_plus_1 = torch.cat([vs[1:], bootstrap_value[None]], dim=0)
  clipped_pg_rhos = torch.clamp(rhos,
                                max=_threshold(clip_pg_rho_threshold))
  pg_advantages = clipped_pg_rhos * (
      rewards + discounts * vs_t_plus_1 - values)
  return vs, pg_advantages


def _check(name: str, x: torch.Tensor, shape, device):
  if x.device != device:
    raise ValueError(f'{name} is on {x.device}, expected {device}')
  if x.dtype != torch.float32:
    raise TypeError(f'{name} must be float32, got {x.dtype}')
  if tuple(x.shape) != tuple(shape):
    raise ValueError(f'{name} has shape {tuple(x.shape)}, expected '
                     f'{tuple(shape)}')
  if not x.is_contiguous():
    raise ValueError(f'{name} must be contiguous')


def from_importance_weights(log_rhos, discounts, rewards, values,
                            bootstrap_value, clip_rho_threshold=1.0,
                            clip_pg_rho_threshold=1.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Fused V-trace on [T, ...] float32 tensors (bootstrap [...]); returns
  (vs, pg_advantages) of log_rhos' shape. A threshold of None is no
  clipping."""
  return _dispatch(from_importance_weights, log_rhos, discounts, rewards,
                   values, bootstrap_value, clip_rho_threshold,
                   clip_pg_rho_threshold)


from_importance_weights.launches = 0


def sharded_from_importance_weights(mesh, log_rhos, discounts, rewards,
                                    values, bootstrap_value,
                                    clip_rho_threshold=1.0,
                                    clip_pg_rho_threshold=1.0,
                                    batch_axis='data', batch_size=None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Fused V-trace on this rank's shard of a batch split over
  `batch_axis` of `mesh` (parallel/mesh.py; a tuple of axes splits over
  their product, as the batch does under tensor parallelism): [T, B/D,
  ...] float32 tensors, bootstrap [B/D, ...], D = mesh.shape[batch_axis].
  Returns
  this rank's (vs, pg_advantages); no collectives.

  `batch_size` is the global batch B (None: the local batch times D). B
  must split into D equal shards, as under `shard_map`: otherwise, or
  when the local batch is not B/D, it raises ValueError."""
  shards = 1
  for axis in (batch_axis if isinstance(batch_axis, tuple)
               else (batch_axis,)):
    if axis not in mesh.shape:
      raise ValueError(f'mesh has no axis {axis!r}: {mesh.shape}')
    shards *= mesh.shape[axis]
  if log_rhos.ndim < 2:
    raise ValueError(f'log_rhos must be [T, B, ...], got shape '
                     f'{tuple(log_rhos.shape)}')
  local = log_rhos.shape[1]
  if batch_size is None:
    batch_size = local * shards
  if batch_size % shards:
    raise ValueError(f'batch of {batch_size} does not split over the '
                     f'{shards} shards of mesh axis {batch_axis!r}')
  if local * shards != batch_size:
    raise ValueError(f'local batch {local} is not batch {batch_size} / '
                     f'{shards} shards of mesh axis {batch_axis!r}')
  return _dispatch(sharded_from_importance_weights, log_rhos, discounts,
                   rewards, values, bootstrap_value, clip_rho_threshold,
                   clip_pg_rho_threshold)


sharded_from_importance_weights.launches = 0


def _dispatch(wrapper, log_rhos, discounts, rewards, values,
              bootstrap_value, clip_rho_threshold, clip_pg_rho_threshold):
  """Check the inputs; run the plain twin on CPU tensors, or launch the
  kernel on CUDA tensors and count the launch on `wrapper`."""
  shape = tuple(log_rhos.shape)
  device = log_rhos.device
  for name, x in (('log_rhos', log_rhos), ('discounts', discounts),
                  ('rewards', rewards), ('values', values)):
    _check(name, x, shape, device)
  _check('bootstrap_value', bootstrap_value, shape[1:], device)
  if device.type == 'cpu':
    return plain_from_importance_weights(
        log_rhos, discounts, rewards, values, bootstrap_value,
        clip_rho_threshold, clip_pg_rho_threshold)
  if device.type != 'cuda':
    raise ValueError(f'fused V-trace runs on CUDA or CPU tensors, got '
                     f'{device}')

  fn = _launcher()
  t_len = shape[0]
  n_cols = math.prod(shape[1:])
  geometry = launch_geometry(t_len, n_cols)
  inputs = (log_rhos, discounts, rewards, values)
  vs = torch.empty((t_len, n_cols), dtype=torch.float32, device=device)
  pg = torch.empty((t_len, n_cols), dtype=torch.float32, device=device)
  with torch.cuda.device(device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(x.data_ptr() for x in inputs), bootstrap_value.data_ptr(),
             vs.data_ptr(), pg.data_ptr(), t_len, n_cols,
             _threshold(clip_rho_threshold),
             _threshold(clip_pg_rho_threshold), *geometry[:5], stream)
  if err != 0:
    raise RuntimeError(f'vtrace kernel launch failed: CUDA error {err}')
  wrapper.launches += 1
  return vs.reshape(shape), pg.reshape(shape)


_LAUNCHER = None


def _launcher():
  """`vtrace_launch` of the built library, bound once per process."""
  global _LAUNCHER
  if _LAUNCHER is None:
    fn = build.load('vtrace').vtrace_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    _LAUNCHER = fn
  return _LAUNCHER
