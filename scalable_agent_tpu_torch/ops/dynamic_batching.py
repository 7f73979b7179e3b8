"""Dynamic batching of concurrent inference calls, ported from the JAX
package's ops/dynamic_batching.py (the low-level `Batcher`).

The native piece is the port's own copy of the host C++ batcher
(`ops/batcher/batcher.cc`), built by g++ at first use into `_build/`
(`ops/build.load_host`) and driven through ctypes. A failed build raises:
there is no Python batcher to fall back to.

Threading model (the reference's): N caller threads block in `compute`;
one computation thread loops `get_batch_into` -> the batched function ->
`set_outputs` (or `set_error`). Tensors cross as opaque byte rows; dtype
and trailing shape are fixed by the first call.
"""

import ctypes
import math
import threading
from typing import List, Optional, Sequence

import numpy as np

from scalable_agent_tpu_torch.ops import build

# Return codes mirroring batcher.cc's enum Rc.
RC_OK, RC_ERROR, RC_CANCELLED, RC_SHAPE, RC_TOO_BIG, RC_CLOSED, \
    RC_BAD_ID, RC_SIZE = range(8)

_lib = None
_lib_lock = threading.Lock()


class BatcherError(RuntimeError):
  """Computation error propagated from the batched function."""


class BatcherCancelled(RuntimeError):
  """The batcher was closed while this call was in flight."""


def library():
  """The loaded batcher library (built by g++ first if needed)."""
  global _lib
  with _lib_lock:
    if _lib is not None:
      return _lib
    lib = build.load_host('batcher')
    i64 = ctypes.c_longlong
    p = ctypes.c_void_p
    signatures = {
        'batcher_create': (p, [i64, i64, i64, i64]),
        'batcher_compute_begin': (i64, [p, ctypes.POINTER(p),
                                        ctypes.POINTER(i64), i64,
                                        ctypes.POINTER(i64)]),
        'batcher_compute_wait': (i64, [p, i64, ctypes.c_char_p, i64]),
        'batcher_result_size': (i64, [p, i64, i64]),
        'batcher_result_copy': (i64, [p, i64, i64, p, i64]),
        'batcher_request_free': (None, [p, i64]),
        'batcher_get_batch': (i64, [p, ctypes.POINTER(i64),
                                    ctypes.POINTER(i64)]),
        'batcher_batch_input_copy': (i64, [p, i64, i64, p]),
        'batcher_set_outputs': (i64, [p, i64, i64, ctypes.POINTER(p),
                                      ctypes.POINTER(i64), i64]),
        'batcher_set_error': (i64, [p, i64, ctypes.c_char_p]),
        'batcher_close': (None, [p]),
        'batcher_destroy': (None, [p]),
    }
    for name, (restype, argtypes) in signatures.items():
      fn = getattr(lib, name)
      fn.restype = restype
      fn.argtypes = argtypes
    _lib = lib
    return lib


def _as_contiguous(arrays) -> List[np.ndarray]:
  out = []
  for a in arrays:
    a = np.asarray(a)
    # Checked before ascontiguousarray, which promotes 0-d to 1-d.
    if a.ndim < 1:
      raise ValueError('batched tensors need a leading batch dim; got '
                       f'scalar of dtype {a.dtype}')
    out.append(np.ascontiguousarray(a))
  return out


def _row_bytes(shape, itemsize) -> int:
  return math.prod(shape) * itemsize


def _pointers_and_row_bytes(arrays):
  n = len(arrays)
  data = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
  row_bytes = (ctypes.c_longlong * n)(
      *[_row_bytes(a.shape[1:], a.itemsize) for a in arrays])
  return data, row_bytes


class Batcher:
  """Handle over the C++ batcher for one family of input tensors."""

  def __init__(self, num_tensors: int, minimum_batch_size: int = 1,
               maximum_batch_size: int = 1024, timeout_ms: int = 100):
    self._lib = library()
    self._h = self._lib.batcher_create(
        minimum_batch_size, maximum_batch_size, timeout_ms, num_tensors)
    self._num_tensors = num_tensors
    self._meta_lock = threading.Lock()
    # dtype/trailing shape per input tensor, fixed by the first call and
    # published under the lock before compute_begin; the computation
    # thread reads it after get_batch (the C++ mutex orders the two).
    self._in_meta: Optional[List] = None
    self._out_meta: Optional[List] = None
    self._closed = False

  # -- caller side --

  def compute(self, arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Submit rows; block until the computation thread answers."""
    arrays = _as_contiguous(arrays)
    if len(arrays) != self._num_tensors:
      raise ValueError(
          f'expected {self._num_tensors} tensors, got {len(arrays)}')
    rows = arrays[0].shape[0]
    for a in arrays:
      if a.shape[0] != rows:
        raise ValueError('inconsistent leading (batch) dims: '
                         f'{[x.shape for x in arrays]}')
    with self._meta_lock:
      if self._in_meta is None:
        self._in_meta = [(a.dtype, a.shape[1:]) for a in arrays]
      else:
        for a, (dtype, trail) in zip(arrays, self._in_meta):
          if a.dtype != dtype or a.shape[1:] != trail:
            raise ValueError(
                f'tensor mismatch: got {a.dtype}{a.shape[1:]}, '
                f'expected {dtype}{trail}')

    data, row_bytes = _pointers_and_row_bytes(arrays)
    req_id = ctypes.c_longlong(0)
    rc = self._lib.batcher_compute_begin(
        self._h, data, row_bytes, rows, ctypes.byref(req_id))
    if rc == RC_CLOSED:
      raise BatcherCancelled('batcher is closed')
    if rc == RC_TOO_BIG:
      raise ValueError(f'rows={rows} exceeds maximum_batch_size')
    if rc == RC_SHAPE:
      raise ValueError('row byte-size mismatch vs. earlier calls')
    assert rc == RC_OK, rc

    err = ctypes.create_string_buffer(4096)
    rc = self._lib.batcher_compute_wait(self._h, req_id, err, 4096)
    try:
      if rc == RC_ERROR:
        raise BatcherError(err.value.decode('utf-8', errors='replace'))
      if rc == RC_CANCELLED:
        raise BatcherCancelled('batcher closed while waiting')
      assert rc == RC_OK, rc
      with self._meta_lock:
        out_meta = list(self._out_meta)
      outs = []
      for i, (dtype, trail) in enumerate(out_meta):
        nbytes = self._lib.batcher_result_size(self._h, req_id, i)
        row_nb = _row_bytes(trail, dtype.itemsize)
        if nbytes and (row_nb == 0 or nbytes % row_nb):
          raise BatcherError(
              f'output {i}: stored {nbytes} bytes is not a whole number '
              f'of rows of shape {tuple(trail)} dtype {dtype} — the '
              'batched function\'s output shape varied')
        buf = np.empty((nbytes // row_nb if row_nb else 0,) + tuple(trail),
                       dtype)
        if nbytes:
          rc = self._lib.batcher_result_copy(self._h, req_id, i,
                                             buf.ctypes.data, buf.nbytes)
          assert rc == RC_OK, rc
        outs.append(buf)
      return outs
    finally:
      self._lib.batcher_request_free(self._h, req_id)

  # -- computation-thread side --

  def input_meta(self):
    """[(dtype, trailing_shape)] per input tensor, or None before the
    first compute() fixed it."""
    with self._meta_lock:
      return list(self._in_meta) if self._in_meta is not None else None

  def get_batch_into(self, make_buffers):
    """Block for the next merged batch and copy it into caller storage.

    `make_buffers(total_rows)` returns one C-contiguous array per input
    tensor (dtype and trailing shape as `input_meta()`, leading capacity
    >= total_rows); the C++ merge copy lands in their first total_rows
    rows. Returns (batch_id, total_rows, buffers), or None when the
    batcher is closed and drained."""
    i64 = ctypes.c_longlong
    batch_id, total_rows = i64(0), i64(0)
    rc = self._lib.batcher_get_batch(
        self._h, ctypes.byref(batch_id), ctypes.byref(total_rows))
    if rc == RC_CLOSED:
      return None
    assert rc == RC_OK, rc
    try:
      buffers = make_buffers(total_rows.value)
      for i, buf in enumerate(buffers):
        rc = self._lib.batcher_batch_input_copy(self._h, batch_id, i,
                                                buf.ctypes.data)
        if rc != RC_OK:
          return None  # close() erased the batch: shutdown
      return batch_id.value, total_rows.value, buffers
    except Exception as e:
      # The batch is dequeued: answer its callers before re-raising.
      self.set_error(batch_id.value, f'{type(e).__name__}: {e}')
      raise

  def set_outputs(self, batch_id: int, arrays: Sequence[np.ndarray]):
    """Answer a batch: output row i goes to the caller of input row i."""
    arrays = _as_contiguous(arrays)
    rows = arrays[0].shape[0]
    for a in arrays:
      if a.shape[0] != rows:
        raise ValueError('inconsistent output batch dims: '
                         f'{[x.shape for x in arrays]}')
    with self._meta_lock:
      self._out_meta = [(a.dtype, a.shape[1:]) for a in arrays]
    data, row_bytes = _pointers_and_row_bytes(arrays)
    rc = self._lib.batcher_set_outputs(
        self._h, batch_id, len(arrays), data, row_bytes, rows)
    if rc == RC_SIZE:
      raise ValueError('output rows do not match the batch rows')
    if rc not in (RC_OK, RC_BAD_ID):  # BAD_ID: cancelled by close
      raise RuntimeError(f'set_outputs rc={rc}')

  def set_error(self, batch_id: int, message: str):
    """Fail every caller of a batch with `message` (BatcherError)."""
    self._lib.batcher_set_error(self._h, batch_id, message.encode('utf-8'))

  def close(self):
    """Cancel every waiting caller; get_batch returns None once drained."""
    if not self._closed:
      self._closed = True
      self._lib.batcher_close(self._h)

  def __del__(self):
    try:
      if getattr(self, '_h', None):
        self.close()
        self._lib.batcher_destroy(self._h)
        self._h = None
    except Exception:
      pass
