"""Content checksums of the checkpoint plane, copied from the JAX
package's integrity.py: the CRC of bytes and files, its on-disk record,
the record's verification, and the one-bit flip the fault sites share.

CRC32C (Castagnoli) through the `google_crc32c` C extension when it
imports, else zlib.crc32 (the IEEE polynomial, also C speed), so the
module always imports. `CRC_ALGO` names the one in use and is written
into every record: a checksum is compared only with one made by the same
algorithm, and a record of another algorithm skips the verification
instead of reporting corruption that is not there.

`spec_table_digest` is the CRC of a checkpoint's sharding manifest
(checkpoint.py's SHARDING_<step>.json), `tree_digest` that of a tree of
host arrays (the replay tier's insert-time digest of an unroll,
runtime/ring_buffer.py). The registry counts the digests made and says
whether the zlib fallback runs (`integrity/*`).
"""

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from scalable_agent_tpu_torch import telemetry

try:
  import google_crc32c as _crc32c_lib

  def _crc_update(crc: int, data) -> int:
    # The extension takes only `bytes`.
    if not isinstance(data, bytes):
      data = bytes(data)
    return _crc32c_lib.extend(crc, data)

  CRC_ALGO = 'crc32c'
except ImportError:
  import zlib as _zlib

  def _crc_update(crc: int, data) -> int:
    return _zlib.crc32(data, crc) & 0xFFFFFFFF

  CRC_ALGO = 'zlib-crc32'


def crc_bytes(data, crc: int = 0) -> int:
  """CRC of one bytes-like object (optionally extending `crc`)."""
  return _crc_update(crc, data)


class Crc:
  """Incremental CRC accumulator."""

  __slots__ = ('value',)

  def __init__(self, value: int = 0):
    self.value = int(value)

  def update(self, data) -> 'Crc':
    self.value = _crc_update(self.value, data)
    return self


# How much content hashing the integrity plane does, and whether this
# host runs the slower zlib fallback.
_TREE_DIGESTS = telemetry.counter('integrity/tree_digests')
_FILE_DIGESTS = telemetry.counter('integrity/file_digests')
telemetry.gauge('integrity/crc_algo_is_fallback',
                fn=lambda: 0 if CRC_ALGO == 'crc32c' else 1)


def _leaves(tree) -> Iterator:
  """The leaves of a tree of (named) tuples, lists and dicts, depth
  first, dicts by sorted key and None skipped: JAX's flatten order."""
  if tree is None:
    return
  if isinstance(tree, (tuple, list)):
    for child in tree:
      yield from _leaves(child)
  elif isinstance(tree, dict):
    for key in sorted(tree):
      yield from _leaves(tree[key])
  else:
    yield tree


def tree_digest(tree) -> int:
  """Content CRC of a tree of host arrays in flatten order. Each leaf
  adds its dtype name and shape to the stream, so a reshaped or recast
  tree never collides with the original."""
  _TREE_DIGESTS.inc()
  crc = Crc()
  for leaf in _leaves(tree):
    arr = np.asarray(leaf)
    crc.update(f'{arr.dtype.name}:{arr.shape};'.encode())
    if not arr.flags['C_CONTIGUOUS']:
      arr = np.ascontiguousarray(arr)
    crc.update(arr.reshape(-1).view(np.uint8))
  return crc.value


def file_digest(path: str, chunk_bytes: int = 1 << 20) -> int:
  """Content CRC of one file (the checkpoint's bit-rot ledger)."""
  _FILE_DIGESTS.inc()
  crc = Crc()
  with open(path, 'rb') as f:
    while True:
      chunk = f.read(chunk_bytes)
      if not chunk:
        return crc.value
      crc.update(chunk)


def digest_record(value: int) -> Dict:
  """The on-disk spelling of a digest: value and algorithm, so a reader
  built with another algorithm refuses to compare."""
  return {'crc': int(value), 'algo': CRC_ALGO}


def spec_table_digest(specs: Dict[str, str]) -> int:
  """CRC of a sharding-spec table ({JAX param path: spec string},
  parallel/sharding.ShardingRegistry.describe) in sorted-path order, as
  the JAX package computes it: a spec change is a layout change even
  when every byte of the arrays is the same."""
  crc = Crc()
  for path in sorted(specs):
    crc.update(f'{path}={specs[path]};'.encode())
  return crc.value


def verify_record(record, value: int) -> Optional[bool]:
  """Compare `value` with a `digest_record`. None: not comparable
  (missing or malformed record, or another algorithm; the caller skips
  the verification, loudly); True or False: verified or corrupt."""
  if not isinstance(record, dict):
    return None
  if record.get('algo') != CRC_ALGO:
    return None
  try:
    return int(record['crc']) == int(value)
  except (KeyError, TypeError, ValueError):
    return None


def flip_bit(buf: bytearray, bit_index: int) -> Tuple[int, int]:
  """Flip one bit of `buf` in place; returns (byte offset, bit)."""
  byte = (bit_index // 8) % max(len(buf), 1)
  bit = bit_index % 8
  buf[byte] ^= 1 << bit
  return byte, bit
